"""instances.view: the mean `num_instances` that `render_full` returns per
view of the traced window (the program's counter). Moves view_ms."""


def read(ctx):
    vals = [v for v in ctx["instances"] if v is not None]
    if ctx["loop"] != "view" or not vals:
        return None
    return sum(vals) / len(vals)
