"""instances.pose: the mean `num_instances` that `camera_step` returns per
step of the traced window (binning's (gaussian, tile) instances; the
program's counter). Moves train_step_ms."""


def read(ctx):
    if ctx["loop"] != "pose" or not ctx["instances"]:
        return None
    return sum(ctx["instances"]) / len(ctx["instances"])
