"""mfu.view: the whole view's least time at the H100's peaks (the
reference's work; benchmark/work.py) over the traced window's time per
view, in %. Moves view_ms."""
from benchmark import work


def read(ctx):
    if ctx["loop"] != "view" or not ctx["frames"] or not ctx["steps"]:
        return None
    least = sum(work.view_least_s(w, ctx["pixels"], ctx["scene_bytes"]) for w in ctx["frames"])
    return 100.0 * least / ctx["window_s"]
