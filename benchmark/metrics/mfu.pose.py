"""mfu.pose: the whole pose step's least time at the H100's peaks (the
reference's work, benchmark/work.py: a served view's, the scene read once,
then K2's; no parameter bytes, the 7-vector's Adam is a few bytes) over
the traced window's time per step, in %. The two least times are added:
the step runs the view, then K2, one after the other. Moves
train_step_ms."""
from benchmark import work


def read(ctx):
    if ctx["loop"] != "pose" or not ctx["frames"] or not ctx["steps"]:
        return None
    least = sum(work.view_least_s(w, ctx["pixels"], ctx["scene_bytes"]) + work.k2_least_s(w, ctx["pixels"])
                for w in ctx["frames"])
    return 100.0 * least / ctx["window_s"]
