"""mfu.train: the whole training step's least time at the H100's peaks
(forward and backward, the reference's work; benchmark/work.py) over the
traced window's time per step, in %. Moves train_step_ms."""
from benchmark import work


def read(ctx):
    if ctx["loop"] != "train" or not ctx["frames"] or not ctx["steps"]:
        return None
    least = sum(work.step_least_s(w, ctx["pixels"], ctx["scene_bytes"], ctx["param_bytes"])
                for w in ctx["frames"])
    return 100.0 * least / ctx["window_s"]
