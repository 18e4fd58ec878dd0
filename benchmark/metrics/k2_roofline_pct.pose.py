"""k2_roofline_pct.pose: K2's least time (the reference's work at the
H100's peaks, benchmark/work.py) over its mean device time per launch
(`tiles_packed_bwd` kernels in the profiler's trace) in the pose steps, in
%. Moves train_step_ms."""
from benchmark import trace, work


def read(ctx):
    if ctx["loop"] != "pose" or not ctx["frames"]:
        return None
    t = trace.kernel_mean_s(ctx["kernels"], "tiles_packed_bwd")
    if not t:
        return None
    least = sum(work.k2_least_s(w, ctx["pixels"]) for w in ctx["frames"]) / len(ctx["frames"])
    return 100.0 * least / t
