"""k1_roofline_pct.view: K1's least time (the reference's work at the
H100's peaks, benchmark/work.py) over its mean device time per launch
(`tiles_packed_fwd` kernels in the profiler's trace), in %. Moves view_ms."""
from benchmark import trace, work


def read(ctx):
    if ctx["loop"] != "view" or not ctx["frames"]:
        return None
    t = trace.kernel_mean_s(ctx["kernels"], "tiles_packed_fwd")
    if not t:
        return None
    least = sum(work.k1_least_s(w, ctx["pixels"]) for w in ctx["frames"]) / len(ctx["frames"])
    return 100.0 * least / t
