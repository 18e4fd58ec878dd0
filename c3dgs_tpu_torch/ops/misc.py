"""Small math helpers (port of c3dgs_tpu/ops/misc.py: inverse_sigmoid, the
LR schedule and the exact chunked kNN; the Morton-window kNN for > 600k
points comes with a later slice)."""
from __future__ import annotations

import math

import numpy as np
import torch

# exact-path ceiling of c3dgs_tpu.ops.misc: above it the JAX package switches
# to the Morton-window approximation, which this port does not have yet
EXACT_KNN_MAX_POINTS = 600_000


def inverse_sigmoid(x):
    """logit (tensor, numpy array or python float)."""
    if isinstance(x, torch.Tensor):
        return torch.log(x / (1 - x))
    return np.log(x / (1 - x))


def get_expon_lr_func(
    lr_init: float,
    lr_final: float,
    lr_delay_steps: int = 0,
    lr_delay_mult: float = 1.0,
    max_steps: int = 1000000,
):
    """Log-linear LR interpolation with an optional sine-delay warmup
    (utils/general_utils.py:32-61). The returned callable takes the step
    as a python number and evaluates in float32, as the JAX helper does;
    0 for a negative step or when lr_init == lr_final == 0."""
    f32 = np.float32

    def helper(step) -> float:
        step = f32(step)
        if lr_delay_steps > 0:
            ramp = np.clip(step / f32(lr_delay_steps), f32(0), f32(1))
            delay_rate = f32(lr_delay_mult) + f32(1 - lr_delay_mult) * np.sin(f32(0.5 * math.pi) * ramp)
        else:
            delay_rate = f32(1.0)
        t = np.clip(step / f32(max_steps), f32(0), f32(1))
        log_lerp = np.exp(
            f32(math.log(max(lr_init, 1e-32))) * (f32(1) - t) + f32(math.log(max(lr_final, 1e-32))) * t
        )
        if step < 0 or (lr_init == 0.0 and lr_final == 0.0):
            return 0.0
        return float(f32(delay_rate * log_lerp))

    return helper


def mean_knn_sq_dist(xyz: torch.Tensor, k: int = 3, chunk: int = 4096) -> torch.Tensor:
    """Mean squared distance to the k nearest neighbours of each point.

    Exact chunked pairwise distances: one (chunk, N) block at a time, so
    memory is O(chunk * N) and a 300k cloud never builds its N x N matrix.
    The distance products are one torch.matmul per block, as the JAX
    package leaves them to XLA."""
    n = xyz.shape[0]
    sq = torch.sum(xyz * xyz, dim=1)
    out = torch.empty(n, dtype=xyz.dtype, device=xyz.device)
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        rows = xyz[lo:hi]
        d = sq[lo:hi, None] + sq[None, :] - 2.0 * (rows @ xyz.T)
        # exclude self-distance
        idx = torch.arange(lo, hi, device=xyz.device)
        d[idx - lo, idx] = float("inf")
        nearest = torch.topk(d, k, dim=1, largest=False).values
        out[lo:hi] = torch.clamp(nearest, min=0.0).mean(dim=1)
    return out
