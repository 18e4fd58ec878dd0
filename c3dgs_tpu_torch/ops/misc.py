"""Small math helpers (port of c3dgs_tpu/ops/misc.py: inverse_sigmoid, the
LR schedule, the exact chunked kNN and the Morton-window kNN that replaces
it above EXACT_KNN_MAX_POINTS)."""
from __future__ import annotations

import math

import numpy as np
import torch

from . import morton

# exact-path ceiling of c3dgs_tpu.ops.misc: the exact kNN builds a
# (4096, N) block per chunk; above it models/gaussians.py::from_point_cloud
# takes the Morton-window approximation, as the JAX package does
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


def mean_knn_sq_dist_large(xyz: torch.Tensor, k: int = 3, window: int = 32) -> torch.Tensor:
    """Approximate mean squared distance to the k nearest neighbours for
    big clouds: sort by Morton code (on the host), take each point's k
    nearest among its +-window neighbours in Morton order. Memory
    O(N * window). torch.roll wraps, so the first and last `off` rows also
    see far-away points: real points, so at worst an overestimate, which
    the only consumer (a log-scale init) tolerates."""
    n = xyz.shape[0]
    order = torch.as_tensor(morton.morton_order(xyz.detach().cpu().numpy()), device=xyz.device)
    xs = xyz[order]
    ds = []
    for off in range(1, window + 1):
        for sgn in (1, -1):
            ds.append(torch.sum((xs - torch.roll(xs, sgn * off, dims=0)) ** 2, dim=1))
    nearest = torch.topk(torch.stack(ds, dim=1), k, dim=1, largest=False).values
    mean_k = torch.clamp(nearest, min=0.0).mean(dim=1)
    out = torch.empty(n, dtype=mean_k.dtype, device=xyz.device)
    out[order] = mean_k
    return out
