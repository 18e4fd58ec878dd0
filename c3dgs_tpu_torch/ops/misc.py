"""Small math helpers (port of c3dgs_tpu/ops/misc.py: inverse_sigmoid and
the exact chunked kNN; the Morton-window kNN for > 600k points and the LR
schedule come with later slices)."""
from __future__ import annotations

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
