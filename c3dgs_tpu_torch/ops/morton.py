"""Morton (Z-order) encoding for serialization-time reordering (port of
c3dgs_tpu/ops/morton.py, numpy only).

Positions are quantized to 21 bits per axis over their bounding box, the
axes are permuted by ascending extent, and the interleaved 63-bit codes
are sorted ascending (stable). This is host I/O work at save time; the
JAX package's native codec computes the same permutation.
"""
from __future__ import annotations

import numpy as np


def _split_by_3(a: np.ndarray) -> np.ndarray:
    x = a.astype(np.int64) & 0x1FFFFF  # first 21 bits
    x = (x | x << 32) & 0x1F00000000FFFF
    x = (x | x << 16) & 0x1F0000FF0000FF
    x = (x | x << 8) & 0x100F00F00F00F00F
    x = (x | x << 4) & 0x10C30C30C30C30C3
    x = (x | x << 2) & 0x1249249249249249
    return x


def morton_encode(pos_q: np.ndarray, ordering=(0, 1, 2)) -> np.ndarray:
    """Interleave 21-bit integer coords [N, 3] -> int64 Morton codes [N]."""
    x = pos_q[:, ordering[0]]
    y = pos_q[:, ordering[1]]
    z = pos_q[:, ordering[2]]
    return _split_by_3(x) | (_split_by_3(y) << 1) | (_split_by_3(z) << 2)


def morton_order(xyz: np.ndarray) -> np.ndarray:
    """Permutation that sorts points in Morton order."""
    xyz = np.asarray(xyz, dtype=np.float64)
    pp_min = xyz.min(axis=0)
    pp_diap = xyz.max(axis=0) - pp_min
    denom = np.where(pp_diap > 0, pp_diap, 1.0)
    xyz_q = ((2**21 - 1) * (xyz - pp_min) / denom).astype(np.int64)
    ordering = np.argsort(pp_diap)
    codes = morton_encode(xyz_q, tuple(int(i) for i in ordering))
    return np.argsort(codes, kind="stable")
