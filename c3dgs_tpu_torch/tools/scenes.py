"""Seeded numpy scenes that hold the packed kernels against their plain
versions on the card: shared by tests/test_torch_gpu.py and chip_smoke.py.
"""
from __future__ import annotations

import numpy as np


def long_tile_scene(n: int = 4000, seed: int = 11):
    """4,000 splats over the left half of a 64x48 view (tanfovx tan 0.6,
    tanfovy tan 0.45, identity camera), so the three left tiles hold
    1,792-2,053 slots each (14-16 batches of the packed kernels' ring).
    Opaque at the top, faint below: the top-left tile freezes at slot 1408
    after crossing 10 aligned boundaries live (margins >= 0.46 in log T
    there, -0.027 at the freeze), the others never freeze.

    Returns numpy (means, scales, quats, opacity, colors)."""
    rng = np.random.default_rng(seed)
    z = rng.uniform(4.0, 8.0, n)
    means = np.stack([rng.uniform(-4.6, -0.2, n) * z / 6, rng.uniform(-3.3, 3.3, n) * z / 6, z], 1)
    scales = np.exp(rng.normal(size=(n, 3)) * 0.3 - 1.2).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    row = means[:, 1] / means[:, 2] * 6
    opacity = np.select([row < -1.0, row < 1.0], [0.6, 0.05], 0.02) * rng.uniform(0.5, 1.5, n)
    colors = rng.random(size=(n, 3)).astype(np.float32)
    return means.astype(np.float32), scales, quats, opacity.astype(np.float32), colors
