"""Seeded numpy inputs shared by tests/test_torch_gpu.py and chip_smoke.py:
a scene that holds the packed kernels against their plain versions on the
card, and random LPIPS weights that hold the card's LPIPS against the
CPU's.
"""
from __future__ import annotations

import numpy as np

from ..eval.lpips import ALEX_CONVS, VGG_BLOCKS


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


def lpips_random_weights(net_type: str, rng: np.random.Generator) -> dict:
    """Random LPIPS weights in the weights-file layout (conv{i}/kernel,
    conv{i}/bias, lin{i}/kernel), drawn from `rng` as
    tests/test_lpips.py's _random_weights (vgg) and _random_alex_weights
    (alex) draw them: per conv its kernel N(0, 1) * 0.05 and its bias
    N(0, 1) * 0.01, then per tap |N(0, 1)| heads."""
    convs = [(cout, 3) for cout, n_convs in VGG_BLOCKS for _ in range(n_convs)] if net_type == "vgg" else \
        [(cout, k) for cout, k, *_ in ALEX_CONVS]
    taps = [cout for cout, _ in VGG_BLOCKS] if net_type == "vgg" else [cout for cout, *_ in ALEX_CONVS]
    state, cin = {}, 3
    for i, (cout, k) in enumerate(convs):
        state[f"conv{i}/kernel"] = rng.normal(size=(cout, cin, k, k)).astype(np.float32) * 0.05
        state[f"conv{i}/bias"] = rng.normal(size=(cout,)).astype(np.float32) * 0.01
        cin = cout
    for i, cout in enumerate(taps):
        state[f"lin{i}/kernel"] = np.abs(rng.normal(size=(1, cout, 1, 1)).astype(np.float32))
    return state
