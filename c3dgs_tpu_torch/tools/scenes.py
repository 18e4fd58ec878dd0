"""Seeded inputs shared by the tools, tests/test_torch_gpu.py and
chip_smoke.py: bench.py's point cloud (the saturation and clamp probes'
scenes), a scene that holds the packed kernels against their plain
versions on the card, and random LPIPS weights that hold the card's LPIPS
against the CPU's.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..device import DeviceLike
from ..eval.lpips import ALEX_CONVS, VGG_BLOCKS
from ..models import gaussians as gmod


def bench_arrays(n: int, seed, trained: bool = True):
    """bench.py:34-77's numpy draws, in its order: n points N(0, 2^2) about
    z = 6, uniform colors, and (trained) opacity logits of Beta(0.5, 0.35)
    draws clipped to [0.005, 0.995], else None. `seed` is an int or a
    numpy Generator, which then goes on from where these draws leave it
    (bench_render.py draws its codebook indices next). Returns (points,
    colors, logits)."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(n, 3)).astype(np.float32) * 2.0
    pts[:, 2] += 6.0
    cols = rng.random(size=(n, 3)).astype(np.float32)
    if not trained:
        return pts, cols, None
    op = np.clip(rng.beta(0.5, 0.35, size=(n, 1)), 0.005, 0.995)
    return pts, cols, np.log(op / (1.0 - op)).astype(np.float32)


def bench_recipe_scene(n: int, seed, scale: float, trained: bool = True,
                       device: DeviceLike = None) -> gmod.GaussianScene:
    """bench_arrays (`seed` an int or a Generator) through from_point_cloud
    (no quantization), the kNN scales multiplied by `scale`; the opacities bench_arrays drew, if any
    (else from_point_cloud's)."""
    pts, cols, logits = bench_arrays(n, seed, trained)
    scene = gmod.from_point_cloud(pts, cols, capacity=n, quantization=False, device=device)
    with torch.no_grad():
        scene.scaling_factor += math.log(scale)
        if logits is not None:
            scene.opacity.copy_(torch.as_tensor(logits))
    return scene


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
