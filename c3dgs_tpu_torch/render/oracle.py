"""Reference renderer: per-pixel alpha compositing over the whole image, one
gaussian at a time (port of c3dgs_tpu/render/oracle.py).

Slow and plain — the oracle the packed path is held against. Semantics of
forward.cu renderCUDA (:270-383): tile-rect confinement, alpha =
min(0.99, op*exp(min(power, 0))) skipped below 1/255, contributions while
T*(1-alpha) >= 1e-4, front to back in the binning's order (quantized
depth, then float depth, then gaussian index). Like the kernels it keeps
multiplying T after a pixel saturates and clamps power to 0 instead of
skipping power > 0.
"""
from __future__ import annotations

from typing import Optional

import torch

from .binning import depth_bits, quantize_depth
from .preprocess import Preprocessed, preprocess
from .tiles import MAX_ALPHA, MIN_ALPHA, STOP_T
from .types import TILE_X, TILE_Y, RasterSettings


def blend_oracle(prep: Preprocessed, settings: RasterSettings):
    """Returns (color (3,H,W) without background, final_T (H,W))."""
    h, w = settings.height, settings.width
    dev = prep.depth.device
    depth_q = quantize_depth(prep.depth, prep.radius > 0, settings.num_tiles)
    by_depth = torch.argsort(depth_bits(prep.depth), stable=True)
    key = torch.where(prep.radius > 0, depth_q, torch.full_like(depth_q, 0xFFFFFFFF))[by_depth]
    order = by_depth[torch.argsort(key, stable=True)].tolist()

    px = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
    py = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    tile_px = (torch.arange(w, device=dev) // TILE_X)[None, :]
    tile_py = (torch.arange(h, device=dev) // TILE_Y)[:, None]

    color = torch.zeros((3, h, w), dtype=torch.float32, device=dev)
    t_acc = torch.ones((h, w), dtype=torch.float32, device=dev)
    for idx in order:
        xy = prep.mean2d[idx]
        con = prep.conic[idx]
        dx = xy[0] - px
        dy = xy[1] - py
        power = -0.5 * (con[0] * dx * dx + con[2] * dy * dy) - con[1] * dx * dy
        power = torch.clamp(power, max=0.0)
        alpha = torch.clamp(prep.opacity[idx] * torch.exp(power), max=MAX_ALPHA)
        in_rect = (
            (tile_px >= prep.rect_min[idx, 0])
            & (tile_px < prep.rect_max[idx, 0])
            & (tile_py >= prep.rect_min[idx, 1])
            & (tile_py < prep.rect_max[idx, 1])
        )
        mask = (alpha >= MIN_ALPHA) & in_rect & (prep.radius[idx] > 0)
        alpha = torch.where(mask, alpha, torch.zeros_like(alpha))
        test_t = t_acc * (1.0 - alpha)
        contrib = torch.where(test_t >= STOP_T, alpha * t_acc, torch.zeros_like(alpha))
        color = color + prep.color[idx][:, None, None] * contrib[None]
        t_acc = test_t
    return color, t_acc


def render_oracle(
    means3d: torch.Tensor,
    cov3d: torch.Tensor,
    opacity: torch.Tensor,
    extrinsic_vector: torch.Tensor,
    settings: RasterSettings,
    bg: torch.Tensor,
    shs: Optional[torch.Tensor] = None,
    colors_precomp: Optional[torch.Tensor] = None,
) -> dict:
    """End-to-end oracle render (preprocess + blend + background)."""
    prep = preprocess(means3d, cov3d, opacity, extrinsic_vector, settings, shs, colors_precomp)
    color, final_t = blend_oracle(prep, settings)
    image = color + final_t[None] * bg[:, None, None]
    return {"render": image, "final_T": final_t, "radii": prep.radius}
