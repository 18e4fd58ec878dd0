"""Spherical-harmonics color evaluation, degrees 0..3 (port of
c3dgs_tpu/ops/sh.py). Layout [..., K, 3] with K = (deg+1)^2, DC first.
sh_to_rgb_indexed_blocked evaluates a codebook-indexed scene's colors
block by block, without a dense (P, K, 3) SH array."""
from __future__ import annotations

import torch

from .segment import gather_rows

C0 = 0.28209479177387814
C1 = 0.4886025119029199
C2 = (
    1.0925484305920792,
    -1.0925484305920792,
    0.31539156525252005,
    -1.0925484305920792,
    0.5462742152960396,
)
C3 = (
    -0.5900435899266435,
    2.890611442640554,
    -0.4570457994644658,
    0.3731763325901154,
    -0.4570457994644658,
    1.445305721320277,
    -0.5900435899266435,
)

MAX_DEGREE = 3


def num_coeffs(degree: int) -> int:
    return (degree + 1) ** 2


def eval_sh(deg: int, sh: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """Evaluate SH at unit directions. sh: [..., K, 3], dirs: [..., 3].
    Only the first (deg+1)^2 coefficients are read."""
    if not 0 <= deg <= MAX_DEGREE:
        raise ValueError(f"SH degree must be in 0..{MAX_DEGREE}, got {deg}")
    result = C0 * sh[..., 0, :]
    if deg > 0:
        x = dirs[..., 0:1]
        y = dirs[..., 1:2]
        z = dirs[..., 2:3]
        result = (
            result
            - C1 * y * sh[..., 1, :]
            + C1 * z * sh[..., 2, :]
            - C1 * x * sh[..., 3, :]
        )
        if deg > 1:
            xx, yy, zz = x * x, y * y, z * z
            xy, yz, xz = x * y, y * z, x * z
            result = (
                result
                + C2[0] * xy * sh[..., 4, :]
                + C2[1] * yz * sh[..., 5, :]
                + C2[2] * (2.0 * zz - xx - yy) * sh[..., 6, :]
                + C2[3] * xz * sh[..., 7, :]
                + C2[4] * (xx - yy) * sh[..., 8, :]
            )
            if deg > 2:
                result = (
                    result
                    + C3[0] * y * (3.0 * xx - yy) * sh[..., 9, :]
                    + C3[1] * xy * z * sh[..., 10, :]
                    + C3[2] * y * (4.0 * zz - xx - yy) * sh[..., 11, :]
                    + C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy) * sh[..., 12, :]
                    + C3[4] * x * (4.0 * zz - xx - yy) * sh[..., 13, :]
                    + C3[5] * z * (xx - yy) * sh[..., 14, :]
                    + C3[6] * x * (xx - 3.0 * yy) * sh[..., 15, :]
                )
    return result


def sh_to_rgb(
    deg: int, sh: torch.Tensor, dirs: torch.Tensor, clamp_color: bool = True
) -> torch.Tensor:
    """SH -> RGB as the rasterizer does: eval + 0.5, optional clamp at 0."""
    rgb = eval_sh(deg, sh, dirs) + 0.5
    if clamp_color:
        rgb = torch.clamp(rgb, min=0.0)
    return rgb


def sh_to_rgb_indexed_blocked(
    deg: int,
    codebook: torch.Tensor,
    indices: torch.Tensor,
    dirs: torch.Tensor,
    clamp_color: bool = True,
    block: int = 1 << 18,
) -> torch.Tensor:
    """Per-splat RGB of a codebook-indexed scene: each block of `block`
    splats gathers its (block, K, 3) codebook rows, evaluates them and
    keeps only the (block, 3) colors, so a render without gradients never
    holds more than one block's SH. codebook (C, K, 3), indices (P,) int64,
    dirs (P, 3) unit."""
    p = indices.shape[0]
    out = [
        sh_to_rgb(deg, gather_rows(codebook, indices[s : s + block]), dirs[s : s + block], clamp_color)
        for s in range(0, max(p, 1), block)
    ]
    return out[0] if len(out) == 1 else torch.cat(out)


def rgb_to_sh_dc(rgb):
    """RGB in [0,1] -> DC SH coefficient (tensor or numpy array)."""
    return (rgb - 0.5) / C0


def sh_dc_to_rgb(dc):
    """DC SH coefficient -> RGB (tensor or numpy array)."""
    return dc * C0 + 0.5
