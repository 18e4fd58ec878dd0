"""Per-Gaussian preprocessing: cull, project, EWA 2D covariance, conic,
radius, tile rect, SH color (port of c3dgs_tpu/render/preprocess.py, the
vectorized form of the reference's preprocessCUDA, forward.cu:164-265).

Plain tensor code over all N Gaussians; culling is masking (radius 0).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..ops import camera_math, sh
from .types import TILE_X, TILE_Y, RasterSettings


class Preprocessed(NamedTuple):
    """Per-Gaussian screen-space quantities (all length N)."""

    mean2d: torch.Tensor  # (N, 2) pixel coords
    depth: torch.Tensor  # (N,) view-space z
    conic: torch.Tensor  # (N, 3) inverse 2D covariance (a, b, c)
    color: torch.Tensor  # (N, 3) RGB
    opacity: torch.Tensor  # (N,)
    radius: torch.Tensor  # (N,) int32 pixel radius, 0 = culled
    tiles_touched: torch.Tensor  # (N,) int32
    rect_min: torch.Tensor  # (N, 2) int32 tile coords (x, y)
    rect_max: torch.Tensor  # (N, 2) int32 tile coords, exclusive


def compute_cov2d(
    mean3d: torch.Tensor,
    cov3d: torch.Tensor,
    viewmatrix: torch.Tensor,
    settings: RasterSettings,
) -> torch.Tensor:
    """EWA projection of the 3D covariance (forward.cu:82-121): (N,3) =
    (cov_xx, cov_xy, cov_yy) with the +0.3 px low-pass."""
    r = viewmatrix[:3, :3]
    t3 = mean3d @ r.T + viewmatrix[:3, 3]
    limx = 1.3 * settings.tanfovx
    limy = 1.3 * settings.tanfovy
    # keep tz away from 0: rows at the camera plane are culled later, but a
    # 0/0 here would poison every padded row's gradient with NaN
    tz = t3[:, 2]
    tz = torch.where(torch.abs(tz) < 1e-6, torch.full_like(tz, 1e-6), tz)
    txtz = torch.clamp(t3[:, 0] / tz, -limx, limx) * tz
    tytz = torch.clamp(t3[:, 1] / tz, -limy, limy) * tz

    fx, fy = settings.focal_x, settings.focal_y
    zero = torch.zeros_like(tz)
    j00 = fx / tz
    j02 = -(fx * txtz) / (tz * tz)
    j11 = fy / tz
    j12 = -(fy * tytz) / (tz * tz)
    t0 = torch.stack([j00, zero, j02], -1) @ r  # (N,3)
    t1 = torch.stack([zero, j11, j12], -1) @ r

    c_xx, c_xy, c_xz, c_yy, c_yz, c_zz = cov3d.unbind(1)

    def quad(u, v):
        return (
            u[:, 0] * (c_xx * v[:, 0] + c_xy * v[:, 1] + c_xz * v[:, 2])
            + u[:, 1] * (c_xy * v[:, 0] + c_yy * v[:, 1] + c_yz * v[:, 2])
            + u[:, 2] * (c_xz * v[:, 0] + c_yz * v[:, 1] + c_zz * v[:, 2])
        )

    cov00 = quad(t0, t0) + 0.3
    cov01 = quad(t0, t1)
    cov11 = quad(t1, t1) + 0.3
    return torch.stack([cov00, cov01, cov11], -1)


def preprocess(
    means3d: torch.Tensor,
    cov3d: torch.Tensor,
    opacity: torch.Tensor,
    extrinsic_vector: torch.Tensor,
    settings: RasterSettings,
    shs: Optional[torch.Tensor] = None,
    colors_precomp: Optional[torch.Tensor] = None,
) -> Preprocessed:
    """Full per-Gaussian preprocess. means3d (N,3), cov3d (N,6), opacity
    (N,), shs (N,K,3) or colors_precomp (N,3). Culled Gaussians get radius
    0 and 0 tiles."""
    dev = means3d.device
    view = camera_math.extrinsic_to_mat(extrinsic_vector)
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)
    proj = camera_math.projection_matrix(
        2.0 * torch.atan(f32(settings.tanfovx)),
        2.0 * torch.atan(f32(settings.tanfovy)),
    )
    full = proj @ view
    cam_pos = camera_math.camera_center_from_extrinsic(extrinsic_vector)

    ones = torch.ones((means3d.shape[0], 1), dtype=means3d.dtype, device=dev)
    hom = torch.cat([means3d, ones], -1) @ full.T  # (N,4)
    p_w = 1.0 / (hom[:, 3] + 1e-7)
    p_proj = hom[:, :3] * p_w[:, None]
    p_view_z = means3d @ view[2, :3] + view[2, 3]

    in_front = p_view_z > 0.01  # in_frustum near cull (auxiliary.h:156)

    cov2d = compute_cov2d(means3d, cov3d, view, settings)
    det = cov2d[:, 0] * cov2d[:, 2] - cov2d[:, 1] * cov2d[:, 1]
    det_ok = det != 0.0
    det_inv = 1.0 / torch.where(det_ok, det, torch.ones_like(det))
    conic = torch.stack(
        [cov2d[:, 2] * det_inv, -cov2d[:, 1] * det_inv, cov2d[:, 0] * det_inv], -1
    )

    mid = 0.5 * (cov2d[:, 0] + cov2d[:, 2])
    disc = torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    lambda1 = mid + disc
    radius_f = torch.ceil(3.0 * torch.sqrt(torch.maximum(lambda1, mid - disc)))

    mean2d = torch.stack(
        [
            camera_math.ndc_to_pix(p_proj[:, 0], settings.width),
            camera_math.ndc_to_pix(p_proj[:, 1], settings.height),
        ],
        -1,
    )

    # tile rect: the 3-sigma circle of the reference where opacity makes it
    # binding, else the exact bbox of the alpha >= 1/255 support — output
    # identical, far fewer instances for translucent splats
    c_op = torch.sqrt(2.0 * torch.log(torch.clamp(255.0 * opacity, min=1.0 + 1e-6)))
    invisible = opacity * 255.0 <= 1.0
    tight = c_op < 3.0
    half_x = torch.where(
        tight, torch.ceil(c_op * torch.sqrt(torch.clamp(cov2d[:, 0], min=0.0))), radius_f
    )
    half_y = torch.where(
        tight, torch.ceil(c_op * torch.sqrt(torch.clamp(cov2d[:, 2], min=0.0))), radius_f
    )

    tx, ty = settings.tiles_x, settings.tiles_y
    # float -> int32 truncates toward zero and saturates, as XLA's convert
    # does (the bound only has to exceed the tile grid: the clip follows)
    to_i = lambda v: torch.clamp(v, -2e9, 2e9).to(torch.int32)
    rect_min = torch.stack(
        [
            torch.clamp(to_i((mean2d[:, 0] - half_x) / TILE_X), 0, tx),
            torch.clamp(to_i((mean2d[:, 1] - half_y) / TILE_Y), 0, ty),
        ],
        -1,
    )
    rect_max = torch.stack(
        [
            torch.clamp(to_i((mean2d[:, 0] + half_x + TILE_X - 1) / TILE_X), 0, tx),
            torch.clamp(to_i((mean2d[:, 1] + half_y + TILE_Y - 1) / TILE_Y), 0, ty),
        ],
        -1,
    )
    rect_w = rect_max[:, 0] - rect_min[:, 0]
    rect_h = rect_max[:, 1] - rect_min[:, 1]
    tiles = rect_w * rect_h

    alive = in_front & det_ok & (tiles > 0) & ~invisible

    if colors_precomp is not None:
        color = colors_precomp
    else:
        dirs = means3d - cam_pos
        # rsqrt(sumsq + eps) instead of /norm: a splat exactly at the camera
        # position must not emit NaN
        dirs = dirs * torch.rsqrt(torch.sum(dirs * dirs, dim=-1, keepdim=True) + 1e-20)
        color = sh.sh_to_rgb(settings.sh_degree, shs, dirs, clamp_color=settings.clamp_color)

    radius = torch.where(alive, radius_f, torch.zeros_like(radius_f)).to(torch.int32)
    tiles_touched = torch.where(alive, tiles, torch.zeros_like(tiles)).to(torch.int32)

    return Preprocessed(
        mean2d=mean2d,
        depth=p_view_z,
        conic=conic,
        color=color,
        opacity=opacity,
        radius=radius,
        tiles_touched=tiles_touched,
        rect_min=rect_min,
        rect_max=rect_max,
    )
