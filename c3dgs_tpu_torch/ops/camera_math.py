"""Camera math (port of c3dgs_tpu/ops/camera_math.py).

`intrinsic` is the fork's 3x3 with the FULL FoV in radians at [0,0]/[1,1]
and W, H at [0,2]/[1,2]; `extrinsic_vector` is the world-to-camera
7-vector (qx, qy, qz, qw, tx, ty, tz). Plain column-vector math:
x_cam = E @ x_w, x_clip = P @ x_cam. znear 0.01, zfar 100.
"""
from __future__ import annotations

import math

import numpy as np
import torch

ZNEAR = 0.01
ZFAR = 100.0


def extrinsic_to_mat(ev: torch.Tensor) -> torch.Tensor:
    """7-vector -> 4x4 world-to-camera matrix (the reference's algebra:
    diagonal terms 1 + 2*(a^2 - |v|^2))."""
    x, y, z, w, tx, ty, tz = ev.unbind(0)
    d2 = x * x + y * y + z * z
    r0 = torch.stack([1.0 + 2.0 * (x * x - d2), 2.0 * (x * y - w * z), 2.0 * (x * z + w * y), tx])
    r1 = torch.stack([2.0 * (x * y + w * z), 1.0 + 2.0 * (y * y - d2), 2.0 * (y * z - w * x), ty])
    r2 = torch.stack([2.0 * (x * z - w * y), 2.0 * (y * z + w * x), 1.0 + 2.0 * (z * z - d2), tz])
    r3 = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=ev.dtype, device=ev.device)
    return torch.stack([r0, r1, r2, r3])


def projection_matrix(fovx: torch.Tensor, fovy: torch.Tensor) -> torch.Tensor:
    """Perspective projection (column-vector), znear .01 / zfar 100."""
    tan_half_x = torch.tan(fovx / 2.0)
    tan_half_y = torch.tan(fovy / 2.0)
    zero = torch.zeros_like(tan_half_x)
    one = torch.ones_like(tan_half_x)
    r0 = torch.stack([1.0 / tan_half_x, zero, zero, zero])
    r1 = torch.stack([zero, 1.0 / tan_half_y, zero, zero])
    r2 = torch.stack(
        [zero, zero, one * ZFAR / (ZFAR - ZNEAR), -one * (ZFAR * ZNEAR) / (ZFAR - ZNEAR)]
    )
    r3 = torch.stack([zero, zero, one, zero])
    return torch.stack([r0, r1, r2, r3])


def camera_center_from_extrinsic(ev: torch.Tensor) -> torch.Tensor:
    """World-space camera position: -R^T t."""
    m = extrinsic_to_mat(ev)
    return -(m[:3, :3].T @ m[:3, 3])


def intrinsic_geometry(intrinsic) -> tuple[int, int, float, float, float, float]:
    """Host-side unpack: (W, H, tanfovx, tanfovy, focal_x, focal_y)."""
    width = int(intrinsic[0, 2])
    height = int(intrinsic[1, 2])
    tanfovx = math.tan(float(intrinsic[0, 0]) * 0.5)
    tanfovy = math.tan(float(intrinsic[1, 1]) * 0.5)
    focal_x = width / (2.0 * tanfovx)
    focal_y = height / (2.0 * tanfovy)
    return width, height, tanfovx, tanfovy, focal_x, focal_y


def ndc_to_pix(v: torch.Tensor, size: int) -> torch.Tensor:
    """NDC [-1,1] -> pixel coordinate (auxiliary.h ndc2Pix)."""
    return ((v + 1.0) * size - 1.0) * 0.5


def mat_to_extrinsic(m, normed: bool = True) -> np.ndarray:
    """4x4 (or 3x4) world-to-camera numpy matrix -> 7-vector of m's dtype
    (the JAX helper's numpy branch): the quaternion of m[:3, :3] in
    float32 through the branch-free rotmat_to_quat, normalized in python
    floats."""
    from .quat import rotmat_to_quat

    m = np.asarray(m)
    q = rotmat_to_quat(torch.as_tensor(np.asarray(m[:3, :3], np.float32)))
    w, x, y, z = (float(q[i]) for i in range(4))
    if normed:
        n = (x * x + y * y + z * z + w * w) ** 0.5
        x, y, z, w = x / n, y / n, z / n, w / n
    return np.stack([np.asarray(v, dtype=m.dtype) for v in (x, y, z, w, m[0, 3], m[1, 3], m[2, 3])])


def fov_to_focal(fov: float, pixels: int) -> float:
    return pixels / (2.0 * math.tan(fov / 2.0))


def focal_to_fov(focal: float, pixels: int) -> float:
    return 2.0 * math.atan(pixels / (2.0 * focal))
