"""Quaternion / rotation / covariance math (port of c3dgs_tpu/ops/quat.py).

Quaternions are real-first [w, x, y, z]; every function is batched over
leading axes. The rest of the JAX module (rotmat_to_quat, eigh-based
extraction) comes with the compression slice.
"""
from __future__ import annotations

import torch


def normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """L2-normalize along `dim` (torch.nn.functional.normalize semantics)."""
    n = torch.linalg.vector_norm(x, dim=dim, keepdim=True)
    return x / torch.clamp(n, min=eps)


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """Real-first quaternion(s) [..., 4] -> rotation matrices [..., 3, 3].
    Does not normalize (callers normalize first)."""
    w, x, y, z = q.unbind(-1)
    row0 = torch.stack(
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1
    )
    row1 = torch.stack(
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1
    )
    row2 = torch.stack(
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1
    )
    return torch.stack([row0, row1, row2], -2)


def build_scaling_rotation(s: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """L = R @ diag(s): [..., 3] x [..., 4] -> [..., 3, 3]."""
    r = quat_to_rotmat(normalize(q))
    return r * s[..., None, :]


def cov6_from_scaling_rotation(
    scaling: torch.Tensor, rotation: torch.Tensor
) -> torch.Tensor:
    """Upper-triangle covariance (xx, xy, xz, yy, yz, zz) of
    Sigma = R S^2 R^T, written elementwise like the JAX module."""
    q = normalize(rotation)
    w, x, y, z = q.unbind(-1)
    r00 = 1 - 2 * (y * y + z * z)
    r01 = 2 * (x * y - w * z)
    r02 = 2 * (x * z + w * y)
    r10 = 2 * (x * y + w * z)
    r11 = 1 - 2 * (x * x + z * z)
    r12 = 2 * (y * z - w * x)
    r20 = 2 * (x * z - w * y)
    r21 = 2 * (y * z + w * x)
    r22 = 1 - 2 * (x * x + y * y)
    s0 = scaling[..., 0] * scaling[..., 0]
    s1 = scaling[..., 1] * scaling[..., 1]
    s2 = scaling[..., 2] * scaling[..., 2]
    xx = s0 * r00 * r00 + s1 * r01 * r01 + s2 * r02 * r02
    xy = s0 * r00 * r10 + s1 * r01 * r11 + s2 * r02 * r12
    xz = s0 * r00 * r20 + s1 * r01 * r21 + s2 * r02 * r22
    yy = s0 * r10 * r10 + s1 * r11 * r11 + s2 * r12 * r12
    yz = s0 * r10 * r20 + s1 * r11 * r21 + s2 * r12 * r22
    zz = s0 * r20 * r20 + s1 * r21 * r21 + s2 * r22 * r22
    return torch.stack([xx, xy, xz, yy, yz, zz], -1)
