"""Quaternion / rotation / covariance math (port of c3dgs_tpu/ops/quat.py).

Quaternions are real-first [w, x, y, z]; every function is batched over
leading axes. extract_rot_scale (covariance VQ's way back to rotation and
scale) uses torch.linalg.eigh, whose eigenvectors may differ from
jnp.linalg.eigh's in sign and, for equal eigenvalues, in order: the
rotation and scale it returns rebuild the same covariance, not the same
quaternion.
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


def rotmat_to_quat(m: torch.Tensor) -> torch.Tensor:
    """Rotation matrices [..., 3, 3] -> real-first quaternions [..., 4]:
    the branch-free PyTorch3D-style conversion of the JAX module (all four
    candidates built, the best-conditioned one taken)."""
    batch = m.shape[:-2]
    m00, m01, m02, m10, m11, m12, m20, m21, m22 = torch.movedim(m.reshape(batch + (9,)), -1, 0)
    q_abs = torch.sqrt(torch.clamp(torch.stack([
        1.0 + m00 + m11 + m22,
        1.0 + m00 - m11 - m22,
        1.0 - m00 + m11 - m22,
        1.0 - m00 - m11 + m22,
    ], -1), min=0.0))
    quat_by_rijk = torch.stack([
        torch.stack([q_abs[..., 0] ** 2, m21 - m12, m02 - m20, m10 - m01], -1),
        torch.stack([m21 - m12, q_abs[..., 1] ** 2, m10 + m01, m02 + m20], -1),
        torch.stack([m02 - m20, m10 + m01, q_abs[..., 2] ** 2, m12 + m21], -1),
        torch.stack([m10 - m01, m20 + m02, m21 + m12, q_abs[..., 3] ** 2], -1),
    ], -2)
    candidates = quat_by_rijk / (2.0 * torch.clamp(q_abs[..., None], min=0.1))
    best = torch.argmax(q_abs, dim=-1)
    return torch.take_along_dim(candidates, best[..., None, None].expand(*best.shape, 1, 4), dim=-2)[..., 0, :]


def build_covariance(scaling: torch.Tensor, rotation: torch.Tensor) -> torch.Tensor:
    """Full 3x3 covariance Sigma = R S^2 R^T from scale + quaternion."""
    length = build_scaling_rotation(scaling, rotation)
    return length @ length.transpose(-1, -2)


def strip_symmetric(cov: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] symmetric -> upper-triangle 6-vec (xx, xy, xz, yy, yz, zz)."""
    return torch.stack(
        [cov[..., 0, 0], cov[..., 0, 1], cov[..., 0, 2], cov[..., 1, 1], cov[..., 1, 2], cov[..., 2, 2]], -1
    )


def to_full_cov(cov6: torch.Tensor) -> torch.Tensor:
    """Upper-triangle 6-vec [..., 6] -> full symmetric [..., 3, 3]."""
    a, b, c, d, e, f = cov6.unbind(-1)
    return torch.stack([torch.stack([a, b, c], -1), torch.stack([b, d, e], -1), torch.stack([c, e, f], -1)], -2)


# cuSOLVER's batched syev (torch.linalg.eigh on CUDA) refuses a batch of
# 32768 or more 3x3 matrices (CUSOLVER_STATUS_INVALID_VALUE, torch 2.11 /
# CUDA 12.8 on an H100); 16384 runs
EIGH_BATCH = 16384


def _eigh(m: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """torch.linalg.eigh over [..., 3, 3], in batches of EIGH_BATCH on CUDA."""
    flat = m.reshape(-1, 3, 3)
    if m.device.type != "cuda" or flat.shape[0] <= EIGH_BATCH:
        return torch.linalg.eigh(m)
    parts = [torch.linalg.eigh(flat[s : s + EIGH_BATCH]) for s in range(0, flat.shape[0], EIGH_BATCH)]
    vals = torch.cat([p[0] for p in parts]).reshape(*m.shape[:-1])
    return vals, torch.cat([p[1] for p in parts]).reshape(m.shape)


def extract_rot_scale(cov: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Eigendecompose covariances [..., 3, 3] -> (quat [..., 4], scale
    [..., 3]): eigh with a 1e-8 diagonal jitter, sqrt eigenvalues (NaN ->
    1e-6), the eigenvector matrix's sign fixed by its determinant so it is
    a proper rotation, then matrix -> quaternion."""
    jitter = torch.eye(3, dtype=cov.dtype, device=cov.device) * 1e-8
    eigval, eigvec = _eigh(cov + jitter)
    scaling = torch.nan_to_num(torch.sqrt(torch.clamp(eigval, min=0.0)), nan=1e-6)
    det = torch.linalg.det(eigvec)
    rot = rotmat_to_quat(eigvec * det[..., None, None])
    return normalize(rot), scaling
