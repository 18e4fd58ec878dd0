"""Initial cloud thickening: interpolate new splats along rays to each
point's k nearest neighbours (port of c3dgs_tpu/train/densify_initial.py).

Parity: GaussianModel.densify_initial (gaussian_model.py:1352-1389), the
fork's sparse-cloud bootstrap for the camera trainers (train_camera.py:26):
for every point, find its 3 nearest neighbours; for neighbour rays longer
than the average inter-point step, insert clones at integer multiples of
that step along the ray.

The neighbour search is the chunked exact kNN on the scene's device (one
(chunk, N) distance block at a time, in elementwise operations rounded as
JAX's CPU dot rounds: a TF32 product, or a matmul that rounds differently
on the card and the CPU, flips neighbours, and then insertion counts);
the slotting rule runs on the host in numpy, as in the JAX package, and
the clones are written into the first free slots.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..models.gaussians import GaussianScene


def _smallest_k(d: torch.Tensor, k: int) -> torch.Tensor:
    """Column indices of each row's k smallest entries, ordered by (value,
    index): lax.top_k's order, which puts the lower index first among
    equal values. torch.topk promises no order among ties, so only rows
    with a tie at the k-th value are sorted in full."""
    vals, idx = torch.topk(d, k, dim=1, largest=False, sorted=True)
    tied = (d <= vals[:, -1:]).sum(1) > k
    if bool(tied.any()):
        rows = torch.nonzero(tied)[:, 0]
        idx[rows] = torch.sort(d[rows], dim=1, stable=True).indices[:, :k]
    idx = torch.sort(idx, dim=1).values  # by index, then stably by value
    order = torch.sort(torch.gather(d, 1, idx), dim=1, stable=True).indices
    return torch.gather(idx, 1, order)


def _fma_dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """fma(a_2, b_2, fma(a_1, b_1, a_0 b_0)) over broadcast (.., 3) float32
    operands, as XLA's CPU dot rounds it, with each fused multiply-add
    carried out in float64 and rounded once to float32. Elementwise IEEE
    operations give the same bits on the card and on the CPU, where a
    matmul's blocking and FMAs differ between cuBLAS and the CPU's BLAS
    (and cuBLAS may run it in TF32)."""
    a, b = a.double(), b.double()
    out = (a[..., 0] * b[..., 0]).float()
    out = (a[..., 1] * b[..., 1] + out.double()).float()
    return (a[..., 2] * b[..., 2] + out.double()).float()


def _knn_indices(xyz: np.ndarray, k: int, chunk: int = 1024, device: DeviceLike = None) -> np.ndarray:
    """Exact k-NN indices (excluding self) via chunked pairwise distances
    (sq_i + sq_j) - 2 x_i.x_j, the diagonal set to +inf, rounded as the JAX
    package's are, so that the card, the CPU and JAX pick the same
    neighbours even where two distances differ in the last bits. Runs on
    `device` (CUDA unless the caller names another)."""
    dev = resolve_device(device)
    n = xyz.shape[0]
    x = torch.as_tensor(np.asarray(xyz, np.float32), device=dev)
    sq = x[:, 0] * x[:, 0] + x[:, 1] * x[:, 1] + x[:, 2] * x[:, 2]
    out = np.empty((n, k), np.int64)
    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        d = sq[s:e, None] + sq[None, :]
        d -= 2.0 * _fma_dot3(x[s:e, None, :], x[None, :, :])
        rows = torch.arange(e - s, device=dev)
        d[rows, rows + s] = float("inf")
        out[s:e] = _smallest_k(d, k).cpu().numpy()
    return out


@torch.no_grad()
def densify_initial(scene: GaussianScene, dist_thr_coeff: float = 1.0, k: int = 3) -> GaussianScene:
    """Insert interpolated clones along rays to the k nearest neighbours.

    Follows the reference's slotting rule (gaussian_model.py:1374-1387):
    for each neighbour at relative distance d (in average-step units), for
    every integer step `dist` with d >= dist+1, clone the point at fraction
    dist/d along the ray; a step with one such point or none adds nothing.
    Capacity grows to the next power of two when the free rows do not
    suffice. Returns a new scene (the caller's keeps its rows), or the
    caller's scene itself when nothing is added. Runs on the scene's
    device."""
    if scene.is_color_indexed or scene.is_gaussian_indexed:
        raise ValueError("densify_initial expects a dense scene")
    active = scene.active.cpu().numpy()
    xyz_all = scene.xyz.detach().cpu().numpy()
    xyz = xyz_all[active]
    n = xyz.shape[0]
    if n < k + 1:
        return scene
    volume = float(np.prod(xyz.max(0) - xyz.min(0))) / n
    average_step = dist_thr_coeff * volume ** (1.0 / 3)
    if average_step <= 0:
        return scene

    nbrs = _knn_indices(xyz, k, device=scene.device)
    active_idx = np.nonzero(active)[0]

    src_list, new_xyz_list = [], []
    for nb in range(k):
        delta = xyz[nbrs[:, nb]] - xyz
        rel = np.sqrt((delta**2).sum(1)) / average_step
        max_rel = rel.max()
        for dist in range(1, int(max_rel)):
            slot = rel >= dist + 1
            if slot.sum() > 1:
                alpha = (dist / rel[slot])[:, None]
                src = active_idx[slot]
                tgt = active_idx[nbrs[slot, nb]]
                src_list.append(src)
                new_xyz_list.append(xyz_all[src] * (1 - alpha) + xyz_all[tgt] * alpha)

    if not src_list:
        print("Densification completed (nothing to add)")
        return scene

    src = np.concatenate(src_list)
    new_xyz = np.concatenate(new_xyz_list).astype(np.float32)
    n_new = len(src)

    free = int((~active).sum())
    if free < n_new:
        scene = scene.pad_to_capacity(1 << int(np.ceil(np.log2(scene.capacity + n_new - free))))
    else:
        scene = scene.clone()

    dev = scene.device
    dst = torch.as_tensor(np.nonzero(~scene.active.cpu().numpy())[0][:n_new], device=dev)
    src_t = torch.as_tensor(src, device=dev)
    for name in ("opacity", "features_dc", "features_rest", "scaling", "rotation", "scaling_factor"):
        arr = getattr(scene, name)
        if arr is not None:
            arr[dst] = arr[src_t]
    scene.xyz[dst] = torch.as_tensor(new_xyz, device=dev)
    scene.active[dst] = True
    print(f"Densification completed (+{n_new} splats)")
    return scene
