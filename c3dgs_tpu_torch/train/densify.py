"""Adaptive density control under fixed capacity (port of
c3dgs_tpu/train/densify.py).

The reference grows and shrinks tensors and performs Adam-state surgery
(gaussian_model.py:1161-1350). As in the JAX package, this works on a
capacity-padded buffer instead:
- `prune` deactivates rows;
- `clone` / `split` copy selected rows into free (inactive) slots; free and
  selected slots are listed in ascending order (jnp.nonzero(size=cap,
  fill_value=cap)), and writes past the free capacity are dropped and
  counted, so the caller can grow capacity with trainer.grow_capacity;
- the caller zeroes the Adam moments of written slots.
The port writes the rows into the scene's parameters in place.

Selection criteria match densify_and_clone (:1279), densify_and_split
(:1213), densify_and_prune (:1336) and reset_opacity (:1391).

Divergence from the reference (documented in the JAX package too): in
factor-scaling mode the reference's split stores `stds/(0.8N)` as the scale
direction, which the normalize activation cancels; here split shrinks the
scaling_factor by log(0.8*N), the upstream-3DGS behaviour.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import torch

from ..models.gaussians import GaussianScene
from ..ops import misc, quat

ROW_FIELDS = ("xyz", "opacity", "features_dc", "features_rest", "scaling", "rotation", "scaling_factor")


@dataclasses.dataclass
class DensifyStats:
    """Running screen-space gradient statistics
    (gaussian_model.py:95-97,1399-1402)."""

    xyz_gradient_accum: torch.Tensor  # (P,)
    denom: torch.Tensor  # (P,)
    max_radii2d: torch.Tensor  # (P,)

    @classmethod
    def zeros(cls, capacity: int, device=None) -> "DensifyStats":
        z = lambda: torch.zeros(capacity, dtype=torch.float32, device=device)
        return cls(z(), z(), z())


def add_densification_stats(stats: DensifyStats, viewspace_grad: torch.Tensor, radii: torch.Tensor) -> DensifyStats:
    """gaussian_model.py:1399 + the train loop's radii max (train.py:101-106)."""
    update = radii > 0
    gnorm = torch.linalg.vector_norm(viewspace_grad, dim=-1)
    zero = torch.zeros_like(gnorm)
    return DensifyStats(
        xyz_gradient_accum=stats.xyz_gradient_accum + torch.where(update, gnorm, zero),
        denom=stats.denom + update.to(torch.float32),
        max_radii2d=torch.maximum(stats.max_radii2d, torch.where(update, radii.to(torch.float32), zero)),
    )


def _ascending(mask: torch.Tensor):
    """(cap,) int64 indices of the True rows in ascending order, then `cap`
    as fill; and their count."""
    cap = mask.shape[0]
    order = torch.sort((~mask).to(torch.uint8), stable=True).indices
    count = mask.sum()
    rank = torch.arange(cap, device=mask.device)
    return torch.where(rank < count, order, torch.full_like(order, cap)), count


def _free_slots(active: torch.Tensor):
    """Indices of inactive rows, ascending (fill = capacity => invalid), and
    their count."""
    return _ascending(~active)


@torch.no_grad()
def _scatter_rows(scene: GaussianScene, src_idx, dst_idx, write_mask, overrides: Optional[dict] = None):
    """Copy per-splat rows src -> dst where write_mask; dst == capacity
    drops the write. Returns dst (capacity where dropped)."""
    overrides = overrides or {}
    cap = scene.capacity
    dst = torch.where(write_mask, dst_idx, torch.full_like(dst_idx, cap))
    keep = dst < cap
    d = dst[keep]
    for name in ROW_FIELDS:
        arr = getattr(scene, name)
        if arr is None:
            continue
        src_rows = overrides[name] if name in overrides else arr[src_idx]
        arr[d] = src_rows[keep]
    scene.active[d] = True
    return dst


def densify_and_clone(scene: GaussianScene, grads, grad_threshold: float, scene_extent: float, percent_dense: float):
    """gaussian_model.py:1279-1334 under fixed capacity, in place. Returns
    (scene, written (P,) bool, dropped count)."""
    cap = scene.capacity
    with torch.no_grad():
        scaling_max = scene.get_scaling().max(dim=1).values
    selected = (grads >= grad_threshold) & (scaling_max <= percent_dense * scene_extent) & scene.active
    sel_idx, n_sel = _ascending(selected)
    free, n_free = _free_slots(scene.active)
    rank = torch.arange(cap, device=scene.device)
    write = (rank < n_sel) & (rank < n_free)
    dropped = torch.clamp(n_sel - n_free, min=0)
    dst = _scatter_rows(scene, torch.clamp(sel_idx, max=cap - 1), free, write)
    return scene, _written(dst, cap), dropped


def _written(dst: torch.Tensor, cap: int) -> torch.Tensor:
    written = torch.zeros(cap + 1, dtype=torch.bool, device=dst.device)
    written[dst] = True
    return written[:cap]


def densify_and_split(
    scene: GaussianScene,
    grads,
    grad_threshold: float,
    scene_extent: float,
    percent_dense: float,
    generator: torch.Generator,
    n_children: int = 2,
):
    """gaussian_model.py:1213-1277, in place: N=2 children of each selected
    gaussian, shrunk, and the parent deactivated. Returns (scene, written,
    dropped)."""
    samples = [
        torch.randn((scene.capacity, 3), generator=generator, device=generator.device)
        for _ in range(n_children)
    ]
    return split_with_samples(scene, grads, grad_threshold, scene_extent, percent_dense, samples)


def split_with_samples(scene: GaussianScene, grads, grad_threshold, scene_extent, percent_dense,
                       samples: Sequence[torch.Tensor]):
    """densify_and_split given each child's (capacity, 3) standard-normal
    samples (a test feeds JAX's draws here)."""
    n_children = len(samples)
    cap = scene.capacity
    with torch.no_grad():
        scaling = scene.get_scaling()
        rotation = scene.get_rotation()
    selected = (grads >= grad_threshold) & (scaling.max(dim=1).values > percent_dense * scene_extent) & scene.active
    sel_idx, n_sel = _ascending(selected)
    sel_safe = torch.clamp(sel_idx, max=cap - 1)
    free, n_free = _free_slots(scene.active)
    written = torch.zeros(cap, dtype=torch.bool, device=scene.device)
    dropped = torch.clamp(n_sel * n_children - n_free, min=0)
    shrink = math.log(0.8 * n_children)
    rank = torch.arange(cap, device=scene.device)
    for child, z in enumerate(samples):
        with torch.no_grad():
            offsets = z.to(scaling.dtype) * scaling[sel_safe]
            rots = quat.quat_to_rotmat(quat.normalize(rotation[sel_safe]))
            overrides = {"xyz": torch.einsum("nij,nj->ni", rots, offsets) + scene.xyz[sel_safe]}
            if scene.scaling_factor is not None:
                overrides["scaling_factor"] = scene.scaling_factor[sel_safe] - shrink
            else:
                overrides["scaling"] = scene.scaling[sel_safe] - shrink
        dst_slots = torch.where(
            (rank < n_sel) & (child + rank * n_children < n_free),
            free[torch.clamp(rank * n_children + child, max=cap - 1)],
            torch.full_like(free, cap),
        )
        dst = _scatter_rows(scene, sel_safe, dst_slots, dst_slots < cap, overrides)
        written |= _written(dst, cap)
    scene.mask_splats(~selected)  # prune the split parents (:1276-1277)
    return scene, written, dropped


@torch.no_grad()
def prune(scene: GaussianScene, stats: DensifyStats, min_opacity: float, extent: float,
          max_screen_size: Optional[float]) -> GaussianScene:
    """Opacity/size pruning (gaussian_model.py:1344-1349), in place."""
    prune_mask = scene.get_opacity()[:, 0] < min_opacity
    if max_screen_size:
        big_vs = stats.max_radii2d > max_screen_size
        big_ws = scene.get_scaling().max(dim=1).values > 0.1 * extent
        prune_mask = prune_mask | big_vs | big_ws
    return scene.mask_splats(~prune_mask)


def densify_and_prune(
    scene: GaussianScene,
    stats: DensifyStats,
    generator: torch.Generator,
    max_grad: float,
    min_opacity: float,
    extent: float,
    max_screen_size: Optional[float],
    percent_dense: float,
):
    """The full ADC step (gaussian_model.py:1336-1350), in place. Returns
    (scene, written mask for the Adam-moment reset, zeroed stats,
    dropped)."""
    grads = torch.nan_to_num(stats.xyz_gradient_accum / torch.clamp(stats.denom, min=1.0))
    scene, w1, d1 = densify_and_clone(scene, grads, max_grad, extent, percent_dense)
    scene, w2, d2 = densify_and_split(scene, grads, max_grad, extent, percent_dense, generator)
    scene = prune(scene, stats, min_opacity, extent, max_screen_size)
    return scene, w1 | w2, DensifyStats.zeros(scene.capacity, scene.device), d1 + d2


@torch.no_grad()
def reset_opacity(scene: GaussianScene) -> GaussianScene:
    """Clamp opacity to <= 0.01 (gaussian_model.py:1391-1396), in place;
    the caller zeroes the opacity Adam moments."""
    new_op = misc.inverse_sigmoid(torch.clamp(torch.clamp(scene.get_opacity(), max=0.01), 1e-7, 1 - 1e-7))
    scene.opacity.copy_(new_op)
    return scene
