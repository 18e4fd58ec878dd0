"""Multi-device rendering and training over a (dp, tiles) mesh (port of
c3dgs_tpu/parallel/sharded.py; each rank runs this code on its own part).

- preprocess: each rank of a tiles row preprocesses an N/D slice of the
  (replicated) Gaussians, and the per-Gaussian outputs are all_gathered;
- binning: ROUTED (render/binning.py::bin_gaussians_routed): enumeration,
  cull and sorts at ~cap/D per rank, instances all_to_all'd to the rank
  that owns their tile;
- blend: K1 in its tile-range mode on the rank's own sorted array of
  owned tiles (K2 on the backward, which reduces by pre-sort slot keys);
- image: rows 0-3 of the tile blocks all_gathered over "tiles";
- gradients: each rank backpropagates its tiles and its preprocess slice,
  the gathers' backward is the reduce-scatter, and one psum over the mesh
  assembles the full gradient.

Entry points run on the scene's device: the card's kernels for CUDA
tensors, their plain versions for CPU tensors.
"""
from __future__ import annotations

import torch

from ..config import OptimizationParams
from ..models.gaussians import GaussianScene
from ..ops import losses as L
from ..render.binning import bin_gaussians_routed, per_gaussian_table, routed_local_cap
from ..render.preprocess import Preprocessed, preprocess
from ..render.rasterizer import assemble_image, blend_gaussians_packed
from ..render.types import RasterSettings
from ..train import trainer
from .mesh import Axis, Mesh


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _sharded_preprocess(means3d, cov3d, opacity, shs, ev, settings: RasterSettings, axis: Axis) -> Preprocessed:
    """Preprocess N/D Gaussians on this rank and all_gather the
    per-Gaussian outputs over `axis`; the gather's backward is the matching
    reduce-scatter. Pad rows (zeros) cull to radius 0 and are sliced off
    after the gather."""
    n = means3d.shape[0]
    k = _round_up(n, axis.size) // axis.size
    rows = slice(axis.index * k, (axis.index + 1) * k)

    def sl(x):
        pad = k * axis.size - n
        if pad:
            x = torch.cat([x, x.new_zeros((pad, *x.shape[1:]))])
        return x[rows]

    prep_l = preprocess(sl(means3d), sl(cov3d), sl(opacity), ev, settings, shs=sl(shs))
    return Preprocessed(*(axis.all_gather(x)[:n] for x in prep_l))


_SSIM_HALO = 5  # 11x11 SAME window radius


def photometric_loss_rows(pred, target, lambda_dssim: float, axis: Axis):
    """Exact tile-sharded photometric loss on full images that every rank
    of `axis` holds: each rank sums its row slab's L1 and SSIM-map terms
    (slab + 5-row halo, so every window of a slab row matches the
    full-image SAME convolution) and a psum over `axis` reassembles the
    full-image mean. The psum's backward is the identity: each rank's
    gradient of this loss is its slab's partial.

    Equal to L.photometric_loss up to f32 partial-sum order."""
    c, h, w = pred.shape
    rows = _round_up(h, axis.size) // axis.size
    span = min(rows + 2 * _SSIM_HALO, h)
    r0 = axis.index * rows
    start = min(max(r0 - _SSIM_HALO, 0), h - span)
    sl_p = pred[:, start : start + span]
    sl_t = target[:, start : start + span]
    grow = start + torch.arange(span, device=pred.device)  # global row of each slab row
    mask = ((grow >= r0) & (grow < min(r0 + rows, h))).to(pred.dtype)[None, :, None]
    l1_sum = torch.sum(L.abs_like_jax(sl_p - sl_t) * mask)
    ssim_map = L.ssim(sl_p, sl_t, size_average=None)  # (1, C, span, W)
    ssim_sum = torch.sum(ssim_map[0] * mask)
    l1_sum, ssim_sum = axis.psum(torch.stack([l1_sum, ssim_sum]))
    total = float(c * h * w)
    return (1.0 - lambda_dssim) * (l1_sum / total) + lambda_dssim * (1.0 - ssim_sum / total)


def _local_blend_tiles(prep: Preprocessed, settings: RasterSettings, axis: Axis):
    """This rank's piece: routed binning, then stage + K1 over ONLY its
    owned tiles (and, on the backward, K2 + the reduction of its local
    sorted array; the caller sums the per-Gaussian partials). Returns the
    local (t_local, OUT_ROWS, PIX) blocks, the routed bookkeeping and the
    local route_dropped counter (instances dropped by a routing-budget
    overflow: nonzero means a tile rendered without them)."""
    rb = bin_gaussians_routed(Preprocessed(*(t.detach() for t in prep)), settings, axis)
    table = per_gaussian_table(prep, rb.offset)
    n = prep.mean2d.shape[0]
    cap, _ = settings.resolve_caps(n)
    t_total = settings.num_tiles
    _, t_local, cap_local = routed_local_cap(cap, axis.size, t_total)
    meta = torch.stack([rb.chunks_exec, *(torch.full_like(rb.chunks_exec, v) for v in (rb.t0, rb.t1, cap))])
    out_l = blend_gaussians_packed(
        table, rb.gid_sorted, rb.tid_sorted, rb.sent_sorted, rb.j_sorted, rb.tile_lo, meta,
        rb.starts, rb.ends, None, rb.emit_cum, settings.tiles_x, t_local, t_total, cap_local, cap,
        settings.fast_grad,
    )
    return out_l, rb, rb.route_dropped


def _gathered_image(out_l, settings: RasterSettings, bg, axis: Axis):
    """all_gather the local tile blocks over `axis` -> the full image.
    Only rows 0-3 (color + final_T) cross ranks: rows 4+ are residuals of
    the local backward. The last rank's padding blocks are sliced off."""
    out_full = axis.all_gather(out_l[:, :4])[: settings.num_tiles]
    image, _ = assemble_image(out_full, settings, None, bg)
    return image


def render_tile_sharded(
    scene: GaussianScene,
    extrinsic_vector,
    settings: RasterSettings,
    bg,
    mesh: Mesh,
    return_diag: bool = False,
):
    """Render with the tile grid sharded over the mesh axis "tiles"
    (replicated over "dp"); every rank returns the full image. With
    `return_diag`, also {"shard_route_dropped": the psum'd counter}
    (nonzero: instances were dropped by a routing-budget overflow under
    extreme tile skew and their tiles rendered without them; raise
    settings.instance_capacity).

    Differentiable as a single-device render is: a loss that every rank
    computes from the image gives every rank the single-device gradient.
    The image's cotangent reaches the gather's reduce-scatter from all D
    ranks of the row, so the image passes 1/D of it back, and the scene's
    tensors sum their per-rank partials over "tiles"."""
    axis = mesh.tiles
    settings = trainer.settings_with_degree(settings, scene.active_sh_degree)
    dev = scene.device
    ev = torch.as_tensor(extrinsic_vector, dtype=torch.float32, device=dev)
    bg = torch.as_tensor(bg, dtype=torch.float32, device=dev)
    means3d, cov3d, opacity, shs = (
        axis.sum_grads(x)
        for x in (scene.get_xyz(), scene.get_covariance(), scene.get_opacity()[:, 0], scene.get_features())
    )
    prep = _sharded_preprocess(means3d, cov3d, opacity, shs, ev, settings, axis)
    out_l, _, trunc = _local_blend_tiles(prep, settings, axis)
    image = _GradScale.apply(_gathered_image(out_l, settings, bg, axis), 1.0 / axis.size)
    if return_diag:
        return image, {"shard_route_dropped": mesh.world.psum(trunc)}
    return image


class _GradScale(torch.autograd.Function):
    """Identity whose backward scales the cotangent."""

    @staticmethod
    def forward(ctx, x, scale: float):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None


def hybrid_loss_and_grads(mesh: Mesh, settings: RasterSettings, opt: OptimizationParams, scene: GaussianScene,
                          evs, gts, bg):
    """The hybrid step's forward and backward: (the dp-mean loss, the
    gradients by parameter field, summed over the mesh and divided by
    n_dp, the psum'd route_dropped). Rank (i, d) renders camera evs[i]
    and differentiates its partial: its preprocess slice and its tiles'
    blend path, with the gathers' backward summing the cross-rank pieces.
    The psum over "tiles" then assembles each camera's gradient exactly
    once, the psum over "dp" sums the cameras, and only the dp mean is
    divided out."""
    n_dp = mesh.dp.size
    dev = scene.device
    ev = torch.as_tensor(evs, dtype=torch.float32, device=dev)[mesh.dp.index]
    gt = torch.as_tensor(gts, dtype=torch.float32, device=dev)[mesh.dp.index]
    bg = torch.as_tensor(bg, dtype=torch.float32, device=dev)
    params = trainer.scene_params(scene)
    st = trainer.settings_with_degree(settings, scene.active_sh_degree)
    prep = _sharded_preprocess(
        scene.get_xyz(), scene.get_covariance(), scene.get_opacity()[:, 0], scene.get_features(), ev, st,
        mesh.tiles,
    )
    out_l, _, trunc = _local_blend_tiles(prep, st, mesh.tiles)
    image = _gathered_image(out_l, st, bg, mesh.tiles)
    loss = photometric_loss_rows(image, gt, opt.lambda_dssim, mesh.tiles)
    g = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    g = [torch.zeros_like(p) if gk is None else gk for p, gk in zip(params.values(), g)]
    # one psum for every field: a flat buffer, split back
    flat = mesh.world.psum(torch.cat([x.reshape(-1) for x in g])) / n_dp
    grads, at = {}, 0
    for (k, p), x in zip(params.items(), g):
        grads[k] = flat[at : at + x.numel()].view_as(p)
        at += x.numel()
    with torch.no_grad():
        loss = mesh.dp.psum(loss.detach()) / n_dp
        trunc = mesh.world.psum(trunc)
    return loss, grads, trunc


def make_hybrid_train_step(
    mesh: Mesh,
    settings: RasterSettings,
    opt: OptimizationParams = OptimizationParams(),
    spatial_lr_scale: float = 1.0,
):
    """A dp x tile-sharded train step: step(state, extrinsics (B, 7), gts
    (B, 3, H, W), bg (3,)) with B == mesh.shape["dp"]. Each dp row trains
    its own camera; the gradients are summed over the whole mesh and every
    rank applies the same Adam update to its replica (trainer.adam_update,
    after update_observers), in place. Returns (state, {"loss",
    "shard_route_dropped"})."""
    schedules = trainer.make_lr_schedules(opt, spatial_lr_scale)

    def step(state: trainer.TrainState, evs, gts, bg):
        scene = state.scene.update_observers()
        loss, grads, trunc = hybrid_loss_and_grads(mesh, settings, opt, scene, evs, gts, bg)
        trainer.adam_update(state.opt_state, trainer.scene_params(scene), grads, schedules)
        state.scene = scene
        state.step += 1
        return state, {"loss": loss, "shard_route_dropped": trunc}

    return step
