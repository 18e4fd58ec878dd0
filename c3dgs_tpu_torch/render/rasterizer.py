"""Rasterizer: the packed forward path (port of c3dgs_tpu/render/rasterizer.py).

  preprocess -> bin_gaussians -> per_gaussian_table
  -> blend_gaussians_packed (stage the sorted fields + K1)
  -> assemble_image (tile-space background composite, soft-clamp mask)

`blend_gaussians_packed` is a torch.autograd.Function whose backward (K2 +
the per-slot grad reduction) arrives with the training slice; until then
it raises. The per-tile kernel family (`packed=False`, K3/K4) is a later
slice too.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import tiles_packed
from .binning import CHUNK, OFFSET_ROW, bin_gaussians, per_gaussian_table
from .preprocess import Preprocessed, preprocess
from .types import TILE_X, TILE_Y, RasterSettings


def _build_fields_packed(
    table: torch.Tensor,
    gid_sorted: torch.Tensor,
    tid_sorted: torch.Tensor,
    sent_sorted: torch.Tensor,
    j_sorted: torch.Tensor,
    tiles_x: int,
    num_tiles: int,
    cap_total: int,
) -> torch.Tensor:
    """(N, NUM_FIELDS) table -> (NUM_FIELDS, cap) staged sorted instance
    fields: means TILE-LOCAL (one local pixel grid serves every lane),
    dead lanes (sentinel / invalid / culled) at opacity 0, row TID_ROW the
    lane's tile id, row OFFSET_ROW the pre-sort slot offset[gid] + j
    (cap_total on dead lanes)."""
    rows = table[gid_sorted.long()]  # (cap, NUM_FIELDS) one row gather
    tid = torch.clamp(tid_sorted, max=num_tiles - 1)
    ox = ((tid % tiles_x) * TILE_X).to(rows.dtype)
    oy = (torch.div(tid, tiles_x, rounding_mode="floor") * TILE_Y).to(rows.dtype)
    dead = sent_sorted | (tid_sorted >= num_tiles)
    presort = torch.where(
        dead,
        torch.full_like(ox, float(cap_total)),
        rows[:, OFFSET_ROW] + j_sorted.to(rows.dtype),
    )
    cols = list(rows.unbind(1))
    cols[0] = cols[0] - ox
    cols[1] = cols[1] - oy
    cols[5] = torch.where(dead, torch.zeros_like(cols[5]), cols[5])
    cols[OFFSET_ROW] = presort
    cols[tiles_packed.TID_ROW] = tid_sorted.to(rows.dtype)
    return torch.stack(cols, 0)


class BlendGaussiansPacked(torch.autograd.Function):
    """Stage the sorted fields and composite them with K1. Returns the
    (T, OUT_ROWS, PIX) tile blocks."""

    @staticmethod
    def forward(ctx, table, gid_sorted, tid_sorted, sent_sorted, j_sorted,
                tile_lo, meta, starts, ends, tiles_x, num_tiles, cap_total):
        fields = _build_fields_packed(
            table, gid_sorted, tid_sorted, sent_sorted, j_sorted, tiles_x,
            num_tiles, cap_total,
        )
        return tiles_packed.forward(fields, tile_lo, meta, starts, ends)

    @staticmethod
    def backward(ctx, grad_out):
        raise NotImplementedError("training slice: K2")


def blend_gaussians_packed(table, gid_sorted, tid_sorted, sent_sorted, j_sorted,
                           tile_lo, meta, starts, ends, tiles_x: int,
                           num_tiles: int, cap_total: int) -> torch.Tensor:
    return BlendGaussiansPacked.apply(
        table, gid_sorted, tid_sorted, sent_sorted, j_sorted, tile_lo, meta,
        starts, ends, tiles_x, num_tiles, cap_total,
    )


def assemble_image(
    out_tiles: torch.Tensor,
    settings: RasterSettings,
    complete: Optional[torch.Tensor] = None,
    bg: Optional[torch.Tensor] = None,
):
    """(T, OUT_ROWS, PIX) tile blocks -> (color (3,H,W), final_T (H,W)).

    `complete` (T,) bool: incomplete tiles (never flushed on an
    exec-clamped frame; their blocks are unwritten memory) become empty
    tiles, i.e. pure background. `bg` (3,): the background composite runs
    in tile-block space before the block -> image transpose."""
    ty, tx = settings.tiles_y, settings.tiles_x
    used = out_tiles[:, :4]

    def to_image(rows):  # (T, k, PIX) -> (k, H, W)
        k = rows.shape[1]
        blocks = rows.reshape(ty, tx, k, TILE_Y, TILE_X)
        full = blocks.permute(2, 0, 3, 1, 4).reshape(k, ty * TILE_Y, tx * TILE_X)
        return full[:, : settings.height, : settings.width]

    if bg is None:
        if complete is not None:
            empty = torch.zeros((4, used.shape[2]), dtype=used.dtype, device=used.device)
            empty[3] = 1.0
            used = torch.where(complete[:, None, None], used, empty[None])
        full = to_image(used)
        return full[:3], full[3]
    composed = used[:, :3] + used[:, 3:4] * bg[:, None]
    ft_rows = used[:, 3:4]
    if complete is not None:
        # masked after compositing: an empty tile composes to exactly bg
        m = complete[:, None, None]
        composed = torch.where(m, composed, bg[:, None].expand_as(composed))
        ft_rows = torch.where(m, ft_rows, torch.ones_like(ft_rows))
    return to_image(composed), to_image(ft_rows)[0]


def render(
    means3d: torch.Tensor,
    cov3d: torch.Tensor,
    opacity: torch.Tensor,
    extrinsic_vector: torch.Tensor,
    settings: RasterSettings,
    bg: torch.Tensor,
    shs: Optional[torch.Tensor] = None,
    colors_precomp: Optional[torch.Tensor] = None,
    viewspace_offset: Optional[torch.Tensor] = None,
) -> dict:
    """Render on the device the inputs live on. means3d (N,3), cov3d (N,6),
    opacity (N,), bg (3,), shs (N,K,3) or colors_precomp (N,3);
    viewspace_offset (N,2) is added to the projected means in NDC*[W/2,H/2]
    units. Returns the image, final_T and the binning counters."""
    if not settings.packed:
        raise NotImplementedError(
            "packed=False renders through the per-tile kernels (K3/K4), which "
            "arrive with the port's per-tile slice"
        )
    prep = preprocess(means3d, cov3d, opacity, extrinsic_vector, settings, shs, colors_precomp)
    if viewspace_offset is not None:
        scale = torch.tensor(
            [0.5 * settings.width, 0.5 * settings.height], dtype=means3d.dtype, device=means3d.device
        )
        prep = prep._replace(mean2d=prep.mean2d + viewspace_offset * scale)

    binning = bin_gaussians(Preprocessed(*(t.detach() for t in prep)), settings)
    table = per_gaussian_table(prep, binning.offset)
    n = means3d.shape[0]
    cap, _ = settings.resolve_caps(n)
    # execution capacity: the sorted content ends at chunks_exec*CHUNK; a
    # probed grad bucket clamps the executed chunks, counted in grad_overflow
    exec_cap = settings.resolve_grad_cap(n)
    nc_exec = exec_cap // CHUNK
    chunks_c = torch.clamp(binning.chunks_exec, max=nc_exec)
    grad_overflow = torch.clamp(binning.chunks_exec - nc_exec, min=0) * CHUNK
    zero = torch.zeros_like(chunks_c)
    meta = torch.stack([chunks_c, zero, zero + settings.num_tiles, zero + cap])
    out_tiles = blend_gaussians_packed(
        table,
        binning.gid_sorted[:exec_cap],
        binning.tid_sorted[:exec_cap],
        binning.sent_sorted[:exec_cap],
        binning.j_sorted[:exec_cap],
        binning.tile_lo[: nc_exec + 1],
        meta,
        binning.starts,
        binning.ends,
        settings.tiles_x,
        settings.num_tiles,
        cap,
    )
    # SOFT clamp: tiles whose sentinel lies past the executed chunks never
    # flushed; they degrade to background instead of unwritten memory
    first_unflushed = binning.tile_lo[chunks_c.long()]
    complete = torch.arange(settings.num_tiles, device=means3d.device) < first_unflushed
    image, final_t = assemble_image(out_tiles, settings, complete, bg)
    return {
        "render": image,
        "final_T": final_t,
        "radii": prep.radius,
        "visibility_filter": prep.radius > 0,
        "num_instances": binning.num_instances,
        "overflow": binning.overflow,
        "grad_total": binning.chunks_exec * CHUNK,
        "grad_overflow": grad_overflow,
        "clipped": binning.clipped,
        "culled": binning.culled,
    }
