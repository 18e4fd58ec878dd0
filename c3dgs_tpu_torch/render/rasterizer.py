"""Rasterizer: the packed path (port of c3dgs_tpu/render/rasterizer.py).

  preprocess -> bin_gaussians -> per_gaussian_table
  -> blend_gaussians_packed (stage the sorted fields + K1; backward: K2 +
     the per-slot grad reduction through binning.perm)
  -> assemble_image (tile-space background composite, soft-clamp mask)

Gradients reach every input of `render` by autograd: the blend's backward
returns d_table, and autograd carries it through per_gaussian_table,
preprocess and the viewspace offset. The per-tile kernel family
(`packed=False`, K3/K4) is a later slice.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import tiles_packed
from .binning import CHUNK, NUM_FIELDS, NUM_USED_FIELDS, OFFSET_ROW, bin_gaussians, per_gaussian_table
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


def _segment_prefix_diff(d_pre, end_idx, valid, compensated: bool):
    """Per-segment sums by prefix differences at end_idx.

    d_pre: (live, rows) values, segment-contiguous along rows; end_idx:
    (n,) inclusive-end row count per segment (nondecreasing); valid: (n,)
    bool (False -> zero segment). Returns (n, live). A segment of exact
    zeros sums to exactly 0. The prefix runs along the contiguous last
    dimension: torch scans an outer dimension of a few columns with one
    thread per column (the whole reduction then took 176 ms at the 1080p
    bench frame on an H100); the inner-dimension scan is deterministic.

    compensated=True adds a second prefix over the per-step rounding
    residues r_i = d_pre_i - (cs_i - cs_{i-1}) (exact in f32, Fast2Sum):
    the raw difference errs by O(eps * |prefix|) absolute, which reaches
    ~0.3 on the moment columns of a 1080p frame, and the residue prefix
    recovers the lost mass to second order."""
    live, rows = d_pre.shape
    cs = torch.cumsum(d_pre, 1)
    if compensated:
        prev_cs = torch.cat([torch.zeros_like(cs[:, :1]), cs[:, :-1]], 1)
        r = d_pre - (cs - prev_cs)
        cs = torch.cat([cs, torch.cumsum(r, 1)], 0)
    cs_end = torch.where(
        valid[None, :], cs[:, torch.clamp(end_idx.long() - 1, 0, rows - 1)], torch.zeros_like(cs[:, :1])
    )
    prev = torch.cat([torch.zeros_like(cs_end[:, :1]), cs_end[:, :-1]], 1)
    seg = cs_end - prev
    if compensated:
        seg = seg[:live] + seg[live:]
    return seg.T


def _reduce_instance_grads_packed(grads, perm, boundaries, compensated: bool = False):
    """(NUM_FIELDS, exec_cap) slot-aligned grads -> (N, NUM_FIELDS) per
    gaussian: rows reordered gaussian-major by the binning permutation,
    then per-gaussian sums as prefix differences at the emission
    boundaries (emit_cum). Rows past the emitted total, or perm entries
    past the execution capacity, are masked before the prefix."""
    live = NUM_USED_FIELDS
    n = boundaries.shape[0]
    rows = grads.shape[1]
    p = perm[:rows].long()
    d_pre = grads[:live][:, torch.clamp(p, max=rows - 1)]  # (live, rows)
    idx = torch.arange(rows, device=grads.device)
    keep = (idx < boundaries[-1]) & (p < rows)
    d_pre = torch.where(keep[None, :], d_pre, torch.zeros_like(d_pre))
    seg = _segment_prefix_diff(d_pre, boundaries, boundaries > 0, compensated)
    return torch.cat([seg, torch.zeros((n, NUM_FIELDS - live), dtype=seg.dtype, device=seg.device)], 1)


class BlendGaussiansPacked(torch.autograd.Function):
    """Stage the sorted fields and composite them with K1; returns the
    (T, OUT_ROWS, PIX) tile blocks. The backward runs K2 on the cotangent
    of those blocks and reduces its per-slot rows to d_table, compensated
    unless `fast_grad`. It needs `perm` (training binning): a render binned
    with inference=True raises there."""

    @staticmethod
    def forward(ctx, table, gid_sorted, tid_sorted, sent_sorted, j_sorted,
                tile_lo, meta, starts, ends, perm, emit_cum, tiles_x,
                num_tiles, cap_total, fast_grad):
        fields = _build_fields_packed(
            table, gid_sorted, tid_sorted, sent_sorted, j_sorted, tiles_x,
            num_tiles, cap_total,
        )
        out = tiles_packed.forward(fields, tile_lo, meta, starts, ends)
        ctx.save_for_backward(fields, tile_lo, meta, starts, ends, out, perm, emit_cum)
        ctx.fast_grad = fast_grad
        return out

    @staticmethod
    def backward(ctx, grad_out):
        fields, tile_lo, meta, starts, ends, out, perm, emit_cum = ctx.saved_tensors
        if perm is None:
            raise RuntimeError(
                "this render was binned with inference=True, which skips the "
                "gaussian-major permutation the backward reduces through; "
                "render with inference=False to take gradients"
            )
        grads = tiles_packed.backward(fields, tile_lo, meta, starts, ends, out, grad_out)
        d_table = _reduce_instance_grads_packed(grads, perm, emit_cum, compensated=not ctx.fast_grad)
        return (d_table,) + (None,) * 14


def blend_gaussians_packed(table, gid_sorted, tid_sorted, sent_sorted, j_sorted,
                           tile_lo, meta, starts, ends, perm, emit_cum,
                           tiles_x: int, num_tiles: int, cap_total: int,
                           fast_grad: bool) -> torch.Tensor:
    return BlendGaussiansPacked.apply(
        table, gid_sorted, tid_sorted, sent_sorted, j_sorted, tile_lo, meta,
        starts, ends, perm, emit_cum, tiles_x, num_tiles, cap_total, fast_grad,
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
        binning.perm,
        binning.emit_cum,
        settings.tiles_x,
        settings.num_tiles,
        cap,
        settings.fast_grad,
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
