"""Rasterizer (port of c3dgs_tpu/render/rasterizer.py).

  preprocess -> bin_gaussians -> per_gaussian_table
  -> packed=True (the default): blend_gaussians_packed (stage the sorted
     fields + K1; backward: K2 + the per-slot grad reduction through
     binning.perm)
     packed=False: blend_gaussians (stage the sorted fields + K3; backward:
     K4 + the coverage-aware reduction keyed by each row's pre-sort slot)
  -> assemble_image (tile-space background composite, soft-clamp mask)

Gradients reach every input of `render` by autograd: the blend's backward
returns d_table, and autograd carries it through per_gaussian_table,
preprocess and the viewspace offset. A render binned with inference=True
has no binning.perm; its backward reduces the kernel rows by their
pre-sort slot keys instead, in both families, so it takes gradients too.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..spans import span
from . import segment_sum, tiles, tiles_packed
from .binning import (
    CHUNK,
    NUM_FIELDS,
    NUM_USED_FIELDS,
    OFFSET_ROW,
    PRESORT_ROW,
    _rank_in_sorted,
    bin_gaussians,
    per_gaussian_table,
)
from .preprocess import Preprocessed, preprocess
from .types import TILE_X, TILE_Y, RasterSettings


def _build_fields(table: torch.Tensor, gid_sorted: torch.Tensor, j_sorted: torch.Tensor) -> torch.Tensor:
    """(N, NUM_FIELDS) table -> (NUM_FIELDS, cap) staged instance fields in
    sorted order for the per-tile kernels: global means, row PRESORT_ROW
    the pre-sort slot offset[gid] + j (exact in f32 below 2^24). Sentinel
    and invalid slots carry a real gaussian's fields (gid is clamped): the
    kernels mask every lane outside its tile's [start, end)."""
    rows = table[gid_sorted.long()]  # (cap, NUM_FIELDS) one row gather
    cols = list(rows.unbind(1))
    cols[PRESORT_ROW] = cols[OFFSET_ROW] + j_sorted.to(rows.dtype)
    return torch.stack(cols, 0)


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


def _reduce_instance_grads_packed(grads, perm, boundaries, meta, exact: bool = False):
    """(NUM_FIELDS, exec_cap) slot-aligned grads -> (N, NUM_FIELDS) per
    gaussian, each gaussian's emissions (the segments of the emission
    boundaries emit_cum) read through the binning permutation. Entries past
    the emitted total, or whose sorted slot lies past the execution
    capacity, add nothing.

    exact=True sums each segment directly in float64
    (segment_sum.segment_sum: the kernels on the card, which read no slot
    past K1/K2's executed chunks meta[0]*CHUNK).
    Otherwise (fast_grad) the rows are gathered gaussian-major and the sums
    are float32 prefix differences at the boundaries, which err by
    eps * |prefix|.

    The whole permutation is read: it is indexed by emission (payload
    order, culled emissions included), and the emissions can outnumber
    the execution capacity, whose bound is on the KEPT slots. The
    reference slices it to exec_cap entries
    (c3dgs_tpu/render/rasterizer.py:296), which drops every emission past
    that index from the gradient when the bucket is tight (ROADMAP C)."""
    if exact:
        return segment_sum.segment_sum(grads, perm, boundaries, meta)
    live = NUM_USED_FIELDS
    n = boundaries.shape[0]
    rows = grads.shape[1]
    p = perm.long()
    d_pre = grads[:live][:, torch.clamp(p, max=rows - 1)]  # (live, cap)
    idx = torch.arange(p.shape[0], device=grads.device)
    keep = (idx < boundaries[-1]) & (p < rows)
    d_pre = torch.where(keep[None, :], d_pre, torch.zeros_like(d_pre))
    seg = _segment_prefix_diff(d_pre, boundaries, boundaries > 0, False)
    return torch.cat([seg, torch.zeros((n, NUM_FIELDS - live), dtype=seg.dtype, device=seg.device)], 1)


def _reduce_instance_grads(grads, boundaries, cap: int, grad_lo, grad_hi, partial_coverage: bool,
                           compensated: bool = False):
    """(NUM_FIELDS, grad_cap) per-instance grads -> (N, NUM_FIELDS) per
    gaussian, deterministic and free of scatters: one stable sort of the
    int32 pre-sort slot keys (row PRESORT_ROW) brings the rows into
    gaussian-major emission order, one column gather follows, and the
    per-gaussian sums are prefix differences (_segment_prefix_diff,
    compensated in exact mode).

    Rows outside [grad_lo, grad_hi) belong to no window of this call (other
    devices' tiles under tile sharding) and, like the tail lanes the
    kernels tag with `cap`, key to the sentinel `cap`, which sorts last and
    is masked. With `partial_coverage` the segment ends are the ranks of
    the slot-domain boundaries (emit_cum) among the sorted keys, which
    absorbs the cull's compaction and any partial coverage; otherwise
    `boundaries` are already the kept-instance counts."""
    n = boundaries.shape[0]
    grad_cap = grads.shape[1]
    live = NUM_USED_FIELDS
    pos = torch.arange(grad_cap, device=grads.device)
    covered = (pos >= grad_lo) & (pos < grad_hi)
    sentinel = torch.full((grad_cap,), cap, dtype=torch.int32, device=grads.device)
    key = torch.where(covered, grads[PRESORT_ROW].to(torch.int32), sentinel)
    key = torch.where((key >= 0) & (key < cap), key, sentinel)
    key_s, idx_s = torch.sort(key, stable=True)
    # a tile-sharded buffer may be shorter than the slot domain `cap`; a
    # per-tile one is longer, and at most `cap` of its keys are real
    key_c = key_s[:cap]
    d_pre = grads[:live][:, idx_s[:cap]]  # (live, rows) gaussian-major
    d_pre = torch.where((key_c < cap)[None, :], d_pre, torch.zeros_like(d_pre))
    end_pos = _rank_in_sorted(key_c, boundaries - 1) if partial_coverage else boundaries
    seg = _segment_prefix_diff(d_pre, end_pos, end_pos > 0, compensated)
    return torch.cat([seg, torch.zeros((n, NUM_FIELDS - live), dtype=seg.dtype, device=seg.device)], 1)


class BlendGaussians(torch.autograd.Function):
    """Stage the sorted fields and composite them with K3; returns the
    (T, OUT_ROWS, PIX) tile blocks of the tiles `tile_ids`. The backward
    runs K4 on the cotangent of those blocks into a grad_cap-long buffer
    and reduces its rows to d_table over the coverage [grad_lo, grad_hi),
    compensated unless `fast_grad`."""

    @staticmethod
    def forward(ctx, table, gid_sorted, j_sorted, starts, ends, nchunks, grad_base, emit_cum,
                tile_ids, grad_lo, grad_hi, tiles_x, cap, grad_cap, partial_coverage, fast_grad):
        with span("stage"):
            fields = _build_fields(table, gid_sorted, j_sorted)
        with span("blend"):
            out = tiles.forward(fields, tile_ids, starts, ends, nchunks, tiles_x)
        ctx.save_for_backward(fields, tile_ids, starts, ends, nchunks, grad_base, emit_cum, out)
        ctx.grad_range = (grad_lo, grad_hi)
        ctx.statics = (tiles_x, cap, grad_cap, partial_coverage, fast_grad)
        return out

    @staticmethod
    def backward(ctx, grad_out):
        fields, tile_ids, starts, ends, nchunks, grad_base, emit_cum, out = ctx.saved_tensors
        tiles_x, cap, grad_cap, partial_coverage, fast_grad = ctx.statics
        with span("blend_bwd"):
            grads = tiles.backward(fields, tile_ids, starts, ends, nchunks, grad_base, out, grad_out,
                                   tiles_x, grad_cap)
        with span("reduction"):
            d_table = _reduce_instance_grads(grads, emit_cum, cap, *ctx.grad_range, partial_coverage,
                                             compensated=not fast_grad)
        return (d_table,) + (None,) * 15


def blend_gaussians(table, gid_sorted, j_sorted, starts, ends, nchunks, grad_base, emit_cum,
                    tile_ids, grad_range, tiles_x: int, cap: int, grad_cap: int,
                    partial_coverage: bool, fast_grad: bool) -> torch.Tensor:
    """Per-tile stage + alpha-composite: (T, OUT_ROWS, PIX) blocks, rows
    0-2 color without background, 3 final transmittance. tile_ids maps
    the call's tiles to global tiles (identity when unsharded);
    grad_range = (lo, hi) is the coverage of the call's grad writes;
    emit_cum is binning.emit_cum, the slot-domain boundaries the backward's
    reduction ranks (partial_coverage) or takes as they are."""
    return BlendGaussians.apply(
        table, gid_sorted, j_sorted, starts, ends, nchunks, grad_base, emit_cum, tile_ids,
        grad_range[0], grad_range[1], tiles_x, cap, grad_cap, partial_coverage, fast_grad,
    )


class BlendGaussiansPacked(torch.autograd.Function):
    """Stage the sorted fields and composite them with K1; returns the
    (t_out, OUT_ROWS, PIX) tile blocks. The backward runs K2 on the
    cotangent of those blocks and reduces its per-slot rows to d_table:
    through `perm` after a training binning (unless `fast_grad`, float64
    segment sums, the segment_sum kernel on the card), or, with perm None
    (an inference binning, or one device's routed array under tile
    sharding), by the rows' pre-sort slot keys over the executed chunks
    [0, meta[0]*CHUNK), compensated unless `fast_grad`, as the reference
    does (c3dgs_tpu/render/rasterizer.py:365-372)."""

    @staticmethod
    def forward(ctx, table, gid_sorted, tid_sorted, sent_sorted, j_sorted,
                tile_lo, meta, starts, ends, perm, emit_cum, tiles_x, t_out,
                num_tiles, cap, cap_total, fast_grad):
        if starts.shape[0] != t_out or gid_sorted.shape[0] != cap:
            raise ValueError(f"expected {t_out} tile ranges and {cap} slots, got {starts.shape[0]} and "
                             f"{gid_sorted.shape[0]}")
        with span("stage"):
            fields = _build_fields_packed(
                table, gid_sorted, tid_sorted, sent_sorted, j_sorted, tiles_x,
                num_tiles, cap_total,
            )
        with span("blend"):
            out = tiles_packed.forward(fields, tile_lo, meta, starts, ends)
        ctx.save_for_backward(fields, tile_lo, meta, starts, ends, out, perm, emit_cum)
        ctx.statics = (cap_total, fast_grad)
        return out

    @staticmethod
    def backward(ctx, grad_out):
        fields, tile_lo, meta, starts, ends, out, perm, emit_cum = ctx.saved_tensors
        cap_total, fast_grad = ctx.statics
        with span("blend_bwd"):
            grads = tiles_packed.backward(fields, tile_lo, meta, starts, ends, out, grad_out)
        with span("reduction"):
            if perm is None:
                # meta[0] * CHUNK stays a device tensor: no read back to the host
                d_table = _reduce_instance_grads(grads, emit_cum, cap_total, 0, meta[0] * CHUNK, True,
                                                 compensated=not fast_grad)
            else:
                d_table = _reduce_instance_grads_packed(grads, perm, emit_cum, meta, exact=not fast_grad)
        return (d_table,) + (None,) * 16


def blend_gaussians_packed(table, gid_sorted, tid_sorted, sent_sorted, j_sorted,
                           tile_lo, meta, starts, ends, perm, emit_cum,
                           tiles_x: int, t_out: int, num_tiles: int, cap: int,
                           cap_total: int, fast_grad: bool) -> torch.Tensor:
    """Packed stage + alpha-composite: (t_out, OUT_ROWS, PIX) blocks, block
    i for global tile meta[1] + i.

    t_out: the out block count, num_tiles when unsharded, this device's
      tile slice under tile sharding. num_tiles: the GLOBAL tile count (the
      staging's dead-lane domain). cap: the slots of this call's sorted
      array (its execution capacity when unsharded, the routed array's
      cap_local under sharding). cap_total: the global slot domain that
      keys the pre-sort slots. meta = [chunks_exec, tile_start, tile_end,
      cap_total] int32; perm is None under sharding (and for an inference
      binning), where the backward reduces by pre-sort slot keys; emit_cum
      is binning.emit_cum."""
    return BlendGaussiansPacked.apply(
        table, gid_sorted, tid_sorted, sent_sorted, j_sorted, tile_lo, meta,
        starts, ends, perm, emit_cum, tiles_x, t_out, num_tiles, cap, cap_total, fast_grad,
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
    with span("preprocess"):
        prep = preprocess(means3d, cov3d, opacity, extrinsic_vector, settings, shs, colors_precomp)
        if viewspace_offset is not None:
            scale = torch.tensor(
                [0.5 * settings.width, 0.5 * settings.height], dtype=means3d.dtype, device=means3d.device
            )
            prep = prep._replace(mean2d=prep.mean2d + viewspace_offset * scale)

    with span("binning"):
        binning = bin_gaussians(Preprocessed(*(t.detach() for t in prep)), settings)
        table = per_gaussian_table(prep, binning.offset)
        n = means3d.shape[0]
        cap, _ = settings.resolve_caps(n)
        # the grad bucket; packed, the execution capacity: the sorted content
        # ends at chunks_exec*CHUNK, and a probed grad bucket clamps the
        # executed chunks, counted in grad_overflow
        exec_cap = settings.resolve_grad_cap(n)
        if settings.packed:
            nc_exec = exec_cap // CHUNK
            chunks_c = torch.clamp(binning.chunks_exec, max=nc_exec)
            grad_overflow = torch.clamp(binning.chunks_exec - nc_exec, min=0) * CHUNK
            grad_total = binning.chunks_exec * CHUNK
            zero = torch.zeros_like(chunks_c)
            meta = torch.stack([chunks_c, zero, zero + settings.num_tiles, zero + cap])
    if not settings.packed:
        return _render_per_tile(prep, binning, table, settings, bg, cap, exec_cap)
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
        settings.num_tiles,
        exec_cap,
        cap,
        settings.fast_grad,
    )
    with span("blend"):
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
        "grad_total": grad_total,
        "grad_overflow": grad_overflow,
        "clipped": binning.clipped,
        "culled": binning.culled,
    }


def _render_per_tile(prep, binning, table, settings: RasterSettings, bg, cap: int, grad_cap: int) -> dict:
    """The per-tile branch of `render` (K3/K4): full coverage of the tile
    grid, the reducer in partial-coverage mode (exact under full coverage
    too). Every tile is written, so no completeness mask."""
    tile_ids = torch.arange(settings.num_tiles, dtype=torch.int32, device=table.device)
    out_tiles = blend_gaussians(
        table, binning.gid_sorted, binning.j_sorted, binning.starts, binning.ends, binning.nchunks,
        binning.grad_base, binning.emit_cum, tile_ids, (0, binning.grad_total), settings.tiles_x,
        cap, grad_cap, True, settings.fast_grad,
    )
    with span("blend"):
        image, final_t = assemble_image(out_tiles, settings, None, bg)
    return {
        "render": image,
        "final_T": final_t,
        "radii": prep.radius,
        "visibility_filter": prep.radius > 0,
        "num_instances": binning.num_instances,
        "overflow": binning.overflow,
        "grad_total": binning.grad_total,
        "grad_overflow": binning.grad_overflow,
        "clipped": binning.clipped,
        "culled": binning.culled,
    }
