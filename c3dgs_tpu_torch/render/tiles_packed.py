"""Packed compositing kernels: the K1 forward and K2 backward wrappers and
their plain versions (port of c3dgs_tpu/render/tiles_packed.py).

`forward` / `backward` launch the hand-written Hopper kernels
(csrc/tiles_packed_fwd.cu, csrc/tiles_packed_bwd.cu) for CUDA tensors and
`forward_plain` / `backward_plain` for CPU tensors; there is no fallback
from one to the other. Both families take the staged sorted fields of
rasterizer._build_fields_packed plus the binning's tile_lo / meta /
starts / ends.

meta = [chunks_exec, tile_start, tile_end, cap] int32 stays on the
device: the kernels read it there. A single-device render passes the
tile range [0, T); under tile sharding (parallel/sharded.py) the fields
are one device's routed array, starts/ends hold its owned tiles' slot
ranges, and block i is global tile tile_start + i (t_out = len(starts)
blocks; those at or past tile_end, the last device's padding tiles, are
left unwritten by the kernels and zero in the plain versions). tile_lo
is numbered globally.

The forward returns (t_out, OUT_ROWS, PIX) blocks: rows 0-2 color without
background, 3 exp(lt_final), 4 lt_final, 5 the freeze start slot (meta[3]
if never frozen), 6-7 zero. The backward takes those blocks and the
cotangent blocks (rows 0-2 dL/dC, 3 dL/dT_final) and returns (NUM_FIELDS,
exec_cap) per-slot gradient rows: 0-1 dL/dx, dL/dy (tile-local means), 2-4
dL/d(a', b', c') (the moments mxx, mxy, myy), 5 dL/dopacity, 6-8 dL/drgb,
9 the pre-sort slot of each walked slot, 10-15 zero. Tiles that never
flushed on an exec-clamped frame keep all-zero rows.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .. import kernels
from .binning import CHUNK, NUM_FIELDS, NUM_USED_FIELDS, OFFSET_ROW
from .tiles import (LOG_EXIT_T, LOG_STOP_T, MAX_ALPHA, MIN_ALPHA, OUT_ROWS, PIX, SKIP_POWER, STOP_T, WARP_REGION,
                    _check_blocks, _on_card)
from .types import TILE_X, TILE_Y

TID_ROW = 9  # staged field row carrying the lane's tile id (f32 exact)

FORWARD_KERNEL = kernels.register(
    kernels.Kernel(
        name="tiles_packed_fwd",
        source="tiles_packed_fwd.cu",
        symbol="c3dgs_tiles_packed_fwd",
        argtypes=(
            ctypes.c_void_p,  # fields
            ctypes.c_longlong,  # field row stride (exec_cap)
            ctypes.c_void_p,  # starts
            ctypes.c_void_p,  # ends
            ctypes.c_void_p,  # meta
            ctypes.c_void_p,  # out
            ctypes.c_int,  # t_out (blocks)
            ctypes.c_void_p,  # stream
        ),
        replaces="c3dgs_tpu/render/tiles_packed.py:149",
    )
)

BACKWARD_KERNEL = kernels.register(
    kernels.Kernel(
        name="tiles_packed_bwd",
        source="tiles_packed_bwd.cu",
        symbol="c3dgs_tiles_packed_bwd",
        argtypes=(
            ctypes.c_void_p,  # fields
            ctypes.c_longlong,  # field / grad row stride (exec_cap)
            ctypes.c_void_p,  # starts
            ctypes.c_void_p,  # ends
            ctypes.c_void_p,  # meta
            ctypes.c_void_p,  # totals (K1's blocks)
            ctypes.c_void_p,  # grad_out (cotangent blocks)
            ctypes.c_void_p,  # grads out (zero-initialized)
            ctypes.c_int,  # t_out (blocks)
            ctypes.c_void_p,  # stream
        ),
        replaces="c3dgs_tpu/render/tiles_packed.py:353",
    )
)


def _check(fields, tile_lo, meta, starts, ends) -> int:
    """Validate the kernel's inputs; returns the out block count t_out."""
    dev = fields.device
    for name, t, dt in (
        ("fields", fields, torch.float32),
        ("tile_lo", tile_lo, torch.int32),
        ("meta", meta, torch.int32),
        ("starts", starts, torch.int32),
        ("ends", ends, torch.int32),
    ):
        if t.dtype != dt or t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dt} tensor on {dev}")
    if fields.ndim != 2 or fields.shape[0] != NUM_FIELDS or fields.shape[1] % CHUNK:
        raise ValueError(f"fields must be ({NUM_FIELDS}, k*{CHUNK}), got {tuple(fields.shape)}")
    if tile_lo.shape != (fields.shape[1] // CHUNK + 1,) or meta.shape != (4,):
        raise ValueError("tile_lo must hold exec_cap/128 + 1 entries and meta 4")
    if dev.type == "cuda" and fields.data_ptr() % 16:
        raise ValueError("fields must be 16-byte aligned: the kernels stage them with bulk copies")
    t_out = starts.shape[0]
    if starts.ndim != 1 or ends.shape != starts.shape:
        raise ValueError("starts and ends must be (t_out,)")
    return t_out


def forward(fields, tile_lo, meta, starts, ends) -> torch.Tensor:
    """Packed forward compositing: (t_out, OUT_ROWS, PIX) tile blocks,
    block i for global tile meta[1] + i (t_out = len(starts)).

    meta = [chunks_exec, tile_start, tile_end, cap] int32 on the fields'
    device, never read on the host here. CUDA tensors launch K1 (or raise);
    CPU tensors run forward_plain."""
    t_out = _check(fields, tile_lo, meta, starts, ends)
    if not _on_card(fields):
        return forward_plain(fields, tile_lo, meta, starts, ends)
    out = torch.empty((t_out, OUT_ROWS, PIX), dtype=torch.float32, device=fields.device)
    launch(fields, meta, starts, ends, out)
    return out


def launch(fields, meta, starts, ends, out) -> None:
    """One K1 launch on the current stream into `out`, on tensors that
    `forward` has validated (timing loops call it directly)."""
    with torch.cuda.device(fields.device):
        FORWARD_KERNEL.launch(
            fields.data_ptr(),
            fields.shape[1],
            starts.data_ptr(),
            ends.data_ptr(),
            meta.data_ptr(),
            out.data_ptr(),
            starts.shape[0],
            torch.cuda.current_stream(fields.device).cuda_stream,
        )


def _dot64(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b accumulated in float64, returned as float32: immune to TF32
    and at least as exact as the TPU's f32 MXU passes (_tri_dot)."""
    return (a.double() @ b.double()).float()


def forward_plain(
    fields, tile_lo, meta, starts, ends, stats: Optional[dict] = None
) -> torch.Tensor:
    """The plain version of K1: a chunk-wise replica of the TPU walk, an
    algorithm independent of the kernel's per-tile walk.

    One aligned 128-slot chunk at a time, vectorized over (PIX, CHUNK):
    lanes group by tid - lo, lo = max(tile_lo[c], tile_start) (the tiles
    flushing in the chunk are clamped to the range, and lanes of tiles
    outside it are dead); each lane's in-group exclusive prefix
    of log(1-alpha) is a float64 cumsum taken from its group's head; group 0
    takes the open tile's carried color and lt; groups 0..ng-1 flush at
    their sentinels; the trailing group becomes the carry. Between chunks,
    a chunk with no flush whose open tile has max lt < log(1e-6) freezes
    that tile (its remaining lanes are dead, its freeze slot is exported).

    `stats`, if given, accumulates the work counts of `_count_pairs` that
    this data needs. Unflushed tiles of a clamped frame are zero here."""
    t_out = _check(fields, tile_lo, meta, starts, ends)
    nchunks, tile_start, tile_end, cap = meta.tolist()
    lo_all = tile_lo.tolist()
    dev = fields.device
    f32 = dict(dtype=torch.float32, device=dev)
    out = torch.zeros((t_out, OUT_ROWS, PIX), **f32)
    pix = torch.arange(PIX, device=dev)
    px = (pix % TILE_X).to(torch.float32)[:, None]  # (PIX, 1) tile-local
    py = (pix // TILE_X).to(torch.float32)[:, None]
    lane = torch.arange(CHUNK, device=dev)
    carry_c = torch.zeros((3, PIX), **f32)
    carry_lt = torch.zeros(PIX, **f32)
    frz = -1
    for c in range(nchunks):
        lo, hi = max(lo_all[c], tile_start), min(lo_all[c + 1], tile_end)
        ng = max(hi - lo, 0)
        if ng == 0 and float(carry_lt.max()) < LOG_EXIT_T:
            if frz < 0:
                frz = c * CHUNK
            continue
        f = fields[:, c * CHUNK : (c + 1) * CHUNK]
        tid = f[TID_ROW]
        grp = tid - float(lo)
        dead = (tid >= float(tile_end)) | (tid < float(tile_start))
        if frz >= 0:
            dead = dead | (grp == 0)
        op = torch.where(dead, torch.zeros_like(f[5]), f[5])
        dx = f[0] - px
        dy = f[1] - py
        power = torch.clamp((f[2] * dx + f[3] * dy) * dx + (f[4] * dy) * dy, max=0.0)
        raw = op * torch.exp(power)
        alpha = torch.where(raw >= MIN_ALPHA, torch.clamp(raw, max=MAX_ALPHA), torch.zeros_like(raw))
        if stats is not None:
            _count_pairs(stats, op, power, alpha)
        tlog = torch.log1p(-alpha)  # (PIX, CHUNK)
        # in-group exclusive prefix: the chunk's float64 exclusive cumsum
        # minus its value at the lane's group head (tid is non-decreasing
        # along the lanes, so each group is one contiguous run)
        t64 = tlog.double()
        excl = torch.cumsum(t64, 1) - t64
        head = torch.ones_like(dead)
        head[1:] = grp[1:] != grp[:-1]
        first = torch.cummax(torch.where(head, lane, torch.zeros_like(lane)), 0).values
        g0 = (grp == 0).to(torch.float32)
        lt_in = (excl - excl[:, first]).float() + carry_lt[:, None] * g0
        t_in = torch.exp(lt_in)
        w = torch.where(t_in * (1.0 - alpha) >= STOP_T, alpha * t_in, torch.zeros_like(alpha))
        # per-group sums for groups 0..ng (ng = the trailing, still open one)
        onehot = (grp[:, None] == torch.arange(ng + 1, device=dev)[None, :]).to(torch.float32)
        col = _dot64(f[6:9][None] * w[:, None, :], onehot)  # (PIX, 3, ng+1)
        col = col.permute(2, 1, 0)  # (ng+1, 3, PIX)
        ltg = _dot64(tlog, onehot).T  # (ng+1, PIX)
        if ng >= 1:
            col_f = col[:ng].clone()
            lt_f = ltg[:ng].clone()
            col_f[0] = col_f[0] + carry_c
            lt_f[0] = lt_f[0] + carry_lt
            frz_f = torch.full((ng, PIX), float(cap), **f32)
            if frz >= 0:
                frz_f[0] = float(frz)
            blocks = slice(lo - tile_start, hi - tile_start)  # local numbering
            out[blocks, 0:3] = col_f
            out[blocks, 3] = torch.exp(lt_f)
            out[blocks, 4] = lt_f
            out[blocks, 5] = frz_f
            carry_c, carry_lt, frz = col[ng], ltg[ng], -1
        else:
            carry_c = carry_c + col[0]
            carry_lt = carry_lt + ltg[0]
    return out


def backward(fields, tile_lo, meta, starts, ends, totals, grad_out) -> torch.Tensor:
    """Packed backward: (NUM_FIELDS, exec_cap) per-slot gradient rows.

    `totals` are K1's blocks for these fields, `grad_out` the cotangent of
    those blocks (autograd may hand over an expanded or strided tensor; it
    is made contiguous here). The kernel computes in fp32 in both fast_grad
    modes: fast_grad only selects how the reduction that follows sums.
    CUDA tensors launch K2 (or raise); CPU tensors run backward_plain."""
    t_out = _check(fields, tile_lo, meta, starts, ends)
    grad_out = grad_out.contiguous()
    _check_blocks(totals, grad_out, t_out, fields.device)
    if not _on_card(fields):
        return backward_plain(fields, tile_lo, meta, starts, ends, totals, grad_out)
    grads = torch.zeros((NUM_FIELDS, fields.shape[1]), dtype=torch.float32, device=fields.device)
    launch_backward(fields, meta, starts, ends, totals, grad_out, grads)
    return grads


def launch_backward(fields, meta, starts, ends, totals, grad_out, grads) -> None:
    """One K2 launch on the current stream into the zero-initialized
    `grads`, on tensors that `backward` has validated (timing loops call
    it directly)."""
    with torch.cuda.device(fields.device):
        BACKWARD_KERNEL.launch(
            fields.data_ptr(),
            fields.shape[1],
            starts.data_ptr(),
            ends.data_ptr(),
            meta.data_ptr(),
            totals.data_ptr(),
            grad_out.data_ptr(),
            grads.data_ptr(),
            starts.shape[0],
            torch.cuda.current_stream(fields.device).cuda_stream,
        )


def _group_last(grp: torch.Tensor) -> torch.Tensor:
    """(CHUNK,) index of the last lane of each lane's group (groups are
    contiguous runs of equal grp)."""
    lane = torch.arange(grp.shape[0], device=grp.device)
    tail = torch.ones_like(grp, dtype=torch.bool)
    tail[:-1] = grp[:-1] != grp[1:]
    big = torch.full_like(lane, grp.shape[0])
    return torch.flip(torch.cummin(torch.flip(torch.where(tail, lane, big), (0,)), 0).values, (0,))


def _in_group_suffix(x64: torch.Tensor, last: torch.Tensor) -> torch.Tensor:
    """(PIX, CHUNK) float64 -> inclusive in-group suffix sums: lane i gets
    the sum over lanes i..last[i]."""
    rev = torch.flip(torch.cumsum(torch.flip(x64, (1,)), 1), (1,))  # sum over j >= i
    rev = torch.cat([rev, torch.zeros_like(rev[:, :1])], 1)
    return rev[:, :-1] - rev[:, last + 1]


def _count_pairs(stats: dict, op: torch.Tensor, power: torch.Tensor, alpha: torch.Tensor) -> None:
    """Add to `stats` one chunk's (pixel, live lane) evaluations: `pairs`,
    `exp_pairs`, those whose exp the kernels cannot skip (opacity above 1
    or power at least SKIP_POWER), and `alpha_pairs`, those with alpha > 0.
    op is (CHUNK,) with dead lanes zeroed; power and alpha are (PIX, CHUNK)."""
    live = op > 0
    stats["pairs"] = stats.get("pairs", 0) + PIX * int(live.sum())
    needs_exp = live & ((op > 1.0) | (power >= SKIP_POWER))
    stats["exp_pairs"] = stats.get("exp_pairs", 0) + int(needs_exp.sum())
    stats["alpha_pairs"] = stats.get("alpha_pairs", 0) + int((alpha > 0).sum())


def _count_live_groups(stats: dict, live: torch.Tensor) -> None:
    """Add to `stats` the (slot, pixel group) pairs in which any pixel has
    alpha > 0, for the pixel groups the kernels' warps cover: `row_pairs`
    (one tile row, the warps of K2's first version at 32x16) and
    `warp_pairs` (a WARP_REGION, 16x4 or 8x8, the redesigned K2's warps,
    which reduce only such pairs). `live` is (PIX, lanes) bool, pixels
    row-major in the tile."""
    lanes = live.shape[1]
    grid = live.reshape(TILE_Y, TILE_X, lanes)
    for key, (gy, gx) in (("row_pairs", (1, TILE_X)), ("warp_pairs", WARP_REGION)):
        g = grid.reshape(TILE_Y // gy, gy, TILE_X // gx, gx, lanes).any(3).any(1)
        stats[key] = stats.get(key, 0) + int(g.sum())


def backward_plain(
    fields, tile_lo, meta, starts, ends, totals, grad_out, stats: Optional[dict] = None
) -> torch.Tensor:
    """The plain version of K2: a chunk-wise replica of the TPU walk, an
    algorithm independent of the kernel's per-tile walk.

    Aligned 128-slot chunks in REVERSE, vectorized over (PIX, CHUNK):
    lanes group by tid - lo, lo = max(tile_lo[c], tile_start), with the
    flushing tiles clamped to the range, lanes outside it dead and the
    blocks in local numbering (as in forward_plain); groups 0..ng-1 flush
    in this chunk and
    start from their tile's lt_final (K1 row 4) with an empty suffix, the
    trailing group ng continues the carried walk (lt and the suffix S of
    the later chunks). Within a group the entering log-transmittance and
    the strict suffix of w*(dL/dC . rgb) are float64 suffix sums. Lanes at
    or past their tile's freeze slot (K1 row 5) are dead. The tile left
    open by the last executed chunk (never flushed on a clamped frame)
    carries zeros, so its lanes get all-zero rows, and unflushed tiles'
    blocks are never read. A chunk with no flush whose open tile froze
    before it is a no-op and is skipped.

    `stats`, if given, accumulates the counts of `_count_pairs` and of
    `_count_live_groups`."""
    t_out = _check(fields, tile_lo, meta, starts, ends)
    grad_out = grad_out.contiguous()
    _check_blocks(totals, grad_out, t_out, fields.device)
    nchunks, tile_start, tile_end, cap = meta.tolist()
    lo_all = tile_lo.tolist()
    # flushed tiles, counted in local numbering from tile_start
    n_flushed = min(max(lo_all[nchunks], tile_start), tile_end) - tile_start
    dev = fields.device
    f32 = dict(dtype=torch.float32, device=dev)
    f64 = dict(dtype=torch.float64, device=dev)
    grads = torch.zeros((NUM_FIELDS, fields.shape[1]), **f32)
    frz_all = totals[:n_flushed, 5, 0].tolist()
    # per flushed tile: dL/dC rows, dL/dT_final * T_final, lt_final
    gc_all = grad_out[:n_flushed, 0:3]
    gtt_all = grad_out[:n_flushed, 3] * totals[:n_flushed, 3]
    lt_all = totals[:n_flushed, 4]
    walk_end = torch.minimum(ends[:n_flushed].to(torch.float64), totals[:n_flushed, 5, 0].double())
    pix = torch.arange(PIX, device=dev)
    px = (pix % TILE_X).to(torch.float32)[:, None]  # (PIX, 1) tile-local
    py = (pix // TILE_X).to(torch.float32)[:, None]
    lane = torch.arange(CHUNK, device=dev)
    # the open tile's state; the tile open after the last executed chunk
    # never flushed: zero cotangent, zero walk
    open_gc = torch.zeros((3, PIX), **f32)
    open_gtt = torch.zeros(PIX, **f32)
    open_frz = float(cap)
    carry_lt = torch.zeros(PIX, **f64)
    carry_s = torch.zeros(PIX, **f64)
    for c in range(nchunks - 1, -1, -1):
        lo, hi = max(lo_all[c], tile_start), min(lo_all[c + 1], tile_end)
        ng = max(hi - lo, 0)
        if ng == 0 and c * CHUNK >= open_frz:
            continue
        f = fields[:, c * CHUNK : (c + 1) * CHUNK]
        tid = f[TID_ROW]
        grp = torch.clamp(tid - float(lo), 0, ng).long()
        slot = (c * CHUNK + lane).to(torch.float32)
        # per-group tables: flushed groups 0..ng-1, then the open tile
        blocks = slice(lo - tile_start, hi - tile_start)  # local numbering
        g_gc = torch.cat([gc_all[blocks], open_gc[None]])  # (ng+1, 3, PIX)
        g_gtt = torch.cat([gtt_all[blocks], open_gtt[None]])  # (ng+1, PIX)
        g_lt = torch.cat([lt_all[blocks].double(), carry_lt[None]])
        g_s = torch.cat([torch.zeros((ng, PIX), **f64), carry_s[None]])
        g_frz = torch.tensor(frz_all[blocks] + [open_frz], **f32)
        dead = (tid >= float(tile_end)) | (tid < float(tile_start)) | (slot >= g_frz[grp])
        op = torch.where(dead, torch.zeros_like(f[5]), f[5])
        dx = f[0] - px  # (PIX, CHUNK)
        dy = f[1] - py
        power = torch.clamp((f[2] * dx + f[3] * dy) * dx + (f[4] * dy) * dy, max=0.0)
        raw = op * torch.exp(power)
        capped = raw > MAX_ALPHA
        alpha = torch.where(raw >= MIN_ALPHA, torch.clamp(raw, max=MAX_ALPHA), torch.zeros_like(raw))
        if stats is not None:
            _count_pairs(stats, op, power, alpha)
            _count_live_groups(stats, alpha > 0)
        tlog = torch.log1p(-alpha)
        last = _group_last(grp)
        # entering log-transmittance: walk back from the group's anchor
        # through the inclusive in-group suffix of log(1 - alpha)
        pre64 = g_lt[grp].T - _in_group_suffix(tlog.double(), last)
        pre = pre64.float()
        live = pre + tlog >= LOG_STOP_T
        w = torch.where(live, alpha * torch.exp(pre), torch.zeros_like(alpha))
        gc = g_gc[grp]  # (CHUNK, 3, PIX)
        gc_dot = gc[:, 0].T * f[6] + gc[:, 1].T * f[7] + gc[:, 2].T * f[8]
        gwc = w * gc_dot
        gwc64 = gwc.double()
        strict = _in_group_suffix(gwc64, last) - gwc64 + g_s[grp].T
        s_all = (strict + g_gtt[grp].T.double()).float()
        g_power = gwc - s_all * (alpha / (1.0 - alpha))
        g_power = torch.where(capped, torch.zeros_like(g_power), g_power)

        def colsum(x):
            return x.double().sum(0).float()

        gdx = g_power * dx
        gdy = g_power * dy
        s0, mx, my = colsum(g_power), colsum(gdx), colsum(gdy)
        mxx, mxy, myy = colsum(gdx * dx), colsum(gdx * dy), colsum(gdy * dy)
        g_rgb = [colsum(gc[:, k].T * w) for k in range(3)]
        op_e = torch.clamp(torch.where(tid >= float(tile_end), torch.zeros_like(f[5]), f[5]), min=1e-12)
        g_x = 2.0 * f[2] * mx + f[3] * my
        g_y = 2.0 * f[4] * my + f[3] * mx
        rows = torch.stack([g_x, g_y, mxx, mxy, myy, s0 / op_e, *g_rgb])
        sl = slice(c * CHUNK, (c + 1) * CHUNK)
        grads[:NUM_USED_FIELDS, sl] = rows
        if n_flushed:  # row 9: the pre-sort slot of every slot a tile's walk covers
            t_loc = tid.long() - tile_start
            t_safe = torch.clamp(t_loc, 0, n_flushed - 1)
            walked = (t_loc >= 0) & (t_loc < n_flushed) & (slot.double() < walk_end[t_safe])
            grads[NUM_USED_FIELDS, sl] = torch.where(walked, f[OFFSET_ROW], torch.zeros_like(f[OFFSET_ROW]))
        # carries for chunk c-1, whose open tile is this chunk's group 0
        carry_lt = pre64[:, 0]
        g0 = (grp == 0).to(torch.float64)
        carry_s = (gwc64 * g0).sum(1) + (carry_s if ng == 0 else 0.0)
        if ng >= 1:
            l0 = lo - tile_start
            open_gc, open_gtt, open_frz = gc_all[l0], gtt_all[l0], frz_all[l0]
    return grads
