"""The per-tile compositing kernels: the K3 forward and K4 backward
wrappers and their plain versions (port of c3dgs_tpu/render/tiles.py), and
the constants every compositing kernel shares.

`forward` / `backward` launch the hand-written Hopper kernels
(csrc/tiles_fwd.cu, csrc/tiles_bwd.cu) for CUDA tensors and
`forward_plain` / `backward_plain` for CPU tensors; there is no fallback
from one to the other. Both take the staged sorted fields of
rasterizer._build_fields (global means, row PRESORT_ROW the pre-sort slot;
16-byte aligned on the card, where the kernels stage them with bulk
copies) and the binning's per-tile bookkeeping. Tile t of the call
composites the window of up to 128 instances starting at starts[t] +
w*128, for w in [0, nchunks[t]); its pixels are those of global tile
tile_ids[t].

The forward returns (T, OUT_ROWS, PIX) blocks: rows 0-2 color without
background, 3 exp(lt_final), 4 lt_final, 5 `stop` (the first window the
saturation exit skipped, nchunks if none), 6-7 zero. The backward takes
those blocks and the cotangent blocks (rows 0-2 dL/dC, 3 dL/dT_final) and
returns the zero-initialized (NUM_FIELDS, grad_cap) per-instance gradient
rows: window w of tile t writes its 128 columns at grad_base[t] + w*128,
clamped to grad_cap - 128. Rows 0-1 dL/dx, dL/dy, 2-4 dL/d(a', b', c')
(the moments mxx, mxy, myy), 5 dL/dopacity, 6-8 dL/drgb, 9 the pre-sort
slot (the slot-domain cap on tail lanes), 10-15 zero. Windows at or past
`stop` write zeros and the tag row only.

On a clamped frame several windows land on the last chunk. The TPU runs
its grid in order, so the last of them in (tile ascending, window
descending) order wins: the last tile with any window, at its lowest
window that clamps. Only that window writes the chunk here, in the kernel
and in the plain version alike, so the result does not depend on the order
in which the card runs its blocks.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from .. import kernels
from .binning import CHUNK, NUM_FIELDS, NUM_USED_FIELDS, PRESORT_ROW
from .types import TILE_X, TILE_Y, kernel_shape_problem

PIX = TILE_X * TILE_Y  # 512 pixels per tile at the default 32x16
# the (rows, columns) of the pixel region one warp of K1-K4 covers
# (csrc/tiles_common.cuh::pixel_index): two 8x4 blocks side by side, or
# one above the other where the tile is an odd number of blocks wide
WARP_REGION = (4, 16) if (TILE_X // 8) % 2 == 0 else (8, 8)
STOP_T = 1e-4  # a contribution lands while T * (1 - alpha) >= STOP_T
MIN_ALPHA = 1.0 / 255.0
MAX_ALPHA = 0.99
OUT_ROWS = 8  # per-tile output block rows
# per-tile freeze once every pixel's transmittance is below EXIT_T;
# stricter than STOP_T so the skipped work is provably invisible
EXIT_T = 1e-6
LOG_EXIT_T = math.log(EXIT_T)  # the forward's carry lives in log domain
LOG_STOP_T = math.log(STOP_T)  # the backward's live check in log domain
# the kernels skip the exp of a pair whose opacity is at most 1 and whose
# power is below this: exp(-5.55) < 1/255, so alpha is 0 there
# (csrc/tiles_common.cuh)
SKIP_POWER = -5.55
TILE_BATCH = 256  # tiles one step of the plain versions handles at once

FORWARD_KERNEL = kernels.register(
    kernels.Kernel(
        name="tiles_fwd",
        source="tiles_fwd.cu",
        symbol="c3dgs_tiles_fwd",
        argtypes=(
            ctypes.c_void_p,  # fields
            ctypes.c_longlong,  # field row stride (cap)
            ctypes.c_void_p,  # tile_ids
            ctypes.c_void_p,  # starts
            ctypes.c_void_p,  # ends
            ctypes.c_void_p,  # nchunks
            ctypes.c_int,  # tiles_x
            ctypes.c_void_p,  # out
            ctypes.c_int,  # num_tiles
            ctypes.c_void_p,  # stream
        ),
        replaces="c3dgs_tpu/render/tiles.py:212",
    )
)

BACKWARD_KERNEL = kernels.register(
    kernels.Kernel(
        name="tiles_bwd",
        source="tiles_bwd.cu",
        symbol="c3dgs_tiles_bwd",
        argtypes=(
            ctypes.c_void_p,  # fields
            ctypes.c_longlong,  # field row stride (cap)
            ctypes.c_void_p,  # tile_ids
            ctypes.c_void_p,  # starts
            ctypes.c_void_p,  # ends
            ctypes.c_void_p,  # nchunks
            ctypes.c_void_p,  # grad_base
            ctypes.c_void_p,  # totals (K3's blocks)
            ctypes.c_void_p,  # grad_out (cotangent blocks)
            ctypes.c_int,  # tiles_x
            ctypes.c_void_p,  # grads out (zero-initialized)
            ctypes.c_longlong,  # grad row stride (grad_cap)
            ctypes.c_int,  # num_tiles
            ctypes.c_void_p,  # stream
        ),
        replaces="c3dgs_tpu/render/tiles.py:320",
    )
)


def _check(fields, tile_ids, starts, ends, nchunks, grad_base=None) -> int:
    """Validate the kernels' inputs; returns the tile count."""
    dev = fields.device
    named = [("fields", fields, torch.float32), ("tile_ids", tile_ids, torch.int32),
             ("starts", starts, torch.int32), ("ends", ends, torch.int32),
             ("nchunks", nchunks, torch.int32)]
    if grad_base is not None:
        named.append(("grad_base", grad_base, torch.int32))
    for name, t, dt in named:
        if t.dtype != dt or t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dt} tensor on {dev}")
    if fields.ndim != 2 or fields.shape[0] != NUM_FIELDS or fields.shape[1] % CHUNK:
        raise ValueError(f"fields must be ({NUM_FIELDS}, k*{CHUNK}), got {tuple(fields.shape)}")
    if dev.type == "cuda" and fields.data_ptr() % 16:
        raise ValueError("fields must be 16-byte aligned: the kernels stage them with bulk copies")
    num_tiles = tile_ids.shape[0]
    if tile_ids.ndim != 1 or any(t.shape != (num_tiles,) for _, t, _ in named[2:]):
        raise ValueError("tile_ids, starts, ends, nchunks and grad_base must all be (T,)")
    return num_tiles


def _on_card(fields) -> bool:
    """True for CUDA tensors (launch the kernel), False for CPU tensors
    (the plain version, at any tile shape); raises on any other device,
    and on the card for a tile shape the kernels cannot be built for."""
    if fields.device.type == "cpu":
        return False
    if fields.device.type != "cuda":
        raise ValueError(f"unsupported device {fields.device}")
    problem = kernel_shape_problem(TILE_X, TILE_Y)
    if problem:
        raise NotImplementedError(f"the CUDA kernels cannot take the tile shape C3DGS_TILE_X/Y set: {problem}")
    return True


def forward(fields, tile_ids, starts, ends, nchunks, tiles_x: int) -> torch.Tensor:
    """Per-tile forward compositing: (T, OUT_ROWS, PIX) tile blocks. CUDA
    tensors launch K3 (or raise); CPU tensors run forward_plain."""
    num_tiles = _check(fields, tile_ids, starts, ends, nchunks)
    if not _on_card(fields):
        return forward_plain(fields, tile_ids, starts, ends, nchunks, tiles_x)
    out = torch.empty((num_tiles, OUT_ROWS, PIX), dtype=torch.float32, device=fields.device)
    launch(fields, tile_ids, starts, ends, nchunks, tiles_x, out)
    return out


def launch(fields, tile_ids, starts, ends, nchunks, tiles_x: int, out) -> None:
    """One K3 launch on the current stream into `out`, on tensors that
    `forward` has validated (timing loops call it directly)."""
    with torch.cuda.device(fields.device):
        FORWARD_KERNEL.launch(
            fields.data_ptr(), fields.shape[1], tile_ids.data_ptr(), starts.data_ptr(),
            ends.data_ptr(), nchunks.data_ptr(), tiles_x, out.data_ptr(), tile_ids.shape[0],
            torch.cuda.current_stream(fields.device).cuda_stream,
        )


def _pixel_coords(tile_ids, tiles_x: int):
    """Global pixel x, y (B, PIX) f32 of each tile's pixels."""
    pix = torch.arange(PIX, device=tile_ids.device)
    tid = tile_ids.long()[:, None]
    px = (tid % tiles_x) * TILE_X + pix % TILE_X
    py = torch.div(tid, tiles_x, rounding_mode="floor") * TILE_Y + pix // TILE_X
    return px.to(torch.float32), py.to(torch.float32)


def _window(fields, start, count, w: int):
    """Window w of each tile: (NUM_FIELDS, B, CHUNK) fields and the (B,
    CHUNK) mask of its lanes that hold the tile's instances (the rest read
    a clamped in-bounds slot and stay masked)."""
    lane = torch.arange(CHUNK, device=fields.device)
    off = w * CHUNK + lane
    seg = off[None, :] < count[:, None]
    idx = torch.clamp(start[:, None] + off[None, :], max=fields.shape[1] - 1)
    return fields[:, idx], seg


def _alpha(f, px, py, seg):
    """JAX's _chunk_alpha over (B, PIX, CHUNK): dx, dy, the clamped power,
    masked alpha, and the lanes whose alpha was capped at 0.99."""
    dx = f[0][:, None, :] - px[:, :, None]
    dy = f[1][:, None, :] - py[:, :, None]
    a2, b2, c2 = f[2][:, None, :], f[3][:, None, :], f[4][:, None, :]
    power = torch.clamp((a2 * dx + b2 * dy) * dx + (c2 * dy) * dy, max=0.0)
    raw = f[5][:, None, :] * torch.exp(power)
    capped = raw > MAX_ALPHA
    mask = (raw >= MIN_ALPHA) & seg[:, None, :]
    alpha = torch.where(mask, torch.clamp(raw, max=MAX_ALPHA), torch.zeros_like(raw))
    return dx, dy, power, alpha, capped


def needs_exp(f, power, seg):
    """(B, PIX, CHUNK) pairs whose exp the kernels cannot skip: a real lane
    whose opacity is above 1 or whose power is at least SKIP_POWER."""
    return seg[:, None, :] & ((f[5][:, None, :] > 1.0) | (power >= SKIP_POWER))


def _excl_prefix(x: torch.Tensor) -> torch.Tensor:
    """Exclusive prefix along the last dimension, summed in float64."""
    x64 = x.double()
    return (torch.cumsum(x64, -1) - x64).float()


def _count(stats, f, power, alpha, seg) -> None:
    """Add one window's work to `stats`: `pairs` (pixel, real lane)
    evaluations, `exp_pairs`, those whose exp the kernels cannot skip
    (needs_exp), and `alpha_pairs`, those with alpha > 0."""
    if stats is not None:
        stats["pairs"] = stats.get("pairs", 0) + PIX * int(seg.sum())
        stats["exp_pairs"] = stats.get("exp_pairs", 0) + int(needs_exp(f, power, seg).sum())
        stats["alpha_pairs"] = stats.get("alpha_pairs", 0) + int((alpha > 0).sum())


def forward_plain(fields, tile_ids, starts, ends, nchunks, tiles_x: int,
                  stats: Optional[dict] = None) -> torch.Tensor:
    """The plain version of K3: the TPU kernel's math window by window
    (tiles.py:183-209 alpha, :272-298 the step), vectorized over up to
    TILE_BATCH tiles and (PIX, CHUNK): the in-window exclusive prefix of
    log(1 - alpha) plus the carried lt gives each lane's entering log
    transmittance, lt then advances by the whole window's sum, and a tile
    whose every pixel has lt < log(1e-6) after window w stops at w + 1.

    `stats`, if given, accumulates the work this data needs in the windows
    before `stop` (_count: `pairs`, `exp_pairs`, `alpha_pairs`)."""
    num_tiles = _check(fields, tile_ids, starts, ends, nchunks)
    dev = fields.device
    out = torch.zeros((num_tiles, OUT_ROWS, PIX), dtype=torch.float32, device=dev)
    for b0 in range(0, num_tiles, TILE_BATCH):
        sl = slice(b0, min(num_tiles, b0 + TILE_BATCH))
        nch = nchunks[sl].long()
        start, count = starts[sl].long(), (ends[sl] - starts[sl]).long()
        px, py = _pixel_coords(tile_ids[sl], tiles_x)
        color = torch.zeros((nch.shape[0], 3, PIX), dtype=torch.float32, device=dev)
        lt = torch.zeros((nch.shape[0], PIX), dtype=torch.float32, device=dev)
        stop = nch.clone()
        for w in range(int(nch.max()) if nch.numel() else 0):
            a = torch.nonzero(w < stop).flatten()  # windows >= stop are never blended
            if a.numel() == 0:
                break
            f, seg = _window(fields, start[a], count[a], w)
            _, _, power, alpha, _ = _alpha(f, px[a], py[a], seg)
            _count(stats, f, power, alpha, seg)
            tlog = torch.log1p(-alpha)  # (A, PIX, CHUNK)
            t_in = torch.exp(_excl_prefix(tlog) + lt[a][:, :, None])
            wgt = torch.where(t_in * (1.0 - alpha) >= STOP_T, alpha * t_in, torch.zeros_like(alpha))
            rgb = f[6:9].permute(1, 2, 0)  # (A, CHUNK, 3)
            color[a] = color[a] + torch.bmm(wgt.double(), rgb.double()).float().transpose(1, 2)
            lt_a = lt[a] + tlog.double().sum(-1).float()
            lt[a] = lt_a
            exited = lt_a.max(1).values < LOG_EXIT_T  # a NaN pixel keeps the tile live
            stop[a] = torch.where((stop[a] == nch[a]) & exited, torch.full_like(stop[a], w + 1), stop[a])
        out[sl, 0:3] = color
        out[sl, 3] = torch.exp(lt)
        out[sl, 4] = lt
        out[sl, 5] = stop.to(torch.float32)[:, None]
    return out


def _check_blocks(totals, grad_out, num_tiles: int, dev) -> None:
    for name, t in (("totals", totals), ("grad_out", grad_out)):
        if t.dtype != torch.float32 or t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 tensor on {dev}")
        if t.shape != (num_tiles, OUT_ROWS, PIX):
            raise ValueError(f"{name} must be ({num_tiles}, {OUT_ROWS}, {PIX}), got {tuple(t.shape)}")


def backward(fields, tile_ids, starts, ends, nchunks, grad_base, totals, grad_out,
             tiles_x: int, grad_cap: int) -> torch.Tensor:
    """Per-tile backward: (NUM_FIELDS, grad_cap) per-instance gradient
    rows. `totals` are K3's blocks for these fields, `grad_out` their
    cotangent (made contiguous here: autograd may hand over an expanded
    tensor). fp32 in both fast_grad modes: fast_grad only drops the
    compensation of the reduction that follows. CUDA tensors launch K4 (or
    raise); CPU tensors run backward_plain."""
    num_tiles = _check(fields, tile_ids, starts, ends, nchunks, grad_base)
    grad_out = grad_out.contiguous()
    _check_blocks(totals, grad_out, num_tiles, fields.device)
    if grad_cap < CHUNK or grad_cap % CHUNK:
        raise ValueError(f"grad_cap must be a positive multiple of {CHUNK}, got {grad_cap}")
    if not _on_card(fields):
        return backward_plain(fields, tile_ids, starts, ends, nchunks, grad_base, totals, grad_out,
                              tiles_x, grad_cap)
    grads = torch.zeros((NUM_FIELDS, grad_cap), dtype=torch.float32, device=fields.device)
    launch_backward(fields, tile_ids, starts, ends, nchunks, grad_base, totals, grad_out, tiles_x, grads)
    return grads


def launch_backward(fields, tile_ids, starts, ends, nchunks, grad_base, totals, grad_out,
                    tiles_x: int, grads) -> None:
    """One K4 launch on the current stream into the zero-initialized
    `grads`, on tensors that `backward` has validated (timing loops call it
    directly)."""
    with torch.cuda.device(fields.device):
        BACKWARD_KERNEL.launch(
            fields.data_ptr(), fields.shape[1], tile_ids.data_ptr(), starts.data_ptr(),
            ends.data_ptr(), nchunks.data_ptr(), grad_base.data_ptr(), totals.data_ptr(),
            grad_out.data_ptr(), tiles_x, grads.data_ptr(), grads.shape[1], tile_ids.shape[0],
            torch.cuda.current_stream(fields.device).cuda_stream,
        )


def last_chunk_writer(nchunks, grad_base, grad_cap: int):
    """(tile, window) that writes the clamped last chunk, as the TPU's
    in-order grid leaves it: the last tile with any window, at its lowest
    window whose offset reaches grad_cap - 128. (-1, -1) when no tile has
    a window."""
    nz = torch.nonzero(nchunks > 0).flatten()
    if nz.numel() == 0:
        return -1, -1
    t = int(nz[-1])
    return t, max(0, (grad_cap - CHUNK - int(grad_base[t])) // CHUNK)


def _sum_pix(x: torch.Tensor) -> torch.Tensor:
    """Sum over the pixel dimension of (B, PIX, CHUNK), in float64."""
    return x.double().sum(1).float()


def backward_plain(fields, tile_ids, starts, ends, nchunks, grad_base, totals, grad_out,
                   tiles_x: int, grad_cap: int, stats: Optional[dict] = None) -> torch.Tensor:
    """The plain version of K4: the TPU kernel's math window by window,
    back to front (tiles.py:441-551), vectorized over up to TILE_BATCH
    tiles and (PIX, CHUNK). Per window: the entering lt is the exiting one
    minus the whole window's sum of log(1 - alpha), each lane's is that
    plus its in-window exclusive prefix; the strict suffix of
    w * (dL/dC . rgb) runs over the later lanes of the window, plus the
    later windows' sums and dL/dT_final * T_final. Windows at or past the
    forward's `stop` write zeros and the tag row only.

    `stats`, if given, accumulates the work counts of _count."""
    num_tiles = _check(fields, tile_ids, starts, ends, nchunks, grad_base)
    grad_out = grad_out.contiguous()
    _check_blocks(totals, grad_out, num_tiles, fields.device)
    dev = fields.device
    cap = fields.shape[1]
    grads = torch.zeros((NUM_FIELDS, grad_cap), dtype=torch.float32, device=dev)
    last = grad_cap - CHUNK
    w_tile, w_win = last_chunk_writer(nchunks, grad_base, grad_cap)
    lane = torch.arange(CHUNK, device=dev)
    for b0 in range(0, num_tiles, TILE_BATCH):
        sl = slice(b0, min(num_tiles, b0 + TILE_BATCH))
        tile = torch.arange(sl.start, sl.stop, device=dev)
        nch = nchunks[sl].long()
        start, count, base = starts[sl].long(), (ends[sl] - starts[sl]).long(), grad_base[sl].long()
        stop = torch.minimum(totals[sl, 5, 0].long(), nch)
        px, py = _pixel_coords(tile_ids[sl], tiles_x)
        g_color = grad_out[sl, 0:3]  # (B, 3, PIX)
        g_tfin_term = grad_out[sl, 3] * totals[sl, 3]  # (B, PIX)
        lt_exit = totals[sl, 4].clone()
        s_carry = torch.zeros_like(lt_exit)
        for w in range(int(nch.max()) - 1 if nch.numel() else -1, -1, -1):
            a = torch.nonzero(w < nch).flatten()
            if a.numel() == 0:
                continue
            f, seg = _window(fields, start[a], count[a], w)
            rows = torch.zeros((PRESORT_ROW + 1, a.numel(), CHUNK), dtype=torch.float32, device=dev)
            rows[PRESORT_ROW] = torch.where(seg, f[PRESORT_ROW], torch.full_like(f[PRESORT_ROW], float(cap)))
            ci = torch.nonzero(w < stop[a]).flatten()  # windows the forward blended
            if ci.numel():
                c = a[ci]
                fc, segc = f[:, ci], seg[ci]
                dx, dy, power, alpha, capped = _alpha(fc, px[c], py[c], segc)
                _count(stats, fc, power, alpha, segc)
                tlog = torch.log1p(-alpha)
                s_excl = _excl_prefix(tlog)
                lt_in = lt_exit[c] - tlog.double().sum(-1).float()
                pre = s_excl + lt_in[:, :, None]
                live = pre + tlog >= LOG_STOP_T
                wgt = torch.where(live, alpha * torch.exp(pre), torch.zeros_like(alpha))
                gc = g_color[c]  # (C, 3, PIX)
                gc_dot_c = (gc[:, 0, :, None] * fc[6][:, None, :] + gc[:, 1, :, None] * fc[7][:, None, :]
                            + gc[:, 2, :, None] * fc[8][:, None, :])
                gwc = wgt * gc_dot_c
                g64 = gwc.double()
                suf = (g64.sum(-1, keepdim=True) - torch.cumsum(g64, -1)).float()  # strict suffix
                s_all = suf + (s_carry[c] + g_tfin_term[c])[:, :, None]
                g_power = gwc - s_all * (alpha / (1.0 - alpha))
                g_power = torch.where(capped, torch.zeros_like(g_power), g_power)
                gdx, gdy = g_power * dx, g_power * dy
                mx, my = _sum_pix(gdx), _sum_pix(gdy)
                a2, b2, c2, op = fc[2], fc[3], fc[4], fc[5]
                rows[0, ci] = 2.0 * a2 * mx + b2 * my
                rows[1, ci] = 2.0 * c2 * my + b2 * mx
                rows[2, ci] = _sum_pix(gdx * dx)
                rows[3, ci] = _sum_pix(gdx * dy)
                rows[4, ci] = _sum_pix(gdy * dy)
                rows[5, ci] = _sum_pix(g_power) / torch.clamp(op, min=1e-12)
                rows[6:9, ci] = torch.bmm(gc.double(), wgt.double()).float().permute(1, 0, 2)
                s_carry[c] = s_carry[c] + suf[:, :, 0] + gwc[:, :, 0]
                lt_exit[c] = lt_in
            off = base[a] + w * CHUNK
            clamped = off >= last
            keep = ~clamped | ((tile[a] == w_tile) & (w == w_win))
            cols = torch.clamp(off, max=last)[keep, None] + lane[None, :]
            grads[: PRESORT_ROW + 1, cols] = rows[:, keep]
    return grads
