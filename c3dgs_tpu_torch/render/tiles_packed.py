"""Packed forward compositing: the K1 wrapper and its plain version
(port of c3dgs_tpu/render/tiles_packed.py; the backward K2 comes with the
training slice).

`forward` launches the hand-written Hopper kernel
(csrc/tiles_packed_fwd.cu) for CUDA tensors and `forward_plain` for CPU
tensors; there is no fallback from one to the other. Both take the staged
sorted fields of rasterizer._build_fields_packed plus the binning's
tile_lo / meta / starts / ends and return (T, OUT_ROWS, PIX) blocks:
rows 0-2 color without background, 3 exp(lt_final), 4 lt_final, 5 the
freeze start slot (meta[3] if never frozen), 6-7 zero.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .. import kernels
from .binning import CHUNK, NUM_FIELDS
from .tiles import LOG_EXIT_T, MAX_ALPHA, MIN_ALPHA, OUT_ROWS, PIX, STOP_T
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
            ctypes.c_int,  # num_tiles
            ctypes.c_void_p,  # stream
        ),
        replaces="c3dgs_tpu/render/tiles_packed.py:149",
    )
)


def _check(fields, tile_lo, meta, starts, ends) -> int:
    """Validate the kernel's inputs; returns the tile count."""
    if (TILE_X, TILE_Y) != (32, 16):
        raise NotImplementedError(
            f"the packed forward kernel supports 32x16 tiles only, got {TILE_X}x{TILE_Y}"
        )
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
    num_tiles = starts.shape[0]
    if starts.ndim != 1 or ends.shape != starts.shape:
        raise ValueError("starts and ends must be (T,)")
    return num_tiles


def _check_tile_range(meta_host, num_tiles: int) -> None:
    if (meta_host[1], meta_host[2]) != (0, num_tiles):
        raise NotImplementedError(
            f"tile-sharded rendering (tile range {meta_host[1]}..{meta_host[2]} of "
            f"{num_tiles}) arrives with the port's multi-device slice"
        )


def forward(fields, tile_lo, meta, starts, ends) -> torch.Tensor:
    """Packed forward compositing: (T, OUT_ROWS, PIX) tile blocks.

    meta = [chunks_exec, tile_start, tile_end, cap] int32; the tile range
    must be [0, T). CUDA tensors launch K1 (or raise); CPU tensors run
    forward_plain."""
    num_tiles = _check(fields, tile_lo, meta, starts, ends)
    if fields.device.type == "cpu":
        return forward_plain(fields, tile_lo, meta, starts, ends)
    if fields.device.type != "cuda":
        raise ValueError(f"unsupported device {fields.device}")
    # one small device->host read: the kernel has no tile-sharding mode
    _check_tile_range(meta.tolist(), num_tiles)
    out = torch.empty((num_tiles, OUT_ROWS, PIX), dtype=torch.float32, device=fields.device)
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
    lanes group by tid - tile_lo[c]; each lane's in-group exclusive prefix
    of log(1-alpha) is a float64 cumsum taken from its group's head; group 0
    takes the open tile's carried color and lt; groups 0..ng-1 flush at
    their sentinels; the trailing group becomes the carry. Between chunks,
    a chunk with no flush whose open tile has max lt < log(1e-6) freezes
    that tile (its remaining lanes are dead, its freeze slot is exported).

    `stats`, if given, accumulates the work counts this data needs:
    `pairs` (pixel, live lane) evaluations and `alpha_pairs`, those with
    alpha > 0. Unflushed tiles of a clamped frame are zero here."""
    num_tiles = _check(fields, tile_lo, meta, starts, ends)
    meta_host = meta.tolist()
    _check_tile_range(meta_host, num_tiles)
    nchunks, _, tile_end, cap = meta_host
    lo_all = tile_lo.tolist()
    dev = fields.device
    f32 = dict(dtype=torch.float32, device=dev)
    out = torch.zeros((num_tiles, OUT_ROWS, PIX), **f32)
    pix = torch.arange(PIX, device=dev)
    px = (pix % TILE_X).to(torch.float32)[:, None]  # (PIX, 1) tile-local
    py = (pix // TILE_X).to(torch.float32)[:, None]
    lane = torch.arange(CHUNK, device=dev)
    carry_c = torch.zeros((3, PIX), **f32)
    carry_lt = torch.zeros(PIX, **f32)
    frz = -1
    for c in range(nchunks):
        lo, hi = lo_all[c], lo_all[c + 1]
        ng = hi - lo
        if ng == 0 and float(carry_lt.max()) < LOG_EXIT_T:
            if frz < 0:
                frz = c * CHUNK
            continue
        f = fields[:, c * CHUNK : (c + 1) * CHUNK]
        tid = f[TID_ROW]
        grp = tid - float(lo)
        dead = tid >= float(tile_end)
        if frz >= 0:
            dead = dead | (grp == 0)
        op = torch.where(dead, torch.zeros_like(f[5]), f[5])
        dx = f[0] - px
        dy = f[1] - py
        power = torch.clamp((f[2] * dx + f[3] * dy) * dx + (f[4] * dy) * dy, max=0.0)
        raw = op * torch.exp(power)
        alpha = torch.where(raw >= MIN_ALPHA, torch.clamp(raw, max=MAX_ALPHA), torch.zeros_like(raw))
        if stats is not None:
            stats["pairs"] = stats.get("pairs", 0) + PIX * int((op > 0).sum())
            stats["alpha_pairs"] = stats.get("alpha_pairs", 0) + int((alpha > 0).sum())
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
            out[lo:hi, 0:3] = col_f
            out[lo:hi, 3] = torch.exp(lt_f)
            out[lo:hi, 4] = lt_f
            out[lo:hi, 5] = frz_f
            carry_c, carry_lt, frz = col[ng], ltg[ng], -1
        else:
            carry_c = carry_c + col[0]
            carry_lt = carry_lt + ltg[0]
    return out
