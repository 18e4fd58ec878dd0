"""Deterministic segment sums and the row gather whose backward uses them.

jax.ops.segment_sum is a fixed-order scatter. torch's index_add_ and
bincount(weights=) on CUDA add floats with atomics, so their sums (and a
k-means codebook built from them, or the gradient of a codebook table) can
change from run to run. Here each segment is summed in float64 in an order
that depends only on the ids and rounded once: the same bits on every
run, and within float32 rounding of an exact sum.

`segment_sum` launches the hand-written Hopper kernel
(csrc/table_segment_sum.cu: a stable radix sort of the ids, then the
sums) for CUDA tensors and runs `segment_sum_plain` for CPU tensors;
there is no fallback from one to the other.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import kernels
from ..spans import span

KERNEL = kernels.register(
    kernels.Kernel(
        name="table_segment_sum",
        source="table_segment_sum.cu",
        symbol="c3dgs_table_segment_sum",
        argtypes=(
            ctypes.c_void_p,  # values (n, d) f32
            ctypes.c_void_p,  # ids (n,) i64
            ctypes.c_longlong,  # n
            ctypes.c_longlong,  # d
            ctypes.c_longlong,  # rows
            ctypes.c_void_p,  # scratch
            ctypes.c_ulonglong,  # its bytes
            ctypes.c_void_p,  # out (rows, d)
            ctypes.c_void_p,  # stream
        ),
        # XLA's scatter-add (the table gathers' transpose); no Pallas kernel
        replaces="c3dgs_tpu/models/gaussians.py:162",
    )
)


@functools.lru_cache(maxsize=None)
def _scratch_fn():
    fn = kernels.load(KERNEL.source).c3dgs_table_segment_sum_scratch
    fn.argtypes = [ctypes.c_longlong] * 3
    fn.restype = ctypes.c_ulonglong
    return fn


def scratch_bytes(n: int, d: int, rows: int) -> int:
    """The kernel's scratch for n ids into a (rows, d) table: the sort's
    keys, positions and buffer, the row bounds, and the partials of the
    tiles and of the levels above them."""
    return _scratch_fn()(n, d, rows)


def segment_sum(values: torch.Tensor, ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """(N, ...) values, (N,) integer ids in [0, num_segments) -> the
    (num_segments, ...) sums of the rows of each id, in values' dtype. An
    empty segment sums to 0. CUDA tensors launch the kernel (float32
    values; or raise), CPU tensors run segment_sum_plain."""
    n = ids.shape[0]
    flat = values.reshape(n, -1)
    if flat.device.type == "cpu":
        return segment_sum_plain(flat, ids, num_segments).reshape(num_segments, *values.shape[1:])
    if flat.dtype != torch.float32 or ids.device != flat.device or ids.ndim != 1:
        raise ValueError(f"segment_sum on {flat.device} takes float32 values and 1-D ids on the same device")
    if n >= 2**31 or num_segments >= 2**31:
        raise ValueError(f"segment_sum takes fewer than 2^31 rows and segments, got {n} and {num_segments}")
    flat = flat.contiguous()
    ids = ids.to(torch.int64).contiguous()
    out = torch.empty((num_segments, flat.shape[1]), dtype=torch.float32, device=flat.device)
    scratch = torch.empty(scratch_bytes(n, flat.shape[1], num_segments), dtype=torch.uint8, device=flat.device)
    with torch.cuda.device(flat.device):
        KERNEL.launch(flat.data_ptr(), ids.data_ptr(), n, flat.shape[1], num_segments, scratch.data_ptr(),
                      scratch.numel(), out.data_ptr(), torch.cuda.current_stream(flat.device).cuda_stream)
    return out.reshape(num_segments, *values.shape[1:])


def segment_sum_plain(flat: torch.Tensor, ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """The plain version: a float64 index_add_ of the (N, D) rows in order
    of N, cast to their dtype."""
    sums = torch.zeros((num_segments, flat.shape[1]), dtype=torch.float64, device=flat.device)
    return sums.index_add_(0, ids.long(), flat.double()).to(flat.dtype)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.rows = table.shape[0]
        return table[idx]

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        with span("table_grads"):
            return segment_sum(g, idx, ctx.rows), None


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table[idx] (idx int64) whose gradient with respect to the table is a
    deterministic segment_sum over the rows that read each table row."""
    return _GatherRows.apply(table, idx)
