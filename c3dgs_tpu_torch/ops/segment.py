"""Deterministic segment sums and the row gather whose backward uses them.

jax.ops.segment_sum is a fixed-order scatter. torch's index_add_ and
bincount(weights=) on CUDA add floats with atomics, so their sums (and a
k-means codebook built from them, or the gradient of a codebook table) can
change from run to run. Here the rows are brought together by one stable
sort of their segment ids, and each segment's sum is a difference of two
float64 prefix sums along the contiguous dimension: the same bits on every
run, and within float32 rounding of an exact sum.
"""
from __future__ import annotations

import torch


def segment_sum(values: torch.Tensor, ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """(N, ...) values, (N,) integer ids in [0, num_segments) -> the
    (num_segments, ...) sums of the rows of each id, in values' dtype. An
    empty segment sums to 0."""
    n = ids.shape[0]
    flat = values.reshape(n, -1)
    ids_s, order = torch.sort(ids.long(), stable=True)
    seg = torch.arange(num_segments, device=ids.device)
    starts = torch.searchsorted(ids_s, seg, right=False)
    ends = torch.searchsorted(ids_s, seg, right=True)
    x = flat[order].T.contiguous().to(torch.float64)  # (D, N): the scan runs along N
    cs = torch.cat([torch.zeros_like(x[:, :1]), torch.cumsum(x, 1)], 1)
    sums = cs[:, ends] - cs[:, starts]
    return sums.T.to(values.dtype).reshape(num_segments, *values.shape[1:])


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.rows = table.shape[0]
        return table[idx]

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        return segment_sum(g, idx, ctx.rows), None


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table[idx] (idx int64) whose gradient with respect to the table is a
    deterministic segment_sum over the rows that read each table row."""
    return _GatherRows.apply(table, idx)
