"""The collectives the multi-device layer differentiates through, over one
process group (a mesh axis, parallel/mesh.py):

- `all_gather`: blocks of every rank concatenated along dim 0, in rank
  order; its backward is the reduce-scatter (each rank receives every
  rank's cotangent of its block and sums them in rank order);
- `psum`: the sum over the ranks; its backward passes each rank's
  cotangent through unchanged, so a caller that differentiates a per-rank
  partial of a summed loss sums the parameter gradients exactly once
  (parallel/sharded.py::make_hybrid_train_step);
- `sum_grads`: the identity whose backward is the psum, for inputs that
  every rank holds whole while each rank's cotangent is a partial;
- `all_to_all`: fixed-size (D, ...) blocks exchanged, no gradient.

They use only all_gather, all_to_all_single and all_reduce of
torch.distributed. With the gloo backend a CUDA tensor is staged through
pinned host memory, decided by the backend up front (`stage`): gloo's
support for CUDA tensors differs between its operations and releases, and
its CPU path is the one every release has. NCCL takes the CUDA tensors as
they are.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def _host(x: torch.Tensor, stage: bool) -> torch.Tensor:
    if not (stage and x.is_cuda):
        return x
    h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    h.copy_(x)
    return h


def _back(h: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return h if h.device == like.device else h.to(like.device)


def gather_blocks(x: torch.Tensor, group, size: int, stage: bool) -> torch.Tensor:
    """(k, ...) on each rank -> (size*k, ...), rank order."""
    if size == 1:
        return x.clone()
    src = _host(x.contiguous(), stage)
    parts = [torch.empty_like(src) for _ in range(size)]
    dist.all_gather(parts, src, group=group)
    return _back(torch.cat(parts), x)


def exchange(x: torch.Tensor, group, size: int, stage: bool) -> torch.Tensor:
    """(size, ...) blocks: block j goes to rank j; returns the (size, ...)
    blocks received, block i from rank i."""
    if size == 1:
        return x.clone()
    src = _host(x.contiguous(), stage)
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=group)
    return _back(out, x)


def reduce_sum(x: torch.Tensor, group, size: int, stage: bool) -> torch.Tensor:
    """The elementwise sum over the ranks (a new tensor)."""
    if size == 1:
        return x.clone()
    h = _host(x.contiguous(), stage)
    h = h.clone() if h is x else h
    dist.all_reduce(h, group=group)
    return _back(h, x)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return gather_blocks(x, axis.group, axis.size, axis.stage)

    @staticmethod
    def backward(ctx, g):
        a = ctx.axis
        recv = exchange(g.reshape(a.size, -1, *g.shape[1:]), a.group, a.size, a.stage)
        out = recv[0].clone()
        for i in range(1, a.size):  # rank order: deterministic
            out += recv[i]
        return out, None


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return reduce_sum(x, axis.group, axis.size, axis.stage)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumGrads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        a = ctx.axis
        return reduce_sum(g, a.group, a.size, a.stage), None


def all_gather(x: torch.Tensor, axis) -> torch.Tensor:
    return _AllGather.apply(x, axis)


def psum(x: torch.Tensor, axis) -> torch.Tensor:
    return _PSum.apply(x, axis)


def sum_grads(x: torch.Tensor, axis) -> torch.Tensor:
    return _SumGrads.apply(x, axis)


def all_to_all(x: torch.Tensor, axis) -> torch.Tensor:
    with torch.no_grad():
        return exchange(x, axis.group, axis.size, axis.stage)
