"""Quantization-aware training ops (port of c3dgs_tpu/ops/quantize.py).

int8 per-tensor affine fake-quant with torch.ao's conventions (quant_min
-128, quant_max 127, scale = (max-min)/255, zero_point = clamp(round(qmin -
min/scale))) and the fp16 round trip, both with straight-through
gradients; and the EMA min/max observer (MovingAverageMinMaxObserver,
averaging constant 0.01: the first batch sets the range, which always
includes 0).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

QMIN = -128
QMAX = 127
AVERAGING_CONSTANT = 0.01


class ObserverState(NamedTuple):
    """EMA min/max observer. `initialized` is 0.0 before the first batch."""

    min_val: torch.Tensor  # f32 scalar
    max_val: torch.Tensor  # f32 scalar
    initialized: torch.Tensor  # f32 scalar flag (0/1)


def init_observer(device=None, dtype=torch.float32) -> ObserverState:
    return ObserverState(
        torch.zeros((), dtype=dtype, device=device),
        torch.zeros((), dtype=dtype, device=device),
        torch.zeros((), dtype=dtype, device=device),
    )


def observe(state: ObserverState, x: torch.Tensor) -> ObserverState:
    """One observer update (MovingAverageMinMaxObserver.forward)."""
    new_min = torch.clamp(x.min(), max=0.0).to(state.min_val.dtype)
    new_max = torch.clamp(x.max(), min=0.0).to(state.max_val.dtype)
    c = AVERAGING_CONSTANT
    ema_min = state.min_val + c * (new_min - state.min_val)
    ema_max = state.max_val + c * (new_max - state.max_val)
    init = state.initialized > 0.5
    return ObserverState(
        torch.where(init, ema_min, new_min),
        torch.where(init, ema_max, new_max),
        torch.ones_like(state.initialized),
    )


def set_range(min_val, max_val, device=None) -> ObserverState:
    """An observer pinned to a known range (npz load path)."""
    lo = torch.clamp(torch.tensor(float(min_val), dtype=torch.float32, device=device), max=0.0)
    hi = torch.clamp(torch.tensor(float(max_val), dtype=torch.float32, device=device), min=0.0)
    return ObserverState(lo, hi, torch.ones((), dtype=torch.float32, device=device))


def qparams(state: ObserverState) -> tuple[torch.Tensor, torch.Tensor]:
    """(scale, zero_point) from the observer range, torch affine convention."""
    scale = (state.max_val - state.min_val) / float(QMAX - QMIN)
    scale = torch.clamp(scale, min=1e-12)
    zero_point = torch.clamp(torch.round(QMIN - state.min_val / scale), QMIN, QMAX)
    return scale, zero_point


class _FakeQuantAffine(torch.autograd.Function):
    """Quantize-dequantize; the gradient passes where the UNCLAMPED rounded
    value lies in [QMIN, QMAX] and is 0 elsewhere (torch's fake_quantize
    backward). scale and zero_point get no gradient."""

    @staticmethod
    def forward(ctx, x, scale, zero_point):
        q = torch.round(x / scale + zero_point)
        ctx.save_for_backward((q >= QMIN) & (q <= QMAX))
        return (torch.clamp(q, QMIN, QMAX) - zero_point) * scale

    @staticmethod
    def backward(ctx, g):
        (in_range,) = ctx.saved_tensors
        return torch.where(in_range, g, torch.zeros_like(g)), None, None


def fake_quant_affine(x: torch.Tensor, scale, zero_point) -> torch.Tensor:
    return _FakeQuantAffine.apply(x, scale, zero_point)


def fake_quant(x: torch.Tensor, state: ObserverState) -> torch.Tensor:
    """Quantize-dequantize with the observer's current range; identity while
    the observer is uninitialized (torch FakeQuantize's default)."""
    scale, zp = qparams(state)
    return torch.where(state.initialized > 0.5, fake_quant_affine(x, scale, zp), x)


class _FakeQuantHalf(torch.autograd.Function):
    """fp16 round trip with an identity gradient (FakeQuantizationHalf)."""

    @staticmethod
    def forward(ctx, x):
        return x.to(torch.float16).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g


def fake_quant_half(x: torch.Tensor) -> torch.Tensor:
    """fp16 round trip (FakeQuantizationHalf) with a straight-through
    gradient."""
    return _FakeQuantHalf.apply(x)
