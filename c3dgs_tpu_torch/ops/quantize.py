"""Fake-quant forward ops (port of c3dgs_tpu/ops/quantize.py).

int8 per-tensor affine fake-quant with torch.ao's conventions (quant_min
-128, quant_max 127, scale = (max-min)/255, zero_point = clamp(round(qmin -
min/scale))) and the fp16 round trip. Only the forward is ported here, so
accessors of quantization=True scenes give the JAX values; the
straight-through gradients and `observe` come with the training slice.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

QMIN = -128
QMAX = 127


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


def fake_quant_affine(x: torch.Tensor, scale, zero_point) -> torch.Tensor:
    q = torch.clamp(torch.round(x / scale + zero_point), QMIN, QMAX)
    return (q - zero_point) * scale


def fake_quant(x: torch.Tensor, state: ObserverState) -> torch.Tensor:
    """Quantize-dequantize with the observer's current range; identity while
    the observer is uninitialized (torch FakeQuantize's default)."""
    scale, zp = qparams(state)
    return torch.where(state.initialized > 0.5, fake_quant_affine(x, scale, zp), x)


def fake_quant_half(x: torch.Tensor) -> torch.Tensor:
    """fp16 round trip (FakeQuantizationHalf's forward)."""
    return x.to(torch.float16).to(x.dtype)
