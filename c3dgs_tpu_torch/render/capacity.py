"""Adaptive instance-capacity policy (port of c3dgs_tpu/render/capacity.py).

Capacity lives in geometric buckets m * 2^e with a 5-bit mantissa (m in
16..31, at most 6.7% overshoot): grow when a frame overflows (and render
it again), shrink one mantissa step after sustained low usage. In the port
the buckets bound the binning's enumeration and sort sizes.
"""
from __future__ import annotations

import dataclasses

from .types import RasterSettings

MIN_CAPACITY = 1 << 16


class CapacityPolicy:
    def __init__(
        self,
        initial: int = 1 << 21,
        headroom: float = 1.3,
        shrink_patience: int = 50,
        grad_initial: int = 0,
    ):
        self.capacity = max(_bucket(initial), MIN_CAPACITY)
        self.headroom = headroom
        self.shrink_patience = shrink_patience
        self._low_count = 0
        # per-instance gradient capacity (the packed path's execution
        # capacity), sized from the grad_total each frame reports in its
        # kernel family's own layout (per-tile: 128-aligned windows per
        # tile); 0 = the settings' default until a frame reports it
        self.grad_capacity = max(_bucket(grad_initial), MIN_CAPACITY) if grad_initial else 0
        self._grad_low = 0

    def apply(self, settings: RasterSettings) -> RasterSettings:
        return dataclasses.replace(
            settings,
            instance_capacity=self.capacity,
            grad_capacity=self.grad_capacity,
        )

    def update(
        self,
        num_instances: int,
        overflow: int,
        grad_total: int | None = None,
        grad_overflow: int = 0,
    ) -> bool:
        """Feed one frame's stats. Returns True if the frame overflowed and
        should be rendered again at the new (grown) capacity."""
        rerender = False
        need = int(num_instances * self.headroom)
        if overflow > 0 or need > self.capacity:
            self.capacity = max(_bucket(max(need, self.capacity + 1)), MIN_CAPACITY)
            self._low_count = 0
            rerender = overflow > 0
        elif need < self.capacity * 3 // 4 and self.capacity > MIN_CAPACITY:
            self._low_count += 1
            if self._low_count >= self.shrink_patience:
                e = max(int(self.capacity).bit_length() - 5, 0)
                self.capacity = max(self.capacity - (1 << e), MIN_CAPACITY)
                self._low_count = 0
        else:
            self._low_count = 0

        if grad_total is not None:
            need_g = max(int(grad_total * self.headroom), MIN_CAPACITY)
            if grad_overflow > 0 or (self.grad_capacity and need_g > self.grad_capacity):
                self.grad_capacity = _bucket(max(need_g, self.grad_capacity + 1))
                self._grad_low = 0
                rerender = rerender or grad_overflow > 0
            elif self.grad_capacity == 0:
                self.grad_capacity = _bucket(need_g)
            elif need_g < self.grad_capacity * 3 // 4:
                self._grad_low += 1
                if self._grad_low >= self.shrink_patience:
                    e = max(int(self.grad_capacity).bit_length() - 5, 0)
                    self.grad_capacity = max(self.grad_capacity - (1 << e), MIN_CAPACITY)
                    self._grad_low = 0
            else:
                self._grad_low = 0
        return rerender


def _bucket(x: int) -> int:
    """Smallest m * 2^e >= x with a 5-bit mantissa m in 16..31."""
    if x <= 1:
        return 1
    e = max(int(x - 1).bit_length() - 5, 0)
    return -(-x // (1 << e)) << e
