"""Adaptive instance-capacity policy (port of c3dgs_tpu/render/capacity.py).

Capacity lives in geometric buckets m * 2^e with a 5-bit mantissa (m in
16..31, at most 6.7% overshoot): grow when a frame overflows (and render
it again), shrink one mantissa step after sustained low usage. In the port
the buckets bound the binning's enumeration and sort sizes.

The slot bucket never grows past the binning's slot domain,
types.MAX_BINNING_CAP: a frame with more instances renders clamped (the
deepest-sorted tail dropped and counted in `overflow`) and is not rendered
again; `clamped` says so after update(). Callers that need the whole
frame (eval, sensitivity) raise through check_whole(); trainers go on and
print each clamped step. The JAX policy has no such ceiling: its next
render past 2^24 slots raises in resolve_caps (ROADMAP C).
"""
from __future__ import annotations

import dataclasses

from .types import MAX_BINNING_CAP, RasterSettings

MIN_CAPACITY = 1 << 16


class CapacityPolicy:
    def __init__(
        self,
        initial: int = 1 << 21,
        headroom: float = 1.3,
        shrink_patience: int = 50,
        grad_initial: int = 0,
    ):
        self.capacity = min(max(_bucket(initial), MIN_CAPACITY), MAX_BINNING_CAP)
        self.headroom = headroom
        self.shrink_patience = shrink_patience
        self._low_count = 0
        # per-instance gradient capacity (the packed path's execution
        # capacity), sized from the grad_total each frame reports in its
        # kernel family's own layout (per-tile: 128-aligned windows per
        # tile); 0 = the settings' default until a frame reports it
        self.grad_capacity = max(_bucket(grad_initial), MIN_CAPACITY) if grad_initial else 0
        self._grad_low = 0
        # the last frame overflowed at the ceiling: rendered clamped
        self.clamped = False

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
        self.clamped = False
        if overflow > 0 or need > self.capacity:
            grown = min(max(_bucket(max(need, self.capacity + 1)), MIN_CAPACITY), MAX_BINNING_CAP)
            self.clamped = overflow > 0 and grown == self.capacity
            rerender = overflow > 0 and not self.clamped
            self.capacity = grown
            self._low_count = 0
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

    def check_whole(self, num_instances: int, overflow: int) -> None:
        """Raise if the frame just fed to update() was clamped at the
        ceiling: its image and gradients miss its deepest instances."""
        if self.clamped:
            raise RuntimeError(
                f"a frame of {num_instances} instances overflows the binning's slot domain "
                f"(MAX_BINNING_CAP = {MAX_BINNING_CAP} slots): {overflow} instances would be dropped"
            )

    def note_clamped(self, where: str, num_instances: int, overflow: int) -> bool:
        """For trainers, which go on past a clamped frame: print one line
        if the frame just fed to update() was clamped at the ceiling.
        Returns `clamped`."""
        if self.clamped:
            print(f"[capacity] {where}: trained clamped at the slot domain ({self.capacity} slots), "
                  f"{overflow} of {num_instances} instances dropped", flush=True)
        return self.clamped


def _bucket(x: int) -> int:
    """Smallest m * 2^e >= x with a 5-bit mantissa m in 16..31."""
    if x <= 1:
        return 1
    e = max(int(x - 1).bit_length() - 5, 0)
    return -(-x // (1 << e)) << e
