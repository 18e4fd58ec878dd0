"""Bulk-copy probes on the card: the port of tools/dma_probe.py (P1-P3).

    python -m c3dgs_tpu_torch.tools.dma_probe      # on a machine with a CUDA card

The TPU tool asks which HBM->VMEM copies Mosaic accepts for the backward's
field layouts and what an in-kernel transpose costs. Here each probe is a
hand-written Hopper kernel in csrc/dma_probe.cu that copies with Hopper's
bulk async copy into shared memory, completed on an mbarrier:
  1. (128, 16) f32 slices of a (cap, 16) array; out = 2 x;
  2. (8, 512) blocks of a (T, 8, 512) array; out = x + 1;
  3. (16, 128) column chunks of a (16, nc*128) array: each chunk's sum of
     row0 + row5*row3 over its 128 lanes, with and without a shared-memory
     transpose to (128, 16); the (1, 128) output holds the last chunk's sum,
     as the TPU grid's last step leaves it. `probe3` reports the two times
     and the transpose's cost per chunk.

The wrappers (`scale_chunks`, `add_blocks`, `chunk_sums`) launch their
kernel for CUDA tensors and run the plain versions (`probe1_plain`,
`probe2_plain`, `probe3_plain`) for CPU tensors. The probes run on the card
unless given device="cpu". Where the TPU tool prints FAIL for a copy shape
that Mosaic refuses, a refused launch or a wrong result raises here, and
the entry point exits non-zero.
"""
from __future__ import annotations

import ctypes
import statistics
import sys
import time
from typing import Optional, Tuple

import torch

from .. import kernels
from ..device import DeviceLike, resolve_device

CHUNK = 128
P1_CAP = 1024  # tools/dma_probe.py:24
P2_TILES = 16  # :55
P3_CHUNKS = 4096  # :84
P3_RTOL = 1e-6  # the chunk sums' summation order differs from the plain version's

_SOURCE = "dma_probe.cu"
PROBE1_KERNEL = kernels.register(
    kernels.Kernel(
        name="dma_probe1",
        source=_SOURCE,
        symbol="c3dgs_dma_probe1",
        argtypes=(ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p),  # x, out, chunks, stream
        replaces="tools/dma_probe.py:22",
    )
)
PROBE2_KERNEL = kernels.register(
    kernels.Kernel(
        name="dma_probe2",
        source=_SOURCE,
        symbol="c3dgs_dma_probe2",
        argtypes=(ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p),  # x, out, tiles, stream
        replaces="tools/dma_probe.py:53",
    )
)
PROBE3_KERNEL = kernels.register(
    kernels.Kernel(
        name="dma_probe3",
        source=_SOURCE,
        symbol="c3dgs_dma_probe3",
        argtypes=(
            ctypes.c_void_p,  # x
            ctypes.c_longlong,  # row stride (nc*128)
            ctypes.c_int,  # nc
            ctypes.c_int,  # transpose
            ctypes.c_void_p,  # sums (nc,)
            ctypes.c_void_p,  # out (1, 128)
            ctypes.c_void_p,  # stream
        ),
        replaces="tools/dma_probe.py:80",
    )
)


def _check(x: torch.Tensor, shape_ok: bool, what: str) -> None:
    if x.dtype != torch.float32 or not x.is_contiguous() or not shape_ok:
        raise ValueError(f"expected a contiguous float32 {what}, got {x.dtype} {tuple(x.shape)}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    if x.device.type == "cuda" and x.data_ptr() % 16:
        raise ValueError("the bulk copies need a 16-byte aligned tensor")


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


# ---------------------------------------------------------------- P1
def probe1_plain(x: torch.Tensor) -> torch.Tensor:
    """2 x (exact in float32)."""
    return x * 2.0


def scale_chunks(x: torch.Tensor) -> torch.Tensor:
    """P1: 2 x for x (k*128, 16) f32, one bulk copy per 128-row chunk."""
    _check(x, x.ndim == 2 and x.shape[1] == 16 and x.shape[0] % CHUNK == 0, "(k*128, 16) array")
    if x.device.type == "cpu":
        return probe1_plain(x)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        PROBE1_KERNEL.launch(x.data_ptr(), out.data_ptr(), x.shape[0] // CHUNK, _stream(x))
    return out


# ---------------------------------------------------------------- P2
def probe2_plain(x: torch.Tensor) -> torch.Tensor:
    """x + 1."""
    return x + 1.0


def add_blocks(x: torch.Tensor) -> torch.Tensor:
    """P2: x + 1 for x (T, 8, 512) f32, one bulk copy per (8, 512) block."""
    _check(x, x.ndim == 3 and tuple(x.shape[1:]) == (8, 512), "(T, 8, 512) array")
    if x.device.type == "cpu":
        return probe2_plain(x)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        PROBE2_KERNEL.launch(x.data_ptr(), out.data_ptr(), x.shape[0], _stream(x))
    return out


# ---------------------------------------------------------------- P3
def probe3_plain(x: torch.Tensor, do_t: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """((1, 128) output, (nc,) chunk sums): each 128-column chunk's sum of
    row0 + row5*row3, from the (16, 128) rows or from their transpose
    (tools/dma_probe.py:95-101); the output broadcasts the last chunk's."""
    nc = x.shape[1] // CHUNK
    blocks = x.reshape(16, nc, CHUNK).permute(1, 0, 2)  # (nc, 16, 128)
    if do_t:
        ft = blocks.transpose(1, 2)  # (nc, 128, 16)
        acc = ft[:, :, 0] + ft[:, :, 5] * ft[:, :, 3]
    else:
        acc = blocks[:, 0] + blocks[:, 5] * blocks[:, 3]
    sums = acc.sum(1)
    return sums[-1].expand(1, CHUNK).clone(), sums


def chunk_sums(x: torch.Tensor, do_t: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """P3: ((1, 128) output, (nc,) chunk sums) for x (16, nc*128) f32, 16
    strided row copies per chunk on one mbarrier; `do_t` adds the
    shared-memory transpose."""
    _check(x, x.ndim == 2 and x.shape[0] == 16 and x.shape[1] % CHUNK == 0 and x.shape[1] > 0,
           "(16, nc*128) array")
    if x.device.type == "cpu":
        return probe3_plain(x, do_t)
    nc = x.shape[1] // CHUNK
    sums = torch.empty(nc, dtype=torch.float32, device=x.device)
    out = torch.empty((1, CHUNK), dtype=torch.float32, device=x.device)
    launch3(x, do_t, sums, out)
    return out, sums


def launch3(x, do_t: bool, sums, out) -> None:
    """One P3 launch on the current stream, on tensors that `chunk_sums` has
    validated (timing loops call it directly)."""
    with torch.cuda.device(x.device):
        PROBE3_KERNEL.launch(x.data_ptr(), x.shape[1], x.shape[1] // CHUNK, int(do_t), sums.data_ptr(),
                             out.data_ptr(), _stream(x))


# ------------------------------------------------------------- probes
def median_ms(fn, device: torch.device, reps: int = 20, warmup: int = 2) -> float:
    """Median time (ms) of fn(): CUDA events on the card, the host clock on
    the CPU."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        if device.type == "cuda":
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def probe1(x: Optional[torch.Tensor] = None, device: DeviceLike = None) -> str:
    """(128, 16) slices of a (cap, 16) array; x defaults to the tool's
    arange. Raises unless the result equals 2 x exactly."""
    dev = resolve_device(device)
    if x is None:
        x = torch.arange(P1_CAP * 16, dtype=torch.float32, device=dev).reshape(P1_CAP, 16)
    x = x.to(dev)
    if not torch.equal(scale_chunks(x).cpu(), probe1_plain(x.cpu())):
        raise AssertionError("probe1: the chunk copy's result differs from 2 x")
    return "ok"


def probe2(x: Optional[torch.Tensor] = None, device: DeviceLike = None) -> str:
    """(8, 512) blocks of a (T, 8, 512) array; x defaults to the tool's
    arange. Raises unless the result equals x + 1 exactly."""
    dev = resolve_device(device)
    if x is None:
        x = torch.arange(P2_TILES * 8 * 512, dtype=torch.float32, device=dev).reshape(P2_TILES, 8, 512)
    x = x.to(dev)
    if not torch.equal(add_blocks(x).cpu(), probe2_plain(x.cpu())):
        raise AssertionError("probe2: the block copy's result differs from x + 1")
    return "ok"


def probe3(x: Optional[torch.Tensor] = None, device: DeviceLike = None, reps: int = 20) -> str:
    """Time the (16, 128) chunk sums without and with the shared-memory
    transpose (median of `reps` after warm-up); x defaults to the tool's
    ones((16, 4096*128)). Raises unless both variants' outputs and chunk
    sums match the plain version within rtol 1e-6."""
    dev = resolve_device(device)
    if x is None:
        x = torch.ones((16, P3_CHUNKS * CHUNK), dtype=torch.float32, device=dev)
    x = x.to(dev)
    nc = x.shape[1] // CHUNK
    times = {}
    for do_t in (False, True):
        out, sums = chunk_sums(x, do_t)
        ref_out, ref_sums = probe3_plain(x.cpu(), do_t)
        for name, got, ref in (("output", out, ref_out), ("chunk sums", sums, ref_sums)):
            if not torch.allclose(got.cpu(), ref, rtol=P3_RTOL, atol=0.0):
                raise AssertionError(f"probe3 (transpose={do_t}): {name} differ from the plain version")
        if dev.type == "cuda":
            times[do_t] = median_ms(lambda: launch3(x, do_t, sums, out), dev, reps)
        else:
            times[do_t] = median_ms(lambda: probe3_plain(x, do_t), dev, reps)
    return (
        f"no-transpose {times[False]:.3f} ms, with {times[True]:.3f} ms"
        f" -> transpose cost {(times[True] - times[False]) / nc * 1e6:.1f} ns/chunk"
    )


PROBES = (
    ("probe1 (cap,16) slices", probe1),
    ("probe2 (8,512) blocks", probe2),
    ("probe3 transpose cost", probe3),
)


def main(device: DeviceLike = None) -> int:
    """Run the three probes, printing one line each as the TPU tool does;
    a failing probe raises."""
    dev = resolve_device(device)
    for name, fn in PROBES:
        print(name, "->", fn(device=dev), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
