"""The H100's peaks and the least time a piece of work can take on it.

Shared by chip_smoke.py (the kernels' bounds) and the bench tools
(`bench.py`'s floor, `profile_bench.py`'s device rows). The peaks are the
NVIDIA H100 SXM data sheet's: 3.35 TB/s of HBM3, 67 TFLOP/s of fp32 on the
CUDA cores, 132 SMs with 16 special-function (MUFU) results per SM per
clock, at most 1980 MHz.
"""
from __future__ import annotations

import subprocess

import torch

from ..render import tiles

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
SMS = 132
SFU_PER_SM_CLOCK = 16  # special-function (MUFU) results per SM per clock
MAX_SM_CLOCK_MHZ = 1980.0


def roofline(bytes_moved: int, sfu_ops: int, flops: int, clock_mhz: float):
    """The least time (ms) the card could take for this work: the largest of
    the bytes over the memory rate, the special-function operations over
    the SFUs' rate at the card's clock, and the fp32 flops over the fp32
    peak. Prints the three; returns (bound, what bounds it)."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_sfu = sfu_ops / (SMS * SFU_PER_SM_CLOCK * clock_mhz * 1e6) * 1e3
    t_flops = flops / FP32_FLOPS * 1e3
    print(f"  bound: bytes {t_bytes:.4f} ms ({bytes_moved} B), special functions {t_sfu:.4f} ms "
          f"({sfu_ops} ops at {clock_mhz} MHz), fp32 {t_flops:.4f} ms ({flops} flops)", flush=True)
    return max(t_bytes, t_sfu, t_flops), "bytes" if t_bytes >= max(t_sfu, t_flops) else "operations"


def fwd_work(walked: int, n_tiles: int, int_arrays: int, stats: dict):
    """The least work of a forward kernel (K1, K3) on a frame, as (bytes,
    special-function operations, fp32 flops): each walked slot's 9 staged
    f32 rows read once, `int_arrays` (T,) int arrays read, the (T, 8, PIX)
    blocks written; every walked (pixel, slot) pair's power in fp32, an
    exp for those the kernel's skip keeps, and a log1p and an exp more for
    those with alpha > 0. `stats` are the plain version's counts."""
    return (9 * 4 * walked + int_arrays * 4 * n_tiles + n_tiles * 8 * tiles.PIX * 4,
            stats["exp_pairs"] + 2 * stats["alpha_pairs"], 12 * stats["pairs"] + 11 * stats["alpha_pairs"])


def bwd_work(walked: int, n_tiles: int, grad_cols: int, int_arrays: int, stats: dict):
    """The least work of a backward kernel (K2, K4), as fwd_work's: each
    walked slot's 10 staged rows read once, 7 block rows per pixel read,
    16 gradient rows of `grad_cols` columns written, `int_arrays` (T,) int
    arrays read; every walked pair's power in fp32, an exp for those the
    skip keeps, and a log1p, an exp and a reciprocal per pair with
    alpha > 0."""
    return (10 * 4 * walked + 7 * 4 * n_tiles * tiles.PIX + 16 * 4 * grad_cols + int_arrays * 4 * n_tiles,
            stats["exp_pairs"] + 3 * stats["alpha_pairs"], 12 * stats["pairs"] + 40 * stats["alpha_pairs"])


def segment_sum_work(n: int, emitted: int, kept: int):
    """The least work of the exact reduction (csrc/segment_sum.cu), as
    fwd_work's: `emitted` perm entries and the (n,) emit_cum read once, 9
    f32 rows of each of the `kept` emissions read, the (n, 16) f32 rows
    written; one float64 add per kept value, no special functions (the
    float64 adds are far under any bound, so they count as no fp32 flops)."""
    return 4 * emitted + 4 * n + 9 * 4 * kept + 16 * 4 * n, 0, 0


def card(device: torch.device | str) -> str:
    """The card's name and power limit as nvidia-smi gives them
    (--query-gpu=name,power.limit), or "cpu"."""
    if torch.device(device).type != "cuda":
        return "cpu"
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                       capture_output=True, text=True, check=True, timeout=60)
    return r.stdout.strip().splitlines()[0]


def device_time_us(event) -> float:
    """The device time (us) the profiler gave a key_averages() row, itself
    only. The one place that names the attribute: a torch that renamed it
    raises here instead of reading as no device time."""
    return event.self_device_time_total


def device_busy_ms(fn, device: torch.device | str = "cuda"):
    """Run fn() under torch.profiler and return (the device time it saw, in
    ms; its rows as (name, ms, count), longest first). On a CUDA device the
    rows are its kernels; on the CPU, which is then the device, its ops'
    own CPU time (the profiler records no CUDA activity there)."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA] if cuda else [ProfilerActivity.CPU]
    with profile(activities=activities) as prof:
        fn()
        if cuda:
            torch.cuda.synchronize()
    if cuda:
        rows = [(e.key, device_time_us(e) / 1e3, e.count) for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA and device_time_us(e) > 0]
    else:
        rows = [(e.key, e.self_cpu_time_total / 1e3, e.count) for e in prof.key_averages()
                if e.self_cpu_time_total > 0]
    rows.sort(key=lambda r: r[1], reverse=True)
    return sum(r[1] for r in rows), rows
