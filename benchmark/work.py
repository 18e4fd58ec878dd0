"""The least time a frame's work can take on one NVIDIA H100, from the work
the reference counts (`reference.splat.work_counts`), never from the
program's buckets, capacities or tile shape.

Peaks: the NVIDIA H100 SXM data sheet's, frozen here from the port's
`tools/roofline.py`: 3.35 TB/s of HBM3, 67 TFLOP/s of fp32 on the CUDA
cores, 132 SMs with 16 special-function (MUFU) results per SM per clock at
1980 MHz. A least time is the largest of the bytes over the memory rate,
the fp32 flops over the fp32 peak and the special functions over their
rate: a lower bound, so a share of it cannot pass 100% unless the work is
counted too high or the time leaves some of it out.

Per-pair terms follow bench.py's floor (75 fp32 flops a pair over the
forward and the backward), re-counted on the reference's pairs:
- K1 (forward compositing): 12 flops and one exp per power pair, 11
  flops per blend pair (alpha, the transmittance test and update, three
  colour channels); bytes: each visible splat's 9 staged fields read once,
  the image (3 channels) written once.
- K2 (backward compositing): 12 flops and one exp per power pair, 40 flops
  and one reciprocal (the transmittance restored) per blend pair; bytes:
  the 9 fields read once, 9 gradient rows written once per visible splat,
  dL/dimage read once.
- A whole view: K1, the scene's parameters read once, and each needed
  instance's sort key (8 B) and value (4 B) written and read once.
- A whole training step: a view's work, K2, the target image read once, a
  gradient written per parameter and Adam's read and write of the
  parameter and both moments (8 parameter-sized passes in all with the
  forward's read).
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
SMS = 132
SFU_PER_SM_CLOCK = 16
MAX_SM_CLOCK_HZ = 1980e6
SFU_PER_S = SMS * SFU_PER_SM_CLOCK * MAX_SM_CLOCK_HZ

FIELD_BYTES = 9 * 4
SORT_ROW_BYTES = 2 * (8 + 4)
PAIR = {
    "k1": dict(power_flops=12, blend_flops=11, power_sfu=1, blend_sfu=0),
    "k2": dict(power_flops=12, blend_flops=40, power_sfu=1, blend_sfu=1),
}


def least_s(bytes_moved: float, flops: float, sfu: float) -> float:
    return max(bytes_moved / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S, sfu / SFU_PER_S)


def _pairs(kernel: str, w: dict):
    t = PAIR[kernel]
    flops = t["power_flops"] * w["power_pairs"] + t["blend_flops"] * w["blend_pairs"]
    sfu = t["power_sfu"] * w["power_pairs"] + t["blend_sfu"] * w["blend_pairs"]
    return flops, sfu


def k1_bytes(w: dict, pixels: int) -> int:
    return FIELD_BYTES * w["visible"] + 3 * 4 * pixels


def k2_bytes(w: dict, pixels: int) -> int:
    return 2 * FIELD_BYTES * w["visible"] + 3 * 4 * pixels


def k1_least_s(w: dict, pixels: int) -> float:
    return least_s(k1_bytes(w, pixels), *_pairs("k1", w))


def k2_least_s(w: dict, pixels: int) -> float:
    return least_s(k2_bytes(w, pixels), *_pairs("k2", w))


def view_least_s(w: dict, pixels: int, scene_bytes: int) -> float:
    """scene_bytes: the parameters, tables and index arrays of the scene."""
    return least_s(k1_bytes(w, pixels) + scene_bytes + SORT_ROW_BYTES * w["needed_instances"], *_pairs("k1", w))


def step_least_s(w: dict, pixels: int, scene_bytes: int, param_bytes: int) -> float:
    """param_bytes: the trainable floats of the scene (what Adam updates)."""
    f1, s1 = _pairs("k1", w)
    f2, s2 = _pairs("k2", w)
    moved = (k1_bytes(w, pixels) + k2_bytes(w, pixels) + scene_bytes + 7 * param_bytes
             + SORT_ROW_BYTES * w["needed_instances"] + 3 * 4 * pixels)
    return least_s(moved, f1 + f2, s1 + s2)
