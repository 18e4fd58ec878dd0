"""Benchmark: rasterize fwd+bwd ms per frame at 1080p on one card (port of
the repo's bench.py, the BASELINE.json north-star metric).

    python -m c3dgs_tpu_torch.tools.bench [--device cpu]

The workload is bench.py's exactly: its synthetic scene
(`scenes.bench_recipe_scene`: 300k gaussians from seed 0, kNN scales times
0.15, trained-opacity Beta(0.5, 0.35) statistics), `features_rest` zero
and the scene's active SH degree 0 (from_point_cloud's), so the frame
renders at degree 0 although the settings pass sh_degree=3, as
bench.py's do; the identity camera, 1920x1080 at tan 0.6 both ways; one
forward and the gradients of the L1 loss against a zero image with
respect to the seven scene parameters (`trainer.scene_params`). Knobs as
bench.py reads them: C3DGS_BENCH_N, C3DGS_BENCH_RES (WxH),
C3DGS_BENCH_OPACITY ("trained", else from_point_cloud's 0.1),
C3DGS_BENCH_CAP (a fixed slot bucket: no probe, no gate),
C3DGS_BENCH_ITERS (30), C3DGS_BENCH_BLOCKS (3).

Buckets (bench.py:89-125): a probe render gives the frame's instances and
grad_total; the slot bucket holds the instances plus one sentinel per
tile, the execution bucket grad_total, both at the policy's 5-bit
rounding. The gate: a render at those buckets must show overflow ==
grad_overflow == 0, or the run stops (no retry, no fallback).

Timing, the eager counterpart of bench.py:150-209: a block is k steps
whose gradient sums accumulate into one device scalar, read by the host
once at the block's end. `value` is the marginal cost per step, best of
BLOCKS, of a block of ITERS steps and one of 3*ITERS (the block edge
cancels); `dispatch_ms` is best of BLOCKS blocks of ITERS plain steps,
one sync each. K1 and K2 (the packed kernels) launch once per step: on a
card their launch counts must equal the steps.

`vs_baseline` divides 28 ms, the fwd+bwd envelope bench.py quotes for the
reference CUDA rasterizer at ~300k gaussians at 1080p on an RTX A5000: a
quoted figure, not a measurement. `floor_ms` keeps bench.py's terms and
counts, reckoned at the H100's peaks (`roofline.py`):
  pair_math: exec_rows * PIX (pixel, slot) pairs, each costing 75 fp32
    flops (forward 12 for the power + 11 for alpha and the blend; backward
    12 + 40) and 7 special-function results (forward exp, log1p, exp;
    backward exp, log1p, exp, reciprocal); the larger of the flops at
    67 TFLOP/s and the special functions at 132 SMs x 16 a clock at
    1980 MHz;
  row_ops: 2*cap + 2*exec gathered rows of 9 f32 fields, each read and
    written once (72 B) at 3.35 TB/s;
  sorts: 3*cap sorted rows, each an int64 key read and written and an
    int64 index written (24 B) at 3.35 TB/s.
Prints `# instances=...` (bench.py's line), a `# card ...` line with the
card's name, power limit and K1/K2 launches, then bench.py's one JSON
line with its keys; returns that record with the run's counts.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
from typing import Optional

import torch

from ..device import resolve_device
from ..models.gaussians import GaussianScene
from ..ops import losses
from ..render import tiles, tiles_packed
from ..render.capacity import CapacityPolicy
from ..render.types import RasterSettings
from ..train import trainer
from . import roofline
from .scenes import bench_recipe_scene

BASELINE_MS = 28.0
EV = [0, 0, 0, 1, 0, 0, 0]
PAIR_FLOPS = 12 + 11 + 12 + 40
PAIR_SFU = 3 + 4
ROW_BYTES = 2 * 9 * 4
SORT_ROW_BYTES = 3 * 8


def knobs() -> dict:
    """bench.py's environment knobs."""
    width, height = (int(v) for v in os.environ.get("C3DGS_BENCH_RES", "1920x1080").split("x"))
    cap = os.environ.get("C3DGS_BENCH_CAP")
    return dict(
        n=int(os.environ.get("C3DGS_BENCH_N", 300_000)),
        width=width,
        height=height,
        opacity_mode=os.environ.get("C3DGS_BENCH_OPACITY", "trained"),
        cap=int(cap) if cap else None,
        iters=int(os.environ.get("C3DGS_BENCH_ITERS", 30)),
        blocks=int(os.environ.get("C3DGS_BENCH_BLOCKS", 3)),
    )


def bench_scene(n: int, trained: bool, device) -> GaussianScene:
    """bench.py:34-62's scene: features_rest zero, active SH degree 0."""
    return bench_recipe_scene(n, 0, 0.15, trained=trained, device=device)


def base_settings(width: int, height: int, packed: bool = True) -> RasterSettings:
    return RasterSettings(width=width, height=height, tanfovx=math.tan(0.6), tanfovy=math.tan(0.6), sh_degree=3,
                          packed=packed)


@torch.no_grad()
def probe(scene, ev, settings: RasterSettings, bg) -> dict:
    """One render's counts: num_instances, grad_total, overflow,
    grad_overflow."""
    out = trainer.render_scene(scene, ev, settings, bg, device=scene.device)
    return {k: int(out[k]) for k in ("num_instances", "grad_total", "overflow", "grad_overflow")}


def exact_settings(scene, ev, base: RasterSettings, bg, grad_min: int = 0):
    """bench.py's probe-exact buckets: (settings, instances, grad_total)
    from a probe render at the default 2^21-slot bucket; the execution
    bucket holds max(grad_total, grad_min)."""
    p = probe(scene, ev, CapacityPolicy(initial=1 << 21).apply(base), bg)
    need, grad_need = p["num_instances"], p["grad_total"]
    settings = CapacityPolicy(initial=need + base.num_tiles, grad_initial=max(grad_need, grad_min)).apply(base)
    return settings, need, grad_need


def make_step(scene, ev, settings: RasterSettings, bg):
    """One eager fwd+bwd: the L1 loss against a zero image, its gradients
    to the seven scene parameters."""
    params = list(trainer.scene_params(scene).values())
    zeros = torch.zeros((3, settings.height, settings.width), device=scene.device)

    def step():
        out = trainer.render_scene(scene, ev, settings, bg, device=scene.device)
        return torch.autograd.grad(losses.l1_loss(out["render"], zeros), params)

    return step


def floor_ms(settings: RasterSettings) -> dict:
    """bench.py's floor terms for this frame at the H100's peaks (see the
    module docstring), unrounded."""
    cap_rows = settings.instance_capacity
    exec_rows = settings.grad_capacity or cap_rows
    pairs = exec_rows * tiles.PIX
    sfu_rate = roofline.SMS * roofline.SFU_PER_SM_CLOCK * roofline.MAX_SM_CLOCK_MHZ * 1e6
    pair = max(pairs * PAIR_FLOPS / roofline.FP32_FLOPS, pairs * PAIR_SFU / sfu_rate) * 1e3
    rows = (2 * cap_rows + 2 * exec_rows) * ROW_BYTES / roofline.HBM_BYTES_PER_S * 1e3
    sorts = 3 * cap_rows * SORT_ROW_BYTES / roofline.HBM_BYTES_PER_S * 1e3
    return {"pair_math": pair, "row_ops": rows, "sorts": sorts, "total": pair + rows + sorts}


def main(argv: Optional[list] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", type=str, default=None, help="torch device (default cuda; a missing card is an error)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    k = knobs()
    n, width, height = k["n"], k["width"], k["height"]
    scene = bench_scene(n, k["opacity_mode"] == "trained", dev)
    ev = torch.tensor(EV, dtype=torch.float32, device=dev)
    bg = torch.zeros(3, device=dev)
    base = base_settings(width, height)
    renders = 0  # K1 calls outside the steps
    if k["cap"]:
        settings = CapacityPolicy(initial=k["cap"]).apply(base)
        need = grad_need = None
    else:
        settings, need, grad_need = exact_settings(scene, ev, base, bg)
        print(f"# instances={need} -> capacity bucket {settings.instance_capacity};"
              f" grad_total={grad_need} -> {settings.grad_capacity}", flush=True)
        # the honesty gate: the benched frame is complete, nothing dropped
        chk = probe(scene, ev, settings, bg)
        renders += 2
        assert chk["overflow"] == 0 and chk["grad_overflow"] == 0, (
            f"bench frame degraded: overflow={chk['overflow']} grad_overflow={chk['grad_overflow']}")

    step = make_step(scene, ev, settings, bg)
    k1, k2 = tiles_packed.FORWARD_KERNEL, tiles_packed.BACKWARD_KERNEL
    l1, l2 = k1.launches, k2.launches
    grads = step()
    again = step()  # warm-up, and the determinism check
    repeatable = all(torch.equal(a, b) for a, b in zip(grads, again))
    float(again[0].sum())
    steps = 2

    def block(count: int) -> float:
        acc = torch.zeros((), device=dev)
        t0 = time.perf_counter()
        for _ in range(count):
            for g in step():
                acc = acc + g.sum()
        float(acc)  # the block's one host read
        return time.perf_counter() - t0

    iters, blocks, long_iters = k["iters"], k["blocks"], 3 * k["iters"]
    t_short = min(block(iters) for _ in range(blocks))
    t_long = min(block(long_iters) for _ in range(blocks))
    ms = (t_long - t_short) / (long_iters - iters) * 1e3
    steps += blocks * (iters + long_iters)

    best_d = float("inf")
    for _ in range(blocks):
        t0 = time.perf_counter()
        for _ in range(iters):
            grads = step()
        float(grads[0].sum())  # one sync, on the last step's gradient
        best_d = min(best_d, (time.perf_counter() - t0) / iters * 1e3)
    steps += blocks * iters

    launches = {k1.name: k1.launches - l1, k2.name: k2.launches - l2}
    card = roofline.card(dev)
    print(f"# card {card}; {steps} steps, launches {json.dumps(launches)}; gradients bitwise repeatable "
          f"{repeatable}", flush=True)
    if dev.type == "cuda":
        assert launches == {k1.name: steps, k2.name: steps}, (launches, steps)
    floor = floor_ms(settings)
    record = {
        "metric": f"rasterize_fwd_bwd_ms_per_frame_{width}x{height}_{n}g",
        "value": ms,
        "unit": "ms",
        "vs_baseline": BASELINE_MS / ms,
        "dispatch_ms": best_d,
        "opacity_mode": k["opacity_mode"],
        "floor_ms": floor,
        "vs_floor": floor["total"] / ms,
    }
    print(json.dumps(record), flush=True)
    return {
        "line": record,
        "card": card,
        "instances": need,
        "grad_total": grad_need,
        "buckets": [settings.instance_capacity, settings.grad_capacity],
        "steps": steps,
        "bitwise_repeatable": repeatable,
        "calls": {k1.name: renders + steps, k2.name: steps},
    }


if __name__ == "__main__":
    main()
