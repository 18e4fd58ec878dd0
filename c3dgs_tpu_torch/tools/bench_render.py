"""Benchmark: forward-only (inference) render ms per frame at 1080p on one
card, dense and codebook-indexed (port of the repo's bench_render.py).

    python -m c3dgs_tpu_torch.tools.bench_render [--device cpu]

The scenes are bench_render.py's, from its one RNG stream
(bench_render.py:40-53): seed 0's points and colors (no opacity draw, so
from_point_cloud's 0.1 opacity), kNN scales times 0.15; then, from the
same generator, each splat's color and shape codebook index in
[0, 4096). The indexed scene takes the dense scene's first 4,096 rows
as its codebooks, as bench_render.py:51-60 does (so C3DGS_BENCH_N must
be at least 4,096). Settings: 1920x1080 at tan 0.6, sh_degree=3 (the
scenes' active degree is 0), inference=True. Codebook colors are
evaluated block by block past trainer.BLOCKED_COLORS_MIN splats, as in
the JAX package.

Per mode: a probe render at the default 2^21-slot bucket, then
probe-exact buckets (instances + one sentinel per tile, grad_total);
`value` is a block of ITERS renders whose image sums accumulate into one
device scalar, read by the host once, per render; `dispatch_ms` ITERS
renders with one sync on the last image. Each render is one K1 launch
through `render_scene(...)["render"]`. Knobs: C3DGS_BENCH_N (300,000),
C3DGS_BENCH_RES (1920x1080), C3DGS_BENCH_ITERS (50).

`vs_baseline` divides 4 ms, the forward envelope bench_render.py assumes
for a CUDA-class renderer at 300k gaussians at 1080p on an RTX A5000: a
quoted figure, not a measurement. Prints one JSON line per mode with
bench_render.py's keys, after a `# card ...` line; returns the lines with
the run's counts.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
from typing import Optional

import numpy as np
import torch

from ..device import resolve_device
from ..render import tiles_packed
from ..render.capacity import CapacityPolicy
from ..render.types import RasterSettings
from ..train import trainer
from . import roofline
from .scenes import bench_recipe_scene

BASELINE_MS = 4.0
CODEBOOK = 1 << 12  # the reference's default codebook size
EV = [0, 0, 0, 1, 0, 0, 0]


def scenes(n: int, device):
    """(dense, indexed, fidx, gidx) from bench_render.py's RNG stream."""
    if n < CODEBOOK:
        raise ValueError(f"the indexed scene takes its {CODEBOOK} codebook rows from the first splats; n = {n}")
    rng = np.random.default_rng(0)
    dense = bench_recipe_scene(n, rng, 0.15, trained=False, device=device)
    fidx = rng.integers(0, CODEBOOK, size=n)
    gidx = rng.integers(0, CODEBOOK, size=n)
    with torch.no_grad():
        features = torch.cat([dense.features_dc[:CODEBOOK], dense.features_rest[:CODEBOOK]], 1)
        indexed = dense.set_color_indexed(features, torch.as_tensor(fidx)).set_gaussian_indexed(
            dense.rotation[:CODEBOOK], dense.scaling[:CODEBOOK], torch.as_tensor(gidx))
    return dense, indexed, fidx, gidx


def settings_for(width: int, height: int) -> RasterSettings:
    return RasterSettings(width=width, height=height, tanfovx=math.tan(0.6), tanfovy=math.tan(0.6), sh_degree=3,
                          inference=True)


@torch.no_grad()
def exact_settings(scene, ev, base: RasterSettings, bg) -> RasterSettings:
    """bench_render.py's buckets: a probe at 2^21 slots, then the
    instances + one sentinel per tile and the probed execution rows."""
    out = trainer.render_scene(scene, ev, CapacityPolicy(initial=1 << 21).apply(base), bg, device=scene.device)
    return CapacityPolicy(initial=int(out["num_instances"]) + base.num_tiles,
                          grad_initial=int(out["grad_total"])).apply(base)


def main(argv: Optional[list] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", type=str, default=None, help="torch device (default cuda; a missing card is an error)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    n = int(os.environ.get("C3DGS_BENCH_N", 300_000))
    width, height = (int(v) for v in os.environ.get("C3DGS_BENCH_RES", "1920x1080").split("x"))
    iters = int(os.environ.get("C3DGS_BENCH_ITERS", 50))
    dense, indexed, _, _ = scenes(n, dev)
    ev = torch.tensor(EV, dtype=torch.float32, device=dev)
    bg = torch.zeros(3, device=dev)
    base = settings_for(width, height)
    k1 = tiles_packed.FORWARD_KERNEL
    card = roofline.card(dev)
    print(f"# card {card}", flush=True)
    lines, renders, start = [], 0, k1.launches
    for name, scene in (("dense", dense), ("indexed", indexed)):
        st = exact_settings(scene, ev, base, bg)

        def render():
            return trainer.render_scene(scene, ev, st, bg, device=dev)["render"]

        with torch.no_grad():
            float(render().sum())  # warm-up
            acc = torch.zeros((), device=dev)
            t0 = time.perf_counter()
            for _ in range(iters):
                acc = acc + render().sum()
            float(acc)  # the block's one host read
            ms = (time.perf_counter() - t0) / iters * 1e3
            t0 = time.perf_counter()
            for _ in range(iters):
                img = render()
            float(img.sum())
            dispatch_ms = (time.perf_counter() - t0) / iters * 1e3
        renders += 2 + 2 * iters
        line = {
            "metric": f"render_fwd_ms_per_frame_{width}x{height}_{n}g_{name}",
            "value": ms,
            "unit": "ms",
            "vs_baseline": BASELINE_MS / ms,
            "dispatch_ms": dispatch_ms,
        }
        print(json.dumps(line), flush=True)
        lines.append(line)
    launches = k1.launches - start
    if dev.type == "cuda":
        assert launches == renders, (launches, renders)
    return {"lines": lines, "card": card, "calls": {k1.name: renders},
            "blocked_colors": indexed.capacity >= trainer.BLOCKED_COLORS_MIN}


if __name__ == "__main__":
    main()
