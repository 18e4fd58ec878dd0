"""The image cost of the instance-capacity clamp (port of the JAX package's
tools/clamp_probe.py).

The binning's slot domain caps at 2^24 (render/types.py::MAX_BINNING_CAP);
a frame that emits more instances drops the deepest-sorted tail. This
measures the image cost directly: a dense 1.5M-splat 1920x1080 frame
rendered at full capacity (exact) against the same frame with
instance_capacity forced to 95 / 85 / 70 / 50% of its true instance
count, grad_capacity 0. The clamp drops the largest (tile | depth) sort
keys, the farthest instances of the last tiles, whatever the frame's
size, so the PSNR-against-fraction curve transfers to the 2^24 ceiling.
Each render runs K1. The dropped count is the instances and one sentinel
per tile past the clamped slots: true instances - capacity + tiles.

    python -m c3dgs_tpu_torch.tools.clamp_probe [--out_dir DIR] [--device cpu]

Writes <out_dir>/CLAMP_PROBE.json (the JAX tool's keys, PSNRs unrounded,
plus `card`); the default out_dir is output/torch.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
from typing import Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..render.capacity import CapacityPolicy
from ..render.types import RasterSettings
from ..train import trainer
from .scenes import bench_recipe_scene

FRACTIONS = (0.95, 0.85, 0.70, 0.50)
N = 1_500_000
SETTINGS = RasterSettings(width=1920, height=1080, tanfovx=math.tan(0.6), tanfovy=math.tan(0.6), sh_degree=3)
EV = np.asarray([0, 0, 0, 1, 0, 0, 0], np.float32)


def clamped_settings(full: RasterSettings, true_instances: int, fraction: float,
                     grad_capacity: Optional[int] = None) -> RasterSettings:
    """`full` with instance_capacity at `fraction` of the true instances
    (128-aligned down) and, if given, grad_capacity."""
    st = dataclasses.replace(full, instance_capacity=int(true_instances * fraction) // 128 * 128)
    return st if grad_capacity is None else dataclasses.replace(st, grad_capacity=grad_capacity)


@torch.no_grad()
def clamp_curve(scene, ev, probe_settings: RasterSettings, settings: RasterSettings, bg,
                grad_capacity: Optional[int] = None, device: DeviceLike = None):
    """The clamp experiment of both JAX tools: the true instance count from
    a render at `probe_settings`, the exact image at a bucket of 1.12x it,
    then one render per FRACTIONS entry at clamped_settings. Returns (true
    instances, [(fraction, instances dropped, PSNR against the exact image
    in dB)]). Raises if the exact frame does not fit the slot domain
    (the policy stops at MAX_BINNING_CAP): it then has no exact image."""
    true_inst = int(trainer.render_scene(scene, ev, probe_settings, bg, device=device)["num_instances"])
    full = CapacityPolicy(initial=int(true_inst * 1.12)).apply(settings)
    out = trainer.render_scene(scene, ev, full, bg, device=device)
    if int(out["overflow"]):
        raise RuntimeError(f"the exact frame overflows its {full.instance_capacity} slots: {true_inst} instances")
    exact = out["render"]
    rows = []
    for frac in FRACTIONS:
        out = trainer.render_scene(scene, ev, clamped_settings(full, true_inst, frac, grad_capacity), bg,
                                   device=device)
        mse = float(torch.mean((out["render"] - exact) ** 2))
        rows.append((frac, int(out["overflow"]), 10 * math.log10(1.0 / max(mse, 1e-12))))
        print(rows[-1], flush=True)
    return true_inst, rows


def main(argv: Optional[list] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out_dir", type=str, default=os.path.join("output", "torch"))
    ap.add_argument("--device", type=str, default=None, help="torch device (default cuda; a missing card is an error)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    scene = bench_recipe_scene(N, seed=4, scale=0.1, device=dev)
    bg = torch.zeros(3, device=dev)
    true_inst, rows = clamp_curve(scene, EV, CapacityPolicy(initial=1 << 23).apply(SETTINGS), SETTINGS, bg,
                                  grad_capacity=0, device=dev)
    report = {
        "n_gaussians": N,
        "true_instances": true_inst,
        "resolution": f"{SETTINGS.width}x{SETTINGS.height}",
        "note": (
            "clamp drops the largest (tile|depth) sort keys — the deepest "
            "instances of the last tiles; curve transfers to the 2^24 "
            "MAX_BINNING_CAP ceiling"
        ),
        "curve": [{"capacity_fraction": f, "instances_dropped": d, "psnr_vs_exact_dB": p} for f, d, p in rows],
        "card": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
    }
    os.makedirs(args.out_dir, exist_ok=True)
    with open(os.path.join(args.out_dir, "CLAMP_PROBE.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
