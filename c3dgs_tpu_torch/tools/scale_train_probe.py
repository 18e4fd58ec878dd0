"""Training at scale (port of the JAX package's tools/scale_train_probe.py):
thousands of train steps at >= 1M splats with densify, capacity growth
and opacity reset active, then the instance-capacity clamp on the
trained scene.

1. Ground truth: a 600k-splat procedural scene (a ground slab and 40
   blobs, view-dependent SH) rendered from n_views cameras on a ring at
   1920x1080.
2. Training: from 1M noisy points (capacity 1.25x, QAT on), `steps`
   trainer.train_step calls (K1 + K2) under a CapacityPolicy updated from
   each step's counters, with the JAX tool's cadence: densify every 150
   steps after step 200 until 0.7 * steps (no screen-size prune), the
   capacity doubled (grow_capacity keeps the Adam moments) when fewer
   than max(4096, active / 4) rows are free; an opacity reset every 900
   steps before 0.7 * steps; the SH degree up every steps / 4. An EMA of
   the step PSNR is logged every 50 steps.
3. The clamp experiment (clamp_probe.clamp_curve) on view 0 of the
   trained scene: exact against 95 / 85 / 70 / 50% of its true instances.

    python -m c3dgs_tpu_torch.tools.scale_train_probe [--steps 2000] [--out_dir DIR] [--device cpu]

Writes <out_dir>/SCALE_TRAIN.json (the JAX tool's keys, numbers
unrounded, plus `card`, `clamped_steps` and `max_overflow`) and
<out_dir>/scale_train_log.jsonl; the default out_dir is output/torch.
A step whose frame overflows its capacity bucket trains clamped, with its
deepest instances dropped (as in the JAX tool, the step is not rendered
again): below the binning's slot domain (MAX_BINNING_CAP) the policy
grows the bucket for the next frame, at it every such frame clamps. Each
clamped step prints a line, `clamped_steps` counts them and
`max_overflow` is the largest overflow of any step.
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

from ..config import OptimizationParams
from ..device import DeviceLike, resolve_device
from ..eval.metrics import render_full
from ..models import gaussians as gmod
from ..ops import camera_math
from ..render.capacity import CapacityPolicy
from ..render.types import RasterSettings
from ..train import trainer
from .clamp_probe import clamp_curve

DENSIFY_EVERY = 150
DENSIFY_FROM = 200
RESET_EVERY = 900
LOG_EVERY = 50
SPATIAL_LR_SCALE = 4.0


def schedule(it: int, steps: int) -> dict:
    """What the loop does after step `it` of `steps`, in the JAX tool's
    order: densify (with a capacity check first), reset the opacity, raise
    the SH degree, log."""
    densify_until = int(steps * 0.7)
    degree_every = max(1, steps // 4)
    return {
        "densify": DENSIFY_FROM < it < densify_until and it % DENSIFY_EVERY == 0,
        "reset": it > 0 and it % RESET_EVERY == 0 and it < densify_until,
        "degree": it > 0 and it % degree_every == 0,
        "log": it % LOG_EVERY == 0 or it == steps - 1,
    }


def gt_arrays(rng: np.random.Generator, n: int) -> dict:
    """The GT scene's numpy draws, in the JAX tool's order: a ground slab
    (n // 3 points), 40 blob centres and the blobs, colors, then (after
    from_point_cloud) SH rest bands N(0, 0.05) and opacity logits
    N(1.2, 1.2)."""
    n_g = n // 3
    ground = np.stack(
        [rng.uniform(-3, 3, n_g), rng.uniform(-1.1, -0.9, n_g), rng.uniform(-3, 3, n_g)], axis=1
    ).astype(np.float32)
    centers = rng.normal(size=(40, 3)).astype(np.float32)
    centers[:, 1] = np.abs(centers[:, 1]) * 0.7 - 0.4
    blob = centers[rng.integers(0, 40, n - n_g)] + rng.normal(size=(n - n_g, 3)).astype(np.float32) * 0.18
    pts = np.concatenate([ground, blob]).astype(np.float32)
    cols = rng.random(size=(n, 3)).astype(np.float32)
    rest = rng.normal(size=(n, 15, 3)).astype(np.float32) * 0.05
    opacity = (rng.normal(size=(n, 1)) * 1.2 + 1.2).astype(np.float32)
    return dict(pts=pts, cols=cols, rest=rest, opacity=opacity)


def make_gt_scene(a: dict, device: DeviceLike) -> gmod.GaussianScene:
    scene = gmod.from_point_cloud(a["pts"], a["cols"], capacity=len(a["pts"]), quantization=False, device=device)
    with torch.no_grad():
        scene.features_rest.copy_(torch.as_tensor(a["rest"]))
        scene.opacity.copy_(torch.as_tensor(a["opacity"]))
    scene.active_sh_degree = 3
    return scene


def init_arrays(rng: np.random.Generator, n: int):
    """The noisy init: n points N(0, 1) stretched 2.4x in x and z, y * 0.8
    - 0.2, uniform colors."""
    pts = rng.normal(size=(n, 3)).astype(np.float32)
    pts[:, 0] *= 2.4
    pts[:, 2] *= 2.4
    pts[:, 1] = pts[:, 1] * 0.8 - 0.2
    return pts, rng.random(size=(n, 3)).astype(np.float32)


def cam(theta: float, r: float = 5.0, y: float = 1.2) -> np.ndarray:
    """World-to-camera 7-vector of a camera at angle theta on a ring of
    radius r at height y, looking at the origin."""
    eye = np.array([r * math.sin(theta), y, r * math.cos(theta)], np.float32)
    fwd = -eye / np.linalg.norm(eye)
    up = np.array([0, 1, 0], np.float32)
    right = np.cross(up, fwd)
    right /= np.linalg.norm(right)
    up2 = np.cross(fwd, right)
    r_w2c = np.stack([right, up2, fwd])
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = r_w2c
    m[:3, 3] = -r_w2c @ eye
    return camera_math.mat_to_extrinsic(m)


def main(argv: Optional[list] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--n_init", type=int, default=1_000_000)
    ap.add_argument("--n_gt", type=int, default=600_000)
    ap.add_argument("--n_views", type=int, default=12)
    ap.add_argument("--res", type=str, default="1920x1080")
    ap.add_argument("--out_dir", type=str, default=os.path.join("output", "torch"),
                    help="artifact directory (the committed TPU records under output/ are never overwritten)")
    ap.add_argument("--device", type=str, default=None, help="torch device (default cuda; a missing card is an error)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    w, h = (int(v) for v in args.res.split("x"))
    rng = np.random.default_rng(11)

    settings = RasterSettings(width=w, height=h, tanfovx=math.tan(0.5), tanfovy=math.tan(0.32), sh_degree=3)
    bg = torch.zeros(3, device=dev)
    gt_scene = make_gt_scene(gt_arrays(rng, args.n_gt), dev)
    evs = [cam(2 * math.pi * i / args.n_views) for i in range(args.n_views)]
    # a modest first bucket: render_full probes and grows on overflow
    gt_policy = CapacityPolicy(initial=min(1 << 22, 16 * max(args.n_gt, args.n_init)))
    print("rendering ground-truth views...", flush=True)
    with torch.no_grad():
        gts = [render_full(gt_scene, e, settings, bg, gt_policy, device=dev)["render"] for e in evs]
    del gt_scene

    pts0, cols0 = init_arrays(rng, args.n_init)
    cap0 = int(args.n_init * 1.25) // 128 * 128
    scene = gmod.from_point_cloud(pts0, cols0, capacity=cap0, quantization=True, device=dev)
    scene.active_sh_degree = 0
    opt = OptimizationParams()
    state = trainer.create_train_state(scene, opt, spatial_lr_scale=SPATIAL_LR_SCALE, device=dev)
    # the bucket scaled to the scene, so small configurations do not pay
    # a 4M-slot domain
    capacity = CapacityPolicy(initial=min(1 << 22, 16 * args.n_init))

    os.makedirs(args.out_dir, exist_ok=True)
    log_path = os.path.join(args.out_dir, "scale_train_log.jsonl")
    ema_psnr = None
    grew = clamped = max_overflow = 0
    t0 = time.time()
    with open(log_path, "w") as log_f:
        for it in range(args.steps):
            ev, gt = evs[it % len(evs)], gts[it % len(gts)]
            state, metrics = trainer.train_step(state, ev, gt, capacity.apply(settings), bg, opt, SPATIAL_LR_SCALE,
                                                device=dev)
            n_inst, overflow = int(metrics["num_instances"]), int(metrics["overflow"])
            capacity.update(n_inst, overflow, int(metrics["grad_total"]), int(metrics["grad_overflow"]))
            if not capacity.note_clamped(f"step {it}", n_inst, overflow) and overflow:
                print(f"[capacity] step {it}: trained clamped below the ceiling, {overflow} of {n_inst} instances "
                      f"dropped; the next frame renders at bucket {capacity.capacity}", flush=True)
            clamped += overflow > 0
            max_overflow = max(max_overflow, overflow)
            psnr = float(metrics["psnr"])
            ema_psnr = psnr if ema_psnr is None else 0.95 * ema_psnr + 0.05 * psnr
            todo = schedule(it, args.steps)
            if todo["densify"]:
                n_act = int(state.scene.num_active)
                if state.scene.capacity - n_act < max(4096, n_act // 4):
                    state = trainer.grow_capacity(state, state.scene.capacity * 2, device=dev)
                    grew += 1
                # no screen-size prune: the reference's 20 px threshold
                # assumes a 30k-step schedule (the JAX tool's reasoning)
                state, _ = trainer.densify_step(state, SPATIAL_LR_SCALE, opt, max_screen_size=None, device=dev)
            if todo["reset"]:
                state = trainer.reset_opacity_step(state, device=dev)
            if todo["degree"]:
                state.scene.oneup_sh_degree()
            if todo["log"]:
                rec = {
                    "step": it,
                    "ema_psnr": ema_psnr,
                    "active": int(state.scene.num_active),
                    "capacity": state.scene.capacity,
                    "instances": int(metrics["num_instances"]),
                    "seconds": time.time() - t0,
                }
                log_f.write(json.dumps(rec) + "\n")
                log_f.flush()
                print(rec, flush=True)

    true_inst, rows = clamp_curve(state.scene, evs[0], capacity.apply(settings), settings, bg, device=dev)
    out = {
        "steps": args.steps,
        "resolution": args.res,
        "final_active": int(state.scene.num_active),
        "final_capacity": state.scene.capacity,
        "capacity_growths": grew,
        "final_ema_psnr": ema_psnr,
        "seconds_total": time.time() - t0,
        "true_instances_view0": true_inst,
        "clamp_experiment": [{"capacity_fraction": f, "dropped": d, "psnr_vs_exact": p} for f, d, p in rows],
        "log": log_path,
        "card": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "clamped_steps": clamped,
        "max_overflow": max_overflow,
    }
    with open(os.path.join(args.out_dir, "SCALE_TRAIN.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
