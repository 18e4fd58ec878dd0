"""The full compression pipeline at >= 1M splats (port of the JAX package's
tools/scale_compress_probe.py).

Runs the pipeline functions on a 1.2M-splat procedural scene:

  sensitivity (per-view |grad| accumulation over n_views 1080p cameras, K2)
  -> weighted k-means VQ (color batch 2^18, covariance batch 2^20)
  -> QAT finetune through the indexed renderer (K1 + K2; the blocked
     codebook-color path engages at >= 2^20 splats,
     train/trainer.py::BLOCKED_COLORS_MIN)
  -> Morton-sorted int8 npz -> eval,

with the reference's times.json stage split and the card's peak memory.

Ground truth is the scene's own pre-compression renders: a procedural
scene is "trained" by construction, and the compressed scene's PSNR
against them (fidelity_vs_uncompressed_psnr) is the preservation the
reference's <= 0.5 dB claim is about. The GT renders use the settings
the eval derives from the cameras' intrinsic, so the base scene's eval
renders are its GT: the base PSNR is infinite and psnr_drop null.

    python -m c3dgs_tpu_torch.tools.scale_compress_probe [--n 1200000] [--out_dir DIR] [--device cpu]

Writes <out_dir>/SCALE_COMPRESS.json (the JAX tool's keys, its times
unrounded, plus `card`) and <out_dir>/scale_compress.npz; the default
out_dir is output/torch.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
from types import SimpleNamespace
from typing import Optional

import numpy as np
import torch

from ..compress.pipeline import to_compressed
from ..config import CompressionParams, OptimizationParams
from ..device import DeviceLike, resolve_device
from ..eval.metrics import render_and_eval
from ..models import gaussians as gmod
from ..models import io_npz
from ..ops import camera_math
from ..render.capacity import CapacityPolicy
from ..render.types import settings_from_intrinsic
from ..train import finetune as finetune_mod
from ..train import trainer

PLY_FLOATS = 59  # a splat's f32 attributes in the 3DGS .ply


def make_scene(n: int = 1_200_000, seed: int = 23, device: DeviceLike = None) -> gmod.GaussianScene:
    """Trained-scene-like statistics from the JAX tool's numpy draws: a
    ground slab (n // 3) and 64 blobs, bimodal opacity logits N(1.0, 1.4),
    SH rest bands N(0, 0.05), kNN scales + log 0.8, SH degree 3, quantized
    with one observer step."""
    rng = np.random.default_rng(seed)
    n_ground = n // 3
    ground = np.stack(
        [rng.uniform(-3.0, 3.0, n_ground), rng.uniform(-1.05, -0.95, n_ground), rng.uniform(-3.0, 3.0, n_ground)],
        axis=1,
    ).astype(np.float32)
    centers = rng.normal(size=(64, 3)).astype(np.float32)
    centers[:, 1] = np.abs(centers[:, 1]) * 0.7 - 0.4
    blob = centers[rng.integers(0, 64, n - n_ground)] + rng.normal(size=(n - n_ground, 3)).astype(np.float32) * 0.25
    pts = np.concatenate([ground, blob]).astype(np.float32)
    cols = rng.random(size=(n, 3)).astype(np.float32)
    scene = gmod.from_point_cloud(pts, cols, capacity=n, quantization=True, device=device)
    k = (scene.max_sh_degree + 1) ** 2
    dev = scene.device
    rest = rng.normal(size=(n, k - 1, 3)).astype(np.float32) * 0.05
    opacity = (rng.normal(size=(n, 1)) * 1.4 + 1.0).astype(np.float32)
    with torch.no_grad():
        scene = scene._replace(
            features_rest=torch.as_tensor(rest, device=dev),
            scaling_factor=scene.scaling_factor.detach() + math.log(0.8),
            opacity=torch.as_tensor(opacity, device=dev),
            active_sh_degree=3,
        )
    return scene.update_observers()


def ring_extrinsics(n_views: int) -> list:
    """World-to-camera 7-vectors of n_views cameras on a ring of radius 4.5
    at height -0.7, looking at the origin with -y up."""
    evs = []
    for i in range(n_views):
        a = 2 * math.pi * i / n_views
        pos = np.asarray([4.5 * math.sin(a), -0.7, 4.5 * math.cos(a)], np.float32)
        fwd = -pos / np.linalg.norm(pos)
        up = np.asarray([0, -1, 0], np.float32)
        right = np.cross(up, fwd)
        right /= np.linalg.norm(right)
        upv = np.cross(fwd, right)
        rot = np.stack([right, upv, fwd], axis=0)
        m = np.eye(4, dtype=np.float32)
        m[:3, :3] = rot
        m[:3, 3] = -rot @ pos
        evs.append(camera_math.mat_to_extrinsic(m))
    return evs


def probe_settings(width: int, height: int) -> tuple:
    """(RasterSettings, FoV-radian intrinsic) of the probe's cameras: FoV
    1.2 both ways, the settings derived from the f32 intrinsic as
    render_and_eval derives them. (The JAX tool renders its GT at
    tan(0.6) of the double 0.6, 5e-8 off tan(f32(1.2) / 2): its base scene
    then reads a finite PSNR.)"""
    intrinsic = np.zeros((3, 3), np.float32)
    intrinsic[0, 0] = 1.2
    intrinsic[1, 1] = 1.2
    intrinsic[0, 2] = width
    intrinsic[1, 2] = height
    return settings_from_intrinsic(intrinsic, sh_degree=3), intrinsic


@torch.no_grad()
def render_capped(scene, ev, settings, policy: CapacityPolicy, bg, device: DeviceLike = None) -> dict:
    """One view through the capacity policy: render, and again at the grown
    bucket while the frame overflows (at most 6 renders); a frame past the
    binning's slot domain raises."""
    for _ in range(6):
        out = trainer.render_scene(scene, ev, policy.apply(settings), bg, device=device)
        if not policy.update(int(out["num_instances"]), int(out["overflow"])):
            break
    policy.check_whole(int(out["num_instances"]), int(out["overflow"]))
    return out


def summarize(n: int, n_views: int, res: str, finetune_iters: int, active: int, results: dict, base_psnr: float,
              timings: dict, peak_bytes: int, npz_path: str, card: str) -> dict:
    """SCALE_COMPRESS.json: the JAX tool's keys and accounting (the
    uncompressed size is the active splats' 59 f32 .ply attributes; the
    drop is null when the base PSNR is infinite), its times unrounded,
    plus `card`."""
    raw_bytes = int(active) * PLY_FLOATS * 4
    size = results.get("size_bytes")
    return {
        "n_splats": n,
        "active_after_prune": int(active),
        "views": n_views,
        "res": res,
        "finetune_iterations": finetune_iters,
        "psnr": results.get("psnr"),
        "uncompressed_psnr": base_psnr,
        "fidelity_vs_uncompressed_psnr": results.get("psnr"),
        "psnr_drop": base_psnr - results["psnr"] if np.isfinite(base_psnr) else None,
        "ssim": results.get("ssim"),
        "size_bytes": size,
        "raw_ply_bytes_equiv": raw_bytes,
        "compression_ratio_vs_ply": raw_bytes / size if size else None,
        "times": dict(timings),
        "peak_hbm_gb": round(peak_bytes / 2**30, 2),
        "npz": npz_path,
        "card": card,
    }


def main(argv: Optional[list] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1_200_000)
    ap.add_argument("--n_views", type=int, default=12)
    ap.add_argument("--res", type=str, default="1920x1080")
    ap.add_argument("--finetune_iters", type=int, default=1000)
    ap.add_argument("--out_dir", type=str, default=os.path.join("output", "torch"))
    ap.add_argument("--device", type=str, default=None, help="torch device (default cuda; a missing card is an error)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    on_card = dev.type == "cuda"
    w, h = (int(v) for v in args.res.split("x"))

    t0 = time.time()
    scene = make_scene(args.n, device=dev)
    print(f"# scene: {args.n} splats in {time.time() - t0:.1f}s", flush=True)
    settings, intrinsic = probe_settings(w, h)
    bg = torch.zeros(3, device=dev)
    policy = CapacityPolicy()
    t_all = time.time()
    cams = []
    for ev in ring_extrinsics(args.n_views):
        out = render_capped(scene, ev, settings, policy, bg, device=dev)
        cams.append(SimpleNamespace(extrinsic_vector=ev, intrinsic=intrinsic, original_image=out["render"],
                                    image_name="probe"))
    if on_card:
        torch.cuda.synchronize(dev)
    print(f"# GT renders: {time.time() - t_all:.1f}s, final bucket {policy.capacity} "
          f"({int(out['num_instances'])} instances in the last view)", flush=True)

    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    comp = CompressionParams(finetune_iterations=args.finetune_iters)
    timings = {}
    t0 = time.time()
    compressed = to_compressed(scene, cams, comp, timings=timings, device=dev)
    timings["clustering"] = time.time() - t0 - timings.get("sensitivity_calculation", 0.0)
    print(f"# VQ done: active={int(compressed.num_active)} ({timings['clustering']:.1f}s cluster)", flush=True)

    t0 = time.time()
    compressed = finetune_mod.finetune(compressed, cams, OptimizationParams(), args.finetune_iters,
                                       spatial_lr_scale=4.0, device=dev)
    if on_card:
        torch.cuda.synchronize(dev)
    timings["finetune"] = time.time() - t0

    t0 = time.time()
    os.makedirs(args.out_dir, exist_ok=True)
    npz_path = os.path.join(args.out_dir, "scale_compress.npz")
    compressed = io_npz.save_npz(compressed, npz_path, sort_morton=True, xyz_u16=True)
    timings["encode"] = time.time() - t0

    t0 = time.time()
    results = render_and_eval(compressed, cams, npz_path=npz_path, device=dev)
    base = render_and_eval(scene, cams, device=dev)
    timings["eval"] = time.time() - t0
    timings["total"] = sum(timings.values())
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    out = summarize(args.n, args.n_views, args.res, args.finetune_iters, int(compressed.num_active), results,
                    base["psnr"], timings, peak, npz_path,
                    torch.cuda.get_device_name(dev) if on_card else "cpu")
    with open(os.path.join(args.out_dir, "SCALE_COMPRESS.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
