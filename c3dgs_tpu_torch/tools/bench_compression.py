"""Compression ratio on a 100k-splat synthetic scene (port of the JAX
package's bench_compression.py).

The reference's protocol: the uncompressed 3DGS .ply's size against the
Morton-sorted int8 .npz's, and the PSNR of the compressed scene's renders
against the uncompressed scene's on held-out views (the reference's
<= 0.5 dB criterion). Sensitivity runs over the first 4 of 8 ring views,
the QAT finetune over all 8, the PSNR over the last 4.

    CR_N=100000 CR_FT=150 python -m c3dgs_tpu_torch.tools.bench_compression [--out_dir DIR] [--device cpu]

CR_N sets the splat count, CR_FT the finetune steps. Prints the JAX
script's lines; writes cr_uncompressed.ply, cr_compressed.npz and
bench_compression.json (the printed line's keys with the exact byte
counts, the splats kept and the card) under out_dir (default
output/torch/bench_compression).
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
from ..eval.metrics import render_full
from ..models import gaussians as gmod
from ..models import io_npz, io_ply
from ..ops import losses as L
from ..render.types import RasterSettings
from ..train import finetune as finetune_mod

SETTINGS = RasterSettings(width=800, height=800, tanfovx=math.tan(0.5), tanfovy=math.tan(0.5), sh_degree=3)


def make_scene(n: int = 100_000, device: DeviceLike = None) -> gmod.GaussianScene:
    """The JAX script's scene from its numpy draws (seed 0): 40 clusters
    around z = +6, smooth SH (rest bands N(0, 0.03)), kNN scales + log 0.5
    + N(0, 0.3), opacity logits N(1.0, 1.5), SH degree 3, quantized with
    one observer step."""
    rng = np.random.default_rng(0)
    centers = rng.normal(size=(40, 3)).astype(np.float32) * 2.0
    pts = centers[rng.integers(0, 40, n)] + rng.normal(size=(n, 3)).astype(np.float32) * 0.35
    pts[:, 2] += 6.0
    cols = rng.random(size=(n, 3)).astype(np.float32)
    scene = gmod.from_point_cloud(pts, cols, capacity=n, quantization=True, device=device)
    k = (scene.max_sh_degree + 1) ** 2
    dev = scene.device
    rest = rng.normal(size=(n, k - 1, 3)).astype(np.float32) * 0.03
    jitter = rng.normal(size=(n, 1)).astype(np.float32) * 0.3
    opacity = rng.normal(loc=1.0, scale=1.5, size=(n, 1)).astype(np.float32)
    with torch.no_grad():
        scene = scene._replace(
            features_rest=torch.as_tensor(rest, device=dev),
            scaling_factor=scene.scaling_factor.detach() + math.log(0.5) + torch.as_tensor(jitter, device=dev),
            opacity=torch.as_tensor(opacity, device=dev),
            active_sh_degree=3,
        )
    return scene.update_observers()


def ring_extrinsics() -> list:
    """8 world-to-camera 7-vectors: small rotations about identity on a
    ring of radius 0.6 (the cloud sits at z = +6 in front of them)."""
    evs = []
    for i in range(8):
        a = 2 * math.pi * i / 8
        ev = np.asarray([0.05 * math.sin(a), 0.05 * math.cos(a), 0.0, 1.0, 0.6 * math.sin(a), 0.6 * math.cos(a), 0.0],
                        np.float32)
        ev[:4] /= np.linalg.norm(ev[:4])
        evs.append(ev)
    return evs


def main(argv: Optional[list] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out_dir", type=str, default=os.path.join("output", "torch", "bench_compression"))
    ap.add_argument("--device", type=str, default=None, help="torch device (default cuda; a missing card is an error)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    n = int(os.environ.get("CR_N", 100_000))
    ft = int(os.environ.get("CR_FT", 150))

    scene = make_scene(n, device=dev)
    bg = torch.zeros(3, device=dev)
    S = SETTINGS
    intr = np.zeros((3, 3), np.float32)
    intr[0, 0] = 2 * math.atan(S.tanfovx)
    intr[1, 1] = 2 * math.atan(S.tanfovy)
    intr[0, 2] = S.width
    intr[1, 2] = S.height
    cams = []
    for ev in ring_extrinsics():
        # render_full grows the slot bucket on overflow, so no GT is clipped
        img = render_full(scene, ev, S, bg, device=dev)["render"]
        cams.append(SimpleNamespace(extrinsic_vector=ev, intrinsic=intr, original_image=img,
                                    image_name=f"v{len(cams) + 1}"))
    print("rendered baselines")

    os.makedirs(args.out_dir, exist_ok=True)
    ply_path = os.path.join(args.out_dir, "cr_uncompressed.ply")
    io_ply.save_gaussians_ply(scene, ply_path)
    ply_size = os.path.getsize(ply_path)
    print(f"uncompressed ply: {ply_size / 1e6:.2f} MB")

    t0 = time.time()
    compressed = to_compressed(scene, cams[:4], CompressionParams(), device=dev)
    print(f"compressed in {time.time() - t0:.0f}s")
    compressed = finetune_mod.finetune(compressed, cams, OptimizationParams(), iterations=ft, bg=bg, log_every=50,
                                       device=dev)

    npz_path = os.path.join(args.out_dir, "cr_compressed.npz")
    io_npz.save_npz(compressed.morton_sorted(), npz_path)
    npz_size = os.path.getsize(npz_path)

    psnrs = []
    for c in cams[4:]:
        out = render_full(compressed, c.extrinsic_vector, S, bg, device=dev)
        psnrs.append(float(L.psnr(out["render"], c.original_image)[0, 0]))
    kept = int(compressed.num_active)
    print(f"splats kept: {kept} / {n}")
    line = {
        "metric": f"compression_ratio_{n}g",
        "value": round(ply_size / npz_size, 2),
        "unit": "x",
        "psnr_vs_uncompressed_db": round(float(np.mean(psnrs)), 2),
        "ply_mb": round(ply_size / 1e6, 2),
        "npz_mb": round(npz_size / 1e6, 2),
    }
    print(json.dumps(line))
    full = dict(line, ratio=ply_size / npz_size, psnr=float(np.mean(psnrs)), psnrs=psnrs, ply_bytes=ply_size,
                size_bytes=npz_size, splats_kept=kept, n_splats=n, finetune_iterations=ft,
                card=torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu")
    with open(os.path.join(args.out_dir, "bench_compression.json"), "w") as f:
        json.dump(full, f, indent=1)
    return full


if __name__ == "__main__":
    main()
