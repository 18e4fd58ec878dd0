"""End-to-end convergence + compression evidence run (port of the JAX
package's tools/convergence_run.py).

Builds a synthetic dataset (clustered ground-truth splats with
view-dependent SH, rendered by the port), trains it with the port's train
CLI from a sparse noisy init with densification active, compresses the
TRAINED scene with the port's compress CLI and reports ratio @ delta-PSNR.
Both CLIs run in this process through their main(argv): the code a user
runs. A failed CLI raises, and the tool exits non-zero.

    python -m c3dgs_tpu_torch.tools.convergence_run [--fast] [--out_root DIR] [--device cpu]

Writes <out_root>/data (the dataset), <out_root>/model (the train and
compress CLIs' outputs) and, unless --no_compress, the evidence summary
<out_root>/RESULTS.md and <out_root>/convergence.json. Without --out_root
the root is output/torch/synth512_v3 (output/torch/synth512_v3_fast with
--fast). The round-5 protocol is the default: 60,000 GT splats, 512x512,
288 train / 32 test views, 220 epochs, held-out eval every epochs // 28,
saves at 1/2 and 3/4, then the headline compression (2048/2048
codebooks, keep quantiles 0.985/0.95, 3000 finetune steps).

Environment: C3DGS_FORCE_RETRAIN=1 trains again over an existing model
(otherwise a trained model is reused, so a compress-stage failure does not
cost the training).
"""
from __future__ import annotations

import argparse
import glob
import json
import math
import os
import shutil
from typing import Optional

import numpy as np
import torch

from ..cli import compress as compress_cli
from ..cli import train as train_cli
from ..device import DeviceLike, resolve_device
from ..models import gaussians as gmod
from . import datasets

# round-5 protocol: 288 train / 32 test views of the same generator, so the
# baseline converges to the scene, not to the views
DEFAULT_ROOT = os.path.join("output", "torch", "synth512_v3")


def make_gt_scene(n: int = 60_000, seed: int = 7, device: DeviceLike = None) -> gmod.GaussianScene:
    """The JAX tool's ground truth, from the same numpy draws: a ground
    slab (n // 3 splats) and 24 blobs, random DC colors, SH rest bands ~10x
    below DC, log scales kNN-initialized + log 1.4 + N(0, 0.25), opacity
    logits N(1.5, 1.2), SH degree 3, no quantization."""
    rng = np.random.default_rng(seed)
    n_ground = n // 3
    ground = np.stack(
        [rng.uniform(-2.5, 2.5, n_ground), rng.uniform(-1.05, -0.95, n_ground), rng.uniform(-2.5, 2.5, n_ground)],
        axis=1,
    ).astype(np.float32)
    n_blob = n - n_ground
    centers = rng.normal(size=(24, 3)).astype(np.float32)
    centers[:, 1] = np.abs(centers[:, 1]) * 0.6 - 0.4
    blob = centers[rng.integers(0, 24, n_blob)] + rng.normal(size=(n_blob, 3)).astype(np.float32) * 0.22
    pts = np.concatenate([ground, blob]).astype(np.float32)
    cols = rng.random(size=(n, 3)).astype(np.float32)
    scene = gmod.from_point_cloud(pts, cols, capacity=n, quantization=False, device=device)
    k = (scene.max_sh_degree + 1) ** 2
    dev = scene.device
    rest = rng.normal(size=(n, k - 1, 3)).astype(np.float32) * 0.06
    jitter = rng.normal(size=(n, 1)).astype(np.float32) * 0.25
    opacity = (rng.normal(size=(n, 1)) * 1.2 + 1.5).astype(np.float32)
    with torch.no_grad():
        return scene._replace(
            features_rest=torch.as_tensor(rest, device=dev),
            scaling_factor=scene.scaling_factor.detach() + math.log(1.4) + torch.as_tensor(jitter, device=dev),
            opacity=torch.as_tensor(opacity, device=dev),
            active_sh_degree=3,
        )


def compress_argv(fast: bool) -> list:
    """The compress CLI's flags: CPU-sized for --fast, else the round-5
    headline config (at <= 100k splats the codebooks and the dense keep
    rows dominate the npz, so 2^11 entries and keep quantiles raised to
    0.985 / 0.95; the QAT finetune absorbs the quality cost)."""
    if fast:
        return ["--finetune_iterations", "10", "--color_cluster_iterations", "3", "--gaussian_cluster_iterations", "5"]
    return ["--color_codebook_size", "2048", "--gaussian_codebook_size", "2048", "--color_keep_quantile", "0.985",
            "--gaussian_keep_quantile", "0.95", "--finetune_iterations", "3000"]


def summary(log: list, results: dict, times: dict, protocol: dict, model: str) -> tuple:
    """(markdown, JSON-able dict) of the run: the held-out curve, the
    training curve (about 24 rows and the last), the compression results
    and the stage times."""
    curve = [log[i] for i in range(0, len(log), max(1, len(log) // 24))]
    if log and curve[-1] is not log[-1]:
        curve.append(log[-1])
    evals = [e for e in log if "test_psnr" in e]
    epochs = protocol["epochs"]
    rows = "\n".join(
        f"| {e['epoch']} | {e['it']} | {e['ema_psnr']:.2f} | {e['ema_loss']:.4f} | {e['active']} | "
        f"{e['seconds']:.0f} |"
        for e in curve
    )
    eval_rows = "\n".join(f"| {e['epoch']} | {e['test_psnr']:.2f} | {e['ema_psnr']:.2f} |" for e in evals)
    n_gt, res = protocol["n_gt"], protocol["res"]
    md = f"""# Trained-scene convergence + compression (c3dgs_tpu_torch, {protocol['card']})

Protocol: `c3dgs_tpu_torch.tools.convergence_run` builds a {n_gt}-splat
ground-truth scene with view-dependent SH content, renders {res}x{res}
views ({protocol['n_train']} train / {protocol['n_test']} held-out test), then

1. `cli.train -s ... -m ... --eval --epochs {epochs}` from a sparse noisy
   init ({n_gt // 4} points), densification/pruning/opacity-reset/SH-warmup
   active, quantization-aware, held-out PSNR every {protocol['eval_every']} epochs;
2. `cli.compress -m ... {' '.join(protocol['compress_argv'])}`: sensitivity ->
   weighted-k-means VQ -> QAT finetune -> Morton int8 npz -> eval on the
   held-out test split.

## Held-out convergence (test PSNR vs train EMA)

| epoch | test PSNR | train EMA PSNR |
|---|---|---|
{eval_rows}

Evals shortly after an opacity-reset epoch (every
{max(1, 3000 * epochs // 30000)} epochs here, the reference's cadence) read
a scene whose opacities were just clamped to <= 0.01 and dip until Adam
re-inflates the survivors.

## Training curve (train PSNR is the per-step EMA)

| epoch | step | EMA PSNR | EMA loss | active splats | seconds |
|---|---|---|---|---|---|
{rows}

## Compression (held-out test split)

| metric | value |
|---|---|
| test PSNR (compressed) | {results.get('psnr'):.2f} |
| test PSNR (uncompressed) | {results.get('uncompressed_psnr'):.2f} |
| PSNR drop | {results.get('psnr_drop'):.3f} dB |
| test SSIM (compressed) | {results.get('ssim'):.4f} |
| test LPIPS | {results.get('lpips')} |
| uncompressed .ply size | {results.get('ply_size_bytes', 0) / 1e6:.1f} MB |
| compressed .npz size | {results.get('size_bytes', 0) / 1e6:.2f} MB |
| **compression ratio** | **{results.get('compression_ratio'):.1f}x** |

Stage times (times.json): {json.dumps(times)}

Full per-view metrics: {model}/vq/results.json, per_view.json.
"""
    seconds = log[-1]["seconds"] if log else None
    data = {
        "protocol": protocol,
        "held_out_curve": [{k: e[k] for k in ("epoch", "it", "test_psnr", "ema_psnr", "active")} for e in evals],
        "train_curve": curve,
        "train_seconds": seconds,
        "seconds_per_epoch": seconds / len(log) if log else None,
        "final_active": log[-1]["active"] if log else None,
        "results": results,
        "times": times,
    }
    return md, data


def main(argv: Optional[list] = None) -> Optional[dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--fast", action="store_true", help="small smoke config")
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--res", type=int, default=None, help="override (smokes)")
    ap.add_argument("--n_gt", type=int, default=None)
    ap.add_argument("--views", type=int, default=None)
    ap.add_argument("--out_root", type=str, default=None,
                    help=f"where the dataset, the model and the summary go (default {DEFAULT_ROOT}[_fast])")
    ap.add_argument("--seed", type=int, default=7, help="GT-scene generator seed")
    ap.add_argument("--no_compress", action="store_true",
                    help="train + held-out eval only; otherwise the HEADLINE compression config runs "
                    "(2^11 codebooks, raised keep-quantiles, 3000 finetune iters), not the compress CLI's defaults")
    ap.add_argument("--device", type=str, default=None, help="torch device (default cuda; a missing card is an error)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    res = args.res or (128 if args.fast else 512)
    n_gt = args.n_gt or (4000 if args.fast else 60_000)
    epochs = args.epochs or (30 if args.fast else 220)
    n_train = args.views or (12 if args.fast else 288)
    n_test = max(2, n_train // 9) if args.fast else 32
    root = args.out_root or (DEFAULT_ROOT + ("_fast" if args.fast else ""))
    data, model = os.path.join(root, "data"), os.path.join(root, "model")

    if not os.path.exists(os.path.join(data, "transforms_train.json")):
        scene = make_gt_scene(n=n_gt, seed=args.seed, device=dev)
        datasets.write_blender_dataset(data, res=res, num_train=n_train, num_test=n_test, fov=0.9, scene=scene,
                                       init_noise=0.08, init_subsample=4, device=dev)
        print(f"dataset written to {data}", flush=True)

    eval_every = max(1, epochs // 28)
    have_trained = glob.glob(os.path.join(model, "point_cloud", "iteration_*", "point_cloud.ply"))
    if have_trained and not os.environ.get("C3DGS_FORCE_RETRAIN"):
        print(f"trained model exists ({have_trained[-1]}); skipping train", flush=True)
    else:
        if os.path.exists(model):
            shutil.rmtree(model)
        # a mid-run save, so an interrupted run still leaves a trained
        # point cloud for the compression stage
        train_cli.main(["-s", data, "-m", model, "--eval", "--epochs", str(epochs), "--eval_every", str(eval_every),
                        "--save_epochs", str(max(1, epochs // 2)), str(max(1, 3 * epochs // 4)),
                        "--data_device", str(dev)])
    log_path = os.path.join(model, "train_log.jsonl")
    if args.no_compress:
        if not os.path.exists(log_path):
            print("(--no_compress) train_log.jsonl missing: the model was trained elsewhere; re-run with "
                  "C3DGS_FORCE_RETRAIN=1 to regenerate the eval curve")
            return None
        evals = [e for e in (json.loads(line) for line in open(log_path)) if "test_psnr" in e]
        if not evals:
            print("(--no_compress) no held-out eval entries: the model was trained without --eval; re-run with "
                  "C3DGS_FORCE_RETRAIN=1")
            return None
        print("(--no_compress) held-out eval curve:")
        for e in evals:
            print(f"  epoch {e['epoch']}: test {e['test_psnr']:.2f} dB (train EMA {e['ema_psnr']:.2f})")
        return None

    comp = compress_argv(args.fast)
    compress_cli.main(["-m", model, *comp])
    log = [json.loads(line) for line in open(log_path)]
    results = json.load(open(os.path.join(model, "vq", "results.json")))
    times = json.load(open(os.path.join(model, "vq", "times.json")))
    protocol = {"n_gt": n_gt, "res": res, "n_train": n_train, "n_test": n_test, "epochs": epochs,
                "eval_every": eval_every, "seed": args.seed, "fast": args.fast, "compress_argv": comp,
                "device": str(dev),
                "card": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"}
    md, data_out = summary(log, results, times, protocol, model)
    with open(os.path.join(root, "RESULTS.md"), "w") as f:
        f.write(md)
    with open(os.path.join(root, "convergence.json"), "w") as f:
        json.dump(data_out, f, indent=1)
    print(md[-1200:])
    print(f"summary written to {root}/RESULTS.md and {root}/convergence.json")
    return data_out


if __name__ == "__main__":
    main()
