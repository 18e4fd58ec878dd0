"""Convergence robustness: 3 seeds x 2 scene configs (port of the JAX
package's tools/robustness_runs.py).

Runs the port's convergence tool (c3dgs_tpu_torch.tools.convergence_run)
with --no_compress, in this process, on six small-budget (scene, seed)
configs, then collects each run's held-out eval curve and final test PSNR
into <out_root>/ROBUSTNESS.json and prints a markdown table. A run counts
as DIVERGED if its final test PSNR is NaN or below the background-only
floor (~8 dB on these scenes).

Scene A is the headline generator (ground slab + blobs, 60k splats) at a
reduced budget; scene B a sparser 20k-splat variant of it. Budgets are
small (res 256, 64 views, 60 epochs): the claim under test is "the
densify schedule converges from a noisy sparse init for every seed", not
peak quality.

    python -m c3dgs_tpu_torch.tools.robustness_runs [--only A7,B21] [--out_root DIR] [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Optional

from ..device import resolve_device
from . import convergence_run

DEFAULT_ROOT = os.path.join("output", "torch", "robust")
DIVERGED_BELOW_DB = 8.0

CONFIGS = [{"scene": "A", "n_gt": 60_000, "seed": s} for s in (7, 21, 99)] + [
    {"scene": "B", "n_gt": 20_000, "seed": s} for s in (7, 21, 99)
]


def run_row(cfg: dict, log: list) -> dict:
    """One config's row from its train_log.jsonl entries."""
    evals = [e for e in log if "test_psnr" in e]
    final = evals[-1] if evals else {}
    fp = float(final.get("test_psnr", float("nan")))
    return {
        "scene": cfg["scene"],
        "seed": cfg["seed"],
        "n_gt": cfg["n_gt"],
        "final_test_psnr": fp,
        "final_train_ema": float(final.get("ema_psnr", float("nan"))),
        "eval_curve": [{"epoch": e["epoch"], "test_psnr": e["test_psnr"]} for e in evals],
        "diverged": not (fp == fp and fp > DIVERGED_BELOW_DB),
    }


def main(argv: Optional[list] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--res", type=int, default=256)
    ap.add_argument("--views", type=int, default=64)
    ap.add_argument("--epochs", type=int, default=60)
    ap.add_argument("--only", type=str, default="", help="e.g. A7,B21")
    ap.add_argument("--out_root", type=str, default=DEFAULT_ROOT, help="one folder per config, and ROBUSTNESS.json")
    ap.add_argument("--device", type=str, default=None, help="torch device (default cuda; a missing card is an error)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    rows = []
    for cfg in CONFIGS:
        tag = f"{cfg['scene']}{cfg['seed']}"
        if args.only and tag not in args.only.split(","):
            continue
        root = os.path.join(args.out_root, tag)
        argv_run = ["--no_compress", "--seed", str(cfg["seed"]), "--out_root", root, "--res", str(args.res),
                    "--views", str(args.views), "--epochs", str(args.epochs), "--n_gt", str(cfg["n_gt"]),
                    "--device", str(dev)]
        print(f"=== {tag}: convergence_run {' '.join(argv_run)}", flush=True)
        convergence_run.main(argv_run)
        log = [json.loads(line) for line in open(os.path.join(root, "model", "train_log.jsonl"))]
        rows.append(run_row(cfg, log))
        print(f"=== {tag}: final test {rows[-1]['final_test_psnr']:.2f} dB "
              f"({'DIVERGED' if rows[-1]['diverged'] else 'ok'})", flush=True)

    res = {
        "protocol": {
            "res": args.res,
            "views": args.views,
            "epochs": args.epochs,
            "harness": "c3dgs_tpu_torch.tools.convergence_run --no_compress (the port's CLIs)",
        },
        "runs": rows,
        "any_diverged": any(r["diverged"] for r in rows),
    }
    os.makedirs(args.out_root, exist_ok=True)
    with open(os.path.join(args.out_root, "ROBUSTNESS.json"), "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps({k: v for k, v in res.items() if k != "runs"}))
    print("| scene | seed | final test PSNR | train EMA |")
    print("|---|---|---|---|")
    for r in rows:
        print(f"| {r['scene']} ({r['n_gt'] // 1000}k) | {r['seed']} | {r['final_test_psnr']:.2f} | "
              f"{r['final_train_ema']:.2f} |")
    return res


if __name__ == "__main__":
    main()
