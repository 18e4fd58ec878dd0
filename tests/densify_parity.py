"""Densification of both packages side by side on the CPU.

Runs the JAX package's tools/convergence_run.py and the port's
c3dgs_tpu_torch.tools.convergence_run with --no_compress on one Blender
folder of the tools' 60,000-splat ground truth (written once by the
port's writer and copied, so both train on the same PNGs), and prints
`active`, the train EMA PSNR and the held-out PSNR epoch by epoch with
the largest relative difference in `active`.

The run is the first --epochs epochs of a --full_epochs run: every train
CLI call gets `--iterations` (the budget the schedule is expressed in),
chosen so that densification, opacity resets and SH warm-up fall on the
full run's epochs (cli/train.py::epoch_schedule); --eval_every, if
given, is appended too and overrides the tool's. Each package trains in
a child process of this script, both at once; Python's `random` is
seeded alike in both.

    PYTHONPATH=. python tests/densify_parity.py --res 64 --views 60 --epochs 24 --out DIR
    PYTHONPATH=. python tests/densify_parity.py --res 256 --views 60 --epochs 13 --eval_every 100 --out DIR
"""
import argparse
import json
import os
import random
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def schedule_iterations(epochs: int, full_epochs: int) -> int:
    """The smallest --iterations whose schedule at `epochs` puts densify,
    opacity resets and SH warm-up on the epochs a `full_epochs` run does."""
    from c3dgs_tpu_torch.cli.train import epoch_schedule
    from c3dgs_tpu_torch.config import OptimizationParams

    full = epoch_schedule(OptimizationParams(epochs=full_epochs))
    keys = ("densify_from_epoch", "densification_interval", "opacity_reset_interval", "degree_up")
    for it in range(1, OptimizationParams().iterations + 1):
        cut = epoch_schedule(OptimizationParams(epochs=epochs, iterations=it))
        if all(cut[k] == full[k] for k in keys) and cut["densify_until_epoch"] >= min(epochs, full["densify_until_epoch"]):
            return it
    raise ValueError(f"no iteration budget maps {epochs} epochs onto a {full_epochs}-epoch schedule")


def run_side(side: str, root: str, tool_argv: list, extra: list) -> None:
    """One package's convergence_run --no_compress on `root`, every train
    CLI call given `extra`."""
    sys.path.insert(0, REPO)
    argv = ["--no_compress", *tool_argv, "--out_root", root]
    random.seed(0)
    if side == "jax":
        import importlib.util

        import jax

        jax.config.update("jax_platforms", "cpu")
        import train
        from c3dgs_tpu import config

        config.setup_jax_cache = lambda *a, **k: None
        spec = importlib.util.spec_from_file_location("jax_convergence_run", os.path.join(REPO, "tools",
                                                                                          "convergence_run.py"))
        tool = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(tool)
        # the tool's sh runs `python train.py ...`: run train.main in process
        tool.sh = lambda cmd, retries=2: train.main(cmd[2:] + extra)
        sys.argv = ["convergence_run.py", *argv]
        tool.main()
    else:
        import torch

        torch.set_num_threads(3)
        from c3dgs_tpu_torch.tools import convergence_run as tool

        real = tool.train_cli.main
        tool.train_cli.main = lambda a: real(a + extra)
        tool.main([*argv, "--device", "cpu"])


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--res", type=int, default=64)
    ap.add_argument("--views", type=int, default=60)
    ap.add_argument("--n_gt", type=int, default=60_000)
    ap.add_argument("--epochs", type=int, default=24)
    ap.add_argument("--full_epochs", type=int, default=220)
    ap.add_argument("--eval_every", type=int, default=None)
    ap.add_argument("--out", type=str, required=True)
    ap.add_argument("--side", choices=["jax", "port"], default=None, help="(internal) run one package")
    args = ap.parse_args()
    tool_argv = ["--res", str(args.res), "--views", str(args.views), "--n_gt", str(args.n_gt), "--epochs",
                 str(args.epochs)]
    extra = ["--iterations", str(schedule_iterations(args.epochs, args.full_epochs))]
    if args.eval_every:
        extra += ["--eval_every", str(args.eval_every)]
    if args.side:
        run_side(args.side, os.path.join(args.out, args.side), tool_argv, extra)
        return

    import torch

    from c3dgs_tpu_torch.tools import convergence_run as tconv
    from c3dgs_tpu_torch.tools import datasets

    torch.set_num_threads(4)
    data = os.path.join(args.out, "port", "data")
    # the folder convergence_run writes (n_test 32 outside --fast)
    datasets.write_blender_dataset(data, res=args.res, num_train=args.views, num_test=32, fov=0.9,
                                   scene=tconv.make_gt_scene(n=args.n_gt, seed=7, device="cpu"), init_noise=0.08,
                                   init_subsample=4, device="cpu")
    shutil.copytree(data, os.path.join(args.out, "jax", "data"))
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = {side: subprocess.Popen([sys.executable, os.path.abspath(__file__), *sys.argv[1:], "--side", side],
                                    env=env, stdout=open(os.path.join(args.out, f"{side}.log"), "w"),
                                    stderr=subprocess.STDOUT)
             for side in ("jax", "port")}
    for side, proc in procs.items():
        if proc.wait() != 0:
            raise SystemExit(f"the {side} run failed: see {args.out}/{side}.log")
    logs = {side: [json.loads(line) for line in open(os.path.join(args.out, side, "model", "train_log.jsonl"))]
            for side in procs}
    print(f"res {args.res}, {args.views} views, epochs 0-{args.epochs - 1} of {args.full_epochs} ({' '.join(extra)})")
    print("epoch | active JAX / port | train EMA JAX / port | held-out JAX / port")
    worst = 0.0
    for a, b in zip(logs["jax"], logs["port"], strict=True):
        worst = max(worst, abs(a["active"] - b["active"]) / a["active"])
        print(f"{a['epoch']} | {a['active']} / {b['active']} | {a['ema_psnr']} / {b['ema_psnr']} | "
              f"{a.get('test_psnr')} / {b.get('test_psnr')}")
    print(f"largest relative difference in active: {worst:.4%}")


if __name__ == "__main__":
    main()
