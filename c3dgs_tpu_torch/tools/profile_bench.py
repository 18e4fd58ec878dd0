"""Profile the bench step on the card: torch.profiler over steady-state
steps, the top device ops by total time (port of the repo's
tools/profile_bench.py).

    python -m c3dgs_tpu_torch.tools.profile_bench [--packed 0|1] [--top 25] [--steps 3] [--device cpu]

The step is the JAX tool's build_step: bench.py's scene (C3DGS_BENCH_OPACITY
as bench.py reads it), sh_degree=3 in the settings, the kernel family
--packed selects (1: K1 + K2, 0: K3 + K4), probe-exact buckets with the
execution bucket at max(grad_total, 1), the L1 loss's gradients against
a zero image to the seven scene parameters. After one warm-up step,
--steps steps run under torch.profiler; the tool prints the device total
and the top --top device ops with their counts as the JAX tool's
parse_trace does (on the CPU the device is the CPU, and its ops' own
times are the rows), then one JSON line of the same figures. Returns
them with the run's kernel calls.
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Optional

import torch

from ..device import resolve_device
from ..render import tiles, tiles_packed
from ..train import trainer
from . import bench, roofline


def build_step(packed: bool, n: int = 300_000, width: int = 1920, height: int = 1080, device=None):
    """(step, args): step(*args) is one fwd+bwd of the bench frame and
    returns the gradients of args, the scene's seven parameters; it runs
    the scene the args belong to, so call it with these args."""
    dev = resolve_device(device)
    scene = bench.bench_scene(n, os.environ.get("C3DGS_BENCH_OPACITY", "trained") == "trained", dev)
    ev = torch.tensor(bench.EV, dtype=torch.float32, device=dev)
    bg = torch.zeros(3, device=dev)
    settings, need, _ = bench.exact_settings(scene, ev, bench.base_settings(width, height, packed), bg, grad_min=1)
    print(f"# instances={need} cap={settings.instance_capacity}", flush=True)
    one = bench.make_step(scene, ev, settings, bg)
    args = tuple(trainer.scene_params(scene).values())

    def step(*params):
        assert all(a is b for a, b in zip(params, args)), "step() differentiates the scene it was built on"
        return one()

    return step, args


def main(argv: Optional[list] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--packed", type=int, default=1)
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--device", type=str, default=None, help="torch device (default cuda; a missing card is an error)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    step, inputs = build_step(bool(args.packed), device=dev)
    g = step(*inputs)
    float(g[0].sum())  # warm-up and sync

    def steps():
        for _ in range(args.steps):
            step(*inputs)

    total, rows = roofline.device_busy_ms(steps, dev)
    print(f"# device total {total:.2f} ms over trace")
    for name, ms, count in rows[: args.top]:
        print(f"{ms:9.3f} ms  x{count:<5d} {name[:110]}")
    fwd, bwd = (tiles_packed.FORWARD_KERNEL, tiles_packed.BACKWARD_KERNEL) if args.packed else \
        (tiles.FORWARD_KERNEL, tiles.BACKWARD_KERNEL)
    result = {"packed": args.packed, "steps": args.steps, "device_total_ms": total,
              "top": [{"name": name[:110], "ms": ms, "count": count} for name, ms, count in rows[: args.top]]}
    print(json.dumps(result), flush=True)
    # the probe render launches the forward alone
    return {**result, "card": roofline.card(dev),
            "calls": {fwd.name: 1 + 1 + args.steps, bwd.name: 1 + args.steps}}


if __name__ == "__main__":
    main()
