"""Does batching two frames into one dispatch amortise the host's gap?
(port of the repo's tools/dispatch_probe.py)

    python -m c3dgs_tpu_torch.tools.dispatch_probe [--device cpu]

On bench.py's scene (300,000 gaussians, trained opacities, 1920x1080,
sh_degree=3 in the settings), with the JAX tool's own buckets from a
probe of camera 1 (slots int(instances * 1.12), execution rows
int(grad_total * 1.04)), the gradient of the L1 loss against a zero
image to xyz only:
  1x: one camera's step per dispatch;
  2x: two cameras' losses summed (camera 1 the identity, camera 2
      [0, 0.02, 0, 1, 0.05, 0, 0]) and taken back in one dispatch.
A dispatch here is one torch.autograd.grad call. Each is timed best of 3
blocks of 8 calls, one sync per block, per frame. Both cameras' renders
at these buckets must not overflow (checked once before the timing).
The JAX tool also builds profile_bench's step first and never uses it;
the port skips that build. Prints one JSON line with one_step_ms,
two_step_ms_per_frame and dispatch_amortized_ms; returns it with the
run's kernel calls.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Optional

import torch

from ..device import resolve_device
from ..ops import losses
from ..render import tiles_packed
from ..render.capacity import CapacityPolicy
from ..train import trainer
from . import bench, roofline

EV1 = [0, 0, 0, 1, 0, 0, 0]
EV2 = [0, 0.02, 0, 1, 0.05, 0, 0]
BLOCKS, CALLS = 3, 8


def build(n: int = 300_000, width: int = 1920, height: int = 1080, device=None):
    """(g1, g2, counts): g1() the xyz gradient of camera 1's loss,
    g2() that of both cameras' summed, each one autograd.grad call; counts
    are the two cameras' render counts at the tool's buckets."""
    dev = resolve_device(device)
    scene = bench.bench_scene(n, True, dev)
    ev1, ev2 = (torch.tensor(e, dtype=torch.float32, device=dev) for e in (EV1, EV2))
    bg = torch.zeros(3, device=dev)
    base = bench.base_settings(width, height)
    p = bench.probe(scene, ev1, CapacityPolicy(initial=1 << 21).apply(base), bg)
    settings = CapacityPolicy(initial=int(p["num_instances"] * 1.12),
                              grad_initial=int(p["grad_total"] * 1.04)).apply(base)
    counts = [bench.probe(scene, ev, settings, bg) for ev in (ev1, ev2)]
    gt = torch.zeros((3, height, width), device=dev)

    def loss(ev):
        return losses.l1_loss(trainer.render_scene(scene, ev, settings, bg, device=dev)["render"], gt)

    def g1():
        return torch.autograd.grad(loss(ev1), [scene.xyz])[0]

    def g2():
        return torch.autograd.grad(loss(ev1) + loss(ev2), [scene.xyz])[0]

    return g1, g2, counts


def best_ms(fn, frames: int) -> float:
    """Best of BLOCKS blocks of CALLS calls, one sync each, per frame."""
    float(fn().sum())
    best = float("inf")
    for _ in range(BLOCKS):
        t0 = time.perf_counter()
        for _ in range(CALLS):
            out = fn()
        float(out.sum())
        best = min(best, (time.perf_counter() - t0) / CALLS / frames * 1e3)
    return best


def main(argv: Optional[list] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", type=str, default=None, help="torch device (default cuda; a missing card is an error)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    g1, g2, counts = build(device=dev)
    for i, c in enumerate(counts, 1):
        assert c["overflow"] == 0 and c["grad_overflow"] == 0, f"camera {i} overflows the tool's buckets: {c}"
    ms1 = best_ms(g1, 1)
    ms2 = best_ms(g2, 2)
    line = {"one_step_ms": ms1, "two_step_ms_per_frame": ms2, "dispatch_amortized_ms": ms1 - ms2}
    print(json.dumps(line), flush=True)
    calls = 1 + BLOCKS * CALLS
    k1, k2 = tiles_packed.FORWARD_KERNEL.name, tiles_packed.BACKWARD_KERNEL.name
    # the probe and the two cameras' checks render alone
    return {"line": line, "card": roofline.card(dev), "instances": [c["num_instances"] for c in counts],
            "calls": {k1: 3 + 3 * calls, k2: 3 * calls}}


if __name__ == "__main__":
    main()
