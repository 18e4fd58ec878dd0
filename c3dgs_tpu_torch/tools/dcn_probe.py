"""The two-node layout of the hybrid mesh (port of the JAX package's
tools/dcn_probe.py).

Starts two `torch.distributed.run` agents on this host, nodes 0 and 1 of
a two-node static rendezvous, four gloo ranks each (eight in all). Each
rank calls make_mesh(dp=2, tiles=4) and checks the layout that
parallel/mesh.py promises under torchrun's node-major rank order: the
ranks of each `tiles` group share one node (torchrun's GROUP_RANK), the
counterpart of the JAX mesh keeping `tiles` inside a process, and each
`dp` group spans both nodes, so the dp gradient sum crosses between them.
Then one make_hybrid_train_step (K1 and K2 in their tile-range mode) on
a toy scene (80 splats, capacity 96, 64x32, SH 0, two cameras, zero GT)
is held to a single-device two-camera reference and its Adam step,
computed in the same rank: every parameter within 5e-5, the loss within
1e-5, shard_route_dropped 0 (the JAX tool's bars).

    python -m c3dgs_tpu_torch.tools.dcn_probe [--out_dir DIR] [--device cpu]   # the launcher
    ... --pid N                                                               # a node's ranks

The launcher asks the OS for a free port for the rendezvous. With
--device cuda (the default) all eight ranks share cuda:0 (gloo stages
through the host; NCCL refuses two ranks on one card). Rank 0 writes
<out_dir>/MULTIPROC.json: the JAX tool's keys ("processes" counts the two
nodes, as the JAX tool's two processes), then each rank's layout and K1 /
K2 launches beside the calls that make them, and `card`. The default
out_dir is output/torch.
"""
from __future__ import annotations

import argparse
import datetime
import json
import math
import os
import socket
import subprocess
import sys
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from .. import kernels
from ..config import OptimizationParams
from ..device import resolve_device

NODES, RANKS_PER_NODE = 2, 4
PARAM_TOL, LOSS_TOL = 5e-5, 1e-5
TIMEOUT_S = 300  # every collective of a rank
EV = np.asarray([0, 0, 0, 1, 0, 0, 0], np.float32)
BG = np.asarray([0.1, 0.2, 0.3], np.float32)
REPO = Path(__file__).resolve().parents[2]


def toy_scene(device):
    """The JAX tool's toy scene: 80 points N(0, 0.5^2) about z = 3, uniform
    colors, capacity 96, no quantization."""
    from ..models import gaussians as gmod

    rng = np.random.default_rng(0)
    pts = rng.normal(size=(80, 3)).astype(np.float32) * 0.5
    pts[:, 2] += 3.0
    cols = rng.random(size=(80, 3)).astype(np.float32)
    return gmod.from_point_cloud(pts, cols, capacity=96, quantization=False, device=device)


def reference_step(settings, opt, evs, gts, device):
    """The single-device reference: the mean photometric loss of the two
    cameras, its gradients, one Adam step. Returns (loss, parameters)."""
    from ..ops import losses as L
    from ..train import trainer

    state = trainer.create_train_state(toy_scene(device), opt, 1.0, device=device)
    scene = state.scene.update_observers()
    params = trainer.scene_params(scene)
    total = sum(L.photometric_loss(trainer.render_scene(scene, evs[b], settings, BG, device=device)["render"],
                                   torch.as_tensor(gts[b], device=device), opt.lambda_dssim)
                for b in range(2)) / 2
    grads = torch.autograd.grad(total, list(params.values()), allow_unused=True)
    grads = {k: torch.zeros_like(p) if g is None else g for (k, p), g in zip(params.items(), grads)}
    trainer.adam_update(state.opt_state, params, grads, trainer.make_lr_schedules(opt, 1.0))
    return float(total.detach()), params, grads


def diagnosis(mesh, settings, opt, evs, gts, got, expected, grads, device) -> dict:
    """The entry farthest from the reference step, with the hybrid step's
    and the reference's gradient there (collective: every rank calls it).
    With Adam's eps of 1e-15 a first step moves each entry by about +-lr
    whatever its gradient's size, so opposite signs of two near-zero
    gradients put the entry 2 lr apart."""
    from ..parallel import sharded

    _, g_h, _ = sharded.hybrid_loss_and_grads(mesh, settings, opt, toy_scene(device).update_observers(), evs, gts,
                                              BG)
    diff = {f: (got[f] - expected[f]).detach().abs().flatten() for f in expected}
    k = max(diff, key=lambda f: float(diff[f].max()))
    i = int(diff[k].argmax())

    def at(t):
        return float(t.detach().flatten()[i])

    return {"field": k, "index": i, "hybrid": at(got[k]), "single_device": at(expected[k]), "hybrid_grad": at(g_h[k]),
            "single_device_grad": at(grads[k])}


def count_blends(calls: list) -> None:
    """Count, in calls[0], every packed blend (the hybrid step's tile-range
    one and the reference's) and, in calls[1], every backward through one:
    the calls that launch K1 and K2."""
    from ..parallel import sharded
    from ..render import rasterizer

    real = rasterizer.blend_gaussians_packed

    def backward_seen(grad):
        calls[1] += 1

    def counted(*args):
        out = real(*args)
        calls[0] += 1
        if out.requires_grad:
            out.register_hook(backward_seen)
        return out

    rasterizer.blend_gaussians_packed = sharded.blend_gaussians_packed = counted


def worker(node: int, device: str, out_dir: str) -> None:
    """One rank of node `node` (torchrun's environment names the rest)."""
    import torch.distributed as dist

    from ..parallel import make_hybrid_train_step, make_mesh
    from ..render.types import RasterSettings
    from ..train import trainer

    torch.set_num_threads(1)
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(0)
        dev = torch.device("cuda", 0)
    dist.init_process_group("gloo", timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        rank = dist.get_rank()
        assert dist.get_world_size() == NODES * RANKS_PER_NODE and int(os.environ["GROUP_RANK"]) == node
        mesh = make_mesh(dp=2, tiles=4)
        tiles_nodes = [None] * mesh.tiles.size
        dp_nodes = [None] * mesh.dp.size
        dist.all_gather_object(tiles_nodes, node, group=mesh.tiles.group)
        dist.all_gather_object(dp_nodes, node, group=mesh.dp.group)

        settings = RasterSettings(width=64, height=32, tanfovx=math.tan(0.5), tanfovy=math.tan(0.5), sh_degree=0)
        evs = np.stack([EV, EV + np.asarray([0, 0, 0, 0, 0.1, 0, 0], np.float32)])
        gts = np.zeros((2, 3, 32, 64), np.float32)
        opt = OptimizationParams()
        calls = [0, 0]
        count_blends(calls)
        kernels.reset_counts()
        state = trainer.create_train_state(toy_scene(dev), opt, 1.0, device=dev)
        state, metrics = make_hybrid_train_step(mesh, settings, opt, 1.0)(state, evs, gts, BG)
        loss, dropped = float(metrics["loss"]), int(metrics["shard_route_dropped"])
        ref_loss, expected, ref_grads = reference_step(settings, opt, evs, gts, dev)
        got = trainer.scene_params(state.scene)
        diffs = {k: float((got[k] - expected[k]).detach().abs().max()) for k in expected}
        mine = {
            "rank": rank, "node": node, "dp_index": mesh.dp.index, "tile_index": mesh.tiles.index,
            "tiles_group_nodes": tiles_nodes, "dp_group_nodes": dp_nodes,
            "launches": [kernels.REGISTRY["tiles_packed_fwd"].launches, kernels.REGISTRY["tiles_packed_bwd"].launches],
            "calls": list(calls),
            "loss": loss, "ref_loss": ref_loss, "per_param_diffs": diffs, "shard_route_dropped": dropped,
        }
        ranks = [None] * dist.get_world_size()
        dist.all_gather_object(ranks, mine)
        failures = [f"rank {r['rank']}: {msg}" for r in ranks for msg in check_rank(r)]
        if failures:
            mine["diagnosis"] = diagnosis(mesh, settings, opt, evs, gts, got, expected, ref_grads, dev)
            dist.all_gather_object(ranks, mine)
        if rank == 0:
            worst = {k: max(r["per_param_diffs"][k] for r in ranks) for k in diffs}
            out = {
                "processes": NODES,
                "devices_global": dist.get_world_size(),
                "mesh": {"dp": 2, "tiles": 4},
                "hybrid_branch": "make_mesh: rank = dp_index * tiles + tile_index over torchrun's node-major ranks",
                "collectives": f"gloo ({dev.type}{' staged through the host' if dev.type == 'cuda' else ''})",
                "loss": loss,
                "ref_loss": ref_loss,
                "max_param_update_diff_vs_single_device": max(worst.values()),
                "per_param_diffs": worst,
                "shard_route_dropped": dropped,
                "ranks": ranks,
                "failures": failures,
                "card": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
            }
            os.makedirs(out_dir, exist_ok=True)
            with open(os.path.join(out_dir, "MULTIPROC.json"), "w") as f:
                json.dump(out, f, indent=1)
            print("[dcn_probe]", "FAIL" if failures else "PASS", json.dumps(out), flush=True)
        if failures:
            raise AssertionError("; ".join(failures))
    finally:
        dist.destroy_process_group()


def check_rank(r: dict) -> list:
    """The bars and the layout of one rank's record; [] when it passes."""
    bad = []
    if len(set(r["tiles_group_nodes"])) != 1:
        bad.append(f"its tiles group spans nodes {r['tiles_group_nodes']}")
    if sorted(r["dp_group_nodes"]) != list(range(NODES)):
        bad.append(f"its dp group lies on nodes {r['dp_group_nodes']}")
    over = {k: v for k, v in r["per_param_diffs"].items() if not v < PARAM_TOL}
    if over:
        bad.append(f"parameters past {PARAM_TOL} of the single-device step: {over}")
    if not abs(r["loss"] - r["ref_loss"]) < LOSS_TOL:
        bad.append(f"loss {r['loss']} against {r['ref_loss']}")
    if r["shard_route_dropped"] != 0:
        bad.append(f"shard_route_dropped {r['shard_route_dropped']}")
    return bad


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(device: torch.device, out_dir: str, timeout_s: float = 900) -> dict:
    """Start both nodes' agents, wait for them (a failed node ends the
    other), and return rank 0's record."""
    if device.type == "cuda":
        # built once here, not by eight ranks at once
        kernels.build(["tiles_packed_fwd.cu", "tiles_packed_bwd.cu"])
    port = free_port()
    out_dir = os.path.abspath(out_dir)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(p for p in (str(REPO), os.environ.get("PYTHONPATH")) if p))
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run", "--nnodes", str(NODES), "--node-rank", str(node),
             "--nproc-per-node", str(RANKS_PER_NODE), "--rdzv-backend", "static", "--master-addr", "127.0.0.1",
             "--master-port", str(port), "-m", "c3dgs_tpu_torch.tools.dcn_probe", "--pid", str(node),
             "--device", device.type, "--out_dir", out_dir],
            env=env, cwd=str(REPO),
        )
        for node in range(NODES)
    ]
    deadline = time.monotonic() + timeout_s
    try:
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs) or time.monotonic() > deadline:
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    rcs = [p.returncode for p in procs]
    if any(rcs):
        raise RuntimeError(f"dcn_probe: node exit codes {rcs}")
    with open(os.path.join(out_dir, "MULTIPROC.json")) as f:
        return json.load(f)


def main(argv: Optional[list] = None) -> Optional[dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--pid", type=int, default=None)
    ap.add_argument("--out_dir", type=str, default=os.path.join("output", "torch"))
    ap.add_argument("--device", type=str, default=None, help="torch device (default cuda; a missing card is an error)")
    a = ap.parse_args(argv)
    dev = resolve_device(a.device)
    if a.pid is not None:
        worker(a.pid, dev.type, a.out_dir)
        return None
    out = launch(dev, a.out_dir)
    print(f"both nodes passed; {os.path.join(a.out_dir, 'MULTIPROC.json')} written")
    return out


if __name__ == "__main__":
    main()
