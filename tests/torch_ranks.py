"""Ranks for the port's multi-device tests (tests/test_torch_parallel.py
on the CPU, tests/test_torch_gpu.py on the card).

- `run(world, job, payload, tmp_path)` starts `world` gloo ranks with
  torch.multiprocessing (spawn), meeting at a FileStore under the test's
  tmp_path (no TCP port, so parallel test workers never collide); each
  runs JOBS[job](payload) and returns a picklable result, and the list of
  results comes back in rank order. A failing rank raises here.
- `ThreadAxis` / `route_all` run bin_gaussians_routed for every rank of a
  tiles axis in one process, one thread per rank, with an in-process
  all_to_all: a routed rank's array without a process group.

A spawned rank re-imports this module, so it imports torch, numpy and the
port only, never JAX, and sets torch to one thread.
"""
from __future__ import annotations

import dataclasses
import datetime
import math
import pickle
import threading
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

RANK_TIMEOUT_S = 180


def run(world: int, job: str, payload, tmp_path, device: str = "cpu") -> list:
    out = Path(tmp_path) / f"{job}-{world}"
    out.mkdir(parents=True)
    mp.start_processes(_rank, args=(world, str(out / "store"), job, payload, str(out), device), nprocs=world,
                       join=True, start_method="spawn")
    return [pickle.loads((out / f"rank{r}.pkl").read_bytes()) for r in range(world)]


def _rank(rank, world, store, job, payload, out, device):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=RANK_TIMEOUT_S))
    try:
        result = JOBS[job](payload, device)
        Path(out, f"rank{rank}.pkl").write_bytes(pickle.dumps(result))
    finally:
        dist.destroy_process_group()


# ----------------------------------------------------- in-process routing
@dataclasses.dataclass
class ThreadAxis:
    """A tiles axis whose ranks are threads of one process."""

    size: int
    index: int
    shared: dict

    def all_to_all(self, x):
        s = self.shared
        s["send"][self.index] = x
        s["barrier"].wait()
        recv = torch.stack([s["send"][r][self.index] for r in range(self.size)])
        s["barrier"].wait()
        return recv


def route_all(prep, settings, size: int) -> list:
    """bin_gaussians_routed on every rank of a `size`-wide tiles axis."""
    from c3dgs_tpu_torch.render.binning import bin_gaussians_routed

    shared = {"send": [None] * size, "barrier": threading.Barrier(size)}
    out = [None] * size

    def one(d):
        out[d] = bin_gaussians_routed(prep, settings, ThreadAxis(size, d, shared))

    threads = [threading.Thread(target=one, args=(d,)) for d in range(size)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=RANK_TIMEOUT_S)
    assert all(r is not None for r in out), "a routing thread failed"
    return out


# ------------------------------------------------------------------ jobs
def scene_of(p, device):
    from c3dgs_tpu_torch.models.gaussians import scene_from_numpy

    return scene_from_numpy(p["leaves"], device=device, **p["statics"])


def port_leaves(scene):
    """A port scene as the payload scene_of rebuilds (dense scenes)."""
    names = ("xyz", "opacity", "scaling_factor", "active", "features_dc", "features_rest", "scaling", "rotation")
    return dict(
        leaves={k: None if getattr(scene, k) is None else getattr(scene, k).detach().cpu().numpy() for k in names},
        statics=dict(max_sh_degree=scene.max_sh_degree, active_sh_degree=scene.active_sh_degree,
                     quantization=scene.quantization, use_factor_scaling=scene.use_factor_scaling),
    )


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x


def suite(p, device):
    """Every port result tests/test_torch_parallel.py holds against JAX, on
    a 4-rank world: mesh shapes, the routed binning at D = 4, tile-sharded
    renders at dp1 x tiles4 and dp2 x tiles2, the skew and Morton routing
    cases, the slab loss and the hybrid step at dp2 x tiles2."""
    from c3dgs_tpu_torch.config import OptimizationParams
    from c3dgs_tpu_torch.parallel import make_hybrid_train_step, make_mesh, render_tile_sharded, sharded
    from c3dgs_tpu_torch.render.binning import bin_gaussians_routed
    from c3dgs_tpu_torch.render.preprocess import Preprocessed
    from c3dgs_tpu_torch.render.types import RasterSettings
    from c3dgs_tpu_torch.train import trainer

    res = {}
    meshes = {key: make_mesh(*shape) for key, shape in (
        ("2x2", (2, 2)), ("1x4", (1, 4)), ("4x1", (4, None)), ("tiles4", (None, 4)), ("default", (None, None))
    )}
    res["mesh"] = {k: (m.shape, m.dp.index, m.tiles.index, m.world.index, m.backend) for k, m in meshes.items()}
    m14, m22 = meshes["1x4"], meshes["2x2"]

    r = p["routed"]
    prep = Preprocessed(*(torch.as_tensor(x) for x in r["prep"]))
    rb = bin_gaussians_routed(prep, RasterSettings(**r["kw"]), m14.tiles)
    res["routed"] = {k: _np(v) for k, v in rb._asdict().items()}

    r = p["render"]
    scene, s = scene_of(r, device), RasterSettings(**r["kw"])
    for key in ("1x4", "2x2"):
        img, diag = render_tile_sharded(scene, r["ev"], s, r["bg"], meshes[key], return_diag=True)
        res[f"render_{key}"] = (_np(img), int(diag["shard_route_dropped"]))
    res["render_single"] = _np(trainer.render_scene(scene, r["ev"], s, r["bg"], device=device)["render"])

    for case in ("skew", "morton"):
        r = p[case]
        scene, s = scene_of(r, device), RasterSettings(**r["kw"])
        img, diag = render_tile_sharded(scene, r["ev"], s, r["bg"], m14, return_diag=True)
        single = trainer.render_scene(scene, r["ev"], s, r["bg"], device=device)
        res[case] = (_np(img), int(diag["shard_route_dropped"]), _np(single["render"]), int(single["overflow"]),
                     int(single["num_instances"]))

    res["slab"] = [float(sharded.photometric_loss_rows(torch.as_tensor(a), torch.as_tensor(b), 0.2, m14.tiles))
                   for a, b in p["slab"]]

    r = p["hybrid"]
    opt = OptimizationParams()
    exact = RasterSettings(**r["kw"], fast_grad=False)
    scene = scene_of(r, device)
    loss, grads, trunc = sharded.hybrid_loss_and_grads(m22, exact, opt, scene, r["evs"], r["gts"], r["bg"])
    res["hybrid_grads"] = (float(loss), {k: _np(v) for k, v in grads.items()}, int(trunc))
    state = trainer.create_train_state(scene_of(r, device), opt, 1.0, device=device)
    step = make_hybrid_train_step(m22, RasterSettings(**r["kw"]), opt, 1.0)
    state, metrics = step(state, r["evs"], r["gts"], r["bg"])
    res["hybrid_step"] = (float(metrics["loss"]), int(metrics["shard_route_dropped"]),
                          {k: _np(v) for k, v in trainer.scene_params(state.scene).items()}, state.step,
                          state.opt_state.count)
    return res


def card_render(p, device):
    """render_tile_sharded over the whole world on `device` (dp1 x tiles
    world), its gradient w.r.t. xyz, and the same on one rank alone."""
    from c3dgs_tpu_torch.parallel import make_mesh, render_tile_sharded
    from c3dgs_tpu_torch.render import tiles_packed
    from c3dgs_tpu_torch.render.types import RasterSettings
    from c3dgs_tpu_torch.train import trainer

    mesh = make_mesh()
    scene, s = scene_of(p, device), RasterSettings(**p["kw"], fast_grad=False)
    w = torch.as_tensor(p["w"], device=device)
    k1, k2 = tiles_packed.FORWARD_KERNEL, tiles_packed.BACKWARD_KERNEL
    before = (k1.launches, k2.launches)
    img, diag = render_tile_sharded(scene, p["ev"], s, p["bg"], mesh, return_diag=True)
    (g,) = torch.autograd.grad(torch.sum(w * img), scene.xyz)
    launched = (k1.launches - before[0], k2.launches - before[1])
    single = trainer.render_scene(scene, p["ev"], s, p["bg"], device=device)["render"]
    (g1,) = torch.autograd.grad(torch.sum(w * single), scene.xyz)
    return dict(img=_np(img), single=_np(single), dropped=int(diag["shard_route_dropped"]), grad=_np(g),
                grad_single=_np(g1), launched=launched)


JOBS = {"suite": suite, "card_render": card_render}


def toy_points(n=80, seed=0):
    """tests/test_parallel.py::toy_scene's points and colors."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(n, 3)).astype(np.float32) * 0.5
    pts[:, 2] += 3.0
    cols = rng.random(size=(n, 3)).astype(np.float32)
    return pts, cols


SET_KW = dict(width=64, height=32, tanfovx=math.tan(0.5), tanfovy=math.tan(0.5), sh_degree=0)
