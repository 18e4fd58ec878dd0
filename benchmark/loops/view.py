"""The `view` loop: a closed loop of served views, one viewer.

Set-up builds the viewer and serves `warmup_views` views of the path; the
window then serves the path's next poses one at a time. A seeded uniform
sample of `check_views` of the window's views is kept as produced, and the
reference renders those poses again once the window has closed.

Traffic parameters: `warmup_views`, `check_views`, `trace_steps`.
"""
from __future__ import annotations

import math
import time
from typing import List

import numpy as np
import torch

from benchmark import checks, harness, scene, trace
from benchmark.reference import splat


class ViewTimer:
    """Each view's time from its request to its image complete on the
    device: CUDA events on the card, the host clock elsewhere."""

    def __init__(self, dev):
        self.cuda = dev.type == "cuda"
        self.marks = []

    def start(self):
        if self.cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            return e
        return time.perf_counter()

    def stop(self, t0) -> None:
        if self.cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            self.marks.append((t0, e))
        else:
            self.marks.append((t0, time.perf_counter()))

    def ms(self) -> List[float]:
        if self.cuda:
            torch.cuda.synchronize()
            return [a.elapsed_time(b) for a, b in self.marks]
        return [(b - a) * 1e3 for a, b in self.marks]


def p95(values: List[float]) -> float:
    """Nearest-rank 95th percentile."""
    s = sorted(values)
    return s[max(math.ceil(0.95 * len(s)) - 1, 0)]


def _reference(p: dict) -> "splat.Scene":
    idx = {k: p.get(k) for k in ("feature_indices", "gaussian_indices")}
    ref = splat.Scene({k: p[k] for k in scene.PARAM_FIELDS}, idx)
    ref.obs = splat.observe(None, ref.p)
    return ref


def run(spec: dict, seed: int, seconds: float, tracing: bool, dev, t0: float) -> dict:
    from benchmark import program

    cfg, traffic = spec["cfg"], spec["traffic"]
    p = scene.make_scene(cfg, seed, dev)
    cams = scene.make_cameras(cfg, seed, dev, targets=False)
    harness.inputs_made(dev, t0)
    scene_bytes = sum(v.numel() * v.element_size() for v in p.values())
    prog = program.Viewer(program.build_scene(p, cfg), cfg, cams, dev)
    path = cams["path_ev"]
    n_path = path.shape[0]
    i = 0
    for _ in range(int(traffic["warmup_views"])):
        prog.view(path[i % n_path])
        i += 1
    harness.sync(dev)
    setup_s = time.perf_counter() - t0
    harness.log(t0, "set-up done")

    # a seeded uniform sample of the window's views (reservoir), kept as
    # the program produced them for the reference to judge
    m = int(traffic["check_views"])
    rng = np.random.default_rng([int(seed), 5])
    kept: List[tuple] = []
    timer = ViewTimer(dev)
    views, failed, clipped, inst, frames, out = 0, 0, 0, [], [], {}

    def one():
        nonlocal views, failed, clipped, i
        pose = i % n_path
        t = timer.start()
        r = prog.view(path[pose])
        timer.stop(t)
        i += 1
        failed += r["failed"]
        clipped += r["clipped"] or 0
        frames.append(pose)
        inst.append(r["num_instances"])
        if r["image"] is not None:
            if len(kept) < m:
                kept.append((pose, r["image"]))
            else:
                j = int(rng.integers(0, views + 1))
                if j < m:
                    kept[j] = (pose, r["image"])
        views += 1

    if tracing:
        with trace.profiled(dev) as tr:
            for _ in range(int(traffic["trace_steps"])):
                one()
        out["trace"] = tr
        window_s = tr["window_s"]
    else:
        w0 = time.perf_counter()
        while time.perf_counter() - w0 < seconds:
            one()
        harness.sync(dev)
        window_s = time.perf_counter() - w0
    lat = timer.ms()
    out.update(attempted=views, failed=failed, setup_s=setup_s, window_s=window_s, instances=inst,
               e2e=dict(view_ms=window_s / views * 1e3, view_p95_ms=p95(lat)))
    out["memory_peak_bytes"] = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    harness.log(t0, f"window done: {views} views, {failed} failed, {clipped} tiles clipped, "
                    f"peak {out['memory_peak_bytes']} B")
    del prog
    harness.free()

    ref = _reference(p)
    bg = torch.tensor(cfg["render"]["background"], dtype=torch.float32, device=dev)
    with splat.precision("float32"):
        ref_imgs = [ref.render(splat.Camera(path[pose], cams["intrinsic"], dev), bg) for pose, _ in kept]
        out["numbers"] = dict(image_gap=checks.image_gap([img for _, img in kept], ref_imgs))
        harness.log(t0, f"reference done: {len(ref_imgs)} views")
        if tracing:
            out["frames"] = harness.count_work(ref, [path[f] for f in frames], cams, bg)
            harness.log(t0, "work counted")
    out.update(pixels=cams["width"] * cams["height"], scene_bytes=scene_bytes, param_bytes=0)
    return out


def control_numbers(spec: dict, seed: int, dev, modes, planted) -> dict:
    """{mode: numbers} of the reference with each planted mode put in the
    program's place, against the float32 reference, over `check_views`
    poses of the path drawn from `seed` (see benchmark/control.py); the
    mode "altered" brightens the top quarter of each image it renders."""
    cfg, traffic = spec["cfg"], spec["traffic"]
    p = scene.make_scene(cfg, seed, dev)
    cams = scene.make_cameras(cfg, seed, dev)
    bg = torch.tensor(cfg["render"]["background"], dtype=torch.float32, device=dev)
    gen = torch.Generator().manual_seed(int(seed))
    poses = torch.randperm(cams["path_ev"].shape[0], generator=gen)[: int(traffic["check_views"])].tolist()

    def views():
        ref = _reference(p)
        return [ref.render(splat.Camera(cams["path_ev"][i], cams["intrinsic"], dev), bg) for i in poses]

    with splat.precision("float32"):
        ref = views()
    out = {}
    for mode in modes:
        with planted(mode):
            got = views()
        if mode == "altered":
            for img in got:
                img[:, : img.shape[1] // 4] += 0.05
        out[mode] = dict(image_gap=checks.image_gap(got, ref))
    return out
