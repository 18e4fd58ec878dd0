"""The `train` loop: a closed loop of training steps, one trainer.

Set-up builds the trainer, seeds its capacity policy with one probe render
and drives the first `check_steps` steps through the window's own call;
the window then steps on. The reference follows the checked steps from
the same inputs: each step's loss, each field's first gradient as Adam
holds it, and each field's change over the checked steps.

Traffic parameters: `first_step` (the learning-rate schedule's step at the
start), `check_steps`, `trace_steps`.
"""
from __future__ import annotations

import time
from typing import Dict

import torch

from benchmark import checks, harness, scene, trace
from benchmark.reference import splat


class CameraOrder:
    """Training cameras in seeded permutations, one after another."""

    def __init__(self, seed: int, n: int):
        self.gen = torch.Generator().manual_seed((int(seed) << 4) | 4)
        self.n, self.queue = n, []

    def next(self) -> int:
        if not self.queue:
            self.queue = torch.randperm(self.n, generator=self.gen).tolist()
        return self.queue.pop(0)


def run(spec: dict, seed: int, seconds: float, tracing: bool, dev, t0: float) -> dict:
    from benchmark import program

    cfg, traffic = spec["cfg"], spec["traffic"]
    p = scene.make_scene(cfg, seed, dev)
    cams = scene.make_cameras(cfg, seed, dev)
    harness.inputs_made(dev, t0)
    fields = list(scene.PARAM_FIELDS)
    p0 = {k: p[k].to("cpu", copy=True) for k in fields}  # the reference's copy of the inputs
    idx = {k: p.get(k) for k in ("feature_indices", "gaussian_indices")}
    scene_bytes = sum(v.numel() * v.element_size() for v in p.values())
    param_bytes = scene.param_bytes({k: p[k] for k in fields})
    first_step = int(traffic["first_step"])
    prog = program.Trainer(program.build_scene(p, cfg), cfg, cams, first_step, seed, dev)
    del p  # the scene now holds the parameters, which training changes in place
    order = CameraOrder(seed, cams["train_ev"].shape[0])
    checked = [order.next() for _ in range(int(traffic["check_steps"]))]
    prog.probe(cams["train_ev"][checked[0]])
    losses = []
    for i, c in enumerate(checked):
        r = prog.step(cams["train_ev"][c], cams["targets"][c])
        losses.append(r["loss"])
        if i == 0:
            grad_norms = prog.first_grad_norms()
    after = prog.params()
    step_norms = {k: float(torch.linalg.vector_norm(after[k] - p0[k].to(dev), dtype=torch.float64)) for k in fields}
    harness.sync(dev)
    setup_s = time.perf_counter() - t0
    harness.log(t0, f"set-up done: {len(checked)} checked steps, losses {losses}")

    steps, failed, frames, inst, out = 0, 0, [], [], {}

    def one():
        nonlocal steps, failed
        c = order.next()
        r = prog.step(cams["train_ev"][c], cams["targets"][c])
        steps += 1
        failed += r["failed"]
        frames.append(c)
        inst.append(r["num_instances"])

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
    out.update(attempted=steps, failed=failed, setup_s=setup_s, window_s=window_s, instances=inst,
               e2e=dict(train_step_ms=window_s / steps * 1e3))
    out["memory_peak_bytes"] = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    harness.log(t0, f"window done: {steps} steps, {failed} failed, peak {out['memory_peak_bytes']} B")
    del prog, after
    harness.free()

    ref = splat.Scene({k: p0[k].to(dev) for k in fields}, idx)
    ref_cams = [splat.Camera(cams["train_ev"][c], cams["intrinsic"], dev) for c in checked]
    bg = torch.tensor(cfg["render"]["background"], dtype=torch.float32, device=dev)
    with splat.precision("float32"):
        res = splat.train_steps(ref, ref_cams, [cams["targets"][c] for c in checked], bg, cfg["train"], first_step,
                                cams["extent"])
        leaves: Dict[str, tuple] = {}
        out["numbers"] = checks.train_numbers(dict(losses=losses, grad_norms=grad_norms, step_norms=step_norms), res,
                                              leaves)
        harness.log(t0, f"reference done: losses {res['losses']}; (grad, step) gap by leaf {leaves}")
        del res
        if tracing:
            out["frames"] = harness.count_work(ref, [cams["train_ev"][c] for c in frames], cams, bg)
            harness.log(t0, "work counted")
    out.update(pixels=cams["width"] * cams["height"], scene_bytes=scene_bytes, param_bytes=param_bytes)
    return out


def control_numbers(spec: dict, seed: int, dev, modes, planted) -> dict:
    """{mode: numbers} of the reference with each planted mode put in the
    program's place, against the float32 reference, over the checked
    steps of `seed`'s inputs (see benchmark/control.py)."""
    cfg, traffic = spec["cfg"], spec["traffic"]
    p = scene.make_scene(cfg, seed, dev)
    cams = scene.make_cameras(cfg, seed, dev)
    idx = {k: p.get(k) for k in ("feature_indices", "gaussian_indices")}
    fields = {k: p[k] for k in scene.PARAM_FIELDS}
    bg = torch.tensor(cfg["render"]["background"], dtype=torch.float32, device=dev)
    order = CameraOrder(seed, cams["train_ev"].shape[0])
    checked = [order.next() for _ in range(int(traffic["check_steps"]))]
    ref_cams = [splat.Camera(cams["train_ev"][c], cams["intrinsic"], dev) for c in checked]
    gts = [cams["targets"][c] for c in checked]

    def steps():
        return splat.train_steps(splat.Scene(fields, idx), ref_cams, gts, bg, cfg["train"],
                                 int(traffic["first_step"]), cams["extent"])

    with splat.precision("float32"):
        ref = steps()
    out = {}
    for mode in modes:
        with planted(mode):
            got = steps()
        prog = dict(
            losses=got["losses"],
            grad_norms={k: float(torch.linalg.vector_norm(v.double())) for k, v in got["first_grads"].items()},
            step_norms={k: float(torch.linalg.vector_norm((got["p"][k].detach() - got["p0"][k]).double()))
                        for k in got["p0"]},
        )
        out[mode] = checks.train_numbers(prog, ref)
    return out
