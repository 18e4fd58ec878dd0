"""The `pose` loop: a closed loop of pose steps, one localiser relocalising
camera frames against a frozen, served scene (the fork's
train_camera.py).

Set-up takes `queries` query cameras, the next training cameras of the
seeded permutation (`train.CameraOrder`), renders each query's image
through the served path at its true pose, draws each query's start pose
as the true 7-vector plus N(0, perturb^2) on all seven components, and
drives the first `check_steps` steps of the first query through the
window's own call, keeping the pose each started from and its gradient
(as Adam's first moment holds it). The window steps on: each query takes
`steps_per_query` steps from its own start pose, then the next query
starts. The reference (`reference/pose.py::follow`) stands at each of the
program's checked poses: its loss and its gradient there, and the
7-vector its Adam reaches on the program's own gradients (so that a
gradient near zero in one component, or a threshold of the render
crossed between poses 1e-6 apart, does not part two sound trajectories).

Traffic parameters: `queries`, `steps_per_query`, `lr`, `perturb`,
`check_steps`, `trace_steps`.

Numbers that decide `correct`:
- loss_gap: the largest relative gap of a checked step's loss;
- pose_grad_gap: the largest, over the checked steps, of |program's
  gradient - reference's| over the reference's norm;
- pose_step_gap: |program's change of the 7-vector - the reference
  Adam's| over the reference Adam's norm, after the checked steps, each
  change taken from the start pose with its quaternion renormalised.
"""
from __future__ import annotations

import time
from typing import Dict

import torch

from benchmark import harness, scene, trace
from benchmark.loops.train import CameraOrder
from benchmark.loops.view import _reference  # the scene as served: observers set once
from benchmark.reference import pose, splat


def queries(cfg: dict, traffic: dict, seed: int, cams: dict) -> tuple:
    """The query cameras' true 7-vectors and their start poses (Q, 7), on
    the cameras' device; the perturbation is drawn on the host from the
    seed alone."""
    order = CameraOrder(seed, cams["train_ev"].shape[0])
    picks = [order.next() for _ in range(int(traffic["queries"]))]
    true_ev = cams["train_ev"][picks]
    gen = torch.Generator().manual_seed((int(seed) << 4) | 6)
    noise = torch.randn((len(picks), 7), generator=gen, dtype=torch.float32) * float(traffic["perturb"])
    return true_ev, true_ev + noise.to(true_ev.device)


def pose_numbers(prog: dict, ref: dict, ev0: torch.Tensor) -> Dict[str, float]:
    """prog: `losses`, `grads` and `ev` after the checked steps; ref: the
    same from `pose.follow` at prog's poses; ev0 the start pose. The
    7-vector's change is taken from ev0 with its quaternion renormalised,
    which both sides reach at the first step whatever Adam does."""
    rel = lambda a, b: float(torch.linalg.vector_norm(a.double() - b.double().to(a.device))
                             / torch.linalg.vector_norm(b.double()).clamp_min(1e-30))
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"]))
    start = pose.renormalised(ev0).double()
    return dict(loss_gap=loss_gap,
                pose_grad_gap=max(rel(a, b) for a, b in zip(prog["grads"], ref["grads"])),
                pose_step_gap=rel(prog["ev"].double().to(start.device) - start,
                                  ref["ev"].double().to(start.device) - start))


def run(spec: dict, seed: int, seconds: float, tracing: bool, dev, t0: float) -> dict:
    from benchmark import pose_program, program

    cfg, traffic = spec["cfg"], spec["traffic"]
    p = scene.make_scene(cfg, seed, dev)
    cams = scene.make_cameras(cfg, seed, dev, targets=False)
    harness.inputs_made(dev, t0)
    scene_bytes = sum(v.numel() * v.element_size() for v in p.values())
    prog = pose_program.Localiser(program.build_scene(p, cfg), cfg, cams, traffic["lr"], dev)
    true_ev, start_ev = queries(cfg, traffic, seed, cams)
    images, counts = zip(*(prog.query_image(ev) for ev in true_ev))
    prog.seed_policy(max(counts))
    per_query = int(traffic["steps_per_query"])
    losses, poses, grads = [], [], []
    prog.start(start_ev[0])
    for _ in range(int(traffic["check_steps"])):
        poses.append(prog.ev.detach().clone())
        mu = prog.moment()
        losses.append(prog.step(images[0])["loss"])
        grads.append(prog.step_grad(mu))
    checked = dict(losses=losses, grads=grads, ev=prog.ev.detach().clone())
    harness.sync(dev)
    setup_s = time.perf_counter() - t0
    harness.log(t0, f"set-up done: {len(counts)} queries ({list(counts)} instances), losses {losses}")

    q, done = 0, len(losses)
    steps, failed, evs, inst, out = 0, 0, [], [], {}

    def one():
        nonlocal q, done, steps, failed
        if done == per_query:
            q, done = (q + 1) % len(images), 0
            prog.start(start_ev[q])
        if tracing:
            evs.append(prog.ev.detach().clone())
        r = prog.step(images[q])
        done += 1
        steps += 1
        failed += r["failed"]
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
    gt = images[0]
    del prog, images
    harness.free()

    ref = _reference(p)
    bg = torch.tensor(cfg["render"]["background"], dtype=torch.float32, device=dev)
    with splat.precision("float32"):
        res = pose.follow(ref, poses, grads, start_ev[0], cams["intrinsic"], gt, bg, cfg["train"]["lambda_dssim"],
                          float(traffic["lr"]))
        out["numbers"] = pose_numbers(checked, res, start_ev[0])
        harness.log(t0, f"reference done: losses {res['losses']}, gradients {[g.tolist() for g in res['grads']]}, "
                        f"program's {[g.tolist() for g in grads]}")
        if tracing:
            out["frames"] = harness.count_work(ref, evs, cams, bg)
            harness.log(t0, "work counted")
    out.update(pixels=cams["width"] * cams["height"], scene_bytes=scene_bytes, param_bytes=0)
    return out


def control_numbers(spec: dict, seed: int, dev, modes, planted) -> dict:
    """{mode: numbers} of the reference with each planted mode put in the
    program's place, against the float32 reference at the poses it stood
    at, over the checked steps of `seed`'s first query (see
    benchmark/control.py). The query image is the reference's render at
    the true pose. Modes: "tf32" (the control), the faults of
    `reference/pose.py` (`pose.FAULTS`) and control.py's "half" (the loss
    over the image's top half)."""
    cfg, traffic = spec["cfg"], spec["traffic"]
    p = scene.make_scene(cfg, seed, dev)
    cams = scene.make_cameras(cfg, seed, dev, targets=False)
    true_ev, start_ev = queries(cfg, traffic, seed, cams)
    bg = torch.tensor(cfg["render"]["background"], dtype=torch.float32, device=dev)
    ref_scene = _reference(p)
    lr, lam, n = float(traffic["lr"]), cfg["train"]["lambda_dssim"], int(traffic["check_steps"])
    with splat.precision("float32"):
        gt = ref_scene.render(splat.Camera(true_ev[0], cams["intrinsic"], dev), bg)
    out = {}
    for mode in modes:
        with planted(mode):
            got = pose.pose_steps(ref_scene, start_ev[0], cams["intrinsic"], gt, bg, lam, lr, n,
                                  mode if mode in pose.FAULTS else None)
        with splat.precision("float32"):
            ref = pose.follow(ref_scene, got["poses"], got["grads"], start_ev[0], cams["intrinsic"], gt, bg, lam, lr)
        out[mode] = pose_numbers(got, ref, start_ev[0])
    return out
