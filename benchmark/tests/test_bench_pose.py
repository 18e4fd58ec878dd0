"""Pose recovery in the benchmark at CPU sizes: the port's camera_step (the
plain K1/K2 path) against the plain reference `reference/pose.py` over
three steps, whole runs of the pose loop with each fault the cell can have
planted in the program, a traced run of the pose cell, and the
reference's imports."""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import harness, program, scene, spans, work
from benchmark.loops import pose as pose_loop
from benchmark.reference import pose, splat
from benchmark.tests.small import small_spec
from c3dgs_tpu_torch.ops import camera_math
from c3dgs_tpu_torch.render import preprocess
from c3dgs_tpu_torch.render.types import settings_from_intrinsic
from c3dgs_tpu_torch.train import camera_opt, trainer

ROOT = Path(__file__).resolve().parents[2]
CELL = "pose.garden-5m-1080p"


@pytest.mark.parametrize("seed", [1, 3])
def test_camera_step_follows_the_reference(seed):
    """Each of three steps' loss at 1e-5 relative, the first 7-vector
    gradient within 1e-4 of its norm and the 7-vector after the steps
    within 1e-6 (steps of 1e-3 a component): the float32 sums of a few
    thousand splats in two orders. The program's reduction is the exact
    one the configuration states (`fast_grad` false): with the fast one,
    seed 3's frame, where a splat 0.0116 in front of the camera plane
    spans the frame, parts from the reference by 9.4e-3 of the gradient
    (PERF.md, Open questions)."""
    spec = small_spec(CELL, splats=1500, width=96, height=64)
    cfg, traffic = spec["cfg"], spec["traffic"]
    p = scene.make_scene(cfg, seed, "cpu")
    cams = scene.make_cameras(cfg, seed, "cpu", targets=False)
    true_ev, start_ev = pose_loop.queries(cfg, traffic, seed, cams)
    port = program.build_scene({k: v.clone() for k, v in p.items()}, cfg).update_observers()
    settings = settings_from_intrinsic(np.asarray(cams["intrinsic"]), fast_grad=bool(cfg["render"]["fast_grad"]))
    bg = torch.zeros(3)
    with torch.no_grad():
        gt = trainer.render_scene(port, true_ev[0], settings, bg, device="cpu")["render"]
    ref = pose_loop._reference(p)
    with splat.precision("float32"):
        res = pose.pose_steps(ref, start_ev[0], cams["intrinsic"], gt, bg, 0.2, 1e-3, 3)
    ev = start_ev[0].clone()
    state = trainer.adam_init({"ev": ev})
    _, g, _ = camera_opt.pose_loss_and_grad(port, ev, gt, settings, bg)
    assert float((g - res["grads"][0]).norm()) <= 1e-4 * float(res["grads"][0].norm())
    for i, want in enumerate(res["losses"]):
        ev, state, m = camera_opt.camera_step(port, ev, state, gt, settings, bg, 1e-3)
        assert abs(float(m["loss"]) - want) <= 1e-5 * want, i
        assert int(m["clipped"]) == 0 and int(m["overflow"]) == 0
    assert float((ev - res["ev"]).abs().max()) <= 1e-6
    assert float((ev - start_ev[0]).abs().max()) > 1e-3


@pytest.mark.parametrize("fault", [None, "unchanged"])
def test_reference_follows_a_run_of_its_own(fault):
    """`pose.follow` at a run's own poses and gradients gives back the run's
    losses and gradients bitwise, and the 7-vector the run's Adam reached;
    a run whose pose stayed put is where its Adam was not."""
    spec = small_spec(CELL, splats=800, width=48, height=32)
    cfg, traffic = spec["cfg"], spec["traffic"]
    p = scene.make_scene(cfg, 5, "cpu")
    cams = scene.make_cameras(cfg, 5, "cpu", targets=False)
    true_ev, start_ev = pose_loop.queries(cfg, traffic, 5, cams)
    ref = pose_loop._reference(p)
    bg = torch.zeros(3)
    with splat.precision("float32"):
        gt = ref.render(splat.Camera(true_ev[0], cams["intrinsic"], "cpu"), bg)
        run = pose.pose_steps(ref, start_ev[0], cams["intrinsic"], gt, bg, 0.2, 1e-3, 3, fault)
        got = pose.follow(ref, run["poses"], run["grads"], start_ev[0], cams["intrinsic"], gt, bg, 0.2, 1e-3)
    assert got["losses"] == run["losses"]
    for a, b in zip(got["grads"], run["grads"]):
        assert torch.equal(a, b)
    numbers = pose_loop.pose_numbers(run, got, start_ev[0])
    if fault is None:
        assert torch.equal(got["ev"], run["ev"]) and numbers["pose_step_gap"] == 0.0
    else:
        start = pose.renormalised(start_ev[0])
        assert torch.equal(run["ev"], start) and numbers["pose_step_gap"] == 1.0
        assert float((got["ev"] - start)[4:].abs().min()) > 2.5e-3


def _mean2d_only(monkeypatch):
    """The pose gradient through the projected means alone: the EWA
    covariance and the colours see a camera detached from the 7-vector."""
    cov2d, center = preprocess.compute_cov2d, camera_math.camera_center_from_extrinsic
    monkeypatch.setattr(preprocess, "compute_cov2d", lambda m, c, view, s: cov2d(m, c, view.detach(), s))
    monkeypatch.setattr(camera_math, "camera_center_from_extrinsic", lambda ev: center(ev).detach())


def _colour_cut(monkeypatch):
    """The colour branch cut: the camera centre detached."""
    center = camera_math.camera_center_from_extrinsic
    monkeypatch.setattr(camera_math, "camera_center_from_extrinsic", lambda ev: center(ev).detach())


def _component_scaled(monkeypatch):
    """The gradient's largest component times 1.5 where the backward
    produces it."""
    orig = camera_opt.pose_loss_and_grad

    def scaled(*a, **k):
        loss, grad, out = orig(*a, **k)
        grad = grad.clone()
        grad[int(torch.argmax(grad.abs()))] *= 1.5
        return loss, grad, out

    monkeypatch.setattr(camera_opt, "pose_loss_and_grad", scaled)


def _pose_unchanged(monkeypatch):
    """Adam keeps its moments but the 7-vector does not move."""
    orig = trainer.adam_update

    def frozen(state, params, grads, schedules, eps=trainer.ADAM_EPS):
        orig(state, {k: v.detach().clone() for k, v in params.items()}, grads, schedules, eps)

    monkeypatch.setattr(trainer, "adam_update", frozen)


# The pose cell's limits at this size, set as PERF.md sets the card's, from
# readings of the loop here on 5 seeds, the reference standing at the
# program's poses: loss_gap, sound at most 1.4e-6, the ×1.5 component
# 1.0e-6 (caught by the gradient); pose_grad_gap, sound at most 1.6e-5,
# the cut colour branch (the least fault) 4.2e-4 on one seed of two and
# 6.8e-2 on this test's; pose_step_gap, sound at most 4.6e-5, the
# unchanged pose 1.0; each limit between them with room on both sides.
# The card's limits (checks/pose.garden-5m-1080p.json) are wider: at 5M
# splats sound readings of the gradient reach 2.5e-3 (PERF.md §2).
POSE_LIMITS = {"loss_gap": 6.0e-5, "pose_grad_gap": 7.5e-4, "pose_step_gap": 1.0e-2}


def _run(name):
    spec = small_spec(name)
    if name == CELL:
        spec["limits"] = dict(POSE_LIMITS)
    return harness.run_cell(name, 2 ** 31 + 4321, 0.3, False, "cpu", spec=spec)


@pytest.mark.parametrize("name", [CELL, "view.garden-5m-1080p"])
def test_sound_run_is_correct(name):
    r = _run(name)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] > 0


@pytest.mark.parametrize("fault", [_mean2d_only, _colour_cut, _component_scaled, _pose_unchanged],
                         ids=lambda f: f.__name__)
def test_pose_faults(fault, monkeypatch):
    fault(monkeypatch)
    r = _run(CELL)
    assert not r["correct"], r["checks"]


def test_traced_run_of_the_pose_cell():
    """The pose step's root once a step, its layers' spans, the sum check;
    the readers that need no card read."""
    r = spans.traced(CELL, 2 ** 31 + 99, "cpu", spec=small_spec(CELL))
    assert r["correct"] and r["attempted"] == 2
    got = r["spans"]
    assert got["c3dgs.pose_step"]["count"] == r["attempted"]
    for name in ("accessors", "preprocess", "binning", "stage", "blend", "loss", "backward", "blend_bwd",
                 "reduction", "pose_optimizer"):
        assert got[f"{spans.PREFIX}{name}"]["count"] >= r["attempted"], name
    assert "c3dgs.train_step" not in got and "c3dgs.optimizer" not in got
    total = sum(v["busy_s"] + v["idle_s"] for v in got.values())
    assert total == pytest.approx(r["device"]["window_s"], rel=1e-9)
    assert r["metrics"]["instances.pose"]["value"] > 0 and r["metrics"]["mfu.pose"]["value"] > 0


def test_pose_readers_read_a_pose_window_only():
    frame = dict(visible=1000, instances=3000, needed_instances=2500, power_pairs=10 ** 6, blend_pairs=5 * 10 ** 5)
    ctx = dict(loop="pose", frames=[frame, frame], pixels=1920 * 1080, scene_bytes=10 ** 9, param_bytes=0,
               instances=[3000, 3100], steps=2, kernels={"tiles_packed_bwd_kernel": [2e-3, 2]}, busy_s=0.15,
               window_s=0.2)
    got = {m: harness.load_reader(m)(ctx) for m in ("instances.pose", "k2_roofline_pct.pose", "mfu.pose",
                                                    "device_idle_pct.pose")}
    assert got["instances.pose"] == 3050 and got["device_idle_pct.pose"] == pytest.approx(25.0)
    assert got["k2_roofline_pct.pose"] == pytest.approx(100 * work.k2_least_s(frame, ctx["pixels"]) / 1e-3)
    least = work.view_least_s(frame, ctx["pixels"], 10 ** 9) + work.k2_least_s(frame, ctx["pixels"])
    assert got["mfu.pose"] == pytest.approx(100 * 2 * least / 0.2)
    for m in got:
        assert harness.load_reader(m)(dict(ctx, loop="train")) is None


def test_reference_loads_nothing_of_the_program():
    code = "import benchmark.reference.pose, benchmark.loops.pose\nimport sys; print(' '.join(sys.modules))"
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, check=True,
                         timeout=300)
    mods = {n.split(".")[0] for n in out.stdout.split()}
    assert "torch" in mods and not mods & (set(harness.FORBIDDEN) | {"c3dgs_tpu_torch"})
    assert "benchmark.pose_program" not in out.stdout.split()
