"""Camera-pose recovery, joint scene + pose training and the initial cloud
thickening of the port (c3dgs_tpu_torch.train.camera_opt / joint /
densify_initial) against c3dgs_tpu's on the CPU, on the scenes of
tests/test_camera_opt.py (at most 150 splats, 48x48) and
tests/test_densify_initial.py, each JAX scene carried over leaf by leaf.

Bars:
- the pose loss at atol 1e-6 (the photometric loss's bar in
  tests/test_torch_train.py: the packages' SSIM part by ~2e-6 on one
  image) and its gradient against jax.value_and_grad
  at normalized 5e-4 (tests/test_render.py:150), with and without the
  anchor penalty at a pose equal to its anchor, where JAX's abs'(0) = 1
  gives each component -w/7;
- camera_step: the loss at atol 1e-6 and ev after each of 5 steps within
  1e-5 of JAX's camera_step, the first of them at the anchor;
- optimize_camera given a CapacityPolicy: each step at its bucket, its
  counters fed to it, `clipped` returned and printed (port only);
- joint_step over 3 steps, the first on a camera at its anchor: the loss
  at atol 1e-6, psnr and pose_delta at rtol 1e-5, the counters exactly,
  evs, ev_m, ev_v and ev_t within 1e-5 of JAX's, the scene by
  tests/ply_bars.py (every stored entry within the steps times its
  learning rate, at most 1% beyond 1e-5);
- ports of test_pose_recovery, test_anchor_penalty_keeps_pose_close,
  test_joint_step_updates_scene_and_pose and both densify_initial tests
  with their own bars;
- densify_initial: the kNN indices equal to JAX's on 5,000 points and
  on a grid of ties, the active mask and capacity exactly and every row at
  1e-6.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from c3dgs_tpu.config import OptimizationParams as JOpt
from c3dgs_tpu.models import gaussians as jgauss
from c3dgs_tpu.models import io_ply as jply
from c3dgs_tpu.ops import losses as jlosses
from c3dgs_tpu.render.types import RasterSettings as JSettings
from c3dgs_tpu.train import camera_opt as jcam
from c3dgs_tpu.train import densify_initial as jdi
from c3dgs_tpu.train import joint as jjoint
from c3dgs_tpu.train import trainer as jtrainer
from c3dgs_tpu_torch.config import OptimizationParams
from c3dgs_tpu_torch.models import gaussians as tgauss
from c3dgs_tpu_torch.models import io_ply as tply
from c3dgs_tpu_torch.ops import losses as tlosses
from c3dgs_tpu_torch.render.capacity import CapacityPolicy
from c3dgs_tpu_torch.render.types import RasterSettings
from c3dgs_tpu_torch.train import camera_opt, densify_initial, joint, trainer
from ply_bars import EXTENT, assert_trained_plys_close
from test_torch_serve import carry_over
import torch_cpu  # noqa: F401,E402  (one torch thread per test worker)

KW = dict(width=48, height=48, tanfovx=math.tan(0.5), tanfovy=math.tan(0.5), sh_degree=0)
SET, JSET = RasterSettings(**KW), JSettings(**KW)
BG = np.zeros(3, np.float32)
EV_ID = np.array([0, 0, 0, 1, 0, 0, 0], np.float32)
DELTA = np.array([0.01, -0.01, 0.005, 0, 0.05, -0.04, 0.02], np.float32)  # test_camera_opt.py:28
CPU = dict(device="cpu")


def jax_cloud(n, seed, spread=0.6, capacity=None):
    """tests/test_camera_opt.py's scenes: n points around z = 3."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(n, 3)).astype(np.float32) * spread
    pts[:, 2] += 3.0
    cols = rng.random(size=(n, 3)).astype(np.float32)
    return jgauss.from_point_cloud(pts, cols, capacity=capacity or n, quantization=False)


def render(scene, ev):
    with torch.no_grad():
        return trainer.render_scene(scene, ev, SET, BG, **CPU)["render"].clone()


def normalized_close(got, ref, tol=5e-4):
    scale = max(float(np.abs(ref).max()), 1e-3)
    err = float(np.abs(np.asarray(got) - np.asarray(ref)).max()) / scale
    assert err <= tol, (err, got, ref)
    return err


# ------------------------------------------------------------ camera_step
@pytest.fixture(scope="module")
def pose_case():
    """test_pose_recovery's scene (150 splats), its render at the identity
    as the target, both packages' scenes."""
    js = jax_cloud(150, 1)
    gt = np.array(jtrainer.render_scene(js, jnp.asarray(EV_ID), JSET, jnp.asarray(BG))["render"])
    return js, carry_over(js), gt


@jax.jit
def _jax_pose_loss_and_grad(js, ev, gt, anchor, weight):
    def loss_fn(ev):
        out = jtrainer.render_scene(js, ev, JSET, jnp.zeros(3))
        return jlosses.photometric_loss(out["render"], gt) + weight * jnp.mean(jnp.exp(jnp.abs(anchor - ev)) - 1.0)

    return jax.value_and_grad(loss_fn)(ev)


def test_abs_like_jax_has_jax_derivative_at_zero():
    x = torch.tensor([-0.5, 0.0, 0.5], requires_grad=True)
    (g,) = torch.autograd.grad(tlosses.abs_like_jax(x).sum(), [x])
    np.testing.assert_array_equal(g.numpy(), np.asarray(jax.grad(lambda v: jnp.abs(v).sum())(jnp.asarray(x.detach()))))
    assert g.tolist() == [-1.0, 1.0, 1.0]


@pytest.mark.parametrize("anchor_weight", [0.0, 0.5])
def test_pose_gradient_matches_jax(pose_case, anchor_weight):
    """The pose loss's gradient from a perturbed pose that is also its
    anchor: with weight 0.5 JAX's penalty gradient is -0.5/7 per
    component there."""
    js, ts, gt = pose_case
    ev0 = EV_ID + DELTA
    jl, jg = _jax_pose_loss_and_grad(js, jnp.asarray(ev0), jnp.asarray(gt), jnp.asarray(ev0), anchor_weight)
    tl, tg, out = camera_opt.pose_loss_and_grad(ts, torch.as_tensor(ev0), torch.as_tensor(gt), SET,
                                                torch.as_tensor(BG), torch.as_tensor(ev0), anchor_weight)
    np.testing.assert_allclose(float(tl), float(jl), atol=1e-6, rtol=0)
    normalized_close(tg.numpy(), np.asarray(jg))
    assert int(out["overflow"]) == 0 and ts.xyz.grad is None
    if anchor_weight:
        _, tg_free, _ = camera_opt.pose_loss_and_grad(ts, torch.as_tensor(ev0), torch.as_tensor(gt), SET,
                                                      torch.as_tensor(BG))
        np.testing.assert_allclose((tg - tg_free).numpy(), -anchor_weight / 7, rtol=1e-5)


def test_camera_step_matches_jax_over_five_steps(pose_case):
    js, ts, gt = pose_case
    ev0 = EV_ID + DELTA
    lr, w = 3e-3, 0.5
    jev = jnp.asarray(ev0)
    jopt = jcam.optax.adam(lr).init(jev)
    tev = torch.tensor(ev0)
    tstate = trainer.adam_init({"ev": tev})
    for step in range(5):
        jev, jopt, jl = jcam.camera_step(js, jev, jopt, jnp.asarray(gt), JSET, jnp.asarray(BG), lr, jnp.asarray(ev0), w)
        tev, tstate, m = camera_opt.camera_step(ts, tev, tstate, torch.as_tensor(gt), SET, torch.as_tensor(BG), lr,
                                                torch.as_tensor(ev0), w)
        np.testing.assert_allclose(float(m["loss"]), float(jl), atol=1e-6, rtol=0, err_msg=f"step {step}")
        np.testing.assert_allclose(tev.numpy(), np.asarray(jev), atol=1e-5, rtol=0, err_msg=f"step {step}")
    assert tstate.count == 5 and ts.xyz.grad is None


def test_optimize_camera_feeds_its_policy_and_steps_report_clipped(pose_case, monkeypatch, capsys):
    """With a CapacityPolicy, optimize_camera renders each step at the
    policy's bucket and feeds it the step's counters, as cli/train.py
    does; camera_step returns `clipped`, and a step that dropped tiles
    past the per-splat cap (one tile a splat here) prints a [binning]
    line."""
    _, ts, gt = pose_case
    settings = dataclasses.replace(SET, max_tiles_per_gaussian=1)
    with torch.no_grad():
        want = int(trainer.render_scene(ts, EV_ID + DELTA, settings, BG, **CPU)["clipped"])
    policy = CapacityPolicy(initial=1 << 16)
    fed, steps = [], []
    real_update, real_step = policy.update, camera_opt.camera_step

    def update(*a):
        fed.append(a)
        return real_update(*a)

    def step(scene, ev, state, gt, step_settings, *a):
        ev, state, m = real_step(scene, ev, state, gt, step_settings, *a)
        steps.append((step_settings.instance_capacity, {k: int(m[k]) for k in camera_opt.COUNTERS}))
        return ev, state, m

    monkeypatch.setattr(policy, "update", update)
    monkeypatch.setattr(camera_opt, "camera_step", step)
    camera_opt.optimize_camera(ts, EV_ID + DELTA, gt, settings, iterations=3, lr=3e-3, capacity=policy, **CPU)
    assert [cap for cap, _ in steps] == [1 << 16] * 3
    assert fed == [(c["num_instances"], c["overflow"], c["grad_total"], c["grad_overflow"]) for _, c in steps]
    assert steps[0][1]["clipped"] == want > 0
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("[binning]")]
    assert lines == [f"[binning] camera step {i}: {c['clipped']} tiles dropped past the per-splat tile cap"
                     for i, (_, c) in enumerate(steps)]


def test_pose_recovery():
    """tests/test_camera_opt.py::test_pose_recovery in the port."""
    ts = carry_over(jax_cloud(150, 1))
    gt = render(ts, EV_ID)
    ev0 = EV_ID + DELTA

    def err(ev):
        return float((render(ts, ev) - gt).abs().mean())

    e_before = err(ev0)
    ev_opt, loss = camera_opt.optimize_camera(ts, ev0, gt, SET, iterations=150, lr=3e-3, **CPU)
    e_after = err(ev_opt)
    assert e_after < 0.35 * e_before, (e_before, e_after)
    # translation recovered to ~1e-2
    assert float((ev_opt[4:] - torch.as_tensor(EV_ID[4:])).abs().max()) < 0.03
    assert np.isfinite(loss)
    np.testing.assert_allclose(float(ev_opt[:4].norm()), 1.0, atol=1e-6)


def test_anchor_penalty_keeps_pose_close():
    """tests/test_camera_opt.py::test_anchor_penalty_keeps_pose_close in
    the port; the caller's pose, passed as the start and the anchor, is
    left as it was."""
    ts = carry_over(jax_cloud(80, 2, spread=0.5))
    ev0 = torch.tensor(EV_ID)
    gt = torch.zeros((3, 48, 48))  # pulls pose away (black target)
    ev_free, _ = camera_opt.optimize_camera(ts, ev0, gt, SET, iterations=60, lr=1e-2, **CPU)
    ev_anchored, _ = camera_opt.optimize_camera(ts, ev0, gt, SET, iterations=60, lr=1e-2, anchor=ev0,
                                                anchor_weight=100.0, **CPU)
    np.testing.assert_array_equal(ev0.numpy(), EV_ID)
    drift_free = float((ev_free - ev0).abs().max())
    drift_anch = float((ev_anchored - ev0).abs().max())
    assert drift_anch < drift_free


# ------------------------------------------------------------- joint_step
def joint_case():
    """test_joint_step_updates_scene_and_pose's scene and cameras: 120
    splats at capacity 128, three identity cameras, camera 1 moved 0.05
    in x."""
    js = jax_cloud(120, 2, capacity=128)
    evs = np.stack([EV_ID] * 3)
    evs[1, 4] += 0.05
    return js, evs


def test_joint_step_matches_jax_over_three_steps(tmp_path):
    """Cameras 0, 1, 0: the first step starts at camera 0's anchor (the
    anchor penalty's abs'(0) decides its pose gradient), the target is the
    render of a copy with opacity logits + 1, so no pixel's residual is 0.
    spatial_lr_scale is ply_bars.EXTENT, the extent its xyz bar assumes."""
    jscene, evs = joint_case()
    gt = np.array(jtrainer.render_scene(jscene.replace(opacity=jscene.opacity + 1.0), jnp.asarray(EV_ID), JSET,
                                        jnp.asarray(BG))["render"])
    ts = carry_over(jscene)
    jst = jjoint.create_joint_state(jscene, JOpt(), EXTENT, evs)
    tst = joint.create_joint_state(ts, OptimizationParams(), EXTENT, evs, **CPU)
    pose_lr, w = 1e-3, 0.5
    for step, cam in enumerate((0, 1, 0)):
        jst, jm = jjoint.joint_step(jst, jnp.int32(cam), jnp.asarray(gt), JSET, jnp.asarray(BG), JOpt(), EXTENT,
                                    pose_lr, w)
        tst, tm = joint.joint_step(tst, cam, gt, SET, BG, OptimizationParams(), EXTENT, pose_lr, w, **CPU)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), atol=1e-6, rtol=0, err_msg=f"step {step}")
        for k in ("psnr", "pose_delta"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, atol=1e-7, err_msg=f"step {step} {k}")
        for k in ("num_instances", "overflow", "grad_total", "grad_overflow"):
            assert int(tm[k]) == int(jm[k]), (step, k)
        for k in ("evs", "ev_m", "ev_v", "ev_t"):
            np.testing.assert_allclose(getattr(tst, k).numpy(), np.asarray(getattr(jst, k)), atol=1e-5, rtol=0,
                                       err_msg=f"step {step} {k}")
    # the first step's pose moment is 0.1 * its gradient, the anchor's
    # -w/7 in it: torch.abs would have given the penalty no gradient there
    assert tst.train.step == 3 and int(jst.train.step) == 3
    paths = {}
    for name, save, scene in (("port", tply.save_gaussians_ply, tst.train.scene),
                              ("jax", jply.save_gaussians_ply, jst.train.scene)):
        paths[name] = str(tmp_path / f"{name}.ply")
        save(scene, paths[name])
    assert_trained_plys_close(tply.read_vertices(paths["port"]), tply.read_vertices(paths["jax"]), steps=3)


def test_joint_first_step_at_anchor_moves_pose_as_jax():
    """One joint step on a camera at its anchor with a zero photometric
    gradient is not a no-op: the penalty alone moves each component by
    pose_lr (JAX's abs'(0) = 1, Adam's first step ~lr * sign)."""
    jscene, evs = joint_case()
    ts = carry_over(jscene)
    gt = np.zeros((3, 48, 48), np.float32)
    tst = joint.create_joint_state(ts, OptimizationParams(), 1.0, evs, **CPU)
    with torch.no_grad():
        ts.opacity.fill_(-20.0)  # nothing renders: the image is the background, its gradient 0
    tst, tm = joint.joint_step(tst, 0, gt, SET, BG, OptimizationParams(), 1.0, 1e-3, 0.5, **CPU)
    np.testing.assert_allclose(tst.ev_m[0].numpy(), 0.1 * (-0.5 / 7), rtol=1e-6)
    moved = tst.evs[0].numpy() - evs[0]
    np.testing.assert_allclose(moved[4:], 1e-3, rtol=1e-4)
    assert float(tm["pose_delta"]) > 0


def test_joint_step_updates_scene_and_pose():
    """tests/test_camera_opt.py::test_joint_step_updates_scene_and_pose in
    the port."""
    jscene, evs = joint_case()
    ts = carry_over(jscene)
    opt = OptimizationParams()
    xyz_before = ts.xyz.detach().clone()
    js = joint.create_joint_state(ts, opt, 1.0, evs, **CPU)
    gt = render(ts, EV_ID)
    js2, metrics = joint.joint_step(js, 1, gt, SET, BG, opt, 1.0, 1e-3, 0.5, **CPU)
    assert np.isfinite(float(metrics["loss"]))
    assert float(metrics["pose_delta"]) > 0
    # stepped camera moved, others untouched
    assert not np.allclose(js2.evs[1].numpy(), evs[1])
    np.testing.assert_array_equal(js2.evs[0].numpy(), evs[0])
    np.testing.assert_array_equal(js2.ev_m[2].numpy(), 0.0)
    assert float(js2.ev_t[1]) == 1.0 and float(js2.ev_t[0]) == 0.0
    # scene parameters advanced too
    assert not torch.allclose(js2.train.scene.xyz, xyz_before)
    # quaternion stays normalized
    np.testing.assert_allclose(float(js2.evs[1][:4].norm()), 1.0, atol=1e-6)


# -------------------------------------------------------- densify_initial
def test_knn_indices_match_jax_with_ties():
    # 5,000 points of the bench cloud's shape (N(0, 2) around z = 6): there
    # a dot rounded another way than XLA's (plain products and sums) picks
    # another neighbour in one row
    pts = np.random.default_rng(1).normal(size=(5000, 3)).astype(np.float32) * 2.0
    pts[:, 2] += 6.0
    np.testing.assert_array_equal(densify_initial._knn_indices(pts, 3, **CPU), jdi._knn_indices(pts, 3))
    # a grid: every point has several neighbours at the same distance,
    # and top_k takes the lower index first
    g = np.stack(np.meshgrid(*[np.arange(4.0)] * 3, indexing="ij"), -1).reshape(-1, 3).astype(np.float32)
    np.testing.assert_array_equal(densify_initial._knn_indices(g, 3, **CPU), jdi._knn_indices(g, 3))


def _sparse_scene(rng):
    base = rng.normal(size=(40, 3)).astype(np.float32) * 5.0
    return base, jgauss.from_point_cloud(base, None, capacity=64, quantization=False)


def test_densify_initial_matches_jax(rng):
    """The capacity grows (64 rows, 40 active); the new rows at 1e-6."""
    _, jscene = _sparse_scene(rng)
    ts = carry_over(jscene)
    jout = jdi.densify_initial(jscene, dist_thr_coeff=0.5)
    tout = densify_initial.densify_initial(ts, dist_thr_coeff=0.5)
    assert tout.capacity == jout.capacity > 64 and ts.capacity == 64
    np.testing.assert_array_equal(tout.active.numpy(), np.asarray(jout.active))
    for name in ("xyz", "opacity", "scaling_factor", "features_dc", "features_rest", "scaling", "rotation"):
        np.testing.assert_allclose(getattr(tout, name).detach().numpy(), np.asarray(getattr(jout, name)), atol=1e-6,
                                   rtol=0, err_msg=name)


def test_densify_initial_adds_points(rng):
    """tests/test_densify_initial.py::test_densify_initial_adds_points in
    the port."""
    base, jscene = _sparse_scene(rng)
    scene = carry_over(jscene)
    out = densify_initial.densify_initial(scene, dist_thr_coeff=0.5)
    assert int(out.num_active) > 40
    out.check_state()
    # new points lie within the original bbox (interpolations)
    xyz = out.xyz.detach().numpy()[out.active.numpy()]
    assert xyz.min() >= base.min() - 1e-4
    assert xyz.max() <= base.max() + 1e-4


def test_densify_initial_dense_cloud_noop(rng):
    """tests/test_densify_initial.py::test_densify_initial_dense_cloud_noop
    in the port."""
    base = rng.normal(size=(100, 3)).astype(np.float32) * 0.01
    scene = tgauss.from_point_cloud(base, None, capacity=128, quantization=False, **CPU)
    out = densify_initial.densify_initial(scene, dist_thr_coeff=10.0)
    assert int(out.num_active) == 100
