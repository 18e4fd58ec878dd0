"""Parity of the port's training path (c3dgs_tpu_torch.ops / models /
train) with c3dgs_tpu on the CPU, and ports of tests/test_train.py.

Seeded numpy inputs (or a JAX scene carried over leaf by leaf) go through
both packages:
- photometric_loss value and gradient at atol 1e-6; the straight-through
  fake-quant masks exactly; `observe` at 1e-7; the LR schedule at rtol
  1e-6;
- Adam on identical injected gradients over 3 steps at rtol 1e-6 (eps is
  1e-15, so a first step is ~lr*sign(g): the optimizer is compared on the
  same gradients, never on gradients that differ in sign noise);
- train_step over 3 steps, quantization on and off: losses at rtol 1e-5
  and the gradients before each update (recovered from the first Adam
  moment) at normalized atol 5e-4;
- clone, prune, reset_opacity and pad_to_capacity exactly on the same
  statistics, and split exactly given JAX's normal draws.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from c3dgs_tpu.config import OptimizationParams as JOpt
from c3dgs_tpu.ops import losses as jlosses
from c3dgs_tpu.ops import quantize as jquant
from c3dgs_tpu.render.types import RasterSettings as JSettings
from c3dgs_tpu.train import densify as JD
from c3dgs_tpu.train import trainer as jtrainer
from c3dgs_tpu_torch.config import OptimizationParams
from c3dgs_tpu_torch.models import gaussians as tgauss
from c3dgs_tpu_torch.ops import losses as tlosses
from c3dgs_tpu_torch.ops import quantize as tquant
from c3dgs_tpu_torch.render.types import RasterSettings
from c3dgs_tpu_torch.train import densify as D
from c3dgs_tpu_torch.train import trainer
from test_torch_serve import carry_over
from test_train import toy_scene as jax_toy_scene
import torch_cpu  # noqa: F401,E402  (one torch thread per test worker)

KW = dict(width=32, height=32, tanfovx=math.tan(0.5), tanfovy=math.tan(0.5), sh_degree=0)
SET = RasterSettings(**KW)
EV = np.array([0, 0, 0, 1, 0, 0, 0], np.float32)
BG = np.zeros(3, np.float32)
CPU = dict(device="cpu")


def toy_scene(n=60, cap=96, seed=0, quantization=False):
    """tests/test_train.py::toy_scene, built by the port."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(n, 3)).astype(np.float32) * 0.5
    pts[:, 2] += 3.0
    cols = rng.random(size=(n, 3)).astype(np.float32)
    return tgauss.from_point_cloud(pts, cols, capacity=cap, quantization=quantization, device="cpu")


def perturbed_target(scene):
    """The render of a copy with opacity logits + 1 (test_train.py:37-40)."""
    with torch.no_grad():
        scene.opacity += 1.0
        target = trainer.render_scene(scene, EV, SET, BG, **CPU)["render"].clone()
        scene.opacity -= 1.0
    return target


# ------------------------------------------------------ losses, quantize
def test_photometric_loss_value_and_gradient_match_jax(rng):
    a = rng.random(size=(3, 40, 56)).astype(np.float32)
    b = np.clip(a + rng.normal(size=a.shape) * 0.05, 0, 1).astype(np.float32)
    lj, gj = jax.value_and_grad(jlosses.photometric_loss)(jnp.asarray(a), jnp.asarray(b), 0.2)
    x = torch.tensor(a, requires_grad=True)
    lt = tlosses.photometric_loss(x, torch.as_tensor(b), 0.2)
    lt.backward()
    np.testing.assert_allclose(lt.item(), float(lj), atol=1e-6)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(gj), atol=1e-6)
    for name in ("l1_loss", "l2_loss"):
        t = getattr(tlosses, name)(torch.as_tensor(a), torch.as_tensor(b))
        np.testing.assert_allclose(float(t), float(getattr(jlosses, name)(jnp.asarray(a), jnp.asarray(b))), atol=1e-7)


@pytest.mark.parametrize("initialized", [True, False])
def test_fake_quant_straight_through_masks_match_jax(rng, initialized):
    x = (rng.normal(size=(2000,)) * 1.7).astype(np.float32)
    w = rng.normal(size=x.shape).astype(np.float32)
    lo, hi = float(x.min()) * 0.6, float(x.max()) * 0.6  # some values clamp
    jobs = jquant.set_range(lo, hi) if initialized else jquant.init_observer()
    tobs = tquant.set_range(lo, hi) if initialized else tquant.init_observer()
    gj = jax.grad(lambda v: jnp.vdot(jnp.asarray(w), jquant.fake_quant(v, jobs)))(jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    (torch.as_tensor(w) * tquant.fake_quant(xt, tobs)).sum().backward()
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(gj))
    if initialized:
        assert (xt.grad.numpy() == 0).any() and (xt.grad.numpy() == w).any()
    gh = jax.grad(lambda v: jnp.vdot(jnp.asarray(w), jquant.fake_quant_half(v * 50)))(jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    (torch.as_tensor(w) * tquant.fake_quant_half(xt * 50)).sum().backward()
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(gh))


def test_observe_matches_jax(rng):
    jo, to = jquant.init_observer(), tquant.init_observer()
    for scale in (1.0, 3.0, 0.2):  # the first batch sets the range, later ones EMA
        x = (rng.normal(size=(500, 3)) * scale + 0.3).astype(np.float32)
        jo, to = jquant.observe(jo, jnp.asarray(x)), tquant.observe(to, torch.as_tensor(x))
        for a, b in zip(to, jo):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-7, rtol=0)
    pos = np.abs(rng.normal(size=100)).astype(np.float32) + 1.0
    to = tquant.observe(tquant.init_observer(), torch.as_tensor(pos))
    assert float(to.min_val) == 0.0  # the range always includes 0


def test_lr_schedule_matches_jax():
    from c3dgs_tpu.ops import misc as jmisc
    from c3dgs_tpu_torch.ops import misc as tmisc

    for kw in (dict(lr_init=1.6e-4, lr_final=1.6e-6, lr_delay_mult=0.01, max_steps=30_000),
               dict(lr_init=1e-2, lr_final=1e-4, lr_delay_steps=100, lr_delay_mult=0.1, max_steps=1000)):
        a, b = jmisc.get_expon_lr_func(**kw), tmisc.get_expon_lr_func(**kw)
        for step in (0, 1, 2, 50, 99, 500, 999, 5000, 40_000):
            np.testing.assert_allclose(b(step), float(a(step)), rtol=1e-6)
        assert b(-1) == 0.0


# ---------------------------------------------------------------- Adam
def test_adam_on_injected_gradients_matches_jax(rng):
    shapes = {"xyz": (50, 3), "opacity": (50, 1), "features_rest": (50, 15, 3)}
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    opt = OptimizationParams()
    tx = jtrainer.make_optimizer(JOpt(), 1.0)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = tx.init(jp)
    tp = {k: torch.tensor(v) for k, v in params.items()}
    tstate = trainer.adam_init(tp)
    sched = trainer.make_lr_schedules(opt, 1.0)
    for _ in range(3):
        g = {k: (rng.normal(size=s) * 1e-3).astype(np.float32) for k, s in shapes.items()}
        upd, jstate = tx.update({k: jnp.asarray(v) for k, v in g.items()}, jstate, jp)
        jp = {k: jp[k] + upd[k] for k in jp}
        trainer.adam_update(tstate, tp, {k: torch.as_tensor(v) for k, v in g.items()}, sched)
        for k in shapes:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-7, err_msg=k)
            np.testing.assert_allclose(tstate.mu[k].numpy(), np.asarray(jstate[0].mu[k]), rtol=1e-6, atol=0)
            np.testing.assert_allclose(tstate.nu[k].numpy(), np.asarray(jstate[0].nu[k]), rtol=1e-6, atol=0)
    assert tstate.count == int(jstate[0].count) == 3 and tstate.step == int(jstate[1]) == 3


# ----------------------------------------------------------- train_step
def train_step_parity(quantization: bool, steps: int = 3, **over):
    """train_step of both packages over `steps` steps from the same toy
    scene, with the RasterSettings overrides `over`: losses, counters, the
    gradients recovered from Adam's first moment, densify statistics and
    observers."""
    jset, tset = JSettings(**KW, **over), RasterSettings(**KW, **over)
    js = jax_toy_scene(quantization=quantization)
    jtarget = jtrainer.render_scene(js.replace(opacity=js.opacity + 1.0), jnp.asarray(EV), jset,
                                    jnp.asarray(BG))["render"]
    target = np.array(jtarget)
    ts = carry_over(js)
    jstate = jtrainer.create_train_state(js, JOpt(), 1.0)
    tstate = trainer.create_train_state(ts, OptimizationParams(), 1.0, **CPU)
    jmu_prev = {k: 0.0 for k in trainer.PARAM_FIELDS}
    tmu_prev = dict(jmu_prev)
    for step in range(steps):
        jstate, jm = jtrainer.train_step(jstate, jnp.asarray(EV), jtarget, jset, jnp.asarray(BG), JOpt(), 1.0)
        tstate, tm = trainer.train_step(tstate, EV, target, tset, BG, OptimizationParams(), 1.0, **CPU)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
        for k in ("num_instances", "overflow", "grad_total", "grad_overflow"):
            assert int(tm[k]) == int(jm[k]), k
        for k, mu in tstate.opt_state.mu.items():
            jmu = np.asarray(jstate.opt_state[0].mu[k])
            tmu = mu.numpy()
            gj = (jmu - 0.9 * jmu_prev[k]) / 0.1  # this step's gradient
            gt = (tmu - 0.9 * tmu_prev[k]) / 0.1
            scale = max(np.abs(gj).max(), 1e-3)
            np.testing.assert_allclose(gt / scale, gj / scale, atol=5e-4, err_msg=f"step {step} grad {k}")
            jmu_prev[k], tmu_prev[k] = jmu, tmu
        np.testing.assert_allclose(tstate.stats.denom.numpy(), np.asarray(jstate.stats.denom))
        np.testing.assert_allclose(tstate.stats.xyz_gradient_accum.numpy(),
                                   np.asarray(jstate.stats.xyz_gradient_accum), rtol=1e-3, atol=1e-7)
    for name in tgauss.QUANT_FIELDS:
        for a, b in zip(tstate.scene.observer(name), getattr(jstate.scene.quant, name)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)


@pytest.mark.parametrize("quantization", [False, True])
def test_train_step_matches_jax(quantization):
    train_step_parity(quantization)


def test_quantized_scene_gets_gradient_on_every_field():
    scene = toy_scene(quantization=True)
    rng = np.random.default_rng(1)
    with torch.no_grad():  # anisotropic, rotated splats: rotation matters
        scene.rotation.copy_(torch.as_tensor(rng.normal(size=(scene.capacity, 4)), dtype=torch.float32))
        scene.scaling.mul_(torch.as_tensor(rng.uniform(0.3, 1.0, size=(scene.capacity, 3)), dtype=torch.float32))
    for _ in range(3):
        scene.oneup_sh_degree()
    scene.update_observers()
    assert float(scene.quant_opacity[2]) == 1.0
    target = perturbed_target(scene)
    _, _, grads, vs_grad = trainer.loss_and_grads(scene, EV, target, SET, BG, OptimizationParams())
    for k in trainer.PARAM_FIELDS:
        assert float(grads[k].abs().max()) > 0, k
    assert float(vs_grad.abs().max()) > 0


# ----------------------------------------------------------- densify
def densify_inputs(quantization):
    rng = np.random.default_rng(4)
    js = jax_toy_scene(quantization=quantization)
    js = js.replace(opacity=jnp.asarray(rng.normal(size=js.opacity.shape).astype(np.float32) * 2))
    if quantization:
        js = js.update_observers()
    g = rng.random(js.capacity).astype(np.float32) * 2e-4
    return js, g


@pytest.mark.parametrize("quantization", [False, True])
def test_densify_prune_reset_pad_match_jax_exactly(quantization):
    js, g = densify_inputs(quantization)
    ts = carry_over(js)
    fields = ("xyz", "opacity", "scaling_factor", "features_dc", "features_rest", "scaling", "rotation", "active")

    def same(tscene, jscene, xyz_atol=0.0):
        for f in fields:
            a, b = getattr(tscene, f).detach().numpy(), np.asarray(getattr(jscene, f))
            if f == "xyz" and xyz_atol:
                np.testing.assert_allclose(a, b, rtol=0, atol=xyz_atol)
            else:
                np.testing.assert_array_equal(a, b, err_msg=f)

    # an extent that sends about half of the splats to clone, half to split
    extent = float(np.median(np.asarray(js.get_scaling()).max(1)[:60])) / 0.01
    js1, wj, dj = JD.densify_and_clone(js, jnp.asarray(g), 1e-4, extent, 0.01)
    ts1, wt, dt = D.densify_and_clone(ts, torch.as_tensor(g), 1e-4, extent, 0.01)
    same(ts1, js1)
    np.testing.assert_array_equal(wt.numpy(), np.asarray(wj))
    assert int(dt) == int(dj) and 0 < int(wt.sum())

    key = jax.random.PRNGKey(3)
    js2, wj, dj, _ = JD.densify_and_split(js1, jnp.asarray(g), 1e-4, extent, 0.01, key)
    draws = []
    for _ in range(2):  # densify_and_split's key sequence
        key, sub = jax.random.split(key)
        draws.append(torch.tensor(np.asarray(jax.random.normal(sub, (js.capacity, 3)))))
    ts2, wt, dt = D.split_with_samples(ts1, torch.as_tensor(g), 1e-4, extent, 0.01, draws)
    # a child's offset is the draw times get_scaling(), whose exp rounds
    # differently in XLA and torch by up to an ulp; every other field is exact
    same(ts2, js2, xyz_atol=1e-6)
    np.testing.assert_array_equal(wt.numpy(), np.asarray(wj))
    assert int(dt) == int(dj) > 0  # the free slots ran out: writes dropped and counted

    stats = JD.DensifyStats(jnp.asarray(g), jnp.ones(js.capacity), jnp.asarray(np.arange(js.capacity) % 40.0))
    tstats = D.DensifyStats(*(torch.tensor(np.asarray(v), dtype=torch.float32) for v in stats))
    js3 = JD.prune(js2, stats, 0.3, 3.0, 30.0)
    ts3 = D.prune(ts2, tstats, 0.3, 3.0, 30.0)
    assert 0 < int(js3.num_active) < int(js2.num_active)
    same(ts3, js3, xyz_atol=1e-6)
    same(D.reset_opacity(ts3), JD.reset_opacity(js3), xyz_atol=1e-6)
    ts4, js4 = ts3.pad_to_capacity(130), JD.reset_opacity(js3).pad_to_capacity(130)
    same(ts4, js4, xyz_atol=1e-6)
    ts4.check_state()
    assert int(ts4.num_active) == int(js4.num_active)


# ----------------------------------------- ports of tests/test_train.py
def test_train_step_reduces_loss():
    scene = toy_scene()
    opt = OptimizationParams(lambda_dssim=0.2)
    state = trainer.create_train_state(scene, opt, spatial_lr_scale=1.0, **CPU)
    target = perturbed_target(scene)
    losses = []
    for _ in range(25):
        state, metrics = trainer.train_step(state, EV, target, SET, BG, opt, 1.0, **CPU)
        losses.append(float(metrics["loss"]))
    assert losses[-1] < 0.7 * losses[0], losses[:3] + losses[-3:]
    assert np.isfinite(losses).all()


def test_densify_stats_and_step():
    scene = toy_scene()
    opt = OptimizationParams(percent_dense=0.01, densify_grad_threshold=1e-9)
    state = trainer.create_train_state(scene, opt, spatial_lr_scale=1.0, **CPU)
    target = np.zeros((3, 32, 32), np.float32)
    for _ in range(3):
        state, _ = trainer.train_step(state, EV, target, SET, BG, opt, 1.0, **CPU)
    assert float(state.stats.denom.max()) > 0
    n_before = int(state.scene.num_active)
    state, dropped = trainer.densify_step(state, 10.0, opt, **CPU)
    assert int(state.scene.num_active) != n_before
    assert bool(torch.isfinite(state.scene.xyz).all())
    state.scene.check_state()
    state, _ = trainer.densify_step(state, 10.0, opt, max_screen_size=20.0, **CPU)
    assert bool(torch.isfinite(state.scene.xyz).all())
    state.scene.check_state()


def test_prune_removes_transparent():
    scene = toy_scene()
    with torch.no_grad():
        scene.opacity[:30] = -12.0  # sigmoid ~ 6e-6
    n = int(scene.num_active)
    pruned = D.prune(scene, D.DensifyStats.zeros(scene.capacity), min_opacity=0.005, extent=10.0,
                     max_screen_size=None)
    assert int(pruned.num_active) == n - 30


def test_reset_opacity():
    scene = toy_scene()
    state = trainer.create_train_state(scene, OptimizationParams(), spatial_lr_scale=1.0, **CPU)
    state.opt_state.mu["opacity"].fill_(1.0)
    state = trainer.reset_opacity_step(state, **CPU)
    op = state.scene.get_opacity().detach().numpy()
    active = state.scene.active.numpy()
    assert (op[active] <= 0.011).all()
    assert not state.opt_state.mu["opacity"].any()


def test_split_shrinks_children():
    scene = toy_scene()
    before = scene.get_scaling().detach().numpy()
    gen = torch.Generator().manual_seed(0)
    out, written, dropped = D.densify_and_split(
        scene, torch.full((scene.capacity,), 1.0), 0.5, scene_extent=1e-6, percent_dense=1.0, generator=gen
    )
    w = written.numpy()
    assert w.any()
    after = out.get_scaling().detach().numpy()
    # children are 1/1.6x the parent scale
    assert np.median(np.linalg.norm(after[w], axis=1)) < 0.8 * np.median(np.linalg.norm(before[:60], axis=1))


def test_capacity_growth_roundtrip():
    scene = toy_scene(n=60, cap=64)
    opt = OptimizationParams()
    state = trainer.create_train_state(scene, opt, 1.0, **CPU)
    state = trainer.grow_capacity(state, 128, **CPU)
    assert state.scene.capacity == 128
    state, metrics = trainer.train_step(state, EV, np.zeros((3, 32, 32), np.float32), SET, BG, opt, 1.0, **CPU)
    assert np.isfinite(float(metrics["loss"]))


def test_capacity_growth_preserves_adam_moments():
    """Growth must not reset existing splats' optimizer state: the
    reference zero-pads only the new rows (gaussian_model.py:1161-1185)."""
    scene = toy_scene(n=60, cap=64)
    opt = OptimizationParams()
    state = trainer.create_train_state(scene, opt, 1.0, **CPU)
    target = np.zeros((3, 32, 32), np.float32)
    for _ in range(3):
        state, _ = trainer.train_step(state, EV, target, SET, BG, opt, 1.0, **CPU)
    before = state.opt_state
    mu_b = {k: v.clone() for k, v in before.mu.items()}
    nu_b = {k: v.clone() for k, v in before.nu.items()}
    state = trainer.grow_capacity(state, 128, **CPU)
    after = state.opt_state
    assert (after.count, after.step) == (before.count, before.step) == (3, 3)
    for k in mu_b:
        assert after.mu[k].shape[0] == 128 and after.nu[k].shape[0] == 128
        assert torch.equal(after.mu[k][:64], mu_b[k]) and torch.equal(after.nu[k][:64], nu_b[k])
        assert not after.mu[k][64:].any() and not after.nu[k][64:].any()
    assert bool(mu_b["xyz"].any())  # not vacuous: xyz gets gradient at sh_degree 0
    assert state.stats.denom.shape == (128,)
    state, metrics = trainer.train_step(state, EV, target, SET, BG, opt, 1.0, **CPU)
    assert np.isfinite(float(metrics["loss"]))


def test_training_entry_points_raise_without_cuda_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    scene = toy_scene()
    opt = OptimizationParams()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        trainer.create_train_state(scene, opt, 1.0)
    state = trainer.create_train_state(scene, opt, 1.0, **CPU)
    target = np.zeros((3, 32, 32), np.float32)
    for call in (
        lambda: trainer.train_step(state, EV, target, SET, BG, opt, 1.0),
        lambda: trainer.grow_capacity(state, 128),
        lambda: trainer.densify_step(state, 10.0, opt),
        lambda: trainer.reset_opacity_step(state),
    ):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


# ------------------------------------------- packed against per-tile
def family_losses(steps: int = 3) -> dict:
    """train_step losses of both packages' kernel families from the same
    scene: tests/synth.py's ground-truth scene (400 gaussians) seen by its
    first ring camera at 64x64, trained toward its render with opacity
    logits + 1. Returns {packed: (JAX losses, port losses)}."""
    import synth

    kw = dict(width=64, height=64, tanfovx=math.tan(0.45), tanfovy=math.tan(0.45), sh_degree=0)
    ev = synth.ring_cameras()[0][0]
    scene = synth.gt_scene()
    jtarget = jtrainer.render_scene(scene.replace(opacity=scene.opacity + 1.0), jnp.asarray(ev), JSettings(**kw),
                                    jnp.asarray(BG))["render"]
    target = np.array(jtarget)
    out = {}
    for packed in (True, False):
        jset, tset = JSettings(**kw, packed=packed), RasterSettings(**kw, packed=packed)
        tstate = trainer.create_train_state(carry_over(scene), OptimizationParams(), 1.0, **CPU)
        jstate = jtrainer.create_train_state(jax.tree.map(jnp.copy, scene), JOpt(), 1.0)  # train_step donates
        jl, tl = [], []
        for _ in range(steps):
            jstate, jm = jtrainer.train_step(jstate, jnp.asarray(ev), jtarget, jset, jnp.asarray(BG), JOpt(), 1.0)
            tstate, tm = trainer.train_step(tstate, ev, target, tset, BG, OptimizationParams(), 1.0, **CPU)
            jl.append(float(jm["loss"]))
            tl.append(float(tm["loss"]))
        out[packed] = (jl, tl)
    return out


if __name__ == "__main__":
    # How far the packed and per-tile families' losses part in each package
    # over 3 steps on the CPU: PYTHONPATH=. python tests/test_torch_train.py
    jax.config.update("jax_platforms", "cpu")
    losses = family_losses()
    for step, (jp, tp, jq, tq) in enumerate(zip(*losses[True], *losses[False]), 1):
        print(f"step {step}: JAX packed {jp:.9f} per-tile {jq:.9f} (rel {(jp - jq) / jp:+.3e}); "
              f"port packed {tp:.9f} per-tile {tq:.9f} (rel {(tp - tq) / tp:+.3e})")
