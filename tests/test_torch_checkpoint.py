"""The port's training checkpoints (c3dgs_tpu_torch.train.checkpoint)
against c3dgs_tpu's on the CPU, and ports of tests/test_checkpoint.py.

The file is the contract: either package's checkpoint loads in the other.
- round trip in the port: the next step from the saved and the restored
  state agrees exactly (loss at 1e-7, xyz and Adam's mu at atol 1e-7, as
  tests/test_checkpoint.py holds JAX);
- a JAX checkpoint loaded by the port holds JAX's arrays exactly, and its
  next train_step matches JAX's next step at the train bars
  (tests/test_torch_train.py): loss at rtol 1e-5, this step's gradients
  (recovered from Adam's first moment) at normalized atol 5e-4;
- a port checkpoint loads in JAX with the port's arrays exactly, and its
  `key` is jax.random.PRNGKey of the port generator's seed.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from c3dgs_tpu.config import OptimizationParams as JOpt
from c3dgs_tpu.render.types import RasterSettings as JSettings
from c3dgs_tpu.train import checkpoint as jckpt
from c3dgs_tpu.train import trainer as jtrainer
from c3dgs_tpu_torch.config import OptimizationParams
from c3dgs_tpu_torch.models import gaussians as tgauss
from c3dgs_tpu_torch.render.types import RasterSettings
from c3dgs_tpu_torch.train import checkpoint, trainer
from test_checkpoint import toy_state as jax_toy_state
from test_torch_serve import carry_over
import torch_cpu  # noqa: F401,E402  (one torch thread per test worker)

KW = dict(width=32, height=32, tanfovx=math.tan(0.5), tanfovy=math.tan(0.5), sh_degree=0)
SET = RasterSettings(**KW)
EV = np.array([0, 0, 0, 1, 0, 0, 0], np.float32)
BG = np.zeros(3, np.float32)
TARGET = np.full((3, 32, 32), 0.3, np.float32)
CPU = dict(device="cpu")
OPT = OptimizationParams()


def toy_state(quantization=True):
    """tests/test_checkpoint.py::toy_state, built by the port."""
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(50, 3)).astype(np.float32) * 0.5
    pts[:, 2] += 3.0
    cols = rng.random(size=(50, 3)).astype(np.float32)
    scene = tgauss.from_point_cloud(pts, cols, capacity=64, quantization=quantization, **CPU)
    return trainer.create_train_state(scene, OPT, 1.0, **CPU)


def step(state):
    return trainer.train_step(state, EV, TARGET, SET, BG, OPT, 1.0, **CPU)


def test_checkpoint_roundtrip_resumes_identically(tmp_path):
    state = toy_state()
    for _ in range(3):
        state, _ = step(state)
    p = str(tmp_path / "ckpt.npz")
    checkpoint.save_checkpoint(p, state)
    restored = checkpoint.load_checkpoint(p, OPT, 1.0, **CPU)
    assert restored.step == state.step == 3 and restored.opt_state.count == 3 and restored.opt_state.step == 3
    np.testing.assert_array_equal(restored.scene.xyz.detach().numpy(), state.scene.xyz.detach().numpy())
    assert torch.equal(restored.generator.get_state(), state.generator.get_state())
    s1, m1 = step(state)
    s2, m2 = step(restored)
    assert abs(float(m1["loss"]) - float(m2["loss"])) < 1e-7
    np.testing.assert_allclose(s1.scene.xyz.detach().numpy(), s2.scene.xyz.detach().numpy(), atol=1e-7)
    np.testing.assert_allclose(s1.opt_state.mu["xyz"].numpy(), s2.opt_state.mu["xyz"].numpy(), atol=1e-7)
    # the densify draws continue from the same generator state
    assert torch.equal(torch.randn(4, generator=s1.generator), torch.randn(4, generator=s2.generator))


def test_checkpoint_indexed_scene(tmp_path):
    state = toy_state()
    state = trainer.create_train_state(state.scene.to_indexed(), OPT, 1.0, **CPU)
    p = str(tmp_path / "ckpt_idx.npz")
    checkpoint.save_checkpoint(p, state)
    restored = checkpoint.load_checkpoint(p, OPT, 1.0, **CPU)
    assert restored.scene.is_color_indexed and restored.scene.is_gaussian_indexed
    np.testing.assert_array_equal(restored.scene.feature_indices.numpy(), state.scene.feature_indices.numpy())


def jax_trained(steps=3):
    jstate, jopt = jax_toy_state()
    jset = JSettings(**KW)
    for _ in range(steps):
        jstate, _ = jtrainer.train_step(jstate, jnp.asarray(EV), jnp.asarray(TARGET), jset, jnp.asarray(BG),
                                        jopt, 1.0)
    return jstate, jopt, jset


def assert_state_matches_jax(tstate, jstate):
    for name in ("xyz", "opacity", "scaling_factor", "active", "features_dc", "features_rest", "scaling",
                 "rotation"):
        np.testing.assert_array_equal(getattr(tstate.scene, name).detach().numpy(),
                                      np.asarray(getattr(jstate.scene, name)), err_msg=name)
    for name in tgauss.QUANT_FIELDS:
        for a, b in zip(tstate.scene.observer(name), getattr(jstate.scene.quant, name)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
    adam, jstep = jstate.opt_state
    for k in tstate.opt_state.mu:
        np.testing.assert_array_equal(tstate.opt_state.mu[k].numpy(), np.asarray(adam.mu[k]), err_msg=k)
        np.testing.assert_array_equal(tstate.opt_state.nu[k].numpy(), np.asarray(adam.nu[k]), err_msg=k)
    assert (tstate.opt_state.count, tstate.opt_state.step, tstate.step) == (int(adam.count), int(jstep),
                                                                             int(jstate.step))
    for f in ("xyz_gradient_accum", "denom", "max_radii2d"):
        np.testing.assert_array_equal(getattr(tstate.stats, f).numpy(), np.asarray(getattr(jstate.stats, f)))
    assert tstate.scene.active_sh_degree == jstate.scene.active_sh_degree


def test_jax_checkpoint_loads_in_port_and_takes_jax_step(tmp_path):
    jstate, jopt, jset = jax_trained()
    p = str(tmp_path / "jax.npz")
    jckpt.save_checkpoint(p, jstate)
    tstate = checkpoint.load_checkpoint(p, OPT, 1.0, **CPU)
    assert_state_matches_jax(tstate, jstate)
    k0, k1 = (int(w) for w in np.asarray(jstate.key))
    assert tstate.generator.initial_seed() == (k0 << 32) | k1
    jmu_prev = {k: np.asarray(v) for k, v in jstate.opt_state[0].mu.items()}
    tmu_prev = {k: v.clone().numpy() for k, v in tstate.opt_state.mu.items()}
    jstate, jm = jtrainer.train_step(jstate, jnp.asarray(EV), jnp.asarray(TARGET), jset, jnp.asarray(BG), jopt, 1.0)
    tstate, tm = step(tstate)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
    for k, mu in tstate.opt_state.mu.items():
        gj = (np.asarray(jstate.opt_state[0].mu[k]) - 0.9 * jmu_prev[k]) / 0.1
        gt = (mu.numpy() - 0.9 * tmu_prev[k]) / 0.1
        scale = max(np.abs(gj).max(), 1e-3)
        np.testing.assert_allclose(gt / scale, gj / scale, atol=5e-4, err_msg=k)


@pytest.mark.parametrize("indexed", [False, True])
def test_port_checkpoint_loads_in_jax(tmp_path, indexed):
    jstate, jopt, _ = jax_trained()
    tstate = checkpoint.load_checkpoint(_saved(tmp_path, jstate), OPT, 1.0, **CPU)
    if indexed:
        tstate.scene = tstate.scene.to_indexed()
    tstate.generator.manual_seed(7)
    p = str(tmp_path / "port.npz")
    checkpoint.save_checkpoint(p, tstate)
    back = jckpt.load_checkpoint(p, jopt, 1.0)
    assert_state_matches_jax(tstate, back)
    assert back.scene.is_color_indexed == indexed and back.scene.is_gaussian_indexed == indexed
    if indexed:
        np.testing.assert_array_equal(np.asarray(back.scene.gaussian_indices),
                                      tstate.scene.gaussian_indices.numpy())
    np.testing.assert_array_equal(np.asarray(back.key), np.asarray(jax.random.PRNGKey(7)))


def _saved(tmp_path, jstate):
    p = str(tmp_path / "jax_src.npz")
    jckpt.save_checkpoint(p, jstate)
    return p
