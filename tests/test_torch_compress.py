"""Parity of the port's compression path (c3dgs_tpu_torch.compress,
train/finetune.py, the indexed scene and its ops) with c3dgs_tpu on the
CPU, and ports of tests/test_compress.py.

Seeded numpy inputs, or a JAX scene carried over leaf by leaf, go through
both packages (Pallas in interpret mode), on toy scenes of at most 400
splats, 64x64 views, codebooks of 64 rows and a few k-means steps:
- nearest_codebook: argmin equal on separated data, min distance at rtol
  1e-5;
- the k-means loop fed JAX's draws (the key splits of _kmeans_run): the
  codebook and entry importance at atol 1e-5 (values O(1)) after 8 steps,
  with and without scale_normalize;
- extract_rot_scale: the covariance rebuilt from (rotation, scale) at atol
  1e-6 / rtol 1e-6 (eigenvector signs and order may differ, so
  quaternions are not compared);
- calc_importance over two views in exact mode: both outputs at
  normalized atol 5e-4 (tests/test_render.py:150);
- compress_color / compress_covariance given JAX's codebooks and indices,
  and a JAX to_compressed scene carried across: images at atol 2e-5 /
  rtol 1e-4 (tests/test_render.py:113), codebook-table gradients against
  jax.grad at normalized atol 5e-4 in exact mode;
- blocked colors against the dense gather at atol 1e-6;
- compact, permute and morton_sorted exactly;
- finetune over 3 steps: per-step losses at rtol 1e-4, the caller's scene
  unchanged bit for bit.
"""
import dataclasses
import functools
import math
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from c3dgs_tpu.compress import importance as jimp
from c3dgs_tpu.compress import pipeline as jpipeline
from c3dgs_tpu.compress import vq as jvq
from c3dgs_tpu.config import CompressionParams as JComp
from c3dgs_tpu.config import OptimizationParams as JOpt
from c3dgs_tpu.models import gaussians as jgauss
from c3dgs_tpu.ops import quat as jquat
from c3dgs_tpu.render.types import RasterSettings as JSettings
from c3dgs_tpu.train import finetune as jfinetune
from c3dgs_tpu.train import trainer as jtrainer
from c3dgs_tpu_torch.compress import importance as timp
from c3dgs_tpu_torch.compress import pipeline as tpipeline
from c3dgs_tpu_torch.compress import vq as tvq
from c3dgs_tpu_torch.config import CompressionParams, OptimizationParams
from c3dgs_tpu_torch.models import gaussians as tgauss
from c3dgs_tpu_torch.ops import losses as tlosses
from c3dgs_tpu_torch.ops import quat as tquat
from c3dgs_tpu_torch.ops import sh as tsh
from c3dgs_tpu_torch.ops.segment import gather_rows, segment_sum
from c3dgs_tpu_torch.render.types import RasterSettings
from c3dgs_tpu_torch.train import finetune as tfinetune
from c3dgs_tpu_torch.train import trainer
from test_torch_serve import carry_over
import torch_cpu  # noqa: F401,E402  (one torch thread per test worker)

IMG_TOL = dict(atol=2e-5, rtol=1e-4)  # tests/test_render.py:113
GRAD_TOL = 5e-4  # normalized, exact mode, tests/test_render.py:150
CPU = dict(device="cpu")
BG = np.zeros(3, np.float32)
INTRINSIC = np.array([[1.0, 0, 64], [0, 1.0, 64], [0, 0, 1]], np.float32)  # FoV radians, W, H
KW = dict(width=64, height=64, tanfovx=math.tan(0.5), tanfovy=math.tan(0.5), sh_degree=3)
SMALL_COMP = dict(
    color_codebook_size=64, gaussian_codebook_size=64, color_cluster_iterations=8,
    gaussian_cluster_iterations=8, color_batch_size=128, gaussian_batch_size=128,
)


def extrinsic(yaw: float, tx: float = 0.0) -> np.ndarray:
    """A (qx, qy, qz, qw, tx, ty, tz) world-to-camera vector: a yaw about y
    and a shift along x."""
    return np.array([0, math.sin(yaw / 2), 0, math.cos(yaw / 2), tx, 0, 0], np.float32)


EVS = (extrinsic(0.0), extrinsic(0.12, 0.2))


@functools.lru_cache
def jax_scene(n=150, seed=0):
    """tests/test_compress.py::toy_scene with SH degree 3 active, small
    random higher bands and varied shapes; observers initialized."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(n, 3)).astype(np.float32) * 0.5
    pts[:, 2] += 3.0
    cols = rng.random(size=(n, 3)).astype(np.float32)
    scene = jgauss.from_point_cloud(pts, cols, capacity=n, quantization=True)
    scene = scene.replace(
        features_rest=jnp.asarray(rng.normal(size=scene.features_rest.shape).astype(np.float32) * 0.1),
        rotation=jnp.asarray(rng.normal(size=(n, 4)).astype(np.float32)),
        scaling=jnp.asarray(np.abs(rng.normal(size=(n, 3))).astype(np.float32) + 0.1),
        active_sh_degree=3,
    )
    return scene.update_observers()


# JAX renders under jit: on these scenes, the uncompressed one and its
# compression, every accessor under jit is within 5e-7 of the eager one.
# (A scene loaded from an npz is not: its observers are re-pinned to the
# dequantized ranges, and under jit some fake-quantized colors move by one
# int8 step, so tests/test_torch_model_io.py renders JAX eagerly.)
jax_render = jax.jit(jtrainer.render_scene, static_argnums=(2,))


@functools.lru_cache
def cameras(offset=False):
    """Two views whose images are jax_scene()'s renders; with `offset`,
    each pixel moved by 0.02-0.06 either way, so the L1 term's sign does
    not rest on the packages' last-ulp differences."""
    out = []
    rng = np.random.default_rng(7)
    for ev in EVS:
        img = np.asarray(jax_render(jax_scene(), jnp.asarray(ev), JSettings(**KW), jnp.asarray(BG))["render"])
        if offset:
            img = img + rng.uniform(0.02, 0.06, img.shape).astype(np.float32) * rng.choice([-1, 1], img.shape)
        out.append(SimpleNamespace(extrinsic_vector=ev, intrinsic=INTRINSIC, original_image=img))
    return out


def assert_normalized(got, ref, atol, name=""):
    ref = np.asarray(ref, np.float64)
    scale = max(np.abs(ref).max(), 1e-3)
    np.testing.assert_allclose(np.asarray(got, np.float64) / scale, ref / scale, atol=atol, err_msg=name)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ------------------------------------------------------------------- VQ
def test_nearest_codebook_matches_jax(rng):
    cb = rng.normal(size=(64, 8)).astype(np.float32) * 3.0
    x = (cb[rng.integers(0, 64, 500)] + rng.normal(size=(500, 8)) * 0.3).astype(np.float32)
    dj, ij = jvq.nearest_codebook(jnp.asarray(x), jnp.asarray(cb))
    dt, it = tvq.nearest_codebook(torch.as_tensor(x), torch.as_tensor(cb))
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-5, atol=1e-6)


def jax_draws(features, codebook_size, batch, steps, seed=0):
    """_kmeans_run's draws: the initial codebook from the first split, then
    one randint per step from the keys of the second."""
    key = jax.random.PRNGKey(seed)
    key, sub = jax.random.split(key)
    cb0 = jvq._uniform_init(sub, (codebook_size, features.shape[1]), jnp.asarray(features))
    keys = jax.random.split(key, steps)
    idx = jnp.stack([jax.random.randint(k, (batch,), 0, features.shape[0]) for k in keys])
    return np.array(cb0), np.array(idx)


@pytest.mark.parametrize("scale_normalize", [False, True])
def test_kmeans_loop_fed_jax_draws_matches_jax(rng, scale_normalize):
    if scale_normalize:  # normalized covariances, as covariance VQ clusters them
        feats = np.array(jax_scene(n=400).get_normalized_covariance())
    else:
        feats = rng.normal(size=(400, 12)).astype(np.float32)
    imp = rng.random(400).astype(np.float32) ** 3
    c, b, steps = 64, 128, 8
    cbj, eij, errj = jvq._kmeans_run(jnp.asarray(feats), jnp.asarray(imp), c, b, steps, 0.8, scale_normalize,
                                     jax.random.PRNGKey(0))
    cb0, idx = jax_draws(feats, c, b, steps)
    cbt, eit, errt = tvq.kmeans_loop(torch.as_tensor(feats), torch.as_tensor(imp), torch.as_tensor(cb0),
                                     torch.as_tensor(idx).long(), 0.8, scale_normalize)
    np.testing.assert_allclose(cbt.numpy(), np.asarray(cbj), atol=1e-5, rtol=0)
    np.testing.assert_allclose(eit.numpy(), np.asarray(eij), atol=1e-5, rtol=0)
    np.testing.assert_allclose(errt.numpy(), np.asarray(errj), rtol=1e-5)
    # vq_features draws its own, from one seed: the same bits twice
    a = tvq.vq_features(torch.as_tensor(feats), torch.as_tensor(imp), c, b, steps, scale_normalize=scale_normalize)
    bb = tvq.vq_features(torch.as_tensor(feats), torch.as_tensor(imp), c, b, steps, scale_normalize=scale_normalize)
    assert torch.equal(a[0], bb[0]) and torch.equal(a[1], bb[1])


def test_kmeans_converges_on_clusters(rng):
    """tests/test_compress.py::test_kmeans_converges_on_clusters."""
    centers = np.array([[0, 0], [10, 0], [0, 10], [10, 10]], np.float32)
    pts = np.concatenate([c + rng.normal(size=(200, 2)).astype(np.float32) * 0.1 for c in centers])
    cb, idx = tvq.vq_features(torch.as_tensor(pts), torch.ones(len(pts)), codebook_size=8, vq_chunk=256, steps=200)
    cb = cb.numpy()
    for c in centers:
        assert np.min(np.linalg.norm(cb - c, axis=1)) < 0.2
    assert np.linalg.norm(pts - cb[idx.numpy()], axis=1).mean() < 0.25


def test_importance_weighting_biases_codebook(rng):
    """tests/test_compress.py::test_importance_weighting_biases_codebook."""
    pts = np.concatenate([
        rng.normal(size=(500, 2)).astype(np.float32),
        rng.normal(size=(500, 2)).astype(np.float32) + 20.0,
    ])
    imp = np.concatenate([np.full(500, 100.0), np.full(500, 1.0)]).astype(np.float32)
    cb, _ = tvq.vq_features(torch.as_tensor(pts), torch.as_tensor(imp), codebook_size=8, vq_chunk=512, steps=300)
    assert (np.linalg.norm(cb.numpy(), axis=1) < 10).sum() >= 5


def test_join_features():
    """tests/test_compress.py::test_join_features."""
    feats = torch.arange(20, dtype=torch.float32).reshape(10, 2)
    keep = torch.tensor([True, False] * 5)
    cb = torch.tensor([[100.0, 100.0], [200.0, 200.0]])
    table, idx = tvq.join_features(feats, keep, cb, torch.tensor([0, 1, 0, 1, 0]))
    assert table.shape == (7, 2)
    out = table[idx]
    np.testing.assert_allclose(out[::2], feats.numpy()[::2])
    np.testing.assert_allclose(out[1::2][:, 0], [100, 200, 100, 200, 100])


def test_segment_sum_and_gather_gradient(rng):
    vals = rng.normal(size=(300, 4, 3)).astype(np.float32)
    ids = rng.integers(0, 40, 300)
    ids[ids == 7] = 8  # an empty segment
    got = segment_sum(torch.as_tensor(vals), torch.as_tensor(ids), 40).numpy()
    ref = np.zeros((40, 4, 3))
    np.add.at(ref, ids, vals.astype(np.float64))
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=1e-6)
    assert (got[7] == 0).all()
    table = torch.tensor(rng.normal(size=(40, 4, 3)).astype(np.float32), requires_grad=True)
    w = torch.as_tensor(vals)
    (gather_rows(table, torch.as_tensor(ids)) * w).sum().backward()
    np.testing.assert_allclose(table.grad.numpy(), ref, atol=1e-6, rtol=1e-6)


# --------------------------------------------------------------- shapes
def test_extract_rot_scale_rebuilds_jax_covariance(rng):
    q = rng.normal(size=(200, 4)).astype(np.float32)
    s = np.abs(rng.normal(size=(200, 3))).astype(np.float32) + 0.05
    s[:20, 1] = s[:20, 0]  # equal eigenvalues: eigenvector order and sign are free
    cov = np.asarray(jquat.build_covariance(jnp.asarray(s), jnp.asarray(q)))
    np.testing.assert_allclose(
        tquat.build_covariance(torch.as_tensor(s), torch.as_tensor(q)).numpy(), cov, atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(tquat.to_full_cov(tquat.strip_symmetric(torch.as_tensor(cov))).numpy(), cov)
    rj, sj = jquat.extract_rot_scale(jnp.asarray(cov))
    rt, st = tquat.extract_rot_scale(torch.as_tensor(cov))
    back_j = np.asarray(jquat.build_covariance(sj, rj))
    back_t = tquat.build_covariance(st, rt).numpy()
    np.testing.assert_allclose(back_t, back_j, atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(back_t, cov, atol=1e-5, rtol=1e-5)
    m = np.asarray(jquat.quat_to_rotmat(jquat.normalize(jnp.asarray(q))))
    np.testing.assert_allclose(tquat.rotmat_to_quat(torch.as_tensor(m)).numpy(),
                               np.asarray(jquat.rotmat_to_quat(jnp.asarray(m))), atol=1e-6)


# ----------------------------------------------------------- sensitivity
def exact(cam):
    return dict(width=64, height=64, tanfovx=math.tan(0.5), tanfovy=math.tan(0.5), fast_grad=False)


def test_calc_importance_matches_jax():
    js = jax_scene()
    cams = cameras(offset=True)
    cj, gj = jimp.calc_importance(js, cams, render_settings_fn=lambda c: JSettings(**exact(c)))
    ct, gt = timp.calc_importance(carry_over(js), cams, render_settings_fn=lambda c: RasterSettings(**exact(c)),
                                  **CPU)
    assert ct.shape == (150, 48) and gt.shape == (150, 6)
    assert_normalized(ct.numpy(), cj, GRAD_TOL, "color importance")
    assert_normalized(gt.numpy(), gj, GRAD_TOL, "covariance sensitivity")
    assert float(ct.max()) > 0 and float(gt.max()) > 0


# ------------------------------------------------------- compress stages
@pytest.mark.parametrize("non_dir", [True, False])
def test_compress_stages_given_jax_codebooks_render_jax_image(monkeypatch, rng, non_dir):
    js = jax_scene()
    ts = carry_over(js)
    cimp = rng.random(150).astype(np.float32) ** 2
    gimp = rng.random(150).astype(np.float32) ** 2
    settings = lambda q: dict(codebook_size=64, importance_include=float(np.quantile(q, 0.8)),
                              importance_include_relative=0.8, steps=6, decay=0.8, batch_size=96)
    recorded = []

    def record(*a, **kw):
        out = jvq.vq_features(*a, **kw)
        recorded.append(out)
        return out

    monkeypatch.setattr(jpipeline, "vq_features", record)
    jc = jpipeline.compress_color(js, cimp, jvq.CompressionSettings(**settings(cimp)), non_dir, silent=True)
    jc = jpipeline.compress_covariance(jc, gimp, jvq.CompressionSettings(**settings(gimp)), silent=True)
    given = iter(recorded)
    monkeypatch.setattr(tpipeline, "vq_features",
                        lambda *a, **kw: tuple(torch.as_tensor(np.asarray(v)) for v in next(given)))
    tc = tpipeline.compress_color(ts, cimp, tvq.CompressionSettings(**settings(cimp)), non_dir, silent=True)
    tc = tpipeline.compress_covariance(tc, gimp, tvq.CompressionSettings(**settings(gimp)), silent=True)
    tc.check_state()
    np.testing.assert_array_equal(tc.feature_indices.numpy(), np.asarray(jc.feature_indices))
    np.testing.assert_array_equal(tc.gaussian_indices.numpy(), np.asarray(jc.gaussian_indices))
    np.testing.assert_allclose(_np(tc.get_features()), np.asarray(jc.get_features()), atol=1e-6)
    np.testing.assert_allclose(_np(tc.get_covariance()), np.asarray(jc.get_covariance()), atol=1e-6)
    oj = jax_render(jc, jnp.asarray(EVS[1]), JSettings(**KW), jnp.asarray(BG))
    with torch.no_grad():
        ot = trainer.render_scene(tc, EVS[1], RasterSettings(**KW), BG, **CPU)
    np.testing.assert_allclose(ot["render"].numpy(), np.asarray(oj["render"]), **IMG_TOL)


@pytest.fixture(scope="module")
def jax_compressed():
    js = jax_scene()
    comp = dataclasses.replace(JComp(), **SMALL_COMP)
    return js, jpipeline.to_compressed(js, cameras(), comp, silent=True)


def test_jax_compressed_scene_renders_and_differentiates_like_jax(jax_compressed):
    _, jc = jax_compressed
    assert jc.is_color_indexed and jc.is_gaussian_indexed
    tc = carry_over(jc)
    tc.check_state()
    assert tc.features_dc.shape[0] < tc.capacity and tc.scaling.shape[0] < tc.capacity
    settings = dict(KW, fast_grad=False)
    target = np.random.default_rng(5).random((3, 64, 64)).astype(np.float32)
    tables = ("features_dc", "features_rest", "scaling", "rotation")

    def jloss(*vals):
        out = jtrainer.render_scene(jc.replace(**dict(zip(tables, vals))), jnp.asarray(EVS[1]),
                                    JSettings(**settings), jnp.asarray(BG))
        return jnp.sum((out["render"] - target) ** 2), out["render"]

    (_, img_j), gj = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1, 2, 3), has_aux=True))(
        *(getattr(jc, k) for k in tables))
    out = trainer.render_scene(tc, EVS[1], RasterSettings(**settings), BG, **CPU)
    np.testing.assert_allclose(out["render"].detach().numpy(), np.asarray(img_j), **IMG_TOL)
    gt = torch.autograd.grad(((out["render"] - torch.as_tensor(target)) ** 2).sum(),
                             [getattr(tc, k) for k in tables])
    for name, a, b in zip(tables, gt, gj):
        assert a.shape == b.shape
        assert_normalized(a.numpy(), b, GRAD_TOL, name)


def test_blocked_colors_match_dense_gather(jax_compressed):
    tc = carry_over(jax_compressed[1])
    p = tc.capacity
    dirs = torch.nn.functional.normalize(torch.as_tensor(np.random.default_rng(1).normal(size=(p, 3))).float(), dim=1)
    dense = tsh.sh_to_rgb(3, tc.get_features(), dirs)
    blocked = tsh.sh_to_rgb_indexed_blocked(3, tc.get_features_raw(), tc.feature_indices, dirs, block=37)
    np.testing.assert_allclose(blocked.detach().numpy(), dense.detach().numpy(), atol=1e-6)
    with torch.no_grad():
        a = trainer.render_scene(tc, EVS[0], RasterSettings(**KW), BG, blocked_colors=True, **CPU)["render"]
        b = trainer.render_scene(tc, EVS[0], RasterSettings(**KW), BG, blocked_colors=False, **CPU)["render"]
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)


def test_compact_permute_morton_match_jax_exactly(jax_compressed, rng):
    _, jc = jax_compressed
    p = jc.capacity
    # a few inactive rows, and codebook rows only they read
    active = rng.random(p) > 0.2
    jm = jc.replace(active=jnp.asarray(active))
    tm = carry_over(jm)

    def same(t, j):
        for k in tgauss.TENSOR_FIELDS:
            a, b = getattr(t, k), getattr(j, k)
            assert (a is None) == (b is None), k
            if a is not None:
                np.testing.assert_array_equal(_np(a), np.asarray(b), err_msg=k)

    order = rng.permutation(p)
    same(tm.permute(order), jm.permute(order))
    same(tm.compact(), jm.compact())
    same(tm.morton_sorted(), jm.morton_sorted())
    same(tm.to_unindexed(), jm.to_unindexed())
    assert tm.compact().features_dc.shape[0] < tm.features_dc.shape[0]  # unused codebook rows dropped
    dense = carry_over(jax_scene(n=60))
    same(dense.to_indexed(), jax_scene(n=60).to_indexed())
    with pytest.raises(ValueError, match="dense"):
        tm.pad_to_capacity(p + 10)


# ------------------------------------------------------------- finetune
def test_finetune_matches_jax_and_leaves_callers_scene(monkeypatch, jax_compressed):
    js, jc = jax_compressed
    cams = cameras()
    losses_j = []
    real = jfinetune.trainer.train_step

    def record(*a, **kw):
        state, m = real(*a, **kw)
        losses_j.append(float(m["loss"]))
        return state, m

    monkeypatch.setattr(jfinetune.trainer, "train_step", record)
    jfinetune.finetune(jc, cams, JOpt(), iterations=3, log_every=0, seed=1)
    tc = carry_over(jc)
    before = {k: v.clone() for k, v in tc.state_dict().items()}
    hist = []
    out = tfinetune.finetune(tc, cams, OptimizationParams(), iterations=3, log_every=0, seed=1, history=hist, **CPU)
    np.testing.assert_allclose([h["loss"] for h in hist], losses_j, rtol=1e-4)
    assert all(h["overflow"] == 0 and h["grad_overflow"] == 0 for h in hist)
    assert all(torch.equal(before[k], v) for k, v in tc.state_dict().items())
    assert not torch.equal(out.features_dc, tc.features_dc)  # the copy trained
    assert out.features_dc.shape == tc.features_dc.shape  # Adam on the codebook tables
    with pytest.raises(ValueError, match="indexed"):
        tfinetune.finetune(carry_over(js), cams, OptimizationParams(), 1, **CPU)


def test_compress_end_to_end_preserves_quality():
    """tests/test_compress.py::test_compress_end_to_end_preserves_quality,
    on a scene the port builds: PSNR > 25 dB with 64-row codebooks."""
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(150, 3)).astype(np.float32) * 0.5
    pts[:, 2] += 3.0
    cols = rng.random(size=(150, 3)).astype(np.float32)
    scene = tgauss.from_point_cloud(pts, cols, capacity=150, quantization=True, **CPU).update_observers()
    settings = RasterSettings(width=32, height=32, tanfovx=math.tan(0.5), tanfovy=math.tan(0.5), sh_degree=0)
    ev = extrinsic(0.0)
    with torch.no_grad():
        gt = trainer.render_scene(scene, ev, settings, BG, **CPU)["render"]
    intr = np.array([[1.0, 0, 32], [0, 1.0, 32], [0, 0, 1]], np.float32)
    cam = SimpleNamespace(extrinsic_vector=ev, intrinsic=intr, original_image=gt.numpy())
    comp = dataclasses.replace(
        CompressionParams(), color_codebook_size=64, gaussian_codebook_size=64, color_cluster_iterations=60,
        gaussian_cluster_iterations=120, color_batch_size=256, gaussian_batch_size=256, prune_threshold=-1.0,
    )
    timings = {}
    compressed = tpipeline.to_compressed(scene, [cam], comp, silent=True, timings=timings, **CPU)
    compressed.check_state()
    assert compressed.is_color_indexed and compressed.is_gaussian_indexed
    assert set(timings) == {"sensitivity_calculation", "clustering"}
    with torch.no_grad():
        img = trainer.render_scene(compressed, ev, settings, BG, **CPU)["render"]
    assert float(tlosses.psnr(img, gt)[0, 0]) > 25.0
