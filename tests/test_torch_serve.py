"""The port's serving entry points (c3dgs_tpu_torch.models / train /
eval) against c3dgs_tpu on the CPU, plus the package's isolation from JAX
and its device default. A JAX scene is carried across with
`scene_from_numpy(np.asarray(leaf) ...)`, so the port itself never sees
JAX. Images at the reference's bar (atol 2e-5 / rtol 1e-4), PSNR/SSIM of
render_and_eval within 1e-4 of the JAX values."""
import ast
import dataclasses
import math
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from c3dgs_tpu.eval import metrics as jmetrics
from c3dgs_tpu.models import gaussians as jgauss
from c3dgs_tpu.render.types import RasterSettings as JSettings
from c3dgs_tpu.render.types import settings_from_intrinsic as jsettings_from_intrinsic
from c3dgs_tpu.train import trainer as jtrainer
from c3dgs_tpu_torch import device as tdevice
from c3dgs_tpu_torch.compress import importance as timportance
from c3dgs_tpu_torch.compress import pipeline as tpipeline
from c3dgs_tpu_torch.config import CompressionParams, OptimizationParams
from c3dgs_tpu_torch.eval import metrics as tmetrics
from c3dgs_tpu_torch.models import gaussians as tgauss
from c3dgs_tpu_torch.models import io_npz as tio
from c3dgs_tpu_torch.render.capacity import MIN_CAPACITY, CapacityPolicy
from c3dgs_tpu_torch.render.types import RasterSettings as TSettings
from c3dgs_tpu_torch.render.types import settings_from_intrinsic
from c3dgs_tpu_torch.tools import dma_probe as tprobe
from c3dgs_tpu_torch.train import finetune as tfinetune
from c3dgs_tpu_torch.train import trainer as ttrainer

IMG_TOL = dict(atol=2e-5, rtol=1e-4)
PKG = Path(__file__).resolve().parents[1] / "c3dgs_tpu_torch"
EV = np.array([0, 0, 0, 1, 0, 0, 0], np.float32)
INTRINSIC = np.array([[1.2, 0, 64], [0, 0.9, 48], [0, 0, 1]])  # FoV radians, W, H


def jax_scene(quantization: bool, n=200, seed=3):
    """A JAX from_point_cloud scene with SH degree 3 active and, for
    quantization=True, observers initialized by one update."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(n, 3)).astype(np.float32) * 0.6
    pts[:, 2] += 3.5
    cols = rng.random(size=(n, 3)).astype(np.float32)
    scene = jgauss.from_point_cloud(pts, cols, capacity=n + 8, quantization=quantization)
    rest = (rng.normal(size=scene.features_rest.shape) * 0.1).astype(np.float32)
    op = rng.normal(size=scene.opacity.shape).astype(np.float32)
    scene = scene.replace(features_rest=jnp.asarray(rest), opacity=jnp.asarray(op), active_sh_degree=3)
    return scene.update_observers()


def carry_over(scene, device="cpu"):
    leaves = {
        k: None if getattr(scene, k) is None else np.asarray(getattr(scene, k))
        for k in ("xyz", "opacity", "scaling_factor", "active", "features_dc",
                  "features_rest", "scaling", "rotation", "feature_indices", "gaussian_indices")
    }
    quant = {k: tuple(np.asarray(v) for v in getattr(scene.quant, k)) for k in tgauss.QUANT_FIELDS}
    return tgauss.scene_from_numpy(
        leaves,
        max_sh_degree=scene.max_sh_degree,
        active_sh_degree=scene.active_sh_degree,
        quantization=scene.quantization,
        use_factor_scaling=scene.use_factor_scaling,
        quant=quant,
        device=device,
    )


# ---------------------------------------------------------------- scene
@pytest.mark.parametrize("quantization", [True, False])
def test_scene_accessors_and_render_match_jax(quantization):
    js = jax_scene(quantization)
    ts = carry_over(js)
    for name in ("get_xyz", "get_opacity", "get_scaling", "get_rotation", "get_features", "get_covariance"):
        np.testing.assert_allclose(
            getattr(ts, name)().detach().numpy(), np.asarray(getattr(js, name)()), atol=1e-6, rtol=1e-6,
            err_msg=name,
        )
    # the settings render_and_eval derives from INTRINSIC: the JAX side then
    # shares one jit compile with test_render_and_eval_matches_jax
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    oj = jmetrics._jit_render_scene(js, jnp.asarray(EV), jsettings_from_intrinsic(INTRINSIC, inference=True), jnp.asarray(bg))
    with torch.no_grad():
        ot = ttrainer.render_scene(ts, EV, settings_from_intrinsic(INTRINSIC, inference=True), bg, device="cpu")
    np.testing.assert_allclose(ot["render"].numpy(), np.asarray(oj["render"]), **IMG_TOL)
    for k in ("num_instances", "overflow", "grad_total", "culled"):
        assert int(ot[k]) == int(oj[k]), k


def test_from_point_cloud_matches_jax():
    rng = np.random.default_rng(11)
    pts = rng.normal(size=(300, 3)).astype(np.float32)
    cols = rng.random(size=(300, 3)).astype(np.float32)
    js = jgauss.from_point_cloud(pts, cols, capacity=320)
    ts = tgauss.from_point_cloud(pts, cols, capacity=320, device="cpu")
    assert isinstance(ts, torch.nn.Module) and ts.capacity == 320
    for name in ("xyz", "opacity", "scaling_factor", "features_dc", "features_rest", "scaling", "rotation"):
        np.testing.assert_allclose(
            getattr(ts, name).detach().numpy(), np.asarray(getattr(js, name)), atol=1e-6, err_msg=name
        )
    np.testing.assert_array_equal(ts.active.numpy(), np.asarray(js.active))
    params = {n for n, _ in ts.named_parameters()}
    assert {"xyz", "opacity", "features_dc", "scaling", "rotation"} <= params
    assert "active" in dict(ts.named_buffers())


def test_bench_recipe_matches_jax():
    """chip_smoke.py's bench scene (bench.py:34-77's recipe) at 2,000
    points and 320x180: both packages build the same scene from the same
    seed and render the same frame with the same binning counts."""
    n = 2000
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(n, 3)).astype(np.float32) * 2.0
    pts[:, 2] += 6.0
    cols = rng.random(size=(n, 3)).astype(np.float32)
    op = np.clip(rng.beta(0.5, 0.35, size=(n, 1)), 0.005, 0.995)
    logit = np.log(op / (1.0 - op)).astype(np.float32)
    js = jgauss.from_point_cloud(pts, cols, capacity=n, quantization=False)
    js = js.replace(scaling_factor=js.scaling_factor + math.log(0.15), opacity=jnp.asarray(logit))
    ts = tgauss.from_point_cloud(pts, cols, capacity=n, quantization=False, device="cpu")
    with torch.no_grad():
        ts.scaling_factor += math.log(0.15)
        ts.opacity.copy_(torch.as_tensor(logit))
    kw = dict(width=320, height=180, tanfovx=math.tan(0.6), tanfovy=math.tan(0.6), sh_degree=3)
    oj = jmetrics._jit_render_scene(js, jnp.asarray(EV), JSettings(**kw), jnp.zeros(3))
    with torch.no_grad():
        ot = ttrainer.render_scene(ts, EV, TSettings(**kw), np.zeros(3), device="cpu")
    for k in ("num_instances", "grad_total", "culled", "overflow"):
        assert int(ot[k]) == int(oj[k]), k
    assert int(ot["num_instances"]) > n  # splats span tiles, as at full size
    np.testing.assert_allclose(ot["render"].numpy(), np.asarray(oj["render"]), **IMG_TOL)


def test_indexed_scene_raises():
    """An indexed scene carries across and renders JAX's image; what still
    raises on one is growing it, which the JAX scene refuses too (it
    asserts "grow dense scenes only")."""
    js = jax_scene(False).to_indexed()
    ts = carry_over(js)
    assert ts.is_color_indexed and ts.is_gaussian_indexed and ts.feature_indices.dtype == torch.int64
    kw = dict(width=64, height=48, tanfovx=math.tan(0.6), tanfovy=math.tan(0.45), sh_degree=3)
    oj = jax.jit(jtrainer.render_scene, static_argnums=(2,))(js, jnp.asarray(EV), JSettings(**kw), jnp.zeros(3))
    oj = oj["render"]
    with torch.no_grad():
        ot = ttrainer.render_scene(ts, EV, TSettings(**kw), np.zeros(3), device="cpu")
    np.testing.assert_allclose(ot["render"].numpy(), np.asarray(oj), **IMG_TOL)
    with pytest.raises(ValueError, match="dense"):
        ts.pad_to_capacity(ts.capacity + 8)


# ------------------------------------------------------------- capacity
def test_capacity_policy():
    pol = CapacityPolicy(initial=1 << 20, shrink_patience=3)
    assert pol.capacity == 1 << 20
    assert pol.update(num_instances=3_000_000, overflow=100) is True
    assert pol.capacity >= 3_000_000
    for _ in range(3):
        pol.update(num_instances=1000, overflow=0)
    assert pol.capacity < 4_194_304
    assert CapacityPolicy(initial=1).capacity == MIN_CAPACITY


def test_capacity_policy_grad_buffer():
    pol = CapacityPolicy(initial=1 << 20, shrink_patience=2)
    assert pol.grad_capacity == 0
    assert pol.update(100_000, 0, grad_total=200_000, grad_overflow=0) is False
    assert pol.grad_capacity >= 200_000
    assert pol.update(100_000, 0, grad_total=900_000, grad_overflow=50) is True
    assert pol.grad_capacity >= 900_000
    grown = pol.grad_capacity
    for _ in range(2):
        pol.update(100_000, 0, grad_total=130_000, grad_overflow=0)
    assert MIN_CAPACITY <= pol.grad_capacity < grown
    assert CapacityPolicy(grad_initial=300_000).grad_capacity >= 300_000


def test_render_full_grows_capacity_until_overflow_free(monkeypatch):
    ts = carry_over(jax_scene(False))
    settings = TSettings(width=64, height=48, tanfovx=math.tan(0.6), tanfovy=math.tan(0.45))
    bg = np.array([0.2, 0.1, 0.4], np.float32)
    with torch.no_grad():
        ref = ttrainer.render_scene(ts, EV, settings, bg, device="cpu")
    pol = CapacityPolicy(initial=1)
    pol.capacity = 128  # undersized first bucket (bypass the floor)
    calls = {"n": 0}
    real = ttrainer.render_scene

    def counting(*a, **kw):
        calls["n"] += 1
        return real(*a, **kw)

    monkeypatch.setattr(ttrainer, "render_scene", counting)
    out = tmetrics.render_full(ts, EV, settings, bg, pol, device="cpu")
    assert calls["n"] >= 2 and out["renders"] == calls["n"]
    assert int(out["overflow"]) == 0
    np.testing.assert_allclose(out["render"].numpy(), ref["render"].numpy(), atol=1e-5)


def test_render_and_eval_matches_jax(tmp_path):
    js = jax_scene(True)
    ts = carry_over(js)
    rng = np.random.default_rng(21)
    cams = []
    for i, yaw in enumerate((0.0, 0.15)):
        q = np.array([0.0, math.sin(yaw / 2), 0.0, math.cos(yaw / 2)])
        ev = np.concatenate([q, [0.1 * i, 0.0, 0.0]]).astype(np.float32)
        gt = rng.random(size=(3, 48, 64)).astype(np.float32)
        cams.append(SimpleNamespace(intrinsic=INTRINSIC, extrinsic_vector=ev, original_image=gt, image_name=f"v{i}"))
    rj = jmetrics.render_and_eval(js, cams)
    rt = tmetrics.render_and_eval(ts, cams, dump_dir=str(tmp_path), device="cpu")
    assert rt["num_views"] == 2 and rt["num_renders"] == 2
    for name in ("v0", "v1"):
        for m in ("psnr", "ssim"):
            assert abs(rt["per_view"][name][m] - rj["per_view"][name][m]) < 1e-4, (name, m)
        assert rt["per_view"][name]["lpips"] is None
    assert abs(rt["psnr"] - rj["psnr"]) < 1e-4 and abs(rt["ssim"] - rj["ssim"]) < 1e-4
    assert rt["lpips"] is None and rt["lpips_reason"] == rj["lpips_reason"]
    pytest.importorskip("PIL")
    assert (tmp_path / "renders" / "v0.png").exists() and (tmp_path / "gt" / "v1.png").exists()


def test_settings_from_intrinsic_matches_jax():
    k = np.array([[1.1, 0, 1920], [0, 0.7, 1080], [0, 0, 1]])
    a, b = settings_from_intrinsic(k, inference=True), jsettings_from_intrinsic(k, inference=True)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert (a.num_tiles, a.focal_x, a.resolve_caps(300_000), a.resolve_grad_cap(300_000)) == (
        b.num_tiles, b.focal_x, b.resolve_caps(300_000), b.resolve_grad_cap(300_000)
    )


# ---------------------------------------------------- isolation, device
def test_package_imports_no_jax():
    code = (
        "import sys, c3dgs_tpu_torch, c3dgs_tpu_torch.eval.metrics, c3dgs_tpu_torch.render.rasterizer, "
        "c3dgs_tpu_torch.tools.dma_probe, c3dgs_tpu_torch.compress.pipeline, c3dgs_tpu_torch.train.finetune, "
        "c3dgs_tpu_torch.models.io_npz; "
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'flax', 'optax', 'c3dgs_tpu.')) "
        "or m == 'c3dgs_tpu']; print(bad); sys.exit(1 if bad else 0)"
    )
    root = Path(__file__).resolve().parents[1]
    r = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_package_source_has_no_jax_imports():
    banned = ("jax", "flax", "optax", "c3dgs_tpu", "tools")
    for path in sorted(PKG.rglob("*.py")):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for name in names:
                assert name.split(".")[0] not in banned, f"{path}: imports {name}"


def test_entry_points_raise_without_cuda_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pts = np.random.default_rng(0).normal(size=(20, 3)).astype(np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdevice.resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tgauss.from_point_cloud(pts)
    scene = tgauss.from_point_cloud(pts, device="cpu")
    settings = TSettings(width=32, height=32, tanfovx=0.5, tanfovy=0.5)
    for call in (
        lambda: ttrainer.render_scene(scene, EV, settings, np.zeros(3)),
        lambda: tmetrics.render_full(scene, EV, settings, np.zeros(3)),
        lambda: tmetrics.render_and_eval(scene, []),
        lambda: carry_over(jax_scene(False), device=None),
        lambda: tio.load_npz("scene.npz"),
        lambda: timportance.calc_importance(scene, []),
        lambda: tpipeline.to_compressed(scene, [], CompressionParams()),
        lambda: tfinetune.finetune(scene.to_indexed(), [], OptimizationParams(), 1),
        tprobe.main,
        tprobe.probe1,
    ):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    with torch.no_grad():
        out = ttrainer.render_scene(scene, EV, settings, np.zeros(3), device="cpu")
    assert out["render"].device.type == "cpu"
