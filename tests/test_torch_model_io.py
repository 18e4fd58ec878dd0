"""The port's npz container (c3dgs_tpu_torch.models.io_npz), its PLY codec
(models/io_ply.py) and their numpy helpers against c3dgs_tpu on the CPU,
and ports of tests/test_model_io.py's npz and ply tests.

The file format is the contract: a file either package writes loads in the
other.
- round trips in the port: accessors within one int8 step (atol 0.05) when
  quantized, atol 1e-4 when not; xyz_u16 within one u16 step;
- a JAX-written file (fp16 or u16 xyz, uint16 or int32 indices) loaded by
  the port renders what JAX's load_npz renders, at atol 2e-5 / rtol 1e-4
  (tests/test_render.py:113), and loads to equal leaves;
- a port-written file loaded by JAX and by the port gives equal arrays, key
  by key; the file's arrays equal those JAX writes for the same scene;
- quantize_int8 / dequantize_int8 and the Morton order equal JAX's exactly;
- PLY: the round trip in the port at atol 1e-4 (tests/test_model_io.py);
  a JAX-written .ply loaded by the port and a port-written one loaded by
  JAX give JAX's leaves at atol 1e-6, and both packages write the same
  header and the same vertex bytes for one scene.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from c3dgs_tpu.models import gaussians as jgauss
from c3dgs_tpu.models import io_npz as jio
from c3dgs_tpu.models import io_ply as jply
from c3dgs_tpu.ops import morton as jmorton
from c3dgs_tpu.ops import quantize as jquant
from c3dgs_tpu.render.types import RasterSettings as JSettings
from c3dgs_tpu.train import trainer as jtrainer
from c3dgs_tpu_torch.models import gaussians as tgauss
from c3dgs_tpu_torch.models import io_npz as tio
from c3dgs_tpu_torch.models import io_ply as tply
from c3dgs_tpu_torch.ops import morton as tmorton
from c3dgs_tpu_torch.ops import quantize as tquant
from c3dgs_tpu_torch.render.types import RasterSettings
from c3dgs_tpu_torch.train import trainer
from test_torch_serve import carry_over
import torch_cpu  # noqa: F401,E402  (one torch thread per test worker)

IMG_TOL = dict(atol=2e-5, rtol=1e-4)
CPU = dict(device="cpu")
EV = np.array([0, 0.06, 0, 0.998, 0.1, 0, 0], np.float32)
KW = dict(width=64, height=64, tanfovx=math.tan(0.5), tanfovy=math.tan(0.5), sh_degree=3)
BG = np.zeros(3, np.float32)


def jax_scene(n=100, cap=128, quantization=True, seed=0):
    """tests/test_model_io.py::make_scene, in front of the camera, SH
    degree 3 active."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(n, 3)).astype(np.float32) * 0.6
    pts[:, 2] += 3.0
    cols = rng.random(size=(n, 3)).astype(np.float32)
    scene = jgauss.from_point_cloud(pts, cols, capacity=cap, quantization=quantization)
    scene = scene.replace(
        features_rest=jnp.asarray(rng.normal(size=(cap, 15, 3)).astype(np.float32) * 0.1),
        rotation=jnp.asarray(rng.normal(size=(cap, 4)).astype(np.float32)),
        opacity=jnp.asarray(rng.normal(size=(cap, 1)).astype(np.float32)),
        active_sh_degree=3,
    )
    return scene.update_observers()


def jax_indexed(n=100, seed=0, rows=24):
    """An indexed JAX scene: random codebooks of `rows` rows, each row read."""
    rng = np.random.default_rng(seed + 1)
    js = jax_scene(n, n, seed=seed)
    fid = np.concatenate([np.arange(rows), rng.integers(0, rows, n - rows)]).astype(np.int32)
    gid = np.concatenate([np.arange(rows), rng.integers(0, rows, n - rows)]).astype(np.int32)
    feats = np.asarray(js.get_features_raw())[:rows]
    js = js.set_color_indexed(jnp.asarray(feats), jnp.asarray(fid))
    return js.set_gaussian_indexed(js.rotation[:rows], js.scaling[:rows], jnp.asarray(gid))


def _np(x):
    return None if x is None else (x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x))


def assert_scenes_equal(a, b, atol=1e-5):
    """tests/test_model_io.py::assert_scenes_equal on the port's scenes."""
    a, b = a.compact(), b.compact()
    for name in ("get_opacity", "get_features", "get_scaling"):
        np.testing.assert_allclose(_np(getattr(a, name)()), _np(getattr(b, name)()), atol=atol, err_msg=name)
    np.testing.assert_allclose(_np(a.xyz), _np(b.xyz), atol=atol)
    ra, rb = _np(a.get_rotation()), _np(b.get_rotation())
    flip = np.sign((ra * rb).sum(-1, keepdims=True))  # quaternion sign is gauge
    np.testing.assert_allclose(ra, rb * flip, atol=atol)


def render(scene):
    with torch.no_grad():
        return trainer.render_scene(scene, EV, RasterSettings(**KW), BG, **CPU)["render"].numpy()


def jrender(scene):
    # eager, as the reference's own tests render: under jit some of a
    # loaded scene's fake-quantized colors move by one int8 step (its
    # observers sit on the dequantized ranges), which moves the image by
    # up to 3.5e-4
    return np.asarray(jtrainer.render_scene(scene, jnp.asarray(EV), JSettings(**KW), jnp.asarray(BG))["render"])


# ------------------------------------------------------------ helpers
def test_quantize_int8_and_morton_match_jax(rng):
    x = (rng.normal(size=(500, 3)) * 2).astype(np.float32)
    jo = jquant.observe(jquant.init_observer(), jnp.asarray(x))
    to = tquant.observe(tquant.init_observer(), torch.as_tensor(x))
    qj = np.asarray(jquant.quantize_int8(jnp.asarray(x), jo))
    qt = tquant.quantize_int8(torch.as_tensor(x), to)
    assert qt.dtype == torch.int8
    np.testing.assert_array_equal(qt.numpy(), qj)
    s, z = (float(v) for v in jquant.qparams(jo))
    np.testing.assert_array_equal(tquant.dequantize_int8(qt, s, z).numpy(),
                                  np.asarray(jquant.dequantize_int8(jnp.asarray(qj), s, z)))
    pts = rng.normal(size=(3000, 3)) * np.array([1.0, 4.0, 0.3])
    pts[:10] = pts[10:20]  # equal codes keep their order (stable sort)
    np.testing.assert_array_equal(tmorton.morton_order(pts), jmorton.morton_order(pts))


# --------------------------------------------------------- round trips
@pytest.mark.parametrize("quantization", [True, False])
def test_npz_roundtrip(tmp_path, quantization):
    """tests/test_model_io.py::test_npz_roundtrip."""
    ts = carry_over(jax_scene(80, 100, quantization=quantization))
    p = tmp_path / "model.npz"
    saved = tio.save_npz(ts, p)
    loaded = tio.load_npz(p, override_quantization=True, **CPU)
    assert loaded.capacity == 80
    assert_scenes_equal(saved, loaded, atol=0.05 if quantization else 1e-4)
    if quantization:
        d = np.load(p)
        assert d["features_dc"].dtype == np.int8 and d["xyz"].dtype == np.float16


def test_npz_indexed_roundtrip(tmp_path):
    """tests/test_model_io.py::test_npz_indexed_roundtrip."""
    ts = carry_over(jax_scene(60, 60)).to_indexed()
    p = tmp_path / "idx.npz"
    saved = tio.save_npz(ts, p, sort_morton=True)
    loaded = tio.load_npz(p, override_quantization=True, **CPU)
    assert loaded.is_color_indexed and loaded.is_gaussian_indexed
    assert loaded.feature_indices.dtype == torch.int64
    assert np.load(p)["feature_indices"].dtype == np.uint16
    assert_scenes_equal(saved, loaded, atol=0.05)


def test_npz_xyz_u16_roundtrip(tmp_path):
    """tests/test_model_io.py::test_npz_xyz_u16_roundtrip."""
    ts = carry_over(jax_scene(80, 100))
    p = tmp_path / "u16.npz"
    saved = tio.save_npz(ts, p, xyz_u16=True)
    d = np.load(p)
    assert d["xyz"].dtype == np.uint16 and d["xyz_min"].shape == (3,) and d["xyz_step"].shape == (3,)
    loaded = tio.load_npz(p, override_quantization=True, **CPU)
    assert np.abs(_np(saved.get_xyz()) - _np(loaded.get_xyz())).max() <= d["xyz_step"].max() + 1e-7


# ----------------------------------------------------- across packages
@pytest.mark.parametrize("xyz_u16", [False, True])
@pytest.mark.parametrize("int32_indices", [False, True])
def test_jax_written_npz_renders_jax_image_in_port(tmp_path, xyz_u16, int32_indices):
    p = tmp_path / "jax.npz"
    jio.save_npz(jax_indexed(), str(p), sort_morton=True, xyz_u16=xyz_u16, int32_indices=int32_indices)
    assert np.load(p)["gaussian_indices"].dtype == (np.int32 if int32_indices else np.uint16)
    jl = jio.load_npz(str(p))
    tl = tio.load_npz(p, **CPU)
    for k in tgauss.TENSOR_FIELDS:
        np.testing.assert_array_equal(_np(getattr(tl, k)), _np(getattr(jl, k)), err_msg=k)
    for k in tgauss.QUANT_FIELDS:
        np.testing.assert_array_equal(_np(tl.observer(k).min_val), _np(getattr(jl.quant, k).min_val), err_msg=k)
        np.testing.assert_array_equal(_np(tl.observer(k).max_val), _np(getattr(jl.quant, k).max_val), err_msg=k)
    assert tl.active_sh_degree == jl.active_sh_degree == 3
    np.testing.assert_allclose(render(tl), jrender(jl), **IMG_TOL)


@pytest.mark.parametrize("indexed", [False, True])
def test_port_written_npz_loads_in_jax_with_equal_arrays(tmp_path, indexed):
    js = jax_indexed() if indexed else jax_scene()
    p, pj = tmp_path / "port.npz", tmp_path / "jax.npz"
    tio.save_npz(carry_over(js), p, sort_morton=True, xyz_u16=True)
    jio.save_npz(js, str(pj), sort_morton=True, xyz_u16=True)
    dt, dj = np.load(p), np.load(pj)
    assert set(dt.files) == set(dj.files)
    for k in dj.files:  # the same file, key by key
        assert dt[k].dtype == dj[k].dtype, k
        np.testing.assert_array_equal(dt[k], dj[k], err_msg=k)
    jl = jio.load_npz(str(p))
    tl = tio.load_npz(p, **CPU)
    for k in tgauss.TENSOR_FIELDS:
        np.testing.assert_array_equal(_np(getattr(tl, k)), _np(getattr(jl, k)), err_msg=k)
    np.testing.assert_allclose(render(tl), jrender(jl), **IMG_TOL)


def test_npz_reference_semantics_golden(tmp_path):
    """tests/test_model_io.py::test_npz_reference_semantics_golden: a
    hand-made npz in the reference's exact torch conventions (int8
    int_repr with per-tensor (scale, zero_point), fp16 xyz, opacity after
    the sigmoid, scaling after relu + L2 normalize, rotation normalized,
    scaling_factor as its log, (1,)-shaped scales, int32 indices) loads
    into the documented attribute domains, and save_npz round-trips it."""
    import scipy.special as sp

    rng = np.random.default_rng(11)
    n, n_codes = 60, 16

    def torch_quantize(x, scale, zp):
        return np.clip(np.round(x / scale + zp), -128, 127).astype(np.int8)

    xyz = rng.normal(size=(n, 3)).astype(np.float32)
    f_dc = (rng.normal(size=(n_codes, 1, 3)) * 0.5).astype(np.float32)
    f_rest = (rng.normal(size=(n_codes, 15, 3)) * 0.1).astype(np.float32)
    opacity_act = rng.uniform(0.02, 0.98, size=(n, 1)).astype(np.float32)
    scaling_dir = np.abs(rng.normal(size=(n_codes, 3))).astype(np.float32)
    scaling_dir /= np.linalg.norm(scaling_dir, axis=1, keepdims=True)
    sfac = rng.normal(size=(n, 1)).astype(np.float32) - 3.0
    rot = rng.normal(size=(n_codes, 4)).astype(np.float32)
    rot /= np.linalg.norm(rot, axis=1, keepdims=True)
    fid = np.concatenate([np.arange(n_codes), rng.integers(0, n_codes, size=n - n_codes)]).astype(np.int32)
    gid = np.concatenate([np.arange(n_codes), rng.integers(0, n_codes, size=n - n_codes)]).astype(np.int32)
    qp = {
        "features_dc": (0.01, 3),
        "features_rest": (0.002, -5),
        "opacity": (1 / 255.0, -128),
        "scaling": (1 / 254.0, -127),
        "scaling_factor": (0.05, 10),
        "rotation": (1 / 127.0, 0),
    }
    d = {"quantization": np.bool_(True), "xyz": xyz.astype(np.float16)}
    for name, arr in [("features_dc", f_dc), ("features_rest", f_rest), ("opacity", opacity_act),
                      ("scaling", scaling_dir), ("scaling_factor", sfac), ("rotation", rot)]:
        s, z = qp[name]
        d[name] = torch_quantize(arr, s, z)
        d[f"{name}_scale"] = np.asarray([s], np.float32)
        d[f"{name}_zero_point"] = np.asarray([z], np.int64)
    d["feature_indices"] = fid
    d["gaussian_indices"] = gid
    path = tmp_path / "ref_golden.npz"
    np.savez_compressed(path, **d)

    scene = tio.load_npz(path, **CPU)
    deq = lambda name: (d[name].astype(np.float32) - qp[name][1]) * qp[name][0]
    np.testing.assert_allclose(_np(scene.xyz), xyz.astype(np.float16).astype(np.float32))
    for name in ("features_dc", "features_rest", "scaling", "scaling_factor", "rotation"):
        np.testing.assert_allclose(_np(getattr(scene, name)), deq(name), atol=1e-7, err_msg=name)
    expect_op = sp.logit(np.clip(deq("opacity"), 1e-6, 1 - 1e-6))
    np.testing.assert_allclose(_np(scene.opacity), expect_op, rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(_np(scene.feature_indices), fid)
    np.testing.assert_array_equal(_np(scene.gaussian_indices), gid)
    assert scene.quantization and scene.use_factor_scaling
    assert scene.is_color_indexed and scene.is_gaussian_indexed

    # re-saving keeps each value within one quant step (the observer ranges
    # re-derive from the dequantized data)
    path2 = tmp_path / "resaved.npz"
    tio.save_npz(scene, path2)
    scene2 = tio.load_npz(path2, **CPU)
    for name in ("features_dc", "features_rest", "scaling", "scaling_factor", "rotation"):
        np.testing.assert_allclose(_np(getattr(scene, name)), _np(getattr(scene2, name)),
                                   atol=1.5 * qp[name][0], err_msg=name)
    np.testing.assert_array_equal(_np(scene2.feature_indices), fid)
    assert set(np.load(path2).files) == set(d.keys())


# ------------------------------------------------------------------- ply
PLY_LEAVES = ("xyz", "opacity", "scaling_factor", "active", "features_dc", "features_rest", "scaling", "rotation")


def test_ply_roundtrip(tmp_path):
    """tests/test_model_io.py::test_ply_roundtrip in the port."""
    scene = carry_over(jax_scene(80, 80, quantization=False))
    p = str(tmp_path / "model.ply")
    tply.save_gaussians_ply(scene, p)
    loaded = tply.load_gaussians_ply(p, quantization=False, **CPU)
    assert loaded.capacity == 80 and loaded.active_sh_degree == 3
    assert_scenes_equal(scene, loaded, atol=1e-4)


def test_ply_rgb_pointcloud_init_matches_jax(tmp_path):
    """tests/test_model_io.py::test_ply_rgb_pointcloud_init in both
    packages: a bare RGB cloud initializes the same scene, padded to a
    capacity with rows of rotation (1, 0, 0, 0)."""
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(50, 3)).astype(np.float32)
    cols = (rng.random(size=(50, 3)) * 255).astype(np.uint8)
    p = str(tmp_path / "cloud.ply")
    tply.write_vertices(p, {"x": pts[:, 0], "y": pts[:, 1], "z": pts[:, 2],
                            "red": cols[:, 0], "green": cols[:, 1], "blue": cols[:, 2]})
    ts = tply.load_gaussians_ply(p, capacity=64, **CPU)
    js = jply.load_gaussians_ply(p, capacity=64)
    assert ts.capacity == 64 and ts.active_sh_degree == 0
    for name in PLY_LEAVES:
        np.testing.assert_allclose(_np(getattr(ts, name)), np.asarray(getattr(js, name)), atol=1e-6, err_msg=name)
    cloud = tply.read_point_cloud(p)
    np.testing.assert_array_equal(cloud.points, pts)
    np.testing.assert_array_equal(cloud.colors, cols.astype(np.float32) / 255.0)


def _header(path):
    data = open(path, "rb").read()
    end = data.index(b"end_header\n") + len(b"end_header\n")
    return data[:end], data[end:]


@pytest.mark.parametrize("quantization", [False, True])
def test_ply_files_cross_between_packages(tmp_path, quantization):
    """A JAX-written .ply loads in the port and a port-written one in JAX
    to JAX's leaves (capacity padding included); both write identical
    headers and vertex bytes for the same scene."""
    js = jax_scene(100, 128, quantization=quantization)
    ts = carry_over(js)
    jp, tp = str(tmp_path / "jax.ply"), str(tmp_path / "port.ply")
    jply.save_gaussians_ply(js, jp)
    tply.save_gaussians_ply(ts, tp)
    (jh, jb), (th, tb) = _header(jp), _header(tp)
    assert th == jh
    np.testing.assert_allclose(np.frombuffer(tb, np.float32), np.frombuffer(jb, np.float32), atol=1e-6)
    ref = jply.load_gaussians_ply(jp, quantization=quantization, capacity=128)
    loads = (tply.load_gaussians_ply(jp, quantization=quantization, capacity=128, **CPU),  # JAX's file, port
             jply.load_gaussians_ply(tp, quantization=quantization, capacity=128))  # port's file, JAX
    for got in loads:
        assert got.capacity == 128 and got.active_sh_degree == ref.active_sh_degree == 3
        for name in PLY_LEAVES:
            np.testing.assert_allclose(_np(getattr(got, name)), np.asarray(getattr(ref, name)), atol=1e-6,
                                       err_msg=name)
    np.testing.assert_array_equal(_np(loads[0].rotation)[100:], np.tile([1.0, 0, 0, 0], (28, 1)))
