"""The port's data layer (c3dgs_tpu_torch.data: colmap, readers, cameras,
Scene) and its Morton-window kNN against c3dgs_tpu on the CPU.

Bars:
- readers: every CameraInfo field and point cloud equal (arrays exactly,
  FoVs as python floats);
- resolve_resolution: equal tuples;
- Scene: camera order equal under one seed of Python's `random`,
  extrinsic vectors and intrinsics at atol 1e-6, images bitwise,
  cameras_extent at rtol 1e-6, cameras.json equal key by key with floats
  at rtol 1e-6; the initial scene at from_point_cloud's bar (atol 1e-6,
  tests/test_torch_serve.py::test_from_point_cloud_matches_jax);
- mean_knn_sq_dist_large: rtol 1e-6 against JAX's on 5,000 points.
"""
import json
import os
import random
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from c3dgs_tpu.data import cameras as jcameras
from c3dgs_tpu.data import colmap as jcolmap
from c3dgs_tpu.data import readers as jreaders
from c3dgs_tpu.data.scene import Scene as JScene
from c3dgs_tpu.ops import misc as jmisc
from c3dgs_tpu_torch.data import cameras as tcameras
from c3dgs_tpu_torch.data import colmap as tcolmap
from c3dgs_tpu_torch.data import readers as treaders
from c3dgs_tpu_torch.data.scene import Scene as TScene
from c3dgs_tpu_torch.ops import misc as tmisc
from c3dgs_tpu_torch.tools import datasets
from tests import synth
import torch_cpu  # noqa: F401,E402  (one torch thread per test worker)

CPU = dict(device="cpu")
SCENE_FIELDS = ("xyz", "opacity", "scaling_factor", "features_dc", "features_rest", "scaling", "rotation")


@pytest.fixture(scope="module")
def colmap_dir(tmp_path_factory):
    """A COLMAP folder from tools/datasets.py: 10 views at 40x30 of a
    200-splat scene, PINHOLE fovs 0.9 / 0.7."""
    out = str(tmp_path_factory.mktemp("colmap_ds"))
    scene = datasets.gt_scene(n=200, **CPU)
    evs = [ev for ev, _ in datasets.ring_cameras(10, radius=4.0)]
    datasets.write_colmap_dataset(out, scene, evs, 40, 30, 0.9, 0.7, **CPU)
    return out


@pytest.fixture(scope="module")
def blender_dir(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("blender_ds"))
    synth.write_blender_dataset(out, res=32, num_train=6, num_test=2)
    return out


def write_colmap_text(sparse, cams, imgs, pts):
    """The text model of (cams, imgs, pts) as read from the binary one."""
    with open(os.path.join(sparse, "cameras.txt"), "w") as f:
        f.write("# camera list\n")
        for c in cams.values():
            f.write(f"{c.id} {c.model} {c.width} {c.height} {' '.join(repr(float(p)) for p in c.params)}\n")
    with open(os.path.join(sparse, "images.txt"), "w") as f:
        f.write("# image list\n")
        for im in imgs.values():
            vals = " ".join(repr(float(v)) for v in (*im.qvec, *im.tvec))
            f.write(f"{im.id} {vals} {im.camera_id} {im.name}\n1.5 2.5 7\n")
    with open(os.path.join(sparse, "points3D.txt"), "w") as f:
        xyz, rgb, err = pts
        for i in range(len(xyz)):
            f.write(f"{i + 1} {' '.join(repr(float(v)) for v in xyz[i])} {' '.join(str(int(v)) for v in rgb[i])} "
                    f"{float(err[i])!r} 1 2\n")


def assert_model_equal(a, b):
    (ca, ia, pa), (cb, ib, pb) = a, b
    assert ca.keys() == cb.keys() and ia.keys() == ib.keys()
    for k in ca:
        assert ca[k][:4] == cb[k][:4]
        np.testing.assert_array_equal(ca[k].params, cb[k].params)
    for k in ia:
        assert (ia[k].id, ia[k].camera_id, ia[k].name) == (ib[k].id, ib[k].camera_id, ib[k].name)
        for f in ("qvec", "tvec", "xys", "point3D_ids"):
            np.testing.assert_array_equal(getattr(ia[k], f), getattr(ib[k], f), err_msg=f)
    for x, y in zip(pa, pb):
        np.testing.assert_array_equal(x, y)


def test_colmap_readers_match_jax(colmap_dir, tmp_path):
    """Binary readers and load_model on the tools/datasets.py model, then
    the text readers through load_model's fallback on its text copy."""
    sparse = os.path.join(colmap_dir, "sparse", "0")
    got = tcolmap.load_model(sparse)
    assert_model_equal(got, jcolmap.load_model(sparse))
    cams, imgs, (xyz, rgb, err) = got
    assert len(cams) == 1 and cams[1].model == "PINHOLE" and (cams[1].width, cams[1].height) == (40, 30)
    assert len(imgs) == 10 and xyz.shape == (200, 3) and rgb.dtype == np.uint8 and not err.any()
    text = str(tmp_path / "sparse")
    os.makedirs(text)
    write_colmap_text(text, *got)
    got_text = tcolmap.load_model(text)
    assert_model_equal(got_text, jcolmap.load_model(text))
    np.testing.assert_array_equal(got_text[2][0], xyz)
    for k, im in got_text[1].items():
        np.testing.assert_array_equal(im.qvec, imgs[k].qvec)
        assert im.xys.shape == (1, 2) and list(im.point3D_ids) == [7]
    np.testing.assert_array_equal(tcolmap.qvec2rotmat(imgs[1].qvec), jcolmap.qvec2rotmat(imgs[1].qvec))


def assert_infos_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        for f in ("uid", "fovx", "fovy", "image_path", "image_name", "width", "height", "flip_image"):
            assert getattr(x, f) == getattr(y, f), f
        np.testing.assert_array_equal(x.R, y.R)
        np.testing.assert_array_equal(x.T, y.T)


def assert_scene_infos_equal(a, b):
    assert_infos_equal(a.train_cameras, b.train_cameras)
    assert_infos_equal(a.test_cameras, b.test_cameras)
    assert a.nerf_normalization == b.nerf_normalization and a.ply_path == b.ply_path
    for f in ("points", "colors", "normals"):
        np.testing.assert_array_equal(getattr(a.point_cloud, f), getattr(b.point_cloud, f))


@pytest.mark.parametrize("eval_split", [False, True])
def test_colmap_scene_reader_matches_jax(colmap_dir, eval_split):
    got = treaders.read_colmap_scene(colmap_dir, eval_split=eval_split)
    assert_scene_infos_equal(got, jreaders.read_colmap_scene(colmap_dir, eval_split=eval_split))
    # llffhold 8: views 0 and 8 are the test split
    assert len(got.test_cameras) == (2 if eval_split else 0)
    assert treaders.detect_scene_type(colmap_dir) == "Colmap"


def test_blender_reader_matches_jax(blender_dir):
    got = treaders.read_nerf_synthetic_scene(blender_dir)
    assert_scene_infos_equal(got, jreaders.read_nerf_synthetic_scene(blender_dir))
    assert len(got.train_cameras) == 6 and len(got.test_cameras) == 2
    assert treaders.detect_scene_type(blender_dir) == "Blender"


def test_blender_reader_random_cloud_matches_jax(blender_dir, tmp_path):
    """Without points3d.ply both draw the seeded 100k-point cloud."""
    folder = str(tmp_path / "noply")
    shutil.copytree(blender_dir, folder)
    os.remove(os.path.join(folder, "points3d.ply"))
    got = treaders.read_nerf_synthetic_scene(folder, eval_split=False)
    assert got.point_cloud.points.shape == (100_000, 3) and len(got.test_cameras) == 0
    assert_scene_infos_equal(got, jreaders.read_nerf_synthetic_scene(folder, eval_split=False))


def test_dust3r_reader_and_flip_match_jax(blender_dir, tmp_path):
    """A DUSt3R folder (transforms_dust3r.json + scene.ply): the reader
    marks every camera flipped, and the loaded image is the PNG turned
    upside down and left to right, bitwise as in JAX."""
    folder = str(tmp_path / "dust3r")
    shutil.copytree(blender_dir, folder)
    os.rename(os.path.join(folder, "transforms_train.json"), os.path.join(folder, "transforms_dust3r.json"))
    os.remove(os.path.join(folder, "transforms_test.json"))
    os.rename(os.path.join(folder, "points3d.ply"), os.path.join(folder, "scene.ply"))
    assert treaders.detect_scene_type(folder) == "Dust3r"
    got = treaders.read_dust3r_scene(folder)
    assert_scene_infos_equal(got, jreaders.read_dust3r_scene(folder))
    assert all(c.flip_image for c in got.train_cameras)
    tcam = tcameras.camera_from_info(got.train_cameras[0], 0)
    jcam = jcameras.camera_from_info(got.train_cameras[0], 0)
    np.testing.assert_array_equal(tcam.original_image, jcam.original_image)
    plain = tcameras.camera_from_info(treaders.read_nerf_synthetic_scene(blender_dir).train_cameras[0], 0)
    np.testing.assert_array_equal(tcam.original_image, plain.original_image[:, ::-1, ::-1])


@pytest.mark.parametrize("size,resolution", [((800, 600), -1), ((1920, 1080), -1), ((1920, 1080), 1),
                                             ((1920, 1080), 2), ((1000, 750), 4), ((2000, 1500), 500)])
def test_resolve_resolution_matches_jax(size, resolution):
    got = tcameras.resolve_resolution(*size, resolution)
    assert got == jcameras.resolve_resolution(*size, resolution)
    if resolution == -1:
        assert got[0] == min(size[0], 1600)


def _json_close(a, b):
    """Equal structure and keys; floats at rtol 1e-6."""
    if isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            _json_close(a[k], b[k])
    elif isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _json_close(x, y)
    elif isinstance(a, float):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-9)
    else:
        assert a == b


@pytest.mark.parametrize("kind", ["colmap", "blender"])
def test_scene_matches_jax(kind, colmap_dir, blender_dir, tmp_path):
    source = colmap_dir if kind == "colmap" else blender_dir
    kw = dict(source_path=source, resolution=1, eval_split=True, quantization=True, save_memory=False)
    random.seed(5)
    js = JScene(model_path=str(tmp_path / "jax"), **kw)
    random.seed(5)
    ts = TScene(model_path=str(tmp_path / "port"), device="cpu", **kw)
    for jc, tc in ((js.get_train_cameras(), ts.get_train_cameras()), (js.get_test_cameras(), ts.get_test_cameras())):
        assert [c.image_name for c in tc] == [c.image_name for c in jc]
        for a, b in zip(tc, jc):
            np.testing.assert_allclose(a.extrinsic_vector, b.extrinsic_vector, atol=1e-6)
            np.testing.assert_allclose(a.intrinsic, b.intrinsic, atol=1e-6)
            np.testing.assert_array_equal(a.original_image, b.original_image)
    assert ts.get_some_cameras()[1] == js.get_some_cameras()[1] == "test"
    np.testing.assert_allclose(ts.cameras_extent, js.cameras_extent, rtol=1e-6)
    with open(tmp_path / "port" / "cameras.json") as f, open(tmp_path / "jax" / "cameras.json") as g:
        _json_close(json.load(f), json.load(g))
    if kind == "blender":
        assert (tmp_path / "port" / "input.ply").read_bytes() == (tmp_path / "jax" / "input.ply").read_bytes()
    assert ts.gaussians.capacity == js.gaussians.capacity == 4 * ts.scene_info.point_cloud.points.shape[0]
    for name in SCENE_FIELDS:
        np.testing.assert_allclose(getattr(ts.gaussians, name).detach().numpy(),
                                   np.asarray(getattr(js.gaussians, name)), atol=1e-6, err_msg=name)
    np.testing.assert_array_equal(ts.gaussians.active.numpy(), np.asarray(js.gaussians.active))


def test_scene_loads_saved_iteration(colmap_dir, tmp_path):
    """save() then a Scene with load_iteration=-1 finds the latest
    iteration and loads its .ply (the render / compress CLIs' path)."""
    model = str(tmp_path / "m")
    ts = TScene(colmap_dir, model, resolution=1, shuffle=False, capacity_multiplier=1.0, **CPU)
    ts.save(3)
    ts.save(7)
    back = TScene(colmap_dir, model, load_iteration=-1, resolution=1, shuffle=False, **CPU)
    assert back.loaded_iter == 7 and back.gaussians.capacity == 200
    np.testing.assert_array_equal(back.gaussians.xyz.detach().numpy(), ts.gaussians.xyz.detach().numpy())


def test_save_memory_drops_each_image_after_use(colmap_dir):
    cam = TScene(colmap_dir, "", resolution=1, shuffle=False, **CPU).get_train_cameras()[0]
    assert cam.save_memory and cam._image is None
    img = cam.original_image
    assert img.shape == (3, 30, 40) and img.dtype == np.float32 and cam._image is None


def test_mean_knn_sq_dist_large_matches_jax():
    """The Morton-window kNN, called directly on 5,000 points."""
    rng = np.random.default_rng(4)
    pts = (rng.normal(size=(5000, 3)) * [2.0, 1.0, 0.5]).astype(np.float32)
    got = tmisc.mean_knn_sq_dist_large(torch.as_tensor(pts)).numpy()
    ref = np.asarray(jmisc.mean_knn_sq_dist_large(jnp.asarray(pts)))
    np.testing.assert_allclose(got, ref, rtol=1e-6)
    # never nearer than the exact kNN (whose expanded-square distances
    # cancel to ~1e-3 relative), and near it for most points
    exact = tmisc.mean_knn_sq_dist(torch.as_tensor(pts)).numpy()
    assert np.all(got >= exact * 0.99) and np.median(got / exact) < 1.5


def test_from_point_cloud_takes_the_window_knn_above_the_ceiling(monkeypatch):
    """Above EXACT_KNN_MAX_POINTS (lowered here to 1,000 in both packages)
    from_point_cloud initializes scales from the Morton-window kNN, as
    JAX's does."""
    from c3dgs_tpu.models import gaussians as jgauss
    from c3dgs_tpu_torch.models import gaussians as tgauss

    monkeypatch.setattr(jmisc, "EXACT_KNN_MAX_POINTS", 1000)
    monkeypatch.setattr(tmisc, "EXACT_KNN_MAX_POINTS", 1000)
    rng = np.random.default_rng(12)
    pts = rng.normal(size=(2000, 3)).astype(np.float32)
    cols = rng.random(size=(2000, 3)).astype(np.float32)
    js = jgauss.from_point_cloud(pts, cols, capacity=2100)
    ts = tgauss.from_point_cloud(pts, cols, capacity=2100, **CPU)
    for name in SCENE_FIELDS:
        np.testing.assert_allclose(getattr(ts, name).detach().numpy(), np.asarray(getattr(js, name)), atol=1e-6,
                                   err_msg=name)
    monkeypatch.setattr(tmisc, "EXACT_KNN_MAX_POINTS", 600_000)
    exact = tgauss.from_point_cloud(pts, cols, capacity=2100, **CPU)
    assert not torch.equal(exact.scaling_factor, ts.scaling_factor)
