"""The port's host codec (c3dgs_tpu_torch/native.py, csrc/codec.cpp)
against the numpy versions and the JAX package's codec, on the CPU.

- the points3D.bin parser: tests/test_native.py's writer (tracks of 0-5
  pairs) through the codec, data/colmap.py::read_points3D_binary and
  c3dgs_tpu.native: arrays equal; a truncated file and a missing one
  raise; load_model (which the JAX package's load_model reads through its
  codec) equal to JAX's and counted;
- the Morton order: equal to ops/morton.py and to c3dgs_tpu.native on
  random points, on duplicated points (ties keep their order), with an
  axis of zero extent, with axes of equal extent, and on one point; the
  Morton-sorted scene (morton_sorted, save_npz's order) counted;
- the build: the library lands under build/c3dgs_tpu_torch/ with a
  digest name, none beside the source; a missing compiler and a source
  that does not compile raise, with the compiler's output.
"""
import os
import shutil
import struct
from pathlib import Path

import numpy as np
import pytest
import torch
import torch_cpu  # noqa: F401  (one torch thread per test worker)

from c3dgs_tpu import native as jnative
from c3dgs_tpu.data import colmap as jcolmap
from c3dgs_tpu_torch import kernels, native
from c3dgs_tpu_torch.data import colmap
from c3dgs_tpu_torch.models import gaussians as tgauss
from c3dgs_tpu_torch.ops import morton

REPO = Path(__file__).resolve().parents[1]


def write_points3d_bin(path, xyz, rgb, err, track_lens):
    """tests/test_native.py's writer."""
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(xyz)))
        for i in range(len(xyz)):
            f.write(struct.pack("<Q", i + 1))
            f.write(struct.pack("<ddd", *xyz[i]))
            f.write(struct.pack("<BBB", *rgb[i]))
            f.write(struct.pack("<d", err[i]))
            f.write(struct.pack("<Q", track_lens[i]))
            for t in range(track_lens[i]):
                f.write(struct.pack("<ii", t, t * 2))


@pytest.fixture(scope="module")
def jax_native(tmp_path_factory):
    """c3dgs_tpu.native with its library built into a temporary directory:
    its own build beside its source could race tests/test_native.py's in
    another test worker."""
    with pytest.MonkeyPatch.context() as m:
        m.setattr(jnative, "_LIB_PATH", str(tmp_path_factory.mktemp("jax_native") / "libc3dgs_codec.so"))
        m.setattr(jnative, "_lib", None)
        m.setattr(jnative, "_tried", False)
        assert jnative.get_lib() is not None
        yield jnative


@pytest.fixture
def points_file(tmp_path):
    rng = np.random.default_rng(0)
    n = 500
    xyz = rng.normal(size=(n, 3))
    rgb = rng.integers(0, 256, (n, 3)).astype(np.uint8)
    err = rng.random(n)
    tracks = rng.integers(0, 6, n)
    path = tmp_path / "points3D.bin"
    write_points3d_bin(path, xyz, rgb, err, tracks)
    return path, xyz, rgb, err, tracks


def test_parser_matches_numpy_and_jax(points_file, jax_native):
    path, xyz, rgb, err, tracks = points_file
    assert set(tracks) == set(range(6))
    before = native.calls["colmap_points3d_parse"]
    got = native.read_points3d_binary(path)
    assert native.calls["colmap_points3d_parse"] == before + 1
    assert got[0].dtype == np.float64 and got[1].dtype == np.uint8 and got[2].dtype == np.float64
    for want in ((xyz, rgb, err), colmap.read_points3D_binary(path), jax_native.read_points3d_binary(str(path))):
        for a, b in zip(got, want, strict=True):
            np.testing.assert_array_equal(a, b)


def test_parser_refuses_truncated_and_missing_files(points_file, tmp_path):
    path = points_file[0]
    cut = tmp_path / "cut.bin"
    cut.write_bytes(path.read_bytes()[:-100])
    with pytest.raises(ValueError, match="truncated"):
        native.read_points3d_binary(cut)
    with pytest.raises(FileNotFoundError):
        native.read_points3d_binary(tmp_path / "none.bin")


def test_load_model_reads_through_the_codec_like_jax(points_file, tmp_path, jax_native):
    path, xyz, rgb, err, _ = points_file
    sparse = tmp_path / "sparse"
    sparse.mkdir()
    shutil.copy(path, sparse / "points3D.bin")
    (sparse / "cameras.txt").write_text("1 PINHOLE 64 48 60 60 32 24\n")
    (sparse / "images.txt").write_text("1 1 0 0 0 0 0 4 1 a.png\n\n")
    before = native.calls["colmap_points3d_parse"]
    cams, imgs, pts = colmap.load_model(sparse)
    assert native.calls["colmap_points3d_parse"] == before + 1
    jcams, jimgs, jpts = jcolmap.load_model(sparse)
    assert cams.keys() == jcams.keys() and imgs.keys() == jimgs.keys()
    for a, b, c in zip(pts, jpts, (xyz, rgb, err), strict=True):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


def _clouds():
    rng = np.random.default_rng(1)
    rand = (rng.random((2000, 3)) * 10 - 5).astype(np.float32)
    ties = np.repeat(rand[:200], 5, axis=0)[rng.permutation(1000)]
    flat = rand.copy()
    flat[:, 1] = 0.25  # y has zero extent
    grid = np.stack(np.meshgrid(*[np.arange(6, dtype=np.float32)] * 3, indexing="ij"), -1).reshape(-1, 3)
    return {"random": rand, "ties": ties, "zero_extent": flat, "equal_extents": grid[rng.permutation(len(grid))],
            "one_point": rand[:1]}


@pytest.mark.parametrize("case", list(_clouds()))
def test_morton_order_matches_numpy_and_jax(case, jax_native):
    xyz = _clouds()[case]
    got = native.morton_order(xyz)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, morton.morton_order(xyz))
    np.testing.assert_array_equal(got, jax_native.morton_order(xyz))
    if case == "ties":
        # duplicates keep their input order (a stable sort)
        keys = [tuple(p) for p in xyz[got]]
        for i in range(1, len(got)):
            if keys[i] == keys[i - 1]:
                assert got[i] > got[i - 1]


def test_morton_sorted_scene_goes_through_the_codec():
    rng = np.random.default_rng(2)
    pts = rng.normal(size=(300, 3)).astype(np.float32)
    scene = tgauss.from_point_cloud(pts, rng.random((300, 3)).astype(np.float32), capacity=320, device="cpu")
    before = native.calls["morton_order_f32"]
    out = scene.morton_sorted()
    assert native.calls["morton_order_f32"] == before + 1
    order = morton.morton_order(scene.xyz.detach().numpy())
    active = scene.active.numpy()
    order = np.concatenate([order[active[order]], order[~active[order]]])
    np.testing.assert_array_equal(out.xyz.detach().numpy(), scene.xyz.detach().numpy()[order])
    assert out.active[:300].all() and not out.active[300:].any()


def test_library_lands_under_build():
    lib = native.library_path()
    assert native.get_lib() is not None and lib.exists()
    assert lib.parent == REPO / "build" / "c3dgs_tpu_torch"
    assert lib.name.startswith("libcodec-") and lib.suffix == ".so"
    assert not list((REPO / "c3dgs_tpu_torch").rglob("*.so"))


def test_missing_compiler_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "CXX", "c3dgs-no-such-compiler")
    with pytest.raises(RuntimeError, match="c3dgs-no-such-compiler not found"):
        native.morton_order(np.zeros((4, 3), np.float32))
    assert os.listdir(tmp_path) == []


def test_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / native.SOURCE).write_text('extern "C" { int broken( }\n')
    monkeypatch.setattr(kernels, "CSRC", csrc)
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match=r"host codec build failed:\n(?s:.*)codec\.cpp.*error"):
        native.get_lib()
    assert not list((tmp_path / "build").glob("*.so"))
