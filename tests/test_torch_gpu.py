"""The port's CUDA kernels against their plain versions, on the card.

This file imports no JAX, so it also runs on a machine with a card and no
JAX installed: `python -m pytest --noconftest -m gpu tests/test_torch_gpu.py`
(the repo's conftest.py sets JAX up). Here, without a card, its `gpu` tests
skip. It also holds the seeded test scenes that tests/test_torch_render.py
feeds to both packages.
"""
import math

import numpy as np
import pytest
import torch

from c3dgs_tpu_torch.ops import quat
from c3dgs_tpu_torch.render import oracle, rasterizer, tiles_packed
from c3dgs_tpu_torch.render.binning import bin_gaussians, per_gaussian_table
from c3dgs_tpu_torch.render.preprocess import preprocess
from c3dgs_tpu_torch.render.types import RasterSettings

EV = np.array([0, 0, 0, 1, 0, 0, 0], np.float32)
IMG_TOL = dict(atol=2e-5, rtol=1e-4)  # the reference's bar, tests/test_render.py:113
K1_TOL = dict(atol=2e-5, rtol=1e-4)
SMALL = dict(width=64, height=48, tanfovx=math.tan(0.6), tanfovy=math.tan(0.45), sh_degree=3)


def cov6(scales, quats):
    return quat.cov6_from_scaling_rotation(torch.as_tensor(scales), torch.as_tensor(quats)).numpy()


def make_scene(n=300, seed=0, sh=False):
    """tests/test_render.py::make_scene as numpy arrays."""
    rng = np.random.default_rng(seed)
    means = rng.normal(size=(n, 3)).astype(np.float32) * 0.8
    means[:, 2] += 4.0
    scales = np.exp(rng.normal(size=(n, 3)).astype(np.float32) * 0.5 - 2.5)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    opacity = (1 / (1 + np.exp(-rng.normal(size=n)))).astype(np.float32)
    colors = rng.random(size=(n, 3)).astype(np.float32)
    shs = None
    if sh:
        shs = rng.normal(size=(n, 16, 3)).astype(np.float32) * 0.3
        colors = None
    return dict(means=means, cov=cov6(scales, quats), op=opacity, colors=colors, shs=shs), dict(SMALL)


def occluder_scene():
    """tests/test_render.py:159-191: an opaque near wall over the left tile
    column and far splats behind it. The wall leaves pixels of every tile
    uncovered, so no tile reaches the freeze (kept for its saturated
    pixels; `wall_scene` is the one that freezes)."""
    rng = np.random.default_rng(4)
    n_near, n_far = 60, 500
    near = np.zeros((n_near, 3), np.float32)
    near[:, 0] = rng.uniform(-0.9, -0.3, n_near)
    near[:, 1] = rng.uniform(-0.5, 0.5, n_near)
    near[:, 2] = 2.0 + rng.uniform(0, 0.1, n_near)
    far = np.zeros((n_far, 3), np.float32)
    far[:, 0] = rng.uniform(-0.9, -0.3, n_far)
    far[:, 1] = rng.uniform(-0.5, 0.5, n_far)
    far[:, 2] = 6.0 + rng.uniform(0, 1.0, n_far)
    n = n_near + n_far
    scales = np.full((n, 3), 0.25, np.float32)
    scales[n_near:] = 0.12
    quats = np.tile(np.asarray([1, 0, 0, 0], np.float32), (n, 1))
    opacity = np.full((n,), 0.995, np.float32)
    opacity[n_near:] = 0.6
    colors = rng.random(size=(n, 3)).astype(np.float32)
    means = np.concatenate([near, far])
    return dict(means=means, cov=cov6(scales, quats), op=opacity, colors=colors, shs=None), dict(SMALL)


def wall_scene(seed=4, n_far=800):
    """An opaque near wall of overlapping splats over the whole view and
    800 far splats behind it: the middle tiles saturate with whole chunks
    of far slots still to come, so the packed forward freezes them."""
    rng = np.random.default_rng(seed)
    gx, gy = np.meshgrid(np.linspace(-1.4, 1.4, 10), np.linspace(-1.0, 1.0, 8))
    near = np.stack([gx.ravel(), gy.ravel(), 2.0 + rng.uniform(0, 0.1, gx.size)], 1)
    far = np.stack(
        [rng.uniform(-1.3, 1.3, n_far), rng.uniform(-0.9, 0.9, n_far), 6.0 + rng.uniform(0, 1.0, n_far)], 1
    )
    means = np.concatenate([near, far]).astype(np.float32)
    n, n_near = len(means), len(near)
    scales = np.full((n, 3), 0.5, np.float32)
    scales[n_near:] = 0.12
    quats = np.tile(np.asarray([1, 0, 0, 0], np.float32), (n, 1))
    opacity = np.full((n,), 0.995, np.float32)
    opacity[n_near:] = 0.6
    colors = rng.random(size=(n, 3)).astype(np.float32)
    return dict(means=means, cov=cov6(scales, quats), op=opacity, colors=colors, shs=None), dict(SMALL)


def boundary_scene():
    """tests/test_render.py:230: tiles 74 and 85 end exactly at a 128-slot
    chunk boundary, so their sentinels are lane 0 of the next chunk."""
    rng = np.random.default_rng(35)
    n = 600
    means = rng.normal(size=(n, 3)).astype(np.float32) * 1.2
    means[:, 2] += 4.0
    scales = np.exp(rng.normal(size=(n, 3)).astype(np.float32) * 0.6 - 3.6)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    opacity = (1 / (1 + np.exp(-rng.normal(size=n) - 0.5))).astype(np.float32)
    colors = rng.random(size=(n, 3)).astype(np.float32)
    kw = dict(width=256, height=192, tanfovx=math.tan(0.6), tanfovy=math.tan(0.47), sh_degree=0)
    return dict(means=means, cov=cov6(scales, quats), op=opacity, colors=colors, shs=None), kw


SCENES = {
    "make_scene": lambda: make_scene(300),
    "make_scene_sh": lambda: make_scene(300, sh=True),
    "occluder": occluder_scene,
    "wall": wall_scene,
    "boundary": boundary_scene,
}


def k1_inputs(sc, kw, device):
    """The port's own staged K1 inputs (fields, tile_lo, meta, starts,
    ends) for a scene, on `device`."""
    t = lambda x: None if x is None else torch.as_tensor(x, device=device)
    settings = RasterSettings(**kw)
    prep = preprocess(t(sc["means"]), t(sc["cov"]), t(sc["op"]), t(EV), settings, t(sc["shs"]), t(sc["colors"]))
    b = bin_gaussians(prep, settings)
    n = sc["means"].shape[0]
    cap, _ = settings.resolve_caps(n)
    nc = cap // 128
    fields = rasterizer._build_fields_packed(
        per_gaussian_table(prep, b.offset), b.gid_sorted, b.tid_sorted, b.sent_sorted,
        b.j_sorted, settings.tiles_x, settings.num_tiles, cap,
    )
    meta = torch.stack([b.chunks_exec, *(torch.zeros_like(b.chunks_exec) + v for v in (0, settings.num_tiles, cap))])
    return fields, b.tile_lo[: nc + 1], meta, b.starts, b.ends


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the K1 kernel has no CPU mode")


def test_k1_inputs_stage_on_cpu():
    """The staging these tests feed K1 runs here too, through the wrapper's
    CPU route (the plain version)."""
    sc, kw = wall_scene()
    args = k1_inputs(sc, kw, "cpu")
    out = tiles_packed.forward(*args)
    assert out.shape == (RasterSettings(**kw).num_tiles, 8, 512)
    assert bool((out[:, 5, 0] < float(args[2][3])).any())  # frozen tiles


@pytest.mark.gpu
@pytest.mark.parametrize("scene", ["make_scene_sh", "occluder", "wall", "boundary"])
def test_k1_cuda_kernel_matches_plain(scene):
    """K1 on the card against its plain version on identical staged
    fields: rows 0-4 at atol 2e-5 / rtol 1e-4, freeze slots exact."""
    _need_card()
    sc, kw = SCENES[scene]()
    args = k1_inputs(sc, kw, "cuda")
    before = tiles_packed.FORWARD_KERNEL.launches
    out_k = tiles_packed.forward(*args)
    torch.cuda.synchronize()
    assert tiles_packed.FORWARD_KERNEL.launches == before + 1
    out_p = tiles_packed.forward_plain(*args)
    torch.testing.assert_close(out_k[:, :5], out_p[:, :5], **K1_TOL)
    assert torch.equal(out_k[:, 5:], out_p[:, 5:])


@pytest.mark.gpu
def test_render_on_card_matches_oracle_and_cpu():
    _need_card()
    sc, kw = make_scene(300, sh=True)
    settings = RasterSettings(**kw)
    bg = np.array([0.2, 0.1, 0.4], np.float32)
    host = [torch.as_tensor(x) for x in (sc["means"], sc["cov"], sc["op"], EV)]
    card = [x.cuda() for x in host]
    shs = torch.as_tensor(sc["shs"])
    out_c = rasterizer.render(*card, settings, torch.as_tensor(bg).cuda(), shs=shs.cuda())
    out_o = oracle.render_oracle(*card, settings, torch.as_tensor(bg).cuda(), shs=shs.cuda())
    out_h = rasterizer.render(*host, settings, torch.as_tensor(bg), shs=shs)
    torch.testing.assert_close(out_c["render"], out_o["render"], **IMG_TOL)
    torch.testing.assert_close(out_c["render"].cpu(), out_h["render"], **IMG_TOL)
    torch.testing.assert_close(out_c["final_T"], out_o["final_T"], atol=2e-5, rtol=0)
