"""The port's CUDA kernels against their plain versions, on the card: K1
and K2 (packed) and K3 and K4 (per-tile) on the small scenes, K1 and K2
on a scene of long tiles, K3 and K4 where their windows reach each edge of
their staging ring, K2's and K4's determinism (K4's on clamped frames
too), the per-tile wrappers' refusal of misaligned fields, the DMA probes
P1-P3, the CUDA render's gradients against the
port's oracle and CPU path in both kernel families, the SSIM gradient
in fp32, and the compression path: an indexed scene's render and
codebook gradients against the CPU path, blocked codebook colors past
2^20 splats against the dense gather, bitwise-repeatable VQ and
codebook gradients, the codebook-table gradient kernel on four id layouts
and six widths and its launches in a train_step, fp32 nearest-codebook
search, two finetune steps and eigh past cuSOLVER's batch limit; the
train CLI on the card against the CPU; the pose gradient and a camera_step, and LPIPS, on the card against
the CPU; K1-K4 built for 16x16 tiles against their plain versions, in a
child process (tests/torch_tile_shape_cases.py), and the wrappers'
refusal of a tile shape the kernels cannot take.

This file imports no JAX, so it also runs on a machine with a card and no
JAX installed: `python -m pytest --noconftest -m gpu tests/test_torch_gpu.py`
(the repo's conftest.py sets JAX up). Here, without a card, its `gpu` tests
skip. It also holds the seeded test scenes that tests/test_torch_render.py
and tests/test_torch_backward.py feed to both packages.
"""
import copy
import dataclasses
import json
import math
import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from c3dgs_tpu_torch import kernels
from c3dgs_tpu_torch.compress import pipeline, vq
from c3dgs_tpu_torch.config import CompressionParams, OptimizationParams
from c3dgs_tpu_torch.models import gaussians
from c3dgs_tpu_torch.ops import losses, quat, segment
from c3dgs_tpu_torch.render import oracle, rasterizer, segment_sum, tiles, tiles_packed
from c3dgs_tpu_torch.render.binning import bin_gaussians, per_gaussian_table
from c3dgs_tpu_torch.render.preprocess import preprocess
from c3dgs_tpu_torch.render.types import RasterSettings, settings_from_intrinsic
from c3dgs_tpu_torch.tools import dma_probe as tprobe
from c3dgs_tpu_torch.tools import scenes
from c3dgs_tpu_torch.train import finetune, trainer
import torch_ranks
import torch_tile_shape_cases

EV = np.array([0, 0, 0, 1, 0, 0, 0], np.float32)
IMG_TOL = dict(atol=2e-5, rtol=1e-4)  # the reference's bar, tests/test_render.py:113
K1_TOL = dict(atol=2e-5, rtol=1e-4)
GRAD_TOL = 5e-4  # normalized gradient bar, tests/test_render.py:150
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


def long_tile_scene():
    """c3dgs_tpu_torch.tools.scenes.long_tile_scene at its 64x48 view:
    tiles of 1,792-2,053 slots, the top-left one frozen at slot 1408."""
    means, scales, quats, opacity, colors = scenes.long_tile_scene()
    kw = dict(width=64, height=48, tanfovx=math.tan(0.6), tanfovy=math.tan(0.45), sh_degree=0)
    return dict(means=means, cov=cov6(scales, quats), op=opacity, colors=colors, shs=None), kw


SCENES = {
    "make_scene": lambda: make_scene(300),
    "make_scene_sh": lambda: make_scene(300, sh=True),
    "occluder": occluder_scene,
    "wall": wall_scene,
    "boundary": boundary_scene,
    "long_tile": long_tile_scene,
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
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")


def test_k1_inputs_stage_on_cpu():
    """The staging these tests feed K1 runs here too, through the wrapper's
    CPU route (the plain version)."""
    sc, kw = wall_scene()
    args = k1_inputs(sc, kw, "cpu")
    out = tiles_packed.forward(*args)
    assert out.shape == (RasterSettings(**kw).num_tiles, 8, tiles.PIX)
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


def test_long_tile_scene_stages_on_cpu():
    """The long-tile scene through the CPU route: three tiles of more than
    1,000 slots, one frozen after 10 live aligned boundaries, two never."""
    sc, kw = long_tile_scene()
    args = k1_inputs(sc, kw, "cpu")
    starts, ends, cap = args[3], args[4], int(args[2][3])
    lengths = (ends - starts).tolist()
    assert sorted(lengths)[-3] > 1000
    frz = tiles_packed.forward(*args)[:, 5, 0]
    frozen = torch.nonzero(frz < cap).flatten().tolist()
    assert frozen == [0] and int(frz[0]) - int(starts[0]) > 10 * 128
    assert int(frz[0]) < int(ends[0]) and all(lengths[t] > 1000 for t in (0, 2, 4))


@pytest.mark.gpu
def test_k1_long_tiles_match_plain():
    """K1 on tiles of 1,792-2,053 slots: every ring stage and aligned
    boundary, the freeze slot exact."""
    _need_card()
    args = k1_inputs(*long_tile_scene(), "cuda")
    out_k = tiles_packed.forward(*args)
    torch.cuda.synchronize()
    out_p = tiles_packed.forward_plain(*args)
    torch.testing.assert_close(out_k[:, :5], out_p[:, :5], **K1_TOL)
    assert torch.equal(out_k[:, 5:], out_p[:, 5:])
    assert int((out_k[:, 5, 0] < float(args[2][3])).sum()) == 1


# ------------------------------------------------------ the tile-range mode
def routed_k1_inputs(sc, kw, device, size=4):
    """Each rank's K1 inputs for the scene's routed arrays on a tiles axis
    of `size` (torch_ranks.route_all: the ranks are threads), with its
    RoutedBinning: (fields, tile_lo, meta, starts, ends), meta = [chunks_exec,
    t0, t1, cap]."""
    t = lambda x: None if x is None else torch.as_tensor(x, device=device)
    settings = RasterSettings(**kw)
    prep = preprocess(t(sc["means"]), t(sc["cov"]), t(sc["op"]), t(EV), settings, t(sc["shs"]), t(sc["colors"]))
    cap, _ = settings.resolve_caps(sc["means"].shape[0])
    out = []
    for rb in torch_ranks.route_all(prep, settings, size):
        fields = rasterizer._build_fields_packed(
            per_gaussian_table(prep, rb.offset), rb.gid_sorted, rb.tid_sorted, rb.sent_sorted, rb.j_sorted,
            settings.tiles_x, settings.num_tiles, cap,
        )
        meta = torch.stack([rb.chunks_exec, *(torch.full_like(rb.chunks_exec, v) for v in (rb.t0, rb.t1, cap))])
        out.append(((fields, rb.tile_lo, meta, rb.starts, rb.ends), rb))
    return out


def test_routed_long_tile_blocks_match_single_device():
    """The long-tile scene split 4 ways (tiles 0-1, 2-3, 4-5 and a rank of
    padding tiles only), through the wrapper's CPU route: every owned
    block equals the single-device block of its tile (rank 0's walk starts
    at the same slot, so its freeze slots are equal too)."""
    sc, kw = long_tile_scene()
    full = tiles_packed.forward(*k1_inputs(sc, kw, "cpu"))
    cap = RasterSettings(**kw).resolve_caps(sc["means"].shape[0])[0]
    owned_total = 0
    for d, (args, rb) in enumerate(routed_k1_inputs(sc, kw, "cpu")):
        assert int(rb.route_dropped) == 0
        out = tiles_packed.forward(*args)
        owned = rb.t1 - rb.t0
        assert out.shape == (2, 8, tiles.PIX) and rb.t0 == 2 * d and owned == (0 if d == 3 else 2)
        ref = full[rb.t0 : rb.t1]
        torch.testing.assert_close(out[:owned, :5], ref[:, :5], **K1_TOL)
        assert torch.equal(out[:owned, 5] < cap, ref[:, 5] < cap)
        if d == 0:
            assert torch.equal(out[:owned, 5], ref[:, 5])
        assert not out[owned:].any()
        owned_total += owned
    assert owned_total == 6


@pytest.mark.gpu
def test_k1_k2_tile_range_match_plain():
    """K1 and K2 in their tile-range mode on each routed rank's array of
    the long-tile scene, against their plain versions: owned blocks' rows
    0-4 at atol 2e-5 / rtol 1e-4 and rows 5-7 exact; gradient rows 0-8 at
    normalized 5e-4 per row, rows 9-15 exact."""
    _need_card()
    sc, kw = long_tile_scene()
    for d, (args, rb) in enumerate(routed_k1_inputs(sc, kw, "cuda")):
        owned = rb.t1 - rb.t0
        before = (tiles_packed.FORWARD_KERNEL.launches, tiles_packed.BACKWARD_KERNEL.launches)
        out_k = tiles_packed.forward(*args)
        out_p = tiles_packed.forward_plain(*args)
        torch.testing.assert_close(out_k[:owned, :5], out_p[:owned, :5], **K1_TOL)
        assert torch.equal(out_k[:owned, 5:], out_p[:owned, 5:])
        g = torch.zeros_like(out_p)
        g[:owned, :4] = torch.as_tensor(np.random.default_rng(d).normal(size=(owned, 4, tiles.PIX)), dtype=torch.float32)
        got = tiles_packed.backward(*args, out_p, g)
        torch.cuda.synchronize()
        assert (tiles_packed.FORWARD_KERNEL.launches, tiles_packed.BACKWARD_KERNEL.launches) == (
            before[0] + 1, before[1] + 1)
        ref = tiles_packed.backward_plain(*args, out_p, g)
        for r in range(9):
            assert_normalized(got[r], ref[r], GRAD_TOL, f"rank {d} row {r}")
        assert torch.equal(got[9:], ref[9:])


@pytest.mark.gpu
def test_k1_k2_full_range_equals_split_ranges_bitwise():
    """K1 and K2 over [0, T) against two calls with explicit ranges [0, k)
    and [k, T) over the same array (starts/ends sliced): each CTA walks its
    own tile, so the blocks and the gradient rows are bitwise equal."""
    _need_card()
    sc, kw = long_tile_scene()
    fields, tile_lo, meta, starts, ends = k1_inputs(sc, kw, "cuda")
    t, k = starts.shape[0], 3
    full = tiles_packed.forward(fields, tile_lo, meta, starts, ends)
    parts = []
    for lo, hi in ((0, k), (k, t)):
        m = meta.clone()
        m[1], m[2] = lo, hi
        parts.append((m, slice(lo, hi)))
    split = torch.cat([tiles_packed.forward(fields, tile_lo, m, starts[sl], ends[sl]) for m, sl in parts])
    assert torch.equal(split, full)
    g = torch.zeros_like(full)
    g[:, :4] = torch.as_tensor(np.random.default_rng(3).normal(size=(t, 4, tiles.PIX)), dtype=torch.float32)
    grads = tiles_packed.backward(fields, tile_lo, meta, starts, ends, full, g)
    summed = sum(tiles_packed.backward(fields, tile_lo, m, starts[sl], ends[sl], full[sl], g[sl]) for m, sl in parts)
    assert torch.equal(summed, grads)


def card_render_payload():
    pts, cols = torch_ranks.toy_points(300, seed=1)
    scene = gaussians.from_point_cloud(pts, cols, capacity=320, quantization=False, device="cpu")
    return dict(torch_ranks.port_leaves(scene), kw=torch_ranks.SET_KW, ev=EV, bg=np.array([0.1, 0.2, 0.3], np.float32),
                w=np.random.default_rng(5).normal(size=(3, 32, 64)).astype(np.float32))


def check_card_render(results):
    for res in results:
        assert res["dropped"] == 0 and res["launched"] == (1, 1)
        np.testing.assert_allclose(res["img"], res["single"], atol=1e-5)
        g, g1 = res["grad"], res["grad_single"]
        assert np.abs(g - g1).max() / max(np.abs(g1).max(), 1e-12) < 1e-4
        np.testing.assert_array_equal(res["img"], results[0]["img"])


def test_tile_sharded_render_job_runs_on_cpu(tmp_path):
    """The card test's 2-rank job through the plain versions: the sharded
    image and its xyz gradient against the single-device render."""
    results = torch_ranks.run(2, "card_render", card_render_payload(), tmp_path, device="cpu")
    for res in results:
        res["launched"] = (1, 1)  # CPU tensors launch no kernel
    check_card_render(results)


@pytest.mark.gpu
def test_tile_sharded_render_two_ranks_on_card(tmp_path):
    """render_tile_sharded on 2 gloo ranks sharing cuda:0 (the kernels
    built first, once): the image at atol 1e-5 and the xyz gradient within
    1e-4 (relative max) of the single-device render on the same card, each
    rank launching K1 and K2 once."""
    _need_card()
    kernels.build(sorted({k.source for k in kernels.REGISTRY.values()}))
    check_card_render(torch_ranks.run(2, "card_render", card_render_payload(), tmp_path, device="cuda"))


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


def assert_normalized(got, ref, atol, name="", floor=1e-3):
    """max|got - ref| <= atol * max(max|ref|, floor); the floor of the
    gradient bar, tests/test_render.py:153, unless told otherwise."""
    got, ref = got.double().cpu(), ref.double().cpu()
    scale = max(float(ref.abs().max()), floor)
    err = float(((got - ref) / scale).abs().max())
    assert err <= atol and bool(torch.isfinite(got).all()), f"{name}: normalized error {err:.3e}"


def k2_inputs(scene, device):
    """K1's inputs, its blocks and a seeded cotangent (rows 0-3 random,
    4-7 zero, as assemble_image leaves them) for a small scene."""
    sc, kw = SCENES[scene]()
    args = k1_inputs(sc, kw, device)
    totals = tiles_packed.forward(*args)
    g = np.zeros(tuple(totals.shape), np.float32)
    g[:, :4] = np.random.default_rng(0).normal(size=g[:, :4].shape)
    return args, totals, torch.as_tensor(g, device=device)


def test_k2_inputs_run_on_cpu():
    """The staging these tests feed K2 runs here too, through the wrapper's
    CPU route (the plain version)."""
    args, totals, g = k2_inputs("wall", "cpu")
    grads = tiles_packed.backward(*args, totals, g)
    assert grads.shape == (16, args[0].shape[1]) and bool(grads[:9].abs().max() > 0)


@pytest.mark.parametrize(
    "pixels, want",
    [
        ([[(0, 0)], [(20, 5), (21, 5)], []], dict(row_pairs=2, warp_pairs=2)),
        ([[(0, 0), (8, 0)], [(0, 0), (0, 4), (31, 15)]], dict(row_pairs=4, warp_pairs=4)),
        ([[(0, 0), (16, 0)], [(0, 3), (0, 4)]], dict(row_pairs=3, warp_pairs=4)),
    ],
    ids=["one-group-each", "across-groups", "row-spans-two-warps"],
)
def test_k2_plain_counts_live_pixel_groups(pixels, want):
    """chip_smoke.py's shuffle estimate reads these counts: per slot (lane),
    the 32-pixel rows and 16x4 warp regions holding a live pixel."""
    live = torch.zeros(512, len(pixels), dtype=torch.bool)
    for lane, pts in enumerate(pixels):
        for x, y in pts:
            live[y * 32 + x, lane] = True
    stats = {}
    tiles_packed._count_live_groups(stats, live)
    assert stats == want


def test_packed_plain_counts_the_exps_the_kernels_skip():
    """The K1/K2 bounds in chip_smoke.py count an exp only for the live
    pairs the kernels' skip keeps: opacity above 1 or power at least
    SKIP_POWER. Lane 0 is dead (opacity zeroed)."""
    op = torch.tensor([0.0, 0.5, 2.0, 0.5])
    power = torch.tensor([[-1.0, -6.0, -6.0, -1.0], [-1.0, tiles_packed.SKIP_POWER, -7.0, -7.0]])
    alpha = torch.zeros_like(power)
    alpha[0, 3] = 0.3
    stats = {}
    tiles_packed._count_pairs(stats, op, power, alpha)
    assert stats == dict(pairs=3 * tiles.PIX, exp_pairs=4, alpha_pairs=1)


@pytest.mark.parametrize("scene", ["wall", "long_tile"])
def test_packed_plain_exp_counts_cover_every_live_alpha(scene):
    """The skip never drops a pair whose alpha is above 0: in both plain
    versions alpha_pairs <= exp_pairs, and on these scenes it drops some
    (exp_pairs < pairs)."""
    args, totals, g = k2_inputs(scene, "cpu")
    fwd, bwd = {}, {}
    tiles_packed.forward_plain(*args, stats=fwd)
    tiles_packed.backward_plain(*args, totals, g, stats=bwd)
    for stats in (fwd, bwd):
        assert 0 < stats["alpha_pairs"] <= stats["exp_pairs"] < stats["pairs"]


@pytest.mark.gpu
@pytest.mark.parametrize("scene", ["make_scene", "occluder", "wall", "boundary"])
def test_k2_cuda_kernel_matches_plain(scene):
    """K2 on the card against its plain version on identical inputs: rows
    0-8 at normalized 5e-4 per row, rows 9-15 exact."""
    _need_card()
    args, totals, g = k2_inputs(scene, "cuda")
    before = tiles_packed.BACKWARD_KERNEL.launches
    got = tiles_packed.backward(*args, totals, g)
    torch.cuda.synchronize()
    assert tiles_packed.BACKWARD_KERNEL.launches == before + 1
    ref = tiles_packed.backward_plain(*args, totals, g)
    for r in range(9):
        assert_normalized(got[r], ref[r], GRAD_TOL, f"row {r}")
    assert torch.equal(got[9:], ref[9:])


@pytest.mark.gpu
def test_k2_long_tiles_match_plain_and_repeat():
    """K2 on tiles of 1,792-2,053 slots (14-16 ring stages each, one tile
    walked back from its freeze slot): rows 0-8 at normalized 5e-4 per row,
    the tag rows exact, and a second run bitwise equal."""
    _need_card()
    args, totals, g = k2_inputs("long_tile", "cuda")
    got = tiles_packed.backward(*args, totals, g)
    again = tiles_packed.backward(*args, totals, g)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    ref = tiles_packed.backward_plain(*args, totals, g)
    for r in range(9):
        assert_normalized(got[r], ref[r], GRAD_TOL, f"row {r}")
    assert torch.equal(got[9:], ref[9:])


@pytest.mark.gpu
def test_k2_is_deterministic():
    _need_card()
    args, totals, g = k2_inputs("boundary", "cuda")
    a = tiles_packed.backward(*args, totals, g)
    b = tiles_packed.backward(*args, totals, g)
    assert torch.equal(a, b)


# ---------------------------------------------- the exact reduction
def segment_frame(n=400, seed=3, device="cpu"):
    """A training reduction's inputs, made up: K2-like (16, rows) gradient
    rows, a permutation and emit_cum over n splats. Most splats emit 0-3
    instances; runs of splats emit none (the first and the last among
    them); one splat emits 230 and 1% of the rest 16-256 (summed by a whole
    warp on the card); the permutation runs 50 entries past the emitted
    total, and about 30 emissions' slots lie past the execution bucket
    `rows`, which must drop them."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 4, size=n)
    counts[rng.choice(n, size=n // 100, replace=False)] = rng.integers(16, 257, size=n // 100)
    counts[n // 3] = 230
    counts[:3] = counts[-2:] = counts[n // 2 : n // 2 + 5] = 0
    emit_cum = np.cumsum(counts).astype(np.int32)
    total = int(emit_cum[-1])
    rows = total + 20
    perm = rng.permutation(total + 50).astype(np.int32)
    grads = np.zeros((16, rows), np.float32)
    grads[:9] = rng.normal(size=(9, rows)) * 0.05
    return [torch.as_tensor(x, device=device) for x in (grads, perm, emit_cum)]


def segment_meta(grads, live_chunks):
    """K1/K2's meta for a made-up frame: [chunks_exec, 0, 1, len(grads)]."""
    return torch.tensor([live_chunks, 0, 1, grads.shape[1]], dtype=torch.int32, device=grads.device)


def test_segment_frame_reduces_on_cpu():
    """The frame the card's segment-sum tests use runs here through the
    wrapper's CPU route (the plain version), and launches nothing; slots
    past meta[0]*128 add nothing, as if their rows were zero."""
    grads, perm, emit_cum = segment_frame()
    every = segment_meta(grads, -(-grads.shape[1] // 128))
    before = segment_sum.KERNEL.launches
    out = segment_sum.segment_sum(grads, perm, emit_cum, every)
    assert segment_sum.KERNEL.launches == before
    assert out.shape == (len(emit_cum), 16) and not out[:, 9:].any() and not out[:3].any()
    assert torch.equal(out, segment_sum.segment_sum_plain(grads, perm, emit_cum, every))
    live = grads.shape[1] // 128 - 2
    cut = grads.clone()
    cut[:, live * 128 :] = 0.0
    got = segment_sum.segment_sum(grads, perm, emit_cum, segment_meta(grads, live))
    assert torch.equal(got, segment_sum.segment_sum(cut, perm, emit_cum, every)) and not torch.equal(got, out)


@pytest.mark.gpu
def test_segment_sum_kernel_matches_plain_and_repeats():
    """The exact reduction's kernels on 300,000 splats with 3,000 long
    segments, over every slot and up to a meta's executed chunks: within 1
    ulp of the plain version (both round a float64 sum once; atol 1e-13
    covers the float64 sums' other order, ~256 terms of ~0.05 at 2^-52) and
    bitwise equal on a second launch."""
    _need_card()
    grads, perm, emit_cum = segment_frame(300_000, device="cuda")
    for meta in (segment_meta(grads, -(-grads.shape[1] // 128)), segment_meta(grads, grads.shape[1] // 128 - 50)):
        got = segment_sum.segment_sum(grads, perm, emit_cum, meta)
        again = segment_sum.segment_sum(grads, perm, emit_cum, meta)
        torch.cuda.synchronize()
        assert torch.equal(got, again)
        torch.testing.assert_close(got, segment_sum.segment_sum_plain(grads, perm, emit_cum, meta),
                                   rtol=2.0 ** -23, atol=1e-13)


@pytest.mark.gpu
def test_segment_sum_launches_once_per_exact_training_backward():
    """The kernel's count rises once per backward of a training render in
    exact mode, and stays put through an inference render's forward, a
    fast_grad backward and an inference render's backward (no perm: the
    keyed reduction)."""
    _need_card()
    sc, kw = make_scene(150)
    k = segment_sum.KERNEL
    before = k.launches
    with torch.no_grad():
        rasterizer.render(*(torch.as_tensor(sc[f], device="cuda") for f in ("means", "cov", "op")),
                          torch.as_tensor(EV, device="cuda"), RasterSettings(**kw, inference=True),
                          torch.zeros(3, device="cuda"), colors_precomp=torch.as_tensor(sc["colors"], device="cuda"))
    render_grads(rasterizer.render, sc, kw, "cuda", fast_grad=True)
    render_grads(rasterizer.render, sc, kw, "cuda", fast_grad=False, inference=True)
    torch.cuda.synchronize()
    assert k.launches == before
    for i in (1, 2):
        render_grads(rasterizer.render, sc, kw, "cuda", fast_grad=False)
        assert k.launches == before + i


# ------------------------------------------- the codebook-table gradients
TABLE_LAYOUTS = ("uniform", "bimodal", "skewed", "empty")


def table_ids(layout, small=False, seed=0):
    """(ids, rows) of a table gradient, shuffled: `uniform` ids over the
    whole table; `bimodal` as garden-5m-c3dgs's colour blocks, 4,096
    codebook rows read ~60 times each and 26,000 kept rows read once in a
    table of 4,096 + 500,000 rows; `skewed` one row read by 2^20 ids among
    2^16 uniform over 4,096 rows; `empty` ids on every third row of the
    table's first half only. `small` scales each to a CPU's size (64
    codebook rows, 400 kept, 2^14 on the skewed row)."""
    rng = np.random.default_rng(seed)
    s = 64 if small else 1
    if layout == "uniform":
        rows = (1 << 16) // s
        ids = rng.integers(0, rows, 4 * rows)
    elif layout == "bimodal":
        cb, kept = 4096 // s, 26_000 // s
        rows = cb + 500_000 // s
        ids = np.concatenate([rng.integers(0, cb, 60 * cb), cb + rng.choice(rows - cb, kept, replace=False)])
    elif layout == "skewed":
        rows = 4096 // s
        ids = np.concatenate([np.full((1 << 20) // s, 5), rng.integers(0, rows, (1 << 16) // s)])
    elif layout == "empty":
        rows = (1 << 17) // s
        ids = 3 * rng.integers(0, rows // 6, rows)
    else:
        raise ValueError(layout)
    return rng.permutation(ids), rows


def check_table_kernel(layout, d):
    """segment_sum on the card twice on `layout`'s ids and N(0, 1) values
    of d columns: within one float32 rounding of a float64 index_add_
    (rtol 2^-23; atol 1e-12 covers the two float64 sums' other orders),
    bitwise equal, one launch a call, and every empty row exactly 0."""
    ids, rows = table_ids(layout)
    rng = np.random.default_rng(1)
    vals = torch.as_tensor(rng.normal(size=(len(ids), d)), dtype=torch.float32, device="cuda")
    idx = torch.as_tensor(ids, device="cuda")
    before = segment.KERNEL.launches
    got = segment.segment_sum(vals, idx, rows)
    again = segment.segment_sum(vals, idx, rows)
    torch.cuda.synchronize()
    assert segment.KERNEL.launches == before + 2
    assert torch.equal(got, again)
    ref = torch.zeros((rows, d), dtype=torch.float64).index_add_(0, idx.cpu(), vals.cpu().double())
    torch.testing.assert_close(got.cpu().double(), ref, rtol=2.0**-23, atol=1e-12)
    empty = torch.ones(rows, dtype=torch.bool)
    empty[idx.cpu()] = False
    assert not got.cpu()[empty].any() and (bool(empty.any()) or layout != "empty")


@pytest.mark.gpu
@pytest.mark.parametrize("d", (7, 48))
@pytest.mark.parametrize("layout", TABLE_LAYOUTS)
def test_table_segment_sum_kernel_matches_plain_and_repeats(layout, d):
    """The table-gradient kernel (csrc/table_segment_sum.cu) on each id
    layout, at the shape gather's 7 and the colour blocks' 48 columns, as
    check_table_kernel holds it."""
    _need_card()
    check_table_kernel(layout, d)


@pytest.mark.gpu
@pytest.mark.parametrize("d", (1, 4, 49, 300))
def test_table_segment_sum_kernel_takes_any_width(d):
    """The other widths: the compress pipeline's 4 and vq's 49 columns, a
    lane group of one lane, and 300 columns (two windows of 256), on the
    bimodal layout, as check_table_kernel holds it."""
    _need_card()
    check_table_kernel("bimodal", d)


@pytest.mark.gpu
def test_table_segment_sum_launches_per_colour_block_and_shape_gather(monkeypatch):
    """One train_step of the compressed toy scene (QAT on) with its colours
    in blocks of 128 splats: the table-gradient kernel launches once per
    colour block and once for the shape gather, and nothing else in the
    step launches it."""
    _need_card()
    _, cams, comp = compressed_toy("cuda")
    monkeypatch.setattr(trainer, "BLOCKED_COLORS_MIN", 0)
    real = trainer.sh_ops.sh_to_rgb_indexed_blocked
    monkeypatch.setattr(trainer.sh_ops, "sh_to_rgb_indexed_blocked",
                        lambda *a, **k: real(*a, **k, block=128))
    state = trainer.create_train_state(comp.clone(), OptimizationParams(), 1.0, device="cuda")
    cam = cams[0]
    before = segment.KERNEL.launches
    _, metrics = trainer.train_step(state, cam.extrinsic_vector, cam.original_image,
                                    settings_from_intrinsic(cam.intrinsic), torch.zeros(3, device="cuda"),
                                    device="cuda")
    torch.cuda.synchronize()
    assert comp.quantization and int(metrics["overflow"]) == 0
    assert segment.KERNEL.launches - before == -(-comp.feature_indices.shape[0] // 128) + 1


# --------------------------------------------- another tile shape: 16x16
@pytest.fixture(scope="module")
def cases_16x16(tmp_path_factory):
    """tests/torch_tile_shape_cases.py's card cases in a child process at
    C3DGS_TILE_X=C3DGS_TILE_Y=16 (the tile shape is read at import): K1-K4
    built for 16x16 against their plain versions on the small scenes and
    the long-tile scene, K2 and K4 twice."""
    _need_card()
    out = tmp_path_factory.mktemp("tile_16x16") / "cases.json"
    env = dict(os.environ, C3DGS_TILE_X="16", C3DGS_TILE_Y="16")
    proc = subprocess.run([sys.executable, torch_tile_shape_cases.__file__, "card", str(out)], env=env,
                          capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    return json.loads(out.read_text())


@pytest.mark.gpu
@pytest.mark.parametrize("case", torch_tile_shape_cases.case_names("card"))
def test_kernels_at_16x16_match_plain(cases_16x16, case):
    """At 16x16: forward rows at atol 2e-5 / rtol 1e-4 and rows 5-7
    exact, gradient rows 0-8 at normalized 5e-4 per row and 9-15 exact,
    each launch counted once, K2's and K4's repeat bitwise equal."""
    assert cases_16x16["tile"] == [16, 16]
    assert cases_16x16[case] == "ok", cases_16x16[case]


@pytest.mark.gpu
def test_wrappers_refuse_an_unsupported_tile_shape_before_launching(monkeypatch):
    """A tile shape the kernels cannot take raises on the card, with its
    reason, and launches nothing: no wrapper falls back to its plain
    version."""
    _need_card()
    args, totals, g = k2_inputs("make_scene", "cuda")
    pt, grad_base, st = k3_inputs(*make_scene(300), "cuda")
    monkeypatch.setattr(tiles, "TILE_X", 20)
    before = {k.name: k.launches for k in kernels.REGISTRY.values()}
    for call in (lambda: tiles_packed.forward(*args), lambda: tiles_packed.backward(*args, totals, g),
                 lambda: tiles.forward(*pt, st.tiles_x)):
        with pytest.raises(NotImplementedError, match="20x16: the width must be a multiple of 8"):
            call()
    assert {k.name: k.launches for k in kernels.REGISTRY.values()} == before


def k3_inputs(sc, kw, device, **over):
    """The port's own staged per-tile inputs on `device`: K3's (fields,
    tile_ids, starts, ends, nchunks), then grad_base and the settings."""
    t = lambda x: None if x is None else torch.as_tensor(x, device=device)
    settings = RasterSettings(**kw, packed=False, **over)
    prep = preprocess(t(sc["means"]), t(sc["cov"]), t(sc["op"]), t(EV), settings, t(sc["shs"]), t(sc["colors"]))
    b = bin_gaussians(prep, settings)
    fields = rasterizer._build_fields(per_gaussian_table(prep, b.offset), b.gid_sorted, b.j_sorted)
    tile_ids = torch.arange(settings.num_tiles, dtype=torch.int32, device=device)
    return (fields, tile_ids, b.starts, b.ends, b.nchunks), b.grad_base, settings


def k4_inputs(scene, device, **over):
    """K3's inputs, grad_base, K3's blocks, a seeded cotangent and the grad
    capacity."""
    sc, kw = SCENES[scene]()
    args, grad_base, settings = k3_inputs(sc, kw, device, **over)
    totals = tiles.forward(*args, settings.tiles_x)
    g = np.zeros(tuple(totals.shape), np.float32)
    g[:, :4] = np.random.default_rng(0).normal(size=g[:, :4].shape)
    grad_cap = settings.resolve_grad_cap(len(sc["means"]))
    return args, grad_base, totals, torch.as_tensor(g, device=device), settings.tiles_x, grad_cap


def test_k3_k4_inputs_run_on_cpu():
    """The per-tile staging these tests feed K3 and K4 runs here too,
    through the wrappers' CPU route (the plain versions); the wall scene's
    saturation exit skips windows."""
    args, grad_base, totals, g, tiles_x, grad_cap = k4_inputs("wall", "cpu")
    assert totals.shape == (args[1].shape[0], 8, tiles.PIX)
    assert bool((totals[:, 5, 0] < args[4].float()).any())
    grads = tiles.backward(*args, grad_base, totals, g, tiles_x, grad_cap)
    assert grads.shape == (16, grad_cap) and bool(grads[:9].abs().max() > 0)


@pytest.mark.gpu
@pytest.mark.parametrize("scene", ["make_scene_sh", "occluder", "wall", "boundary"])
def test_k3_cuda_kernel_matches_plain(scene):
    """K3 on the card against its plain version on identical staged
    fields: rows 0-4 at atol 2e-5 / rtol 1e-4, `stop` and rows 6-7 exact."""
    _need_card()
    sc, kw = SCENES[scene]()
    args, _, settings = k3_inputs(sc, kw, "cuda")
    before = tiles.FORWARD_KERNEL.launches
    out_k = tiles.forward(*args, settings.tiles_x)
    torch.cuda.synchronize()
    assert tiles.FORWARD_KERNEL.launches == before + 1
    out_p = tiles.forward_plain(*args, settings.tiles_x)
    torch.testing.assert_close(out_k[:, :5], out_p[:, :5], **K1_TOL)
    assert torch.equal(out_k[:, 5:], out_p[:, 5:])


@pytest.mark.gpu
@pytest.mark.parametrize("scene", ["make_scene", "occluder", "wall", "boundary"])
def test_k4_cuda_kernel_matches_plain(scene):
    """K4 on the card against its plain version on identical inputs: rows
    0-8 at normalized 5e-4 per row, rows 9-15 exact."""
    _need_card()
    args, grad_base, totals, g, tiles_x, grad_cap = k4_inputs(scene, "cuda")
    before = tiles.BACKWARD_KERNEL.launches
    got = tiles.backward(*args, grad_base, totals, g, tiles_x, grad_cap)
    torch.cuda.synchronize()
    assert tiles.BACKWARD_KERNEL.launches == before + 1
    ref = tiles.backward_plain(*args, grad_base, totals, g, tiles_x, grad_cap)
    for r in range(9):
        assert_normalized(got[r], ref[r], GRAD_TOL, f"row {r}")
    assert torch.equal(got[9:], ref[9:])


def clamped_subset(device):
    """The wall scene's tiles up to the one with the most windows, staged
    as a tile-sharded call (tile_ids and grad_base of the subset), with a
    grad capacity that clamps that tile's windows 1..: the TPU grid's last
    writer is its window 1, not its last. Returns K4's inputs."""
    args, _, totals, g, tiles_x, _ = k4_inputs("wall", device)
    t_max = int(torch.argmax(args[4]))
    sub = tuple(x[: t_max + 1].contiguous() for x in args[1:])
    nch = sub[3]
    grad_base = ((torch.cumsum(nch, 0) - nch) * 128).to(torch.int32)
    grad_cap = int(grad_base[t_max]) + 256
    return (args[0], *sub), grad_base, totals[: t_max + 1].contiguous(), g[: t_max + 1].contiguous(), tiles_x, grad_cap


def test_clamped_subset_stages_on_cpu():
    """The clamped inputs of the card test below, through the CPU route:
    the clamped tile has several windows and the writer is its window 1."""
    args, grad_base, totals, g, tiles_x, grad_cap = clamped_subset("cpu")
    t, w = tiles.last_chunk_writer(args[4], grad_base, grad_cap)
    assert (t, w) == (args[4].shape[0] - 1, 1) and int(args[4][t]) >= 3
    grads = tiles.backward(*args, grad_base, totals, g, tiles_x, grad_cap)
    assert grads.shape == (16, grad_cap) and bool(torch.isfinite(grads).all())


@pytest.mark.gpu
def test_k4_clamped_frame_is_deterministic():
    """A clamped call: every clamped window but the TPU grid's last writer
    skips the last chunk, so two K4 runs are bitwise equal and their tags
    equal the plain version's exactly."""
    _need_card()
    args, grad_base, totals, g, tiles_x, grad_cap = clamped_subset("cuda")
    ref = tiles.backward_plain(*args, grad_base, totals, g, tiles_x, grad_cap)
    runs = [tiles.backward(*args, grad_base, totals, g, tiles_x, grad_cap) for _ in range(2)]
    assert torch.equal(runs[0], runs[1])
    for r in range(9):
        assert_normalized(runs[0][r], ref[r], GRAD_TOL, f"row {r}")
    assert torch.equal(runs[0][9:], ref[9:])


def window_spans(args):
    """(first slot, instance count) of every window of a per-tile call."""
    _, _, starts, ends, nch = (x.tolist() for x in args)
    return [(s + w * 128, min(128, e - s - w * 128)) for s, e, n in zip(starts, ends, nch) for w in range(n)]


# The redesigned K3/K4 stage each window's 16-byte aligned span (up to 132
# floats) in a two-deep ring: scenes whose windows reach each edge of that
# design, and the property each shows.
WINDOW_EDGES = {
    # windows start at every residue mod 4: the first group's lanes before
    # the window are skipped
    "residues": ("boundary", lambda spans, nch: {b % 4 for b, _ in spans} == {0, 1, 2, 3}),
    # a tile of 3 or more windows refills both ring stages
    "ring_wrap": ("long_tile", lambda spans, nch: int(nch.max()) >= 3),
    # a full window from an unaligned slot ends past the last aligned group:
    # its span is 33 groups, the stage's whole 132 floats
    "ragged_end": ("long_tile", lambda spans, nch: any(b % 4 and n == 128 for b, n in spans)),
}


@pytest.mark.parametrize("case", list(WINDOW_EDGES))
def test_window_edge_scenes_stage_on_cpu(case):
    """The inputs of the card test below, through the CPU route: each
    scene reaches its edge of the window ring."""
    scene, has_edge = WINDOW_EDGES[case]
    args, grad_base, totals, g, tiles_x, grad_cap = k4_inputs(scene, "cpu")
    assert has_edge(window_spans(args), args[4])
    assert bool(torch.isfinite(tiles.backward(*args, grad_base, totals, g, tiles_x, grad_cap)).all())


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(WINDOW_EDGES))
def test_k3_k4_window_edges_match_plain(case):
    """K3 and K4 against their plain versions where the windows reach an
    edge of the ring: K3's rows 0-4 at atol 2e-5 / rtol 1e-4 and `stop`
    exact, K4's rows 0-8 at normalized 5e-4 per row and its tags exact."""
    _need_card()
    scene, has_edge = WINDOW_EDGES[case]
    args, grad_base, totals, g, tiles_x, grad_cap = k4_inputs(scene, "cuda")
    assert has_edge(window_spans(args), args[4])
    out_p = tiles.forward_plain(*args, tiles_x)
    torch.testing.assert_close(totals[:, :5], out_p[:, :5], **K1_TOL)
    assert torch.equal(totals[:, 5:], out_p[:, 5:])
    got = tiles.backward(*args, grad_base, totals, g, tiles_x, grad_cap)
    ref = tiles.backward_plain(*args, grad_base, totals, g, tiles_x, grad_cap)
    for r in range(9):
        assert_normalized(got[r], ref[r], GRAD_TOL, f"row {r}")
    assert torch.equal(got[9:], ref[9:])


@pytest.mark.gpu
def test_k4_clamped_long_tile_frame_repeats_bitwise():
    """The long-tile frame with 8 chunks fewer than its windows need: the
    clamped windows' last writer alone fills the last chunk, two runs are
    bitwise equal, and both match the plain version."""
    _need_card()
    args, grad_base, totals, g, tiles_x, _ = k4_inputs("long_tile", "cuda")
    grad_cap = int(args[4].sum()) * 128 - 8 * 128
    ref = tiles.backward_plain(*args, grad_base, totals, g, tiles_x, grad_cap)
    runs = [tiles.backward(*args, grad_base, totals, g, tiles_x, grad_cap) for _ in range(2)]
    assert torch.equal(runs[0], runs[1])
    for r in range(9):
        assert_normalized(runs[0][r], ref[r], GRAD_TOL, f"row {r}")
    assert torch.equal(runs[0][9:], ref[9:])


@pytest.mark.gpu
def test_per_tile_kernels_reject_misaligned_fields():
    """The kernels stage fields with 16-byte bulk copies: a contiguous
    copy one column off that alignment is refused by both wrappers."""
    _need_card()
    args, grad_base, totals, g, tiles_x, grad_cap = k4_inputs("make_scene", "cuda")
    fields = args[0]
    shifted = torch.empty(fields.numel() + 1, device=fields.device)[1:].view(fields.shape)
    shifted.copy_(fields)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    with pytest.raises(ValueError, match="16-byte aligned"):
        tiles.forward(shifted, *args[1:], tiles_x)
    with pytest.raises(ValueError, match="16-byte aligned"):
        tiles.backward(shifted, *args[1:], grad_base, totals, g, tiles_x, grad_cap)


def render_grads(render_fn, sc, kw, device, wimg=None, **over):
    """Gradients of sum(wimg * image) (wimg seeded when not given) with
    respect to means, cov, opacity, the extrinsic, the colors or SH and,
    through rasterizer.render, a zero viewspace offset (None for the
    oracle); and the render output."""
    settings = RasterSettings(**kw, **over)
    feats = "shs" if sc["shs"] is not None else "colors"
    leaves = [torch.tensor(sc[k], device=device, requires_grad=True) for k in ("means", "cov", "op")]
    leaves += [torch.tensor(EV, device=device, requires_grad=True),
               torch.tensor(sc[feats], device=device, requires_grad=True),
               torch.zeros((len(sc["means"]), 2), device=device, requires_grad=True)]
    kwf = {"shs": leaves[4]} if feats == "shs" else {"colors_precomp": leaves[4]}
    if render_fn is rasterizer.render:
        kwf["viewspace_offset"] = leaves[5]
    out = render_fn(*leaves[:4], settings, torch.tensor([0.2, 0.1, 0.4], device=device), **kwf)
    if wimg is None:
        wimg = np.random.default_rng(7).normal(size=(3, kw["height"], kw["width"])).astype(np.float32)
    (torch.as_tensor(wimg, device=device) * out["render"]).sum().backward()
    return [x.grad for x in leaves], out


@pytest.mark.gpu
@pytest.mark.parametrize("scene", ["make_scene", "make_scene_sh", "wall", "boundary"])
def test_render_gradients_on_card_match_oracle_and_cpu(scene):
    _need_card()
    sc, kw = make_scene(150) if scene == "make_scene" else SCENES[scene]()
    before = tiles_packed.BACKWARD_KERNEL.launches
    g_card, _ = render_grads(rasterizer.render, sc, kw, "cuda", fast_grad=False)
    assert tiles_packed.BACKWARD_KERNEL.launches == before + 1
    g_cpu, _ = render_grads(rasterizer.render, sc, kw, "cpu", fast_grad=False)
    for name, a, b in zip(("means", "cov", "opacity", "extrinsic", "colors"), g_card, g_cpu):
        assert_normalized(a, b, GRAD_TOL, f"{name} vs CPU path")
    if scene != "boundary":  # the oracle walks every gaussian per pixel
        g_oracle, _ = render_grads(oracle.render_oracle, sc, kw, "cuda")
        for name, a, b in zip(("means", "cov", "opacity", "extrinsic", "colors"), g_card, g_oracle):
            assert_normalized(a, b, GRAD_TOL, f"{name} vs oracle")


@pytest.mark.gpu
@pytest.mark.parametrize("scene", ["make_scene", "wall"])
def test_inference_render_gradients_on_card(scene):
    """A packed render binned with inference=True (no perm) takes its
    gradients on the card by the pre-sort slot keys: they match the
    training binning's and the CPU path's at the exact-mode bar."""
    _need_card()
    sc, kw = make_scene(150) if scene == "make_scene" else SCENES[scene]()
    g_inf, _ = render_grads(rasterizer.render, sc, kw, "cuda", fast_grad=False, inference=True)
    g_train, _ = render_grads(rasterizer.render, sc, kw, "cuda", fast_grad=False)
    g_cpu, _ = render_grads(rasterizer.render, sc, kw, "cpu", fast_grad=False, inference=True)
    for name, a, b, c in zip(("means", "cov", "opacity", "extrinsic", "colors"), g_inf, g_train, g_cpu):
        assert_normalized(a, b, GRAD_TOL, f"{name} vs the training binning")
        assert_normalized(a, c, GRAD_TOL, f"{name} vs CPU path")


@pytest.mark.gpu
@pytest.mark.parametrize("scene", ["make_scene", "wall", "boundary"])
def test_per_tile_render_gradients_on_card_match_oracle_and_cpu(scene):
    """packed=False on the card: K3 and K4 launch once each, and the
    gradients match the CPU path and the oracle."""
    _need_card()
    sc, kw = make_scene(150) if scene == "make_scene" else SCENES[scene]()
    before = (tiles.FORWARD_KERNEL.launches, tiles.BACKWARD_KERNEL.launches)
    g_card, _ = render_grads(rasterizer.render, sc, kw, "cuda", fast_grad=False, packed=False)
    assert (tiles.FORWARD_KERNEL.launches, tiles.BACKWARD_KERNEL.launches) == (before[0] + 1, before[1] + 1)
    g_cpu, _ = render_grads(rasterizer.render, sc, kw, "cpu", fast_grad=False, packed=False)
    for name, a, b in zip(("means", "cov", "opacity", "extrinsic", "colors"), g_card, g_cpu):
        assert_normalized(a, b, GRAD_TOL, f"{name} vs CPU path")
    if scene != "boundary":  # the oracle walks every gaussian per pixel
        g_oracle, _ = render_grads(oracle.render_oracle, sc, kw, "cuda")
        for name, a, b in zip(("means", "cov", "opacity", "extrinsic", "colors"), g_card, g_oracle):
            assert_normalized(a, b, GRAD_TOL, f"{name} vs oracle")


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [None, 0])
def test_dma_probe_kernels_match_plain(seed):
    """P1-P3 on the card at the tool's shapes, on its own inputs (seed
    None: arange, arange, ones) and on seeded ones: P1 and P2 bitwise, P3's
    output and chunk sums within rtol 1e-6 (values in [0.5, 1.5), so no
    cancellation), both transpose variants."""
    _need_card()
    rng = np.random.default_rng(seed)

    def make(shape, default):
        x = default(shape) if seed is None else rng.uniform(0.5, 1.5, size=shape).astype(np.float32)
        return torch.as_tensor(x, dtype=torch.float32).cuda()

    arange = lambda shape: np.arange(np.prod(shape), dtype=np.float32).reshape(shape)
    x1 = make((tprobe.P1_CAP, 16), arange)
    x2 = make((tprobe.P2_TILES, 8, 512), arange)
    x3 = make((16, tprobe.P3_CHUNKS * tprobe.CHUNK), np.ones)
    before = {k.name: k.launches for k in (tprobe.PROBE1_KERNEL, tprobe.PROBE2_KERNEL, tprobe.PROBE3_KERNEL)}
    assert torch.equal(tprobe.scale_chunks(x1).cpu(), tprobe.probe1_plain(x1.cpu()))
    assert torch.equal(tprobe.add_blocks(x2).cpu(), tprobe.probe2_plain(x2.cpu()))
    for do_t in (False, True):
        out, sums = tprobe.chunk_sums(x3, do_t)
        ref_out, ref_sums = tprobe.probe3_plain(x3.cpu(), do_t)
        torch.testing.assert_close(out.cpu(), ref_out, rtol=tprobe.P3_RTOL, atol=0)
        torch.testing.assert_close(sums.cpu(), ref_sums, rtol=tprobe.P3_RTOL, atol=0)
        if seed is None:
            assert bool((out == 256.0).all())
    after = {k.name: k.launches for k in (tprobe.PROBE1_KERNEL, tprobe.PROBE2_KERNEL, tprobe.PROBE3_KERNEL)}
    assert {k: after[k] - before[k] for k in after} == {"dma_probe1": 1, "dma_probe2": 1, "dma_probe3": 2}


@pytest.mark.gpu
def test_dma_probe_entry_point_on_card(capsys):
    _need_card()
    assert tprobe.main() == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 3 and lines[0].endswith("-> ok") and "transpose cost" in lines[2]


@pytest.mark.gpu
def test_ssim_gradient_on_card_is_fp32():
    """The SSIM gradient at 1080p on the card against a float64 CPU
    gradient: the depthwise convolution's backward must not run in TF32.
    Full fp32 itself errs by up to 4.7e-6 of max|grad| on this input (the
    same comparison in fp32 on the CPU), so the bar is 2e-5; TF32 keeps 10
    mantissa bits and misses it by orders of magnitude."""
    _need_card()
    rng = np.random.default_rng(0)
    a = rng.random(size=(3, 1080, 1920)).astype(np.float32)
    b = np.clip(a + rng.normal(size=a.shape) * 0.05, 0, 1).astype(np.float32)

    def grad(x, y, device, dtype):
        x = torch.tensor(x, device=device, dtype=dtype, requires_grad=True)
        losses.ssim(x, torch.tensor(y, device=device, dtype=dtype)).backward()
        return x.grad

    assert_normalized(grad(a, b, "cuda", torch.float32), grad(a, b, "cpu", torch.float64), 2e-5, "ssim grad", floor=0.0)


# ------------------------------------------------ compression, indexed scenes
def compressed_toy(device, n=400):
    """A quantized 400-splat scene with SH degree 3 and varied shapes, two
    64x64 views whose images are the renders of a copy with opacity
    logits + 1 (so the photometric gradients are not zero), and the scene
    compressed with 64-row codebooks and 8 k-means steps."""
    rng = np.random.default_rng(3)
    pts = rng.normal(size=(n, 3)).astype(np.float32) * 0.6
    pts[:, 2] += 3.5
    scene = gaussians.from_point_cloud(pts, rng.random(size=(n, 3)).astype(np.float32), capacity=n,
                                       quantization=True, device=device)
    with torch.no_grad():
        scene.features_rest.copy_(torch.as_tensor(rng.normal(size=(n, 15, 3)) * 0.1, dtype=torch.float32))
        scene.rotation.copy_(torch.as_tensor(rng.normal(size=(n, 4)), dtype=torch.float32))
        scene.scaling.copy_(torch.as_tensor(np.abs(rng.normal(size=(n, 3))) + 0.1, dtype=torch.float32))
    scene.active_sh_degree = 3
    scene.update_observers()
    intrinsic = np.array([[1.0, 0, 64], [0, 1.0, 64], [0, 0, 1]])
    cams = []
    for ev in (EV, np.array([0, 0.06, 0, 0.998, 0.2, 0, 0], np.float32)):
        target = scene.clone()
        with torch.no_grad():
            target.opacity += 1.0
            img = trainer.render_scene(target, ev, settings_from_intrinsic(intrinsic), np.zeros(3),
                                       device=device)["render"]
        cams.append(SimpleNamespace(extrinsic_vector=ev, intrinsic=intrinsic, original_image=img))
    comp = dataclasses.replace(
        CompressionParams(), color_codebook_size=64, gaussian_codebook_size=64, color_cluster_iterations=8,
        gaussian_cluster_iterations=8, color_batch_size=128, gaussian_batch_size=128,
    )
    return scene, cams, pipeline.to_compressed(scene, cams, comp, silent=True, device=device)


def test_compressed_toy_builds_on_cpu():
    """The card tests' compressed scene, built here through the CPU route."""
    scene, cams, comp = compressed_toy("cpu")
    comp.check_state()
    assert comp.is_color_indexed and comp.is_gaussian_indexed
    assert comp.features_dc.shape[0] < comp.capacity and comp.scaling.shape[0] < comp.capacity
    with torch.no_grad():
        img, ref = (trainer.render_scene(s, EV, settings_from_intrinsic(cams[0].intrinsic), np.zeros(3),
                                         device="cpu")["render"] for s in (comp, scene))
    assert float(losses.psnr(img, ref)[0, 0]) > 20


@pytest.mark.gpu
def test_indexed_render_on_card_matches_cpu():
    """An indexed scene on the card (compressed on the CPU, then moved):
    image at atol 2e-5 / rtol 1e-4 and codebook-table gradients at
    normalized 5e-4 (exact mode) against the CPU path; the blocked-colors
    branch and the serving (inference) render give the same image."""
    _need_card()
    _, cams, comp = compressed_toy("cpu")
    card = copy.deepcopy(comp).to("cuda")
    settings = dataclasses.replace(settings_from_intrinsic(cams[1].intrinsic), fast_grad=False)
    tables = ("features_dc", "features_rest", "scaling", "rotation")
    out = {}
    for dev, sc in (("cpu", comp), ("cuda", card)):
        o = trainer.render_scene(sc, cams[1].extrinsic_vector, settings, np.zeros(3), device=dev)
        gt = torch.as_tensor(cams[1].original_image, device=dev)
        grads = torch.autograd.grad(losses.photometric_loss(o["render"], gt), [getattr(sc, k) for k in tables])
        out[dev] = (o["render"].detach(), grads)
    torch.testing.assert_close(out["cuda"][0].cpu(), out["cpu"][0], **IMG_TOL)
    for name, a, b in zip(tables, out["cuda"][1], out["cpu"][1]):
        assert_normalized(a, b, GRAD_TOL, name)
    with torch.no_grad():
        for s, blocked in ((settings, True), (dataclasses.replace(settings, inference=True), None)):
            o = trainer.render_scene(card, cams[1].extrinsic_vector, s, np.zeros(3), blocked_colors=blocked,
                                     device="cuda")
            torch.testing.assert_close(o["render"].cpu(), out["cpu"][0], **IMG_TOL)


@pytest.mark.gpu
def test_blocked_colors_engage_past_2_20_on_card(monkeypatch):
    """A codebook-indexed scene of 2^20 + 1 splats on the card: render_scene
    evaluates its colors block by block on its own (BLOCKED_COLORS_MIN),
    and the image equals the dense gather's at atol 2e-5 / rtol 1e-4."""
    _need_card()
    n = trainer.BLOCKED_COLORS_MIN + 1
    rng = np.random.default_rng(5)
    pts = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n), rng.uniform(4, 8, n)], 1).astype(np.float32)
    scene = gaussians.from_point_cloud(pts, rng.random((n, 3)).astype(np.float32), quantization=False, device="cuda")
    codebook = rng.normal(size=(256, 16, 3)).astype(np.float32) * 0.3
    scene = scene.set_color_indexed(codebook, torch.as_tensor(rng.integers(0, 256, n), device="cuda"))
    scene.active_sh_degree = 3
    calls = []
    real = trainer.sh_ops.sh_to_rgb_indexed_blocked
    monkeypatch.setattr(trainer.sh_ops, "sh_to_rgb_indexed_blocked", lambda *a, **k: calls.append(1) or real(*a, **k))
    settings = RasterSettings(width=256, height=192, tanfovx=math.tan(0.5), tanfovy=math.tan(0.4), sh_degree=3)
    with torch.no_grad():
        auto, dense = (trainer.render_scene(scene, EV, settings, np.zeros(3), blocked_colors=b, device="cuda")
                       for b in (None, False))
    assert len(calls) == 1 and int(auto["overflow"]) == 0 and int(auto["num_instances"]) > n // 2
    torch.testing.assert_close(auto["render"], dense["render"], **IMG_TOL)


@pytest.mark.gpu
def test_vq_and_codebook_gradients_repeat_bitwise_on_card():
    """The color VQ from one seed twice, and the gradient of a 4096-row
    table read by 2^20 rows twice: the same bits. nearest_codebook in full
    fp32 even when the caller allows TF32: min distances at atol 5e-3 of a
    float64 reference, where a TF32 product errs by more than 5e-2."""
    _need_card()
    rng = np.random.default_rng(0)
    feats = torch.as_tensor(rng.normal(size=(50_000, 48)), dtype=torch.float32, device="cuda")
    imp = torch.as_tensor(rng.random(50_000) ** 3, dtype=torch.float32, device="cuda")
    runs = [vq.vq_features(feats, imp, 4096, 1 << 14, steps=20) for _ in range(2)]
    assert torch.equal(runs[0][0], runs[1][0]) and torch.equal(runs[0][1], runs[1][1])
    assert int(torch.unique(runs[0][1]).numel()) > 1000
    idx = torch.as_tensor(rng.integers(0, 4096, 1 << 20), device="cuda")
    g = torch.as_tensor(rng.normal(size=(1 << 20, 16, 3)), dtype=torch.float32, device="cuda")
    grads = []
    for _ in range(2):
        table = torch.zeros((4096, 16, 3), device="cuda", requires_grad=True)
        (segment.gather_rows(table, idx) * g).sum().backward()
        grads.append(table.grad)
    assert torch.equal(grads[0], grads[1])
    ref = torch.zeros((4096, 16, 3), dtype=torch.float64).index_add_(0, idx.cpu(), g.cpu().double())
    assert_normalized(grads[0], ref, 1e-6, "gather gradient", floor=0.0)
    cb = torch.as_tensor(rng.normal(size=(4096, 48)) * 3, dtype=torch.float32, device="cuda")
    x = cb[torch.as_tensor(rng.integers(0, 4096, 20_000), device="cuda")] + 0.3 * torch.randn(
        20_000, 48, device="cuda", generator=torch.Generator("cuda").manual_seed(0))
    prev = torch.backends.cuda.matmul.fp32_precision
    torch.backends.cuda.matmul.fp32_precision = "tf32"
    try:
        d, i = vq.nearest_codebook(x, cb)
        cross_tf32 = (x @ cb.T).double().cpu()  # what the caller's setting gives a plain matmul
    finally:
        torch.backends.cuda.matmul.fp32_precision = prev
    dist = torch.cdist(x.double().cpu(), cb.double().cpu()) ** 2
    assert torch.equal(i.cpu(), dist.argmin(1))
    # |x|^2 and 2 x.c are ~900 here: fp32 cancellation errs by ~5e-4, TF32
    # (10-bit mantissa) by ~0.1
    torch.testing.assert_close(d.double().cpu(), dist.min(1).values, rtol=0, atol=5e-3)
    assert float((cross_tf32 - x.double().cpu() @ cb.double().cpu().T).abs().max()) > 5e-2


@pytest.mark.gpu
def test_finetune_two_steps_on_card_without_overflow():
    """to_compressed and two finetune steps on the card: one K2 launch per
    sensitivity view, K1 + K2 per step (plus the probe's K1), overflow 0,
    finite losses, and the caller's scene unchanged bit for bit."""
    _need_card()
    kernels.reset_counts()
    _, cams, comp = compressed_toy("cuda")
    torch.cuda.synchronize()
    assert tiles_packed.BACKWARD_KERNEL.launches == 2 and tiles_packed.FORWARD_KERNEL.launches == 2 + 2
    before = {k: v.clone() for k, v in comp.state_dict().items()}
    kernels.reset_counts()
    hist = []
    out = finetune.finetune(comp, cams, OptimizationParams(), 2, log_every=0, history=hist, device="cuda")
    torch.cuda.synchronize()
    assert (tiles_packed.FORWARD_KERNEL.launches, tiles_packed.BACKWARD_KERNEL.launches) == (3, 2)
    assert all(h["overflow"] == 0 and h["grad_overflow"] == 0 and math.isfinite(h["loss"]) for h in hist)
    assert all(torch.equal(before[k], v) for k, v in comp.state_dict().items())
    assert not torch.equal(out.features_dc, comp.features_dc)


@pytest.mark.gpu
def test_extract_rot_scale_on_card_past_one_eigh_batch():
    """40,000 covariances (cuSOLVER's batched eigh refuses 32,768 at once):
    the covariance rebuilt from the card's (rotation, scale) against the
    input at atol 1e-5 / rtol 1e-5."""
    _need_card()
    rng = np.random.default_rng(1)
    q = torch.as_tensor(rng.normal(size=(40_000, 4)), dtype=torch.float32)
    s = torch.as_tensor(np.abs(rng.normal(size=(40_000, 3))) + 0.05, dtype=torch.float32)
    cov = quat.build_covariance(s, q)
    r, sc = quat.extract_rot_scale(cov.cuda())
    torch.testing.assert_close(quat.build_covariance(sc, r).cpu(), cov, atol=1e-5, rtol=1e-5)


@pytest.mark.gpu
def test_train_cli_on_card_matches_cpu(tmp_path):
    """The train CLI on a 32-px folder from tools/datasets.py, 1 epoch with
    --data_device cuda and with --data_device cpu under one seed of
    Python's `random`: the same steps and active rows, ema_loss at the
    train bar (rtol 1e-5), one K1 and one K2 launch a step, and the saved
    .ply at tests/ply_bars.py's bar: every entry within the steps times
    its field's learning rate, at most 1% of them beyond 1e-5."""
    import json
    import random

    from ply_bars import assert_trained_plys_close

    from c3dgs_tpu_torch.cli import train as train_cli
    from c3dgs_tpu_torch.models import io_ply
    from c3dgs_tpu_torch.tools import datasets

    _need_card()
    ds = str(tmp_path / "ds")
    datasets.write_blender_dataset(ds, res=32, num_train=12, num_test=2, device="cpu")
    logs, plys = {}, {}
    for dev in ("cpu", "cuda"):
        out = str(tmp_path / dev)
        kernels.reset_counts()
        random.seed(0)
        train_cli.main(["-s", ds, "-m", out, "--epochs", "1", "--data_device", dev])
        torch.cuda.synchronize()
        logs[dev] = [json.loads(line) for line in open(f"{out}/train_log.jsonl")]
        steps = logs[dev][-1]["it"]
        plys[dev] = io_ply.read_vertices(f"{out}/point_cloud/iteration_{steps}/point_cloud.ply")
        launches = (tiles_packed.FORWARD_KERNEL.launches, tiles_packed.BACKWARD_KERNEL.launches)
        assert launches == ((steps, steps) if dev == "cuda" else (0, 0)), (dev, launches)
    (a,), (b,) = logs["cuda"], logs["cpu"]
    assert (a["it"], a["active"]) == (b["it"], b["active"]) == (2, 400)
    np.testing.assert_allclose(a["ema_loss"], b["ema_loss"], rtol=1e-5)
    assert_trained_plys_close(plys["cuda"], plys["cpu"], steps=2)


def pose_scene(device):
    """tests/test_camera_opt.py::test_pose_recovery's scene (150 splats
    around z = 3, 48x48, SH degree 0), its render at the identity as the
    target, and the perturbed start."""
    rng = np.random.default_rng(1)
    pts = rng.normal(size=(150, 3)).astype(np.float32) * 0.6
    pts[:, 2] += 3.0
    scene = gaussians.from_point_cloud(pts, rng.random(size=(150, 3)).astype(np.float32), capacity=150,
                                       quantization=False, device=device)
    settings = RasterSettings(width=48, height=48, tanfovx=math.tan(0.5), tanfovy=math.tan(0.5), sh_degree=0)
    with torch.no_grad():
        gt = trainer.render_scene(scene, EV, settings, np.zeros(3), device=device)["render"].clone()
    ev0 = EV + np.array([0.01, -0.01, 0.005, 0, 0.05, -0.04, 0.02], np.float32)
    return scene, settings, gt, ev0


@pytest.mark.gpu
def test_pose_gradient_and_camera_step_on_card_match_cpu():
    """The pose loss (anchored at the start, weight 0.5) on the card
    against the CPU path: the loss at atol 1e-6, the pose gradient at
    normalized 5e-4, one K1 and one K2 launch and no gradient in the
    scene; then one camera_step each: ev within 1e-5."""
    from c3dgs_tpu_torch.train import camera_opt

    _need_card()
    got = {}
    for dev in ("cpu", "cuda"):
        scene, settings, gt, ev0 = pose_scene(dev)
        ev = torch.as_tensor(ev0, device=dev)
        bg = torch.zeros(3, device=dev)
        kernels.reset_counts()
        loss, grad, out = camera_opt.pose_loss_and_grad(scene, ev, gt, settings, bg, ev.clone(), 0.5)
        launches = (tiles_packed.FORWARD_KERNEL.launches, tiles_packed.BACKWARD_KERNEL.launches)
        assert launches == ((1, 1) if dev == "cuda" else (0, 0)), (dev, launches)
        assert int(out["overflow"]) == 0 and scene.xyz.grad is None
        state = trainer.adam_init({"ev": ev})
        ev, state, _ = camera_opt.camera_step(scene, ev, state, gt, settings, bg, 3e-3, torch.as_tensor(ev0, device=dev),
                                              0.5)
        got[dev] = (float(loss), grad.cpu(), ev.cpu())
    np.testing.assert_allclose(got["cuda"][0], got["cpu"][0], atol=1e-6, rtol=0)
    assert_normalized(got["cuda"][1], got["cpu"][1], GRAD_TOL, "pose gradient")
    torch.testing.assert_close(got["cuda"][2], got["cpu"][2], atol=1e-5, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("net_type", ["vgg", "alex"])
def test_lpips_on_card_matches_cpu(net_type, tmp_path):
    """LPIPS on seeded random weights (tools/scenes.py, tests/test_lpips.py's
    recipe) at 3x256x192 on the card and on the CPU, rtol 1e-4: the
    convolutions run in IEEE fp32 on the card, and the global cuDNN
    setting is left as it was."""
    from c3dgs_tpu_torch.eval import lpips

    _need_card()
    rng = np.random.default_rng(0)
    path = str(tmp_path / f"lpips_{net_type}.npz")
    np.savez(path, **scenes.lpips_random_weights(net_type, rng))
    x = rng.random(size=(3, 192, 256)).astype(np.float32)
    y = np.clip(x + rng.normal(size=x.shape).astype(np.float32) * 0.1, 0, 1).astype(np.float32)
    before = torch.backends.cudnn.conv.fp32_precision
    card = float(lpips.LPIPS(path, net_type, device="cuda")(x, y))
    assert torch.backends.cudnn.conv.fp32_precision == before
    ref = float(lpips.LPIPS(path, net_type, device="cpu")(x, y))
    assert ref > 1e-6
    np.testing.assert_allclose(card, ref, rtol=1e-4)


@pytest.mark.gpu
def test_knn_indices_on_card_match_cpu():
    """densify_initial's kNN on 20,000 points of the bench cloud's shape:
    the same indices on the card and on the CPU (cuBLAS's matmul picked
    other neighbours in 4 rows of 20,000)."""
    from c3dgs_tpu_torch.train import densify_initial

    _need_card()
    pts = np.random.default_rng(1).normal(size=(20_000, 3)).astype(np.float32) * 2.0
    pts[:, 2] += 6.0
    card, cpu = (densify_initial._knn_indices(pts, 3, device=dev) for dev in ("cuda", "cpu"))
    np.testing.assert_array_equal(card, cpu)
