"""Parity of the port's serving render path (c3dgs_tpu_torch.render) with
c3dgs_tpu on the CPU: the same seeded numpy inputs go through both
packages. Preprocess floats at atol/rtol 1e-5 with integers exact; binning,
the per-gaussian table and the staged fields exact; K1's plain version
against the JAX kernel in interpret mode (rows 0-4 at atol 2e-5 / rtol
1e-4, freeze slots exact); the full render at the reference's own image
bar (tests/test_render.py:113, atol 2e-5 / rtol 1e-4) against both JAX and
the port's oracle. The scenes, and the card-only tests of the CUDA kernel,
live in the JAX-free tests/test_torch_gpu.py."""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from c3dgs_tpu.render import binning as jbinning
from c3dgs_tpu.render import rasterizer as jrast
from c3dgs_tpu.render.preprocess import preprocess as jpreprocess
from c3dgs_tpu.render.types import RasterSettings as JSettings
from c3dgs_tpu_torch import kernels
from c3dgs_tpu_torch.render import binning as tbinning
from c3dgs_tpu_torch.render import oracle as toracle
from c3dgs_tpu_torch.render import rasterizer as trast
from c3dgs_tpu_torch.render import tiles_packed as ttiles
from c3dgs_tpu_torch.render.tiles import PIX
from c3dgs_tpu_torch.render.preprocess import Preprocessed as TPrep
from c3dgs_tpu_torch.render.preprocess import preprocess as tpreprocess
from c3dgs_tpu_torch.render.types import RasterSettings as TSettings
from test_torch_gpu import EV, SCENES, make_scene
import torch_cpu  # noqa: F401,E402  (one torch thread per test worker)

IMG_TOL = dict(atol=2e-5, rtol=1e-4)  # tests/test_render.py:113
K1_TOL = dict(atol=2e-5, rtol=1e-4)


def _j(x):
    return None if x is None else jnp.asarray(x)


def _t(x):
    return None if x is None else torch.as_tensor(np.array(x))


# the JAX side runs jitted: one XLA compile per scene shape instead of one
# per eager op
_jit_prep = jax.jit(jpreprocess, static_argnums=(4,))
_jit_bin = jax.jit(jbinning.bin_gaussians, static_argnums=(1,))
_jit_render = jax.jit(jrast.render, static_argnums=(4,))


def jax_prep(sc, js):
    return _jit_prep(
        _j(sc["means"]), _j(sc["cov"]), _j(sc["op"]), _j(EV), js, _j(sc["shs"]), _j(sc["colors"])
    )


def as_torch_prep(prep):
    return TPrep(*(_t(np.asarray(x)) for x in prep))


@jax.jit(static_argnums=(1,))
def _jit_stage(prep, js):
    b = jbinning.bin_gaussians(prep, js)
    table = jbinning.per_gaussian_table(prep, b.offset)
    n = prep.depth.shape[0]
    cap, _ = js.resolve_caps(n)
    exec_cap = js.resolve_grad_cap(n)
    nc = exec_cap // 128
    t = js.num_tiles
    fields = jrast._build_fields_packed(
        table, b.gid_sorted[:exec_cap], b.tid_sorted[:exec_cap], b.sent_sorted[:exec_cap],
        b.j_sorted[:exec_cap], js.tiles_x, t, cap,
    )
    meta = jnp.stack([jnp.minimum(b.chunks_exec, nc), 0, t, cap]).astype(jnp.int32)
    return fields, b.tile_lo[: nc + 1], meta, b


def staged(sc, kw, **over):
    """The JAX stages up to K1's inputs: (settings, fields, tile_lo, meta,
    Binning)."""
    js = JSettings(**kw, **over)
    return (js, *_jit_stage(jax_prep(sc, js), js))


# ------------------------------------------------------------- preprocess
@pytest.mark.parametrize("scene", ["make_scene", "make_scene_sh", "boundary"])
def test_preprocess_matches_jax(scene):
    sc, kw = SCENES[scene]()
    pj = jax_prep(sc, JSettings(**kw))
    pt = tpreprocess(
        _t(sc["means"]), _t(sc["cov"]), _t(sc["op"]), _t(EV), TSettings(**kw), _t(sc["shs"]), _t(sc["colors"])
    )
    for name in pj._fields:
        a, b = np.asarray(getattr(pj, name)), getattr(pt, name).numpy()
        assert a.shape == b.shape, name
        if np.issubdtype(a.dtype, np.integer):
            np.testing.assert_array_equal(b, a, err_msg=name)
        else:
            np.testing.assert_allclose(b, a, atol=1e-5, rtol=1e-5, err_msg=name)


# --------------------------------------------------------------- binning
# (scene, inference, packed); the packed=False cases size the per-tile
# grad buffer, the one Binning field that depends on `packed`
_BINNING_CASES = [
    pytest.param(scene, inference, packed, id=f"{scene}-{inference}" + ("" if packed else "-per_tile"))
    for packed in (True, False)
    for inference in (True, False)
    for scene in ("make_scene", "wall", "boundary")
]


@pytest.mark.parametrize("scene,inference,packed", _BINNING_CASES)
def test_binning_matches_jax_exactly(scene, inference, packed):
    """Fed the JAX Preprocessed, every Binning field is equal. The port's
    inference branch carries no perm (its forward-only graph never reads
    it, as XLA drops it from the JAX graph)."""
    sc, kw = SCENES[scene]()
    js = JSettings(**kw, inference=inference, packed=packed)
    prep = jax_prep(sc, js)
    bj = _jit_bin(prep, js)
    bt = tbinning.bin_gaussians(as_torch_prep(prep), TSettings(**kw, inference=inference, packed=packed))
    for name in bj._fields:
        b = getattr(bt, name)
        if name == "perm" and inference:
            assert b is None
            continue
        a = np.asarray(getattr(bj, name))
        assert b.shape == a.shape, name
        np.testing.assert_array_equal(b.numpy().astype(a.dtype), a, err_msg=name)
    # the training branch reads ends out of the perm sort; same values
    if not inference:
        bi = tbinning.bin_gaussians(as_torch_prep(prep), TSettings(**kw, inference=True))
        assert torch.equal(bi.ends, bt.ends) and torch.equal(bi.starts, bt.starts)


def test_binning_overflow_counted_like_jax():
    """An undersized slot domain: the overflow and the tile ranges read
    from a partial sentinel set still match the JAX Binning."""
    sc, kw = make_scene(300)
    for inference in (True, False):
        js = JSettings(**kw, instance_capacity=256, inference=inference)
        prep = jax_prep(sc, js)
        bj = _jit_bin(prep, js)
        bt = tbinning.bin_gaussians(as_torch_prep(prep), TSettings(**kw, instance_capacity=256, inference=inference))
        assert int(bj.overflow) > 0
        for name in ("overflow", "ends", "starts", "tile_lo", "chunks_exec", "gid_sorted", "tid_sorted"):
            np.testing.assert_array_equal(getattr(bt, name).numpy(), np.asarray(getattr(bj, name)), err_msg=name)


@pytest.mark.parametrize("inference", [False, True])
def test_binning_keeps_every_tile_of_a_splat_at_5m_gaussians(inference):
    """Two splats that cover all 4,080 tiles of a 1920x1080 frame among 5M
    gaussians: every tile holds both, front one first, each splat's j runs
    over all its tiles, and nothing is clipped. (The JAX payload gid <<
    j_bits | j leaves 8 bits for j at 5M gaussians and clips each splat at
    256 tiles; the port's payload is the emission slot.)"""
    n, (w, h) = 5_000_000, (1920, 1080)
    settings = TSettings(width=w, height=h, tanfovx=0.7, tanfovy=0.4, sh_degree=0, instance_capacity=16384,
                         inference=inference)
    tx, ty = settings.tiles_x, settings.tiles_y
    big = torch.tensor([7, n - 1])
    z = lambda *shape, dtype=torch.float32: torch.zeros(*shape, dtype=dtype)
    prep = TPrep(mean2d=z(n, 2), depth=torch.full((n,), 5.0), conic=z(n, 3), color=z(n, 3), opacity=z(n),
                 radius=z(n, dtype=torch.int32), tiles_touched=z(n, dtype=torch.int32),
                 rect_min=z(n, 2, dtype=torch.int32), rect_max=z(n, 2, dtype=torch.int32))
    prep.mean2d[big] = torch.tensor([w / 2, h / 2])
    prep.conic[big] = torch.tensor([1e-7, 0.0, 1e-7])
    prep.opacity[big] = 0.9
    prep.depth[big] = torch.tensor([2.0, 1.0])
    prep.radius[big] = 5000
    prep.tiles_touched[big] = tx * ty
    prep.rect_max[big] = torch.tensor([tx, ty], dtype=torch.int32)
    b = tbinning.bin_gaussians(prep, settings)
    assert int(b.clipped) == 0 and int(b.overflow) == 0 and int(b.num_instances) == 2 * tx * ty
    assert torch.equal(b.ends - b.starts, torch.full((tx * ty,), 2, dtype=torch.int32))
    first, second = b.gid_sorted[b.starts.long()], b.gid_sorted[b.starts.long() + 1]
    assert torch.all(first == n - 1) and torch.all(second == 7)
    for g in (7, n - 1):
        js = b.j_sorted[(b.gid_sorted == g) & ~b.sent_sorted]
        assert torch.equal(torch.sort(js).values, torch.arange(tx * ty, dtype=torch.int32))


def test_binning_orders_a_quantized_depth_tie_by_float_depth():
    """At 1920x1080 the key keeps 19 depth bits: over depths 5-20 two splats
    1e-5 apart share a level. The port blends the nearer first, as the
    reference's float depth order does (JAX: by gaussian index, the
    farther first here); the oracle agrees."""
    n, (w, h) = 3, (1920, 1080)
    settings = TSettings(width=w, height=h, tanfovx=0.7, tanfovy=0.4, sh_degree=0, instance_capacity=8192)
    f = lambda *rows: torch.tensor(rows, dtype=torch.float32)
    i = lambda *rows: torch.tensor(rows, dtype=torch.int32)
    prep = TPrep(mean2d=f([16.0, 8.0], [16.0, 8.0], [1500.0, 900.0]), depth=f(5.0 + 1e-5, 5.0, 20.0),
                 conic=f([0.01, 0.0, 0.01], [0.01, 0.0, 0.01], [0.01, 0.0, 0.01]),
                 color=f([1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]), opacity=f(0.5, 0.5, 0.5),
                 radius=i(20, 20, 20), tiles_touched=i(1, 1, 1), rect_min=i([0, 0], [0, 0], [46, 56]),
                 rect_max=i([1, 1], [1, 1], [47, 57]))
    q = tbinning.quantize_depth(prep.depth, prep.radius > 0, settings.num_tiles)
    assert q[0] == q[1] and prep.depth[0] > prep.depth[1]
    b = tbinning.bin_gaussians(prep, settings)
    assert b.gid_sorted[: int(b.ends[0])].tolist() == [1, 0]
    color, _ = toracle.blend_oracle(prep, settings)
    # the nearer (green) splat lies in front: more green than red
    assert float(color[1, 8, 16]) > float(color[0, 8, 16]) > 0


@pytest.mark.parametrize("scene", ["make_scene_sh", "boundary"])
def test_table_and_staged_fields_match_jax_exactly(scene):
    sc, kw = SCENES[scene]()
    js, fields, tile_lo, meta, b = staged(sc, kw)
    prep = jax_prep(sc, js)
    tp = as_torch_prep(prep)
    table_t = tbinning.per_gaussian_table(tp, _t(np.asarray(b.offset)))
    table_j = np.asarray(jbinning.per_gaussian_table(prep, b.offset))
    np.testing.assert_array_equal(table_t.numpy(), table_j)
    cap = int(meta[3])
    fields_t = trast._build_fields_packed(
        table_t, _t(np.asarray(b.gid_sorted)), _t(np.asarray(b.tid_sorted)),
        _t(np.asarray(b.sent_sorted)), _t(np.asarray(b.j_sorted)), js.tiles_x, js.num_tiles, cap,
    )
    np.testing.assert_array_equal(fields_t.numpy(), np.asarray(fields))


# --------------------------------------------------------------------- K1
def k1_args(fields, tile_lo, meta, b):
    return (_t(np.asarray(fields)), _t(np.asarray(tile_lo)), _t(np.asarray(meta)),
            _t(np.asarray(b.starts)), _t(np.asarray(b.ends)))


@pytest.mark.parametrize("scene", ["make_scene", "make_scene_sh", "occluder", "wall", "boundary"])
def test_k1_plain_matches_jax_kernel(scene):
    """forward_plain against the Pallas kernel (interpret mode) on
    identical staged fields, over every flushed tile."""
    sc, kw = SCENES[scene]()
    js, fields, tile_lo, meta, b = staged(sc, kw)
    out_j = np.asarray(jrast._blend_forward_call_packed(js.num_tiles, fields.shape[1], fields, tile_lo, meta))
    out_t = ttiles.forward(*k1_args(fields, tile_lo, meta, b)).numpy()
    assert out_t.shape == out_j.shape == (js.num_tiles, 8, PIX)
    np.testing.assert_allclose(out_t[:, :5], out_j[:, :5], **K1_TOL)
    np.testing.assert_array_equal(out_t[:, 5:], out_j[:, 5:])
    cap = int(meta[3])
    frozen = int((out_t[:, 5, 0] < cap).sum())
    if scene == "wall":
        assert frozen >= 2  # the freeze really happens here
    if scene == "occluder":
        # tests/test_render.py:159 means to freeze a chunk, but its wall
        # leaves uncovered pixels in every tile: no tile freezes
        assert frozen == 0
    if scene == "boundary":
        ends = np.asarray(b.ends)
        assert ((ends % 128 == 0) & (ends > 0)).any()


def test_k1_plain_exec_clamped_frame_matches_jax():
    """A too-tight execution bucket (tests/test_render.py:472): tiles past
    the clamp stay unflushed; the flushed ones match the JAX kernel."""
    sc, kw = make_scene(300)
    full = dict(instance_capacity=1 << 13)
    _, _, _, _, b = staged(sc, kw, **full)
    need = int(b.chunks_exec) * 128
    js, fields, tile_lo, meta, b = staged(sc, kw, **full, grad_capacity=max(need - 512, 128))
    assert int(meta[0]) < int(b.chunks_exec)
    out_j = np.asarray(jrast._blend_forward_call_packed(js.num_tiles, fields.shape[1], fields, tile_lo, meta))
    out_t = ttiles.forward_plain(*k1_args(fields, tile_lo, meta, b)).numpy()
    flushed = np.asarray(b.ends) < int(meta[0]) * 128
    assert 0 < flushed.sum() < js.num_tiles
    np.testing.assert_allclose(out_t[flushed, :5], out_j[flushed, :5], **K1_TOL)
    np.testing.assert_array_equal(out_t[flushed, 5:], out_j[flushed, 5:])


def test_k1_wrapper_checks_and_cpu_route():
    sc, kw = make_scene(300)
    js, fields, tile_lo, meta, b = staged(sc, kw)
    args = list(k1_args(fields, tile_lo, meta, b))
    before = ttiles.FORWARD_KERNEL.launches
    out = ttiles.forward(*args)
    assert ttiles.FORWARD_KERNEL.launches == before  # CPU tensors: plain version
    assert torch.equal(out, ttiles.forward_plain(*args))
    # the tile-range mode on the same call: block i is global tile 1 + i,
    # the block past tile_end stays zero, and with no tile frozen the
    # range's blocks are the full call's tiles 1..T-1
    sharded = args.copy()
    sharded[2] = torch.tensor([int(meta[0]), 1, js.num_tiles, int(meta[3])], dtype=torch.int32)
    ranged = ttiles.forward(*sharded)
    assert ttiles.FORWARD_KERNEL.launches == before
    assert torch.equal(ranged, ttiles.forward_plain(*sharded))
    assert bool((out[:, 5] == int(meta[3])).all())  # no tile froze
    np.testing.assert_allclose(ranged[: js.num_tiles - 1].numpy(), out[1:].numpy(), atol=1e-6, rtol=1e-6)
    assert not ranged[js.num_tiles - 1].any()
    bad = args.copy()
    bad[0] = bad[0].double()
    with pytest.raises(ValueError):
        ttiles.forward(*bad)
    assert kernels.REGISTRY["tiles_packed_fwd"] is ttiles.FORWARD_KERNEL


# ------------------------------------------------------------ full render
def render_both(sc, kw, **over):
    js, ts = JSettings(**kw, **over), TSettings(**kw, **over)
    bg = np.array([0.2, 0.1, 0.4], np.float32)
    oj = _jit_render(_j(sc["means"]), _j(sc["cov"]), _j(sc["op"]), _j(EV), js, _j(bg),
                      shs=_j(sc["shs"]), colors_precomp=_j(sc["colors"]))
    targs = (_t(sc["means"]), _t(sc["cov"]), _t(sc["op"]), _t(EV), ts, _t(bg))
    tkw = dict(shs=_t(sc["shs"]), colors_precomp=_t(sc["colors"]))
    return oj, trast.render(*targs, **tkw), targs, tkw


@pytest.mark.parametrize("scene", ["make_scene", "make_scene_sh", "wall", "boundary"])
def test_render_matches_jax_and_oracle(scene):
    sc, kw = SCENES[scene]()
    oj, ot, targs, tkw = render_both(sc, kw)
    assert ot["render"].shape == (3, kw["height"], kw["width"])
    np.testing.assert_allclose(ot["render"].numpy(), np.asarray(oj["render"]), **IMG_TOL)
    np.testing.assert_allclose(ot["final_T"].numpy(), np.asarray(oj["final_T"]), atol=2e-5)
    for k in ("radii", "visibility_filter", "num_instances", "overflow", "grad_total",
              "grad_overflow", "clipped", "culled"):
        np.testing.assert_array_equal(ot[k].numpy(), np.asarray(oj[k]), err_msg=k)
    if scene != "boundary":  # the oracle walks every gaussian per pixel
        oo = toracle.render_oracle(*targs, **tkw)
        np.testing.assert_allclose(ot["render"].numpy(), oo["render"].numpy(), **IMG_TOL)
        np.testing.assert_allclose(ot["final_T"].numpy(), oo["final_T"].numpy(), atol=2e-5)


def test_render_exec_clamped_frame_degrades_like_jax():
    """tests/test_render.py:472, forward part: a tight bucket renders
    exactly; a too-tight one counts grad_overflow and the unflushed tiles
    become pure background, as in JAX."""
    sc, kw = make_scene(300)
    full = dict(instance_capacity=1 << 13)
    oj, ot, _, _ = render_both(sc, kw, **full)
    need = int(ot["grad_total"])
    tight_j, tight_t, _, _ = render_both(sc, kw, **full, grad_capacity=need + 128)
    assert int(tight_t["grad_overflow"]) == 0
    np.testing.assert_allclose(tight_t["render"].numpy(), ot["render"].numpy(), atol=1e-6)
    cj, ct, _, _ = render_both(sc, kw, **full, grad_capacity=max(need - 512, 128))
    assert int(ct["grad_overflow"]) == int(cj["grad_overflow"]) > 0
    img = ct["render"].numpy()
    assert np.isfinite(img).all()
    assert np.allclose(img[:, -8:, -16:], np.array([0.2, 0.1, 0.4])[:, None, None])
    np.testing.assert_allclose(img, np.asarray(cj["render"]), **IMG_TOL)


@pytest.mark.parametrize("packed", [True, False])
def test_render_backpropagates_on_both_kernel_families(packed):
    """Both kernel families render and back-propagate finite, nonzero
    gradients (tests/test_torch_backward.py and tests/test_torch_tiles.py
    hold their parity); the per-tile backward needs no binning.perm, so an
    inference=True binning takes gradients there too."""
    sc, kw = make_scene(50)
    targs = (_t(sc["means"]), _t(sc["cov"]), _t(sc["op"]), _t(EV))
    for inference in ((False, True) if not packed else (False,)):
        means = targs[0].clone().requires_grad_(True)
        out = trast.render(means, *targs[1:], TSettings(**kw, packed=packed, inference=inference), torch.zeros(3),
                           colors_precomp=_t(sc["colors"]))
        out["render"].sum().backward()
        assert bool(torch.isfinite(means.grad).all()) and float(means.grad.abs().max()) > 0


def test_assemble_image_complete_mask_without_bg():
    ts = TSettings(width=64, height=48, tanfovx=0.5, tanfovy=0.5)
    blocks = torch.rand(ts.num_tiles, 8, PIX)
    complete = torch.tensor([True, False, True, True, False, True])
    color, final_t = trast.assemble_image(blocks, ts, complete)
    js = JSettings(width=64, height=48, tanfovx=0.5, tanfovy=0.5)
    cj, tj = jrast.assemble_image(jnp.asarray(blocks.numpy()), js, jnp.asarray(complete.numpy()))
    np.testing.assert_array_equal(color.numpy(), np.asarray(cj))
    np.testing.assert_array_equal(final_t.numpy(), np.asarray(tj))
