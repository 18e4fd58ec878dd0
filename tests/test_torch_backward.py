"""Parity of the port's training backward (c3dgs_tpu_torch.render) with
c3dgs_tpu on the CPU: the same seeded numpy inputs go through both
packages, the JAX kernels in interpret mode.

- K2's plain version against the Pallas backward kernel on identical
  staged fields, K1 blocks and cotangents: rows 0-8 at normalized atol
  5e-4 against JAX's exact mode and 5e-2 against its fast mode (the bars
  of tests/test_render.py:150).
- The per-slot reduction against JAX's at atol 1e-6 in both modes, and
  against a float64 index_add.
- Full render gradients (means, cov, opacity, extrinsic, colors or SH,
  viewspace offset) against jax.grad of the JAX render at normalized
  5e-4, also of a render binned with inference=True (no perm: the rows
  reduce by their pre-sort slot keys), and against the port's own oracle
  under autograd.
The card-only tests of the CUDA kernel are in tests/test_torch_gpu.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from c3dgs_tpu.render import rasterizer as jrast
from c3dgs_tpu.render.types import RasterSettings as JSettings
from c3dgs_tpu_torch.render import oracle as toracle
from c3dgs_tpu_torch.render import rasterizer as trast
from c3dgs_tpu_torch.render import tiles_packed as ttiles
from c3dgs_tpu_torch.render.binning import NUM_USED_FIELDS, bin_gaussians
from c3dgs_tpu_torch.render.tiles import PIX
from c3dgs_tpu_torch.render.types import RasterSettings as TSettings
from test_torch_gpu import EV, SCENES, make_scene, render_grads, segment_frame, segment_meta
from test_torch_render import _j, _t, k1_args, staged
import torch_cpu  # noqa: F401,E402  (one torch thread per test worker)

GRAD_TOL = 5e-4  # normalized, tests/test_render.py:150 (exact mode)
FAST_TOL = 5e-2  # the same test's fast_grad class
BG = np.array([0.2, 0.1, 0.4], np.float32)


def assert_normalized(got, ref, atol, name=""):
    ref = np.asarray(ref, np.float64)
    scale = max(np.abs(ref).max(), 1e-3)
    np.testing.assert_allclose(np.asarray(got, np.float64) / scale, ref / scale, atol=atol, err_msg=name)


def cotangent(num_tiles, seed=0):
    """Random dL/dC and dL/dT_final rows; rows 4-7 zero, as assemble_image
    leaves them."""
    g = np.zeros((num_tiles, 8, PIX), np.float32)
    g[:, :4] = np.random.default_rng(seed).normal(size=(num_tiles, 4, PIX))
    return g


# --------------------------------------------------------------------- K2
@pytest.mark.parametrize("fast_grad", [False, True])
@pytest.mark.parametrize("scene", ["make_scene", "occluder", "wall", "boundary"])
def test_k2_plain_matches_jax_kernel(scene, fast_grad):
    sc, kw = SCENES[scene]()
    js, fields, tile_lo, meta, b = staged(sc, kw)
    totals = jrast._blend_forward_call_packed(js.num_tiles, fields.shape[1], fields, tile_lo, meta)
    g = cotangent(js.num_tiles)
    gj = np.asarray(jrast._blend_backward_call_packed(
        js.num_tiles, fields.shape[1], fast_grad, fields, tile_lo, meta, totals, jnp.asarray(g)
    ))
    args = k1_args(fields, tile_lo, meta, b)
    gt = ttiles.backward(*args, _t(totals), torch.as_tensor(g)).numpy()
    assert gt.shape == gj.shape == (16, fields.shape[1])
    tol = FAST_TOL if fast_grad else GRAD_TOL
    for r in range(9):
        assert_normalized(gt[r], gj[r], tol, f"row {r}")
    assert np.abs(gj[:9]).max() > 0 and not gt[10:].any()
    # row 9 carries the pre-sort slot of every walked slot
    walked = gt[9] > 0
    np.testing.assert_array_equal(gt[9, walked], np.asarray(fields)[10, walked])


def test_k2_plain_frame_clamp_and_checks():
    """An exec-clamped frame (tests/test_render.py:472): the open tile
    that never flushed gets all-zero rows even when its blocks are NaN
    (unwritten memory on the card); the flushed tiles still match JAX."""
    sc, kw = make_scene(300)
    full = dict(instance_capacity=1 << 13)
    _, _, _, _, b = staged(sc, kw, **full)
    need = int(b.chunks_exec) * 128
    js, fields, tile_lo, meta, b = staged(sc, kw, **full, grad_capacity=max(need - 512, 128))
    totals = np.array(jrast._blend_forward_call_packed(js.num_tiles, fields.shape[1], fields, tile_lo, meta))
    flushed = np.asarray(b.ends) < int(meta[0]) * 128
    g = cotangent(js.num_tiles)
    g[~flushed] = 0.0  # assemble_image's select
    gj = np.asarray(jrast._blend_backward_call_packed(
        js.num_tiles, fields.shape[1], False, fields, tile_lo, meta, jnp.asarray(totals), jnp.asarray(g)
    ))
    totals[~flushed] = np.nan
    args = k1_args(fields, tile_lo, meta, b)
    gt = ttiles.backward(*args, torch.as_tensor(totals), torch.as_tensor(g)).numpy()
    assert np.isfinite(gt).all()
    for r in range(9):
        assert_normalized(gt[r], gj[r], GRAD_TOL, f"row {r}")
    open_tile = int(np.asarray(tile_lo)[int(meta[0])])
    open_slots = slice(int(np.asarray(b.starts)[open_tile]), int(meta[0]) * 128)
    assert not gt[:, open_slots].any()
    bad = list(args) + [torch.as_tensor(totals), torch.as_tensor(g)]
    bad[5] = bad[5][:, :4]
    with pytest.raises(ValueError, match="totals"):
        ttiles.backward(*bad)


# -------------------------------------------------------------- reduction
def _jax_reduce_every_emission(grads, perm, boundaries, compensated=False):
    """c3dgs_tpu's _reduce_instance_grads_packed over the whole permutation
    (the reference slices it to the execution bucket, rasterizer.py:296)."""
    live, rows = NUM_USED_FIELDS, grads.shape[1]
    d_pre = grads[:live].T[jnp.minimum(perm, rows - 1)]
    idx = jnp.arange(perm.shape[0], dtype=jnp.int32)
    d_pre = jnp.where(((idx < boundaries[-1]) & (perm < rows))[:, None], d_pre, 0.0)
    seg = jrast._segment_prefix_diff(d_pre, boundaries, boundaries > 0, compensated)
    return jnp.concatenate([seg, jnp.zeros((boundaries.shape[0], 16 - live), seg.dtype)], axis=1)


def reducer_frame(frame):
    """(grads, perm, emit_cum) numpy inputs of the reduction: "scene", the
    300-splat scene's frame with seeded rows; "long", test_torch_gpu's
    segment_frame (a 230-emission splat, 16-256 emission splats, runs of
    splats with none, slots past the bucket); "tight", the wall scene at an
    execution bucket of its grad_total (more emissions than slots). The
    rows of every third splat's emissions are zero."""
    if frame == "long":
        grads, perm, emit_cum = (x.numpy() for x in segment_frame())
    else:
        sc, kw = SCENES["wall"]() if frame == "tight" else make_scene(300)
        over = {}
        if frame == "tight":
            _, _, _, _, b = staged(sc, kw)
            over = dict(grad_capacity=int(b.chunks_exec) * 128)
        _, fields, _, _, b = staged(sc, kw, **over)
        perm, emit_cum = np.asarray(b.perm), np.asarray(b.emit_cum)
        grads = (np.random.default_rng(1).normal(size=(16, fields.shape[1])) * 0.05).astype(np.float32)
    total, rows = int(emit_cum[-1]), grads.shape[1]
    owner = np.searchsorted(emit_cum, np.arange(total), side="right")
    slots = perm[:total]
    grads[:, slots[(owner % 3 == 0) & (slots < rows)]] = 0.0  # these gaussians' segments are exact zeros
    return grads, perm, emit_cum


@pytest.mark.parametrize(
    "compensated, frame",
    [(False, "scene"), (True, "scene"), (False, "long"), (True, "long"), (False, "tight"), (True, "tight")],
    ids=["False", "True", "long-False", "long-True", "tight-False", "tight-True"],
)
def test_reducer_matches_jax_and_float64(compensated, frame):
    """The port's packed reduction (exact mode: segment_sum's plain
    version) against JAX's at atol 1e-6 (over the whole permutation on the
    tight frame, where JAX's own drops emissions: the next test) and
    against a float64 index_add over the kept emissions."""
    grads, perm, emit_cum = reducer_frame(frame)
    jax_reduce = _jax_reduce_every_emission if frame == "tight" else jrast._reduce_instance_grads_packed
    dj = np.asarray(jax_reduce(jnp.asarray(grads), jnp.asarray(perm), jnp.asarray(emit_cum), compensated))
    g = torch.as_tensor(grads)
    dt = trast._reduce_instance_grads_packed(
        g, _t(perm), _t(emit_cum), segment_meta(g, -(-g.shape[1] // 128)), compensated
    ).numpy()
    assert dt.shape == dj.shape == (len(emit_cum), 16)
    np.testing.assert_allclose(dt, dj, atol=1e-6)
    assert not dt[np.arange(len(dt)) % 3 == 0].any()
    # float64 index_add over the emissions whose sorted slot lies in the bucket
    total, rows = int(emit_cum[-1]), grads.shape[1]
    owner = np.searchsorted(emit_cum, np.arange(total), side="right")
    pos = perm[:total]
    inside = pos < rows
    ref = np.zeros((len(dt), 9))
    np.add.at(ref, owner[inside], grads[:9, pos[inside]].T.astype(np.float64))
    np.testing.assert_allclose(dt[:, :9], ref, atol=1e-6)
    if frame == "long":
        counts = np.diff(emit_cum, prepend=0)
        assert counts.max() >= 200 and not dt[counts == 0].any()
        assert (~inside).sum() > 0 and np.abs(ref[counts >= 16]).max() > 0
    if frame == "tight":
        assert rows < total


def test_reducer_keeps_emissions_past_a_tight_execution_bucket():
    """An execution bucket at the frame's grad_total (bench.py's
    probe-exact bucket; no grad_overflow): the emissions, culled ones
    included, outnumber the bucket's slots. The port's reduction gathers
    the whole permutation and equals a float64 index_add over every
    emission whose sorted slot lies in the bucket. The reference's slices
    the permutation to the bucket and drops the gradient of every emission
    past that index (c3dgs_tpu/render/rasterizer.py:296; ROADMAP C): pinned
    here."""
    sc, kw = SCENES["wall"]()  # 1,951 emissions, 230 culled, 1,792 slots executed
    _, _, _, _, b = staged(sc, kw)
    need = int(b.chunks_exec) * 128
    js, fields, tile_lo, meta, b = staged(sc, kw, grad_capacity=need)
    rows = fields.shape[1]
    perm, emit_cum = np.asarray(b.perm), np.asarray(b.emit_cum)
    total = int(emit_cum[-1])
    assert rows == need and int(meta[0]) * 128 <= rows < total  # no overflow, more emissions than slots
    grads = (np.random.default_rng(2).normal(size=(16, rows)) * 0.05).astype(np.float32)
    owner = np.searchsorted(emit_cum, np.arange(total), side="right")
    pos = perm[:total]
    inside = pos < rows
    ref = np.zeros((len(emit_cum), 9))
    np.add.at(ref, owner[inside], grads[:9, pos[inside]].T.astype(np.float64))
    g = torch.as_tensor(grads)
    dt = trast._reduce_instance_grads_packed(g, _t(perm), _t(emit_cum), segment_meta(g, rows // 128), True).numpy()
    np.testing.assert_allclose(dt[:, :9], ref, atol=1e-6)
    lost = np.unique(owner[rows:][inside[rows:]])  # gaussians with a kept emission past index `rows`
    assert len(lost) > 0
    dj = np.asarray(jrast._reduce_instance_grads_packed(jnp.asarray(grads), b.perm, b.emit_cum, True))
    assert np.abs(dj[lost, :9] - ref[lost]).max() > 1e-3  # the reference's loss
    np.testing.assert_allclose(dj[: owner[rows - 1], :9], ref[: owner[rows - 1]], atol=1e-6)


# ---------------------------------------------------------- full render
def jax_grads(sc, kw, wimg, **over):
    js = JSettings(**kw, **over)
    n = sc["means"].shape[0]
    feats = "shs" if sc["shs"] is not None else "colors"

    def loss(m, c, o, e, f, vs):
        kwf = {"shs": f} if feats == "shs" else {"colors_precomp": f}
        img = jrast.render(m, c, o, e, js, jnp.asarray(BG), viewspace_offset=vs, **kwf)["render"]
        return jnp.vdot(jnp.asarray(wimg), img)

    g = jax.jit(jax.grad(loss, argnums=tuple(range(6))))(
        _j(sc["means"]), _j(sc["cov"]), _j(sc["op"]), _j(EV), _j(sc[feats]), jnp.zeros((n, 2))
    )
    return [np.asarray(x) for x in g]


def port_grads(sc, kw, wimg, render_fn=trast.render, **over):
    grads, out = render_grads(render_fn, sc, kw, "cpu", wimg, **over)
    return [None if g is None else g.numpy() for g in grads], out


NAMES = ["means", "cov", "opacity", "extrinsic", "colors/shs", "viewspace"]


@pytest.mark.parametrize(
    "scene,fast_grad",
    [("make_scene", False), ("make_scene", True), ("make_scene_sh", False),
     ("occluder", False), ("wall", False), ("boundary", False)],
)
def test_render_gradients_match_jax(scene, fast_grad):
    """Ports tests/test_render.py:121 (both fast_grad values), :159, :230,
    :310 (pose gradients) and :325 (viewspace-offset gradients): every
    input's gradient against jax.grad at the exact-mode bar."""
    if scene == "make_scene":
        sc, kw = make_scene(150)
    else:
        sc, kw = SCENES[scene]()
    wimg = np.random.default_rng(7).normal(size=(3, kw["height"], kw["width"])).astype(np.float32)
    gj = jax_grads(sc, kw, wimg, fast_grad=fast_grad)
    gt, _ = port_grads(sc, kw, wimg, fast_grad=fast_grad)
    for name, a, b in zip(NAMES, gj, gt):
        assert b is not None and np.isfinite(b).all(), name
        assert_normalized(b, a, GRAD_TOL, name)
    assert np.abs(gt[3]).max() > 0 and np.abs(gt[5]).max() > 0


@pytest.mark.parametrize("scene", ["make_scene", "wall"])
def test_render_gradients_match_port_oracle(scene):
    """The port's oracle runs under autograd; the packed path's gradients
    match it at the exact-mode bar (the wall freezes tiles: their far
    splats get zero gradient from the packed path, ~T_final from the
    oracle)."""
    sc, kw = make_scene(150) if scene == "make_scene" else SCENES[scene]()
    wimg = np.random.default_rng(3).normal(size=(3, kw["height"], kw["width"])).astype(np.float32)
    go, _ = port_grads(sc, kw, wimg, render_fn=toracle.render_oracle, fast_grad=False)
    gt, _ = port_grads(sc, kw, wimg, fast_grad=False)
    for name, a, b in zip(NAMES[:5], go, gt):
        assert a is not None and np.abs(a).max() > 0, name
        assert_normalized(b, a, GRAD_TOL, name)


def test_exec_clamped_frame_gradients_match_jax(monkeypatch):
    """The gradient half of tests/test_render.py:472: a clamped frame's
    gradients are finite and equal JAX's; a tight but sufficient bucket
    gives the full frame's gradients. Here 96 emissions past the bucket's
    index (81 of them walked) have their slots inside it: JAX's training
    reduction drops them from the gradient (ROADMAP C; pinned by
    test_reducer_keeps_emissions_past_a_tight_execution_bucket), so the
    JAX side reduces over the whole permutation (_jax_reduce_every_emission,
    patched in for this test only)."""
    sc, kw = make_scene(250)
    full = dict(instance_capacity=1 << 13)
    wimg = np.random.default_rng(2).normal(size=(3, kw["height"], kw["width"])).astype(np.float32)
    g_full, out = port_grads(sc, kw, wimg, **full)
    need = int(out["grad_total"])
    g_tight, _ = port_grads(sc, kw, wimg, **full, grad_capacity=need + 128)
    for a, b in zip(g_full, g_tight):
        np.testing.assert_allclose(b, a, atol=1e-5)
    clamp = dict(full, grad_capacity=max(need - 512, 128))
    gt, out_c = port_grads(sc, kw, wimg, **clamp)
    assert int(out_c["grad_overflow"]) > 0
    monkeypatch.setattr(jrast, "_reduce_instance_grads_packed", _jax_reduce_every_emission)
    gj = jax_grads(sc, kw, wimg, **clamp)
    for name, a, b in zip(NAMES, gj, gt):
        assert np.isfinite(b).all(), name
        assert_normalized(b, a, GRAD_TOL, name)


@pytest.mark.parametrize("fast_grad", [False, True], ids=["exact", "fast_grad"])
def test_backward_of_inference_render_matches_jax(fast_grad):
    """A packed render binned with inference=True has no perm; its
    backward reduces K2's rows by their pre-sort slot keys over the
    executed chunks (c3dgs_tpu/render/rasterizer.py:365-372). Every
    input's gradient against jax.grad of the JAX inference render, at
    normalized 5e-4 (exact) or 5e-2 (fast_grad)."""
    sc, kw = make_scene(150)
    st = TSettings(**kw, inference=True)
    prep = trast.preprocess(_t(sc["means"]), _t(sc["cov"]), _t(sc["op"]), _t(EV), st, None, _t(sc["colors"]))
    assert bin_gaussians(prep, st).perm is None  # serving binning skips the sort
    wimg = np.random.default_rng(7).normal(size=(3, kw["height"], kw["width"])).astype(np.float32)
    gj = jax_grads(sc, kw, wimg, inference=True, fast_grad=fast_grad)
    gt, _ = port_grads(sc, kw, wimg, inference=True, fast_grad=fast_grad)
    tol = FAST_TOL if fast_grad else GRAD_TOL
    for name, a, b in zip(NAMES, gj, gt):
        assert b is not None and np.isfinite(b).all(), name
        assert_normalized(b, a, tol, name)
    assert np.abs(gt[0]).max() > 0 and np.abs(gt[5]).max() > 0


def test_cpu_backward_is_deterministic():
    sc, kw = SCENES["boundary"]()
    wimg = np.random.default_rng(5).normal(size=(3, kw["height"], kw["width"])).astype(np.float32)
    a, _ = port_grads(sc, kw, wimg)
    b, _ = port_grads(sc, kw, wimg)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
