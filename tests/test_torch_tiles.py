"""Parity of the port's per-tile kernel family (packed=False: K3, K4 and
the coverage-aware reducer) with c3dgs_tpu on the CPU: the same seeded
numpy inputs go through both packages, the JAX kernels in interpret mode.

- The staged fields (rasterizer._build_fields) exactly; K3's plain version
  against the Pallas forward on identical fields: rows 0-4 at atol 2e-5 /
  rtol 1e-4, row 5 (`stop`) and rows 6-7 exactly.
- K4's plain version against the Pallas backward on identical fields,
  blocks and cotangents: rows 0-8 at normalized 5e-4 against JAX's exact
  mode and 5e-2 against its fast mode (tests/test_render.py:150), row 9
  (the pre-sort slot, `cap` on tail lanes) exactly; and on a clamped frame,
  where only the TPU grid's last writer may fill the last chunk (rows 0-8
  at the exact-mode bar, the tags exactly).
- The reducer against JAX's in both coverage modes, compensated or not, at
  atol 1e-6.
- render(packed=False) against JAX: the image (tests/test_render.py:98)
  and every input's gradient via jax.grad (:119), and train_step over 2
  steps with quantization on.
The card-only tests of the CUDA kernels are in tests/test_torch_gpu.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from c3dgs_tpu.render import binning as jbinning
from c3dgs_tpu.render import rasterizer as jrast
from c3dgs_tpu.render.types import RasterSettings as JSettings
from c3dgs_tpu_torch.render import rasterizer as trast
from c3dgs_tpu_torch.render import tiles as ttiles
from c3dgs_tpu_torch.render import tiles_packed
from test_torch_backward import FAST_TOL, GRAD_TOL, NAMES, assert_normalized, cotangent, jax_grads, port_grads
from test_torch_gpu import SCENES, k1_inputs, k3_inputs, make_scene
from test_torch_render import IMG_TOL, _j, _t, jax_prep, render_both
from test_torch_train import train_step_parity
import torch_cpu  # noqa: F401,E402  (one torch thread per test worker)

_jit_fwd = jax.jit(jrast._blend_forward_call, static_argnums=(0, 1))
_jit_bwd = jax.jit(jrast._blend_backward_call, static_argnums=(0, 1, 2, 3, 4))


@jax.jit(static_argnums=(1,))
def _jit_stage(prep, js):
    b = jbinning.bin_gaussians(prep, js)
    table = jbinning.per_gaussian_table(prep, b.offset)
    return jrast._build_fields(table, b.gid_sorted, b.j_sorted), table, b


def staged(sc, kw, **over):
    """The JAX stages up to K3's inputs: (settings, fields, table, Binning)."""
    js = JSettings(**kw, packed=False, **over)
    return (js, *_jit_stage(jax_prep(sc, js), js))


def k3_args(js, fields, b):
    """K3's inputs as torch tensors: fields, tile_ids, starts, ends, nchunks."""
    return (_t(np.asarray(fields)), torch.arange(js.num_tiles, dtype=torch.int32),
            *(_t(np.asarray(x)) for x in (b.starts, b.ends, b.nchunks)))


def jax_forward(js, fields, b):
    return _jit_fwd(js.tiles_x, js.num_tiles, fields, jnp.arange(js.num_tiles, dtype=jnp.int32),
                    b.starts, b.ends, b.nchunks)


def jax_backward(js, fields, b, totals, g, grad_cap, fast_grad):
    return np.asarray(_jit_bwd(js.tiles_x, js.num_tiles, fields.shape[1], grad_cap, fast_grad, fields,
                               jnp.arange(js.num_tiles, dtype=jnp.int32), b.starts, b.ends, b.nchunks,
                               b.grad_base, totals, jnp.asarray(g)))


# --------------------------------------------------------------------- K3
@pytest.mark.parametrize("scene", ["make_scene", "occluder", "wall", "boundary"])
def test_k3_plain_matches_jax_kernel(scene):
    sc, kw = SCENES[scene]()
    js, fields, table, b = staged(sc, kw)
    fields_t = trast._build_fields(_t(np.asarray(table)), _t(np.asarray(b.gid_sorted)), _t(np.asarray(b.j_sorted)))
    np.testing.assert_array_equal(fields_t.numpy(), np.asarray(fields))
    out_j = np.asarray(jax_forward(js, fields, b))
    out_t = ttiles.forward(*k3_args(js, fields, b), js.tiles_x).numpy()
    assert out_t.shape == out_j.shape == (js.num_tiles, 8, ttiles.PIX)
    np.testing.assert_allclose(out_t[:, :5], out_j[:, :5], **IMG_TOL)
    np.testing.assert_array_equal(out_t[:, 5:], out_j[:, 5:])
    stopped = int((out_t[:, 5, 0] < np.asarray(b.nchunks)).sum())
    if scene == "wall":
        assert stopped >= 1  # the saturation exit really skips windows here


@pytest.mark.parametrize("scene", ["make_scene", "occluder", "wall", "boundary"])
def test_k3_k4_plain_exp_counts(scene):
    """chip_smoke.py's K3/K4 bounds count an exp only for the pairs the
    kernels' skip keeps (`exp_pairs`). Every pair with alpha > 0 is one of
    them, in each window walked before `stop`; where no tile saturates,
    the per-tile walk evaluates the packed walk's pairs, and both plain
    versions count the same exps."""
    sc, kw = SCENES[scene]()
    args, grad_base, st = k3_inputs(sc, kw, "cpu")
    fields, tile_ids, starts, ends, nch = args
    fwd, bwd = {}, {}
    totals = ttiles.forward_plain(*args, st.tiles_x, stats=fwd)
    g = torch.as_tensor(cotangent(st.num_tiles))
    ttiles.backward_plain(*args, grad_base, totals, g, st.tiles_x, st.resolve_grad_cap(len(sc["means"])),
                          stats=bwd)
    assert fwd == bwd and 0 < fwd["alpha_pairs"] <= fwd["exp_pairs"] < fwd["pairs"]
    stop = totals[:, 5, 0].long()
    px, py = ttiles._pixel_coords(tile_ids, st.tiles_x)
    for w in range(int(stop.max())):
        a = torch.nonzero(w < stop).flatten()
        f, seg = ttiles._window(fields, starts[a].long(), (ends[a] - starts[a]).long(), w)
        _, _, power, alpha, _ = ttiles._alpha(f, px[a], py[a], seg)
        assert not ((alpha > 0) & ~ttiles.needs_exp(f, power, seg)).any()
    if scene != "wall":  # the wall's saturated tiles stop early in both walks, at other points
        packed = {}
        tiles_packed.forward_plain(*k1_inputs(sc, kw, "cpu"), stats=packed)
        assert packed == fwd


# --------------------------------------------------------------------- K4
@pytest.mark.parametrize("fast_grad", [False, True])
@pytest.mark.parametrize("scene", ["make_scene", "occluder", "wall", "boundary"])
def test_k4_plain_matches_jax_kernel(scene, fast_grad):
    sc, kw = SCENES[scene]()
    js, fields, _, b = staged(sc, kw)
    totals = jax_forward(js, fields, b)
    g = cotangent(js.num_tiles)
    grad_cap = js.resolve_grad_cap(sc["means"].shape[0])
    gj = jax_backward(js, fields, b, totals, g, grad_cap, fast_grad)
    args = k3_args(js, fields, b)
    gt = ttiles.backward(*args, _t(np.asarray(b.grad_base)), _t(totals), torch.as_tensor(g), js.tiles_x,
                         grad_cap).numpy()
    assert gt.shape == gj.shape == (16, grad_cap)
    written = int(b.grad_total)  # JAX leaves the columns past it unwritten
    tol = FAST_TOL if fast_grad else GRAD_TOL
    for r in range(9):
        assert_normalized(gt[r, :written], gj[r, :written], tol, f"row {r}")
    np.testing.assert_array_equal(gt[9, :written], gj[9, :written])
    assert np.abs(gj[:9, :written]).max() > 0 and not gt[:, written:].any() and not gt[10:].any()
    assert (gt[9, :written] == fields.shape[1]).any()  # tail lanes carry the cap tag


@pytest.mark.parametrize("case", ["frame", "tile_subset"])
def test_k4_clamped_frame_matches_jax(case):
    """grad_capacity below grad_total: the windows past the buffer clamp
    into its last chunk, which holds what the TPU grid's last writer wrote
    (the last tile with windows, at its lowest clamped window); every
    column matches JAX's. `frame`: the boundary scene's whole frame, 8
    chunks short. `tile_subset`: the wall scene's tiles up to the one with
    the most windows, called as a tile-sharded device would (tile_ids,
    grad_base of the subset), its windows 1.. clamped, so the writer is
    not that tile's last window."""
    if case == "frame":
        sc, kw = SCENES["boundary"]()
        js, fields, _, b = staged(sc, kw)
        tile_ids = jnp.arange(js.num_tiles, dtype=jnp.int32)
        starts, ends, nchunks, grad_base = b.starts, b.ends, b.nchunks, b.grad_base
        grad_cap = int(b.grad_total) - 1024
    else:
        sc, kw = SCENES["wall"]()
        js, fields, _, b = staged(sc, kw)
        t_max = int(jnp.argmax(b.nchunks))
        tile_ids = jnp.arange(t_max + 1, dtype=jnp.int32)
        starts, ends, nchunks = b.starts[: t_max + 1], b.ends[: t_max + 1], b.nchunks[: t_max + 1]
        grad_base = ((jnp.cumsum(nchunks) - nchunks) * 128).astype(jnp.int32)
        grad_cap = int(grad_base[t_max]) + 256
        assert int(nchunks[t_max]) >= 3
    n = tile_ids.shape[0]
    totals = _jit_fwd(js.tiles_x, n, fields, tile_ids, starts, ends, nchunks)
    g = cotangent(n, seed=3)
    gj = np.asarray(_jit_bwd(js.tiles_x, n, fields.shape[1], grad_cap, False, fields, tile_ids, starts, ends,
                             nchunks, grad_base, totals, jnp.asarray(g)))
    args = tuple(_t(np.asarray(x)) for x in (fields, tile_ids, starts, ends, nchunks))
    gb_t = _t(np.asarray(grad_base))
    gt = ttiles.backward(*args, gb_t, _t(totals), torch.as_tensor(g), js.tiles_x, grad_cap).numpy()
    for r in range(9):
        assert_normalized(gt[r], gj[r], GRAD_TOL, f"row {r}")
    np.testing.assert_array_equal(gt[9:], gj[9:])  # the last chunk's tags name its writer
    t, w = ttiles.last_chunk_writer(args[4], gb_t, grad_cap)
    assert t == n - 1 or not np.asarray(nchunks)[t + 1:].any()
    assert int(grad_base[t]) + w * 128 >= grad_cap - 128  # the writer's window really clamps
    if case == "tile_subset":
        assert (w, int(nchunks[t])) == (1, int(nchunks[t_max]))


# -------------------------------------------------------------- reduction
@pytest.mark.parametrize("compensated", [False, True])
@pytest.mark.parametrize("partial_coverage", [True, False])
def test_reducer_matches_jax(partial_coverage, compensated):
    """Seeded grad rows keyed by a shuffled subset of the pre-sort slots,
    some rows tagged with the cap sentinel or out of range, and coverage
    [lo, hi) cutting off both ends of the buffer."""
    sc, kw = make_scene(300)
    js, fields, _, b = staged(sc, kw)
    cap = fields.shape[1]
    emit_cum = np.asarray(b.emit_cum)
    total = int(emit_cum[-1])
    rng = np.random.default_rng(11)
    grad_cap = cap + 512
    grads = (rng.normal(size=(16, grad_cap)) * 0.05).astype(np.float32)
    keys = np.full(grad_cap, cap, np.float32)
    slots = rng.permutation(total)[: total - 40]
    where = np.sort(rng.choice(grad_cap, size=slots.size, replace=False))
    keys[where] = slots
    keys[rng.choice(grad_cap, size=30, replace=False)] = -3.0  # out of range: dropped
    grads[9] = keys
    lo, hi = 200, grad_cap - 300
    if partial_coverage:
        boundaries = emit_cum
    else:  # kept-instance counts: the covered keys below each boundary
        kept = keys[lo:hi]
        kept = np.sort(kept[(kept >= 0) & (kept < cap)])
        boundaries = np.searchsorted(kept, emit_cum - 1, side="right").astype(np.int32)
    dj = np.asarray(jrast._reduce_instance_grads(jnp.asarray(grads), jnp.asarray(boundaries), cap, jnp.int32(lo),
                                                 jnp.int32(hi), partial_coverage, compensated=compensated))
    dt = trast._reduce_instance_grads(torch.as_tensor(grads), _t(boundaries), cap, lo, hi, partial_coverage,
                                      compensated=compensated).numpy()
    assert dt.shape == dj.shape == (sc["means"].shape[0], 16)
    assert np.abs(dj).max() > 0
    np.testing.assert_allclose(dt, dj, atol=1e-6)


# ---------------------------------------------------------- full render
@pytest.mark.parametrize("use_sh", [False, True])
def test_render_per_tile_matches_jax(use_sh):
    sc, kw = make_scene(300, sh=use_sh)
    oj, ot, _, _ = render_both(sc, kw, packed=False)
    np.testing.assert_allclose(ot["render"].numpy(), np.asarray(oj["render"]), **IMG_TOL)
    np.testing.assert_allclose(ot["final_T"].numpy(), np.asarray(oj["final_T"]), atol=2e-5)
    for k in ("num_instances", "overflow", "grad_total", "grad_overflow", "culled"):
        np.testing.assert_array_equal(ot[k].numpy(), np.asarray(oj[k]), err_msg=k)
    _, op, _, _ = render_both(sc, kw)  # the packed path renders the same image
    np.testing.assert_allclose(ot["render"].numpy(), op["render"].numpy(), **IMG_TOL)


@pytest.mark.parametrize("fast_grad", [False, True])
def test_render_per_tile_gradients_match_jax(fast_grad):
    """tests/test_render.py:119 with packed=False: every input's gradient
    (and the viewspace offset's) against jax.grad of the JAX render."""
    sc, kw = make_scene(150)
    wimg = np.random.default_rng(7).normal(size=(3, kw["height"], kw["width"])).astype(np.float32)
    gj = jax_grads(sc, kw, wimg, fast_grad=fast_grad, packed=False)
    gt, _ = port_grads(sc, kw, wimg, fast_grad=fast_grad, packed=False)
    tol = FAST_TOL if fast_grad else GRAD_TOL
    for name, a, c in zip(NAMES, gj, gt):
        assert c is not None and np.isfinite(c).all(), name
        assert_normalized(c, a, tol, name)
    assert np.abs(gt[3]).max() > 0 and np.abs(gt[5]).max() > 0


def test_train_step_per_tile_matches_jax():
    train_step_parity(quantization=True, steps=2, packed=False)
