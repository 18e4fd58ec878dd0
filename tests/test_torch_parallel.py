"""Parity of the port's multi-device layer (c3dgs_tpu_torch.parallel and
render/binning.py::bin_gaussians_routed) with c3dgs_tpu.parallel on the
CPU. The JAX side runs in this process on the conftest's 8 virtual CPU
devices, through its own shard_map wrappers (as tests/test_parallel.py
does); the port side runs as 4 gloo CPU ranks (tests/torch_ranks.py), fed
the same seeded numpy arrays.

- routed_local_cap equal to JAX's, with the geometry invariants;
- bin_gaussians_routed bitwise JAX's on every rank at D = 4, on a 15-tile
  grid (the last rank owns 3 tiles and a padding tile);
- K1's and K2's plain versions in their tile-range mode against the
  Pallas kernels (interpret mode) on routed ranks' arrays with
  tile_start > 0 (the last one padded): blocks at atol 2e-5 / rtol 1e-4,
  freeze slots exact, gradient rows at normalized 5e-4 (exact mode);
- render_tile_sharded at dp1 x tiles4 and dp2 x tiles2 against JAX's and
  the port's single-device image (atol 1e-5, tests/test_parallel.py:41);
- ports of test_tile_skew_trips_truncation_counter,
  test_morton_coherent_source_does_not_drop, test_slab_loss_matches_full
  (rtol 2e-6, atol 2e-7) and test_mesh_shapes (on the 4-rank world);
- make_hybrid_train_step at dp2 x tiles2: gradients against jax.grad of
  the single-device 2-camera mean at normalized 5e-4 (exact mode), the
  parameters after one step at atol 5e-5 (tests/test_parallel.py:146-150)
  and bitwise equal on every rank.
"""
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from c3dgs_tpu.config import OptimizationParams as JOpt
from c3dgs_tpu.models import gaussians as jgauss
from c3dgs_tpu.ops import losses as jlosses
from c3dgs_tpu.parallel import make_mesh as jmake_mesh
from c3dgs_tpu.parallel import render_tile_sharded as jrender_tile_sharded
from c3dgs_tpu.parallel.sharded import photometric_loss_rows as jloss_rows
from c3dgs_tpu.render import binning as jbinning
from c3dgs_tpu.render import rasterizer as jrast
from c3dgs_tpu.render.preprocess import preprocess as jpreprocess
from c3dgs_tpu.render.types import RasterSettings as JSettings
from c3dgs_tpu.train import trainer as jtrainer
from c3dgs_tpu_torch.render import binning as tbinning
from c3dgs_tpu_torch.render import tiles_packed as ttiles
from c3dgs_tpu_torch.render.tiles import PIX
from test_torch_backward import GRAD_TOL, assert_normalized, cotangent
from test_torch_gpu import make_scene
from test_torch_render import K1_TOL, _t
import torch_cpu  # noqa: F401,E402  (one torch thread per test worker)
import torch_ranks

D = 4
WORLD = 4
EV = np.array([0, 0, 0, 1, 0, 0, 0], np.float32)
BG = np.array([0.1, 0.2, 0.3], np.float32)
SET_KW = torch_ranks.SET_KW
# the routed-binning grid: 5 x 3 = 15 tiles, so rank 3 owns tiles 12-14
# and one padding tile
ROUTED_KW = dict(width=160, height=48, tanfovx=math.tan(0.9), tanfovy=math.tan(0.35), sh_degree=0)
ROUTED_FIELDS = ("gid_sorted", "j_sorted", "tid_sorted", "sent_sorted", "tile_lo", "chunks_exec", "t0", "t1",
                 "emit_cum", "offset", "num_instances", "overflow", "clipped", "route_dropped")


def jmesh(dp, tiles):
    return jmake_mesh(dp=dp, tiles=tiles, devices=jax.devices()[: dp * tiles])


# jitted: one XLA compile per call instead of the shard_map's eager ops
_jrender = jax.jit(jrender_tile_sharded, static_argnums=(2, 4, 5))


def leaves(scene):
    """A JAX scene as the payload torch_ranks.scene_of rebuilds."""
    names = ("xyz", "opacity", "scaling_factor", "active", "features_dc", "features_rest", "scaling", "rotation")
    return dict(
        leaves={k: None if getattr(scene, k) is None else np.asarray(getattr(scene, k)) for k in names},
        statics=dict(max_sh_degree=scene.max_sh_degree, active_sh_degree=scene.active_sh_degree,
                     quantization=scene.quantization, use_factor_scaling=scene.use_factor_scaling),
    )


def toy_scene(n=80, cap=96, seed=0):
    """tests/test_parallel.py::toy_scene."""
    pts, cols = torch_ranks.toy_points(n, seed)
    return jgauss.from_point_cloud(pts, cols, capacity=cap, quantization=False)


def skew_scene():
    """tests/test_parallel.py:53-67: every gaussian in tile (0, 0)."""
    n = 600
    rng = np.random.default_rng(3)
    pts = (rng.normal(size=(n, 3)) * 0.02).astype(np.float32)
    pts[:, 0] -= 0.82
    pts[:, 1] -= 0.82
    pts[:, 2] += 3.0
    cols = rng.random(size=(n, 3)).astype(np.float32)
    return jgauss.from_point_cloud(pts, cols, capacity=n, quantization=False), dict(SET_KW, instance_capacity=640)


def morton_scene():
    """tests/test_parallel.py:88-99: spread out, spatially sorted."""
    n = 600
    rng = np.random.default_rng(5)
    pts = rng.uniform(-0.8, 0.8, size=(n, 3)).astype(np.float32)
    pts[:, 2] = 3.0 + pts[:, 2] * 0.05
    pts = pts[np.lexsort((pts[:, 1], pts[:, 0]))]
    cols = rng.random(size=(n, 3)).astype(np.float32)
    return jgauss.from_point_cloud(pts, cols, capacity=n, quantization=False), dict(SET_KW, instance_capacity=1280)


def routed_prep():
    sc, _ = make_scene(400, seed=2)
    sc["means"][:, :2] *= 1.5
    js = JSettings(**ROUTED_KW)
    prep = jax.jit(jpreprocess, static_argnums=(4,))(
        jnp.asarray(sc["means"]), jnp.asarray(sc["cov"]), jnp.asarray(sc["op"]), jnp.asarray(EV), js, None,
        jnp.asarray(sc["colors"]),
    )
    return js, prep


def slab_images():
    rng = np.random.default_rng(9)
    return [(rng.random((3, h, w)).astype(np.float32), rng.random((3, h, w)).astype(np.float32))
            for h, w in [(32, 64), (33, 40), (96, 48)]]


def hybrid_batch():
    evs = np.stack([EV, EV + np.array([0, 0, 0, 0, 0.1, 0, 0], np.float32)])
    return evs, np.zeros((2, 3, 32, 64), np.float32)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The port's results on 4 gloo CPU ranks (one spawn for the file)."""
    _, prep = routed_prep()
    evs, gts = hybrid_batch()
    skew, skew_kw = skew_scene()
    morton, morton_kw = morton_scene()
    payload = dict(
        routed=dict(prep=[np.asarray(x) for x in prep], kw=ROUTED_KW),
        render=dict(leaves(toy_scene()), kw=SET_KW, ev=EV, bg=BG),
        skew=dict(leaves(skew), kw=skew_kw, ev=EV, bg=BG),
        morton=dict(leaves(morton), kw=morton_kw, ev=EV, bg=BG),
        slab=slab_images(),
        hybrid=dict(leaves(toy_scene()), kw=SET_KW, evs=evs, gts=gts, bg=BG),
    )
    return torch_ranks.run(WORLD, "suite", payload, tmp_path_factory.mktemp("ranks"))


@pytest.fixture(scope="module")
def jax_routed():
    """JAX's RoutedBinning of every device at D = 4, stacked on axis 0,
    and the inputs to stage from it."""
    js, prep = routed_prep()

    @functools.partial(jax.shard_map, mesh=jmesh(1, D), in_specs=(P(),), out_specs=P("tiles"), check_vma=False)
    def run(prep):
        rb = jbinning.bin_gaussians_routed(prep, js, "tiles", D)
        return jax.tree_util.tree_map(lambda x: jnp.asarray(x)[None], rb)

    return js, prep, jax.jit(run)(prep)


# ---------------------------------------------------------------- geometry
def test_routed_local_cap_matches_jax_and_invariants():
    for cap, d, t in [
        (1024, 8, 4), (1024, 4, 4), (1 << 21, 8, 4080), (640, 4, 4),
        (1 << 17, 2, 512), (1 << 19, 8, 2040), (128 * 6, 2, 3), (1 << 18, 8, 128),
    ]:
        cap_pair, t_local, cap_local = tbinning.routed_local_cap(cap, d, t)
        assert (cap_pair, t_local, cap_local) == jbinning.routed_local_cap(cap, d, t)
        assert cap_local % tbinning.CHUNK == 0
        assert cap_local >= d * cap_pair + t_local
        assert t_local * d >= t
        assert cap_pair * max(1, min(d, t)) >= 2 * (cap // d)


def test_mesh_shapes(ranks):
    """tests/test_parallel.py::test_mesh_shapes on the 4-rank world: rank =
    dp_index * tiles + tile_index."""
    for rank, res in enumerate(ranks):
        m = res["mesh"]
        assert m["2x2"][:4] == ({"dp": 2, "tiles": 2}, rank // 2, rank % 2, rank)
        assert m["1x4"][:3] == ({"dp": 1, "tiles": 4}, 0, rank)
        assert m["4x1"][:3] == ({"dp": 4, "tiles": 1}, rank, 0)
        assert m["tiles4"][0] == {"dp": 1, "tiles": 4}
        assert m["default"][0] == {"dp": 1, "tiles": 4}
        assert m["default"][4] == "gloo"


# ---------------------------------------------------------------- routing
def test_bin_gaussians_routed_bitwise_jax(ranks, jax_routed):
    js, _, jrb = jax_routed
    t_local = tbinning.routed_local_cap(js.resolve_caps(400)[0], D, js.num_tiles)[1]
    assert js.num_tiles == 15 and t_local == 4
    for d, res in enumerate(ranks):
        rb = res["routed"]
        for name in ROUTED_FIELDS:
            a = np.asarray(getattr(jrb, name))[d]
            b = np.asarray(rb[name])
            assert b.shape == a.shape, name
            np.testing.assert_array_equal(b.astype(a.dtype), a, err_msg=f"rank {d} {name}")
        owned = rb["t1"] - rb["t0"]
        assert rb["t0"] == d * t_local and owned == (3 if d == D - 1 else 4)
        # the owned tiles' ranges end at their sentinels; padding tiles are empty
        ends, starts, sent, tid = rb["ends"], rb["starts"], rb["sent_sorted"], rb["tid_sorted"]
        assert sent[ends[:owned]].all() and (tid[ends[:owned]] == rb["t0"] + np.arange(owned)).all()
        assert (starts[1:owned] == ends[: owned - 1] + 1).all() and starts[0] == 0
        assert (starts[owned:] == ends[owned:]).all()
        assert int(rb["route_dropped"]) == 0 and int(rb["overflow"]) == 0
    assert sum(int((r["routed"]["sent_sorted"] == 0).sum()) for r in ranks) > 100  # real instances routed


def ranged_inputs(js, prep, jrb, d):
    """JAX's staged fields and meta for device d's routed array, and the
    port's K1 arguments for them (starts/ends of the owned tiles from the
    sentinel positions)."""
    rb = jax.tree_util.tree_map(lambda x: x[d], jrb)
    n = prep.depth.shape[0]
    cap, _ = js.resolve_caps(n)
    _, t_local, cap_local = jbinning.routed_local_cap(cap, D, js.num_tiles)
    table = jbinning.per_gaussian_table(prep, rb.offset)
    fields = jrast._build_fields_packed(table, rb.gid_sorted, rb.tid_sorted, rb.sent_sorted, rb.j_sorted,
                                        js.tiles_x, js.num_tiles, cap)
    meta = jnp.stack([rb.chunks_exec, rb.t0, rb.t1, jnp.int32(cap)]).astype(jnp.int32)
    owned = int(rb.t1 - rb.t0)
    ends = np.full(t_local, cap_local, np.int32)
    ends[:owned] = np.flatnonzero(np.asarray(rb.sent_sorted))[:owned]
    starts = ends.copy()
    starts[:owned] = np.concatenate([[0], ends[: owned - 1] + 1])
    args = (_t(fields), _t(rb.tile_lo), _t(meta), _t(starts), _t(ends))
    return fields, rb.tile_lo, meta, t_local, cap_local, owned, args


@pytest.mark.parametrize("d", [1, 2, 3])
def test_k1_k2_plain_tile_range_match_jax_kernels(jax_routed, d):
    js, prep, jrb = jax_routed
    fields, tile_lo, meta, t_local, cap_local, owned, args = ranged_inputs(js, prep, jrb, d)
    assert int(meta[1]) == d * t_local > 0 and int(meta[0]) > 0
    out_j = np.asarray(jrast._blend_forward_call_packed(t_local, cap_local, fields, tile_lo, meta))
    out_t = ttiles.forward(*args).numpy()
    assert out_t.shape == (t_local, 8, PIX)
    np.testing.assert_allclose(out_t[:owned, :5], out_j[:owned, :5], **K1_TOL)
    np.testing.assert_array_equal(out_t[:owned, 5:], out_j[:owned, 5:])
    assert not out_t[owned:].any()  # padding tiles stay zero in the plain version
    g = cotangent(t_local, seed=d)
    g[owned:] = 0.0
    gj = np.asarray(jrast._blend_backward_call_packed(t_local, cap_local, False, fields, tile_lo, meta,
                                                      jnp.asarray(out_j), jnp.asarray(g)))
    gt = ttiles.backward(*args, torch.as_tensor(out_t), torch.as_tensor(g)).numpy()
    for r in range(9):
        assert_normalized(gt[r], gj[r], GRAD_TOL, f"rank {d} row {r}")
    assert np.abs(gt[:9]).max() > 0 and not gt[10:].any()
    walked = gt[9] > 0
    np.testing.assert_array_equal(gt[9, walked], np.asarray(fields)[10, walked])


# ---------------------------------------------------------------- render
@pytest.mark.parametrize("shape", ["1x4", "2x2"])
def test_render_tile_sharded_matches_jax_and_single(ranks, shape):
    dp, tiles = map(int, shape.split("x"))
    scene = toy_scene()
    img_j, diag = _jrender(scene, jnp.asarray(EV), JSettings(**SET_KW), jnp.asarray(BG), jmesh(dp, tiles), True)
    assert int(diag["shard_route_dropped"]) == 0
    for res in ranks:
        img, dropped = res[f"render_{shape}"]
        assert dropped == 0
        np.testing.assert_allclose(img, np.asarray(img_j), atol=1e-5)
        np.testing.assert_allclose(img, res["render_single"], atol=1e-5)
    # every rank holds the same image
    for res in ranks[1:]:
        np.testing.assert_array_equal(res[f"render_{shape}"][0], ranks[0][f"render_{shape}"][0])


def test_tile_skew_trips_truncation_counter(ranks):
    """Every gaussian in one tile at a capacity tight enough that the owning
    rank's load exceeds the per-pair budget: dropped > 0, as JAX counts."""
    scene, kw = skew_scene()
    _, diag = _jrender(scene, jnp.asarray(EV), JSettings(**kw), jnp.asarray(BG), jmesh(1, D), True)
    for res in ranks:
        _, dropped, _, overflow, instances = res["skew"]
        assert overflow == 0 and instances > 2 * kw["instance_capacity"] // D
        assert dropped > 0 and dropped == int(diag["shard_route_dropped"])


def test_morton_coherent_source_does_not_drop(ranks):
    scene, kw = morton_scene()
    img_j = np.asarray(_jrender(scene, jnp.asarray(EV), JSettings(**kw), jnp.asarray(BG), jmesh(1, D), False))
    for res in ranks:
        img, dropped, single, overflow, _ = res["morton"]
        assert overflow == 0 and dropped == 0
        np.testing.assert_allclose(img, single, atol=1e-5)
        np.testing.assert_allclose(img, img_j, atol=1e-5)


def test_slab_loss_matches_full(ranks):
    mesh = jmesh(1, D)

    @jax.jit
    @functools.partial(jax.shard_map, mesh=mesh, in_specs=(P(),) * 2, out_specs=P(), check_vma=False)
    def sharded(p, t):
        return jloss_rows(p, t, 0.2, "tiles")[None]

    for i, (pred, gt) in enumerate(slab_images()):
        want = float(jlosses.photometric_loss(jnp.asarray(pred), jnp.asarray(gt), 0.2))
        got_j = float(sharded(jnp.asarray(pred), jnp.asarray(gt))[0])
        for res in ranks:
            np.testing.assert_allclose(res["slab"][i], want, rtol=2e-6, atol=2e-7)
            np.testing.assert_allclose(res["slab"][i], got_j, rtol=2e-6, atol=2e-7)


# ---------------------------------------------------------------- training
def jax_two_camera_grads(settings):
    evs, gts = hybrid_batch()
    state = jtrainer.create_train_state(toy_scene(), JOpt(), 1.0)
    s0 = state.scene.update_observers()
    params = jtrainer.scene_params(s0)

    def loss_fn(params):
        s = jtrainer.with_params(s0, params)
        total = 0.0
        for b in range(2):
            out = jtrainer.render_scene(s, jnp.asarray(evs[b]), settings, jnp.asarray(BG))
            total = total + jlosses.photometric_loss(out["render"], jnp.asarray(gts[b]), JOpt().lambda_dssim)
        return total / 2

    loss, g = jax.jit(jax.value_and_grad(loss_fn))(params)
    return loss, g, params, state


def test_hybrid_gradients_match_jax(ranks):
    loss_j, g_j, _, _ = jax_two_camera_grads(JSettings(**SET_KW, fast_grad=False))
    for res in ranks:
        loss, grads, dropped = res["hybrid_grads"]
        assert dropped == 0
        np.testing.assert_allclose(loss, float(loss_j), rtol=1e-5)
        assert set(grads) == set(g_j)
        for k, gk in grads.items():
            assert_normalized(gk, np.asarray(g_j[k]), GRAD_TOL, k)
        assert np.abs(grads["xyz"]).max() > 0


def test_hybrid_step_matches_jax_and_replicas_agree(ranks):
    """tests/test_parallel.py::test_hybrid_train_step_runs_and_matches: the
    parameters after one step at atol 5e-5 from a single-device Adam step
    on JAX's single-device gradients; every rank's replica bitwise equal."""
    loss_j, g_j, params, state = jax_two_camera_grads(JSettings(**SET_KW))
    tx = jtrainer.make_optimizer(JOpt(), 1.0)
    updates, _ = tx.update(g_j, state.opt_state, params)
    expected = jax.tree_util.tree_map(lambda p, u: p + u, params, updates)
    orig = toy_scene()
    for res in ranks:
        loss, dropped, got, step, count = res["hybrid_step"]
        assert np.isfinite(loss) and dropped == 0 and step == 1 and count == 1
        np.testing.assert_allclose(loss, float(loss_j), rtol=1e-5)
        assert np.abs(got["xyz"] - np.asarray(orig.xyz)).max() > 0
        for k in expected:
            np.testing.assert_allclose(got[k], np.asarray(expected[k]), atol=5e-5, err_msg=k)
    for res in ranks[1:]:
        for k, v in res["hybrid_step"][2].items():
            np.testing.assert_array_equal(v, ranks[0]["hybrid_step"][2][k], err_msg=k)
