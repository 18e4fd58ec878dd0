"""The port's bench entry points (c3dgs_tpu_torch.tools: bench,
bench_render, profile_bench, dispatch_probe, cumsum_probe) against the
repo's bench.py, bench_render.py and tools/*.py on the CPU.

Bars:
- bench at 2,000 splats and 128x96: the scene tensors equal to bench.py's
  recipe (rebuilt here from bench.py:34-62; the kNN scales at atol 1e-6,
  tests/test_torch_data.py), features_rest zero and the active SH degree
  0 in both packages; the probe's num_instances and grad_total and the
  two buckets equal; the seven gradients of the L1 loss against jax.grad
  at normalized 5e-2 (the default fast_grad) and 5e-4 (fast_grad=False,
  tests/test_render.py:150). At bench.py's probe-exact execution bucket
  JAX's training reduction drops emissions past the bucket's index
  (ROADMAP C), so the JAX side reduces over the whole permutation here
  (test_torch_backward._jax_reduce_every_emission); main() with --device
  cpu prints bench.py's JSON keys (read from bench.py's source) and a
  finite floor; no TPU constant of bench.py's floor is in the port;
- bench_render at 5,000 splats: fidx and gidx equal to bench_render.py's
  stream (rebuilt here), the codebooks the dense scene's first 4,096
  rows, each mode's image against JAX's render_scene at its probe-exact
  buckets at atol 2e-5 / rtol 1e-4 (tests/test_render.py:113), the
  instance counts equal; main() prints the two metric lines;
- profile_bench.build_step(packed 0 and 1) against tools/profile_bench.py's
  build_step at the same n, width and height: the printed instance and
  bucket line equal, the seven gradients at normalized 5e-2 (JAX's
  reduction patched as above for the packed family);
- dispatch_probe's one- and two-camera xyz gradients against JAX's,
  rebuilt from tools/dispatch_probe.py:40-88 at 2,000 splats, at
  normalized 5e-2, the buckets equal;
- cumsum_probe at 4,096 rows (ROWS patched in both tools): each
  formulation against the JAX tool's counterpart at atol 1e-4 (values up
  to ~200; the summation orders differ), the one-pass bf16 matmul against
  a float64 product of the bf16-rounded rows at 1e-4;
- each tool raises without a card unless given --device cpu.
"""
import ast
import dataclasses
import importlib.util
import json
import math
import os
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_cpu  # noqa: F401  (one torch thread per test worker)
from test_torch_backward import FAST_TOL, GRAD_TOL, _jax_reduce_every_emission, assert_normalized  # noqa: E402

from c3dgs_tpu.eval import metrics as jmetrics  # noqa: E402
from c3dgs_tpu.models import gaussians as jgmod  # noqa: E402
from c3dgs_tpu.ops import losses as jlosses  # noqa: E402
from c3dgs_tpu.render import rasterizer as jrast  # noqa: E402
from c3dgs_tpu.render.capacity import CapacityPolicy as JPolicy  # noqa: E402
from c3dgs_tpu.render.types import RasterSettings as JSettings  # noqa: E402
from c3dgs_tpu.train import trainer as jtrainer  # noqa: E402
from c3dgs_tpu_torch.tools import bench as tbench  # noqa: E402
from c3dgs_tpu_torch.tools import bench_render as trender  # noqa: E402
from c3dgs_tpu_torch.tools import cumsum_probe as tcumsum  # noqa: E402
from c3dgs_tpu_torch.tools import dispatch_probe as tdispatch  # noqa: E402
from c3dgs_tpu_torch.tools import profile_bench as tprofile  # noqa: E402
from c3dgs_tpu_torch.train import trainer as ttrainer  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, W, H = 2000, 128, 96
EV = np.asarray([0, 0, 0, 1, 0, 0, 0], np.float32)
IMG_TOL = dict(atol=2e-5, rtol=1e-4)  # tests/test_render.py:113
NAMES = ("xyz", "features_dc", "features_rest", "opacity", "scaling", "scaling_factor", "rotation")
TOOLS = {"bench": tbench, "bench_render": trender, "profile_bench": tprofile, "dispatch_probe": tdispatch,
         "cumsum_probe": tcumsum}


def load_jax_tool(rel):
    """A repo script loaded by path, its persistent-cache setting skipped
    (the scripts point JAX's compilation cache at a directory of their
    own when imported)."""
    spec = importlib.util.spec_from_file_location("jax_" + os.path.basename(rel)[:-3], os.path.join(REPO, rel))
    mod = importlib.util.module_from_spec(spec)
    real = jax.config.update
    jax.config.update = lambda k, v: None if k.startswith("jax_compilation_cache") else real(k, v)
    try:
        spec.loader.exec_module(mod)
    finally:
        jax.config.update = real
    return mod


def jax_bench_scene(n, trained=True):
    """bench.py:34-62 (bench_render.py:40-48 without the opacity draw)."""
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(n, 3)).astype(np.float32) * 2.0
    pts[:, 2] += 6.0
    cols = rng.random(size=(n, 3)).astype(np.float32)
    scene = jgmod.from_point_cloud(pts, cols, capacity=n, quantization=False)
    scene = scene.replace(scaling_factor=scene.scaling_factor + math.log(0.15))
    if trained:
        op = np.clip(rng.beta(0.5, 0.35, size=(n, 1)), 0.005, 0.995)
        scene = scene.replace(opacity=jnp.asarray(np.log(op / (1.0 - op)).astype(np.float32)))
    return scene, rng


def jax_settings(width=W, height=H, **kw):
    return JSettings(width=width, height=height, tanfovx=math.tan(0.6), tanfovy=math.tan(0.6), sh_degree=3, **kw)


def jax_exact(scene, settings, ev=EV, grad_min=0):
    """bench.py:89-107: the probe at 2^21 slots, then the buckets."""
    probe = jmetrics._jit_render_scene(scene, jnp.asarray(ev), JPolicy(initial=1 << 21).apply(settings),
                                       jnp.zeros(3))
    need, grad_need = int(probe["num_instances"]), int(probe["grad_total"])
    st = JPolicy(initial=need + settings.num_tiles, grad_initial=max(grad_need, grad_min)).apply(settings)
    return st, need, grad_need


def jax_bench_grads(scene, settings):
    """bench.py:127-145's step: the L1 gradients to the seven parameters."""
    gt = jnp.zeros((3, settings.height, settings.width))

    def loss_fn(*params):
        s = scene.replace(**dict(zip(NAMES, params)))
        return jlosses.l1_loss(jtrainer.render_scene(s, jnp.asarray(EV), settings, jnp.zeros(3))["render"], gt)

    return jax.jit(jax.grad(loss_fn, argnums=tuple(range(7))))(*(getattr(scene, k) for k in NAMES))


def t2n(x):
    return x.detach().cpu().numpy()


@pytest.fixture(scope="module")
def bench_pair():
    js, _ = jax_bench_scene(N)
    ts = tbench.bench_scene(N, True, "cpu")
    return js, ts


# ------------------------------------------------------------------ bench
def test_bench_scene_matches_jax_recipe(bench_pair):
    js, ts = bench_pair
    for k in NAMES:
        np.testing.assert_allclose(t2n(getattr(ts, k)), np.asarray(getattr(js, k)), atol=1e-6, rtol=0, err_msg=k)
    for k in ("xyz", "features_dc", "features_rest", "opacity", "rotation"):
        np.testing.assert_array_equal(t2n(getattr(ts, k)), np.asarray(getattr(js, k)), err_msg=k)
    assert not ts.features_rest.any() and not np.asarray(js.features_rest).any()
    assert ts.active_sh_degree == int(js.active_sh_degree) == 0


def test_bench_buckets_match_jax(bench_pair):
    js, ts = bench_pair
    jst, jneed, jgrad = jax_exact(js, jax_settings())
    ev, bg = torch.as_tensor(EV), torch.zeros(3)
    tst, tneed, tgrad = tbench.exact_settings(ts, ev, tbench.base_settings(W, H), bg)
    assert (tneed, tgrad) == (jneed, jgrad) and tneed > N
    assert (tst.instance_capacity, tst.grad_capacity) == (jst.instance_capacity, jst.grad_capacity)
    chk = tbench.probe(ts, ev, tst, bg)
    assert chk["overflow"] == chk["grad_overflow"] == 0


@pytest.mark.parametrize("fast_grad", [True, False], ids=["fast_grad", "exact"])
def test_bench_gradients_match_jax(bench_pair, fast_grad, monkeypatch):
    js, ts = bench_pair
    jst, _, _ = jax_exact(js, jax_settings(fast_grad=fast_grad))
    tst, _, _ = tbench.exact_settings(ts, torch.as_tensor(EV), tbench.base_settings(W, H), torch.zeros(3))
    tst = dataclasses.replace(tst, fast_grad=fast_grad)
    monkeypatch.setattr(jrast, "_reduce_instance_grads_packed", _jax_reduce_every_emission)
    gj = jax_bench_grads(js, jst)
    gt = tbench.make_step(ts, torch.as_tensor(EV), tst, torch.zeros(3))()
    for name, a, b in zip(NAMES, gj, gt):
        assert np.isfinite(t2n(b)).all(), name
        assert_normalized(t2n(b), np.asarray(a), FAST_TOL if fast_grad else GRAD_TOL, name)
    assert np.abs(t2n(gt[0])).max() > 0 and np.abs(t2n(gt[3])).max() > 0


def json_keys(path):
    """The keys of the dicts a script passes to json.dumps, in order."""
    tree = ast.parse(open(os.path.join(REPO, path)).read())
    return [[k.value for k in node.args[0].keys] for node in ast.walk(tree)
            if isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "dumps"
            and isinstance(node.args[0], ast.Dict)]


def test_bench_main_prints_bench_keys(monkeypatch, capsys):
    for k, v in dict(N=N, RES=f"{W}x{H}", ITERS=1, BLOCKS=1).items():
        monkeypatch.setenv(f"C3DGS_BENCH_{k}", str(v))
    res = tbench.main(["--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    line = json.loads(out[-1])
    (keys,) = json_keys("bench.py")
    assert list(line) == keys and line == res["line"]
    assert line["metric"] == f"rasterize_fwd_bwd_ms_per_frame_{W}x{H}_{N}g"
    floor_keys = ["pair_math", "row_ops", "sorts", "total"]  # bench.py:236-241
    assert list(line["floor_ms"]) == floor_keys and all(math.isfinite(v) for v in line["floor_ms"].values())
    assert line["floor_ms"]["total"] > 0 and line["opacity_mode"] == "trained"
    assert out[0].startswith(f"# instances={res['instances']} -> capacity bucket ")
    assert out[-2].startswith("# card cpu; 7 steps") and res["bitwise_repeatable"]


def test_port_has_no_tpu_floor_constant():
    """bench.py's floor reckons 0.96 Top/s of VPU and 6 ns a gathered row
    (bench.py:230-231): TPU figures that no port module may carry."""
    root = os.path.join(REPO, "c3dgs_tpu_torch")
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f.endswith((".py", ".cu", ".cuh", ".cpp")):
                text = open(os.path.join(dirpath, f)).read()
                assert "0.96e12" not in text and "6e-9" not in text, f


# ------------------------------------------------------------ bench_render
RN = 5000


@pytest.fixture(scope="module")
def render_pair():
    js, rng = jax_bench_scene(RN, trained=False)
    k = 1 << 12
    fidx = rng.integers(0, k, size=RN)
    gidx = rng.integers(0, k, size=RN)
    jidx = js.replace(features_dc=js.features_dc[:k], features_rest=js.features_rest[:k], scaling=js.scaling[:k],
                      rotation=js.rotation[:k], feature_indices=jnp.asarray(fidx, jnp.int32),
                      gaussian_indices=jnp.asarray(gidx, jnp.int32))
    return (js, jidx, fidx, gidx), trender.scenes(RN, "cpu")


def test_bench_render_indices_match_jax_stream(render_pair):
    (js, _, fidx, gidx), (dense, indexed, tf, tg) = render_pair
    np.testing.assert_array_equal(tf, fidx)
    np.testing.assert_array_equal(tg, gidx)
    np.testing.assert_array_equal(t2n(indexed.feature_indices), fidx)
    np.testing.assert_array_equal(t2n(indexed.gaussian_indices), gidx)
    for k in ("features_dc", "features_rest", "scaling", "rotation"):
        np.testing.assert_array_equal(t2n(getattr(indexed, k)), t2n(getattr(dense, k))[:4096], err_msg=k)
    np.testing.assert_array_equal(t2n(dense.xyz), np.asarray(js.xyz))
    np.testing.assert_array_equal(t2n(dense.opacity), np.asarray(js.opacity))
    assert indexed.capacity < ttrainer.BLOCKED_COLORS_MIN  # colors gathered densely, as JAX decides


@pytest.mark.parametrize("mode", ["dense", "indexed"])
def test_bench_render_images_match_jax(render_pair, mode):
    (js, jidx, _, _), (dense, indexed, _, _) = render_pair
    jscene, tscene = (js, dense) if mode == "dense" else (jidx, indexed)
    jst, jneed, _ = jax_exact(jscene, jax_settings(inference=True))
    tst = trender.exact_settings(tscene, torch.as_tensor(EV), trender.settings_for(W, H), torch.zeros(3))
    assert (tst.instance_capacity, tst.grad_capacity) == (jst.instance_capacity, jst.grad_capacity)
    oj = jmetrics._jit_render_scene(jscene, jnp.asarray(EV), jst, jnp.zeros(3))
    with torch.no_grad():
        ot = ttrainer.render_scene(tscene, EV, tst, np.zeros(3), device="cpu")
    assert int(ot["num_instances"]) == int(oj["num_instances"]) == jneed and int(ot["overflow"]) == 0
    np.testing.assert_allclose(t2n(ot["render"]), np.asarray(oj["render"]), **IMG_TOL)


def test_bench_render_main_prints_two_lines(monkeypatch, capsys):
    for k, v in dict(N=RN, RES=f"{W}x{H}", ITERS=1).items():
        monkeypatch.setenv(f"C3DGS_BENCH_{k}", str(v))
    res = trender.main(["--device", "cpu"])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    (keys,) = json_keys("bench_render.py")
    assert [x["metric"] for x in lines] == [f"render_fwd_ms_per_frame_{W}x{H}_{RN}g_{m}" for m in ("dense", "indexed")]
    assert all(list(x) == keys for x in lines) and lines == res["lines"]
    assert res["calls"] == {"tiles_packed_fwd": 2 * (2 + 2 * 1)}


# ----------------------------------------------------------- profile_bench
@pytest.mark.parametrize("packed", [1, 0], ids=["packed", "per_tile"])
def test_profile_bench_build_step_matches_jax(packed, monkeypatch, capsys):
    jtool = load_jax_tool("tools/profile_bench.py")
    monkeypatch.setattr(jrast, "_reduce_instance_grads_packed", _jax_reduce_every_emission)
    jstep, jargs = jtool.build_step(bool(packed), n=N, width=W, height=H)
    jline = capsys.readouterr().out
    tstep, targs = tprofile.build_step(bool(packed), N, W, H, "cpu")
    tline = capsys.readouterr().out
    assert tline == jline and jline.startswith("# instances=")
    gj, gt = jstep(*jargs), tstep(*targs)
    for name, a, b in zip(NAMES, gj, gt):
        assert_normalized(t2n(b), np.asarray(a), FAST_TOL, name)
    assert np.abs(t2n(gt[0])).max() > 0


# ---------------------------------------------------------- dispatch_probe
def test_dispatch_probe_gradients_match_jax(bench_pair, monkeypatch):
    """tools/dispatch_probe.py:40-88 at N splats and W x H."""
    js, _ = bench_pair
    settings = jax_settings()
    ev1, ev2 = jnp.asarray(EV), jnp.asarray([0, 0.02, 0, 1, 0.05, 0, 0], jnp.float32)
    probe = jmetrics._jit_render_scene(js, ev1, settings, jnp.zeros(3))
    need, grad_need = int(probe["num_instances"]), int(probe["grad_total"])
    settings = JPolicy(initial=int(need * 1.12), grad_initial=int(grad_need * 1.04)).apply(settings)
    gt = jnp.zeros((3, H, W))
    monkeypatch.setattr(jrast, "_reduce_instance_grads_packed", _jax_reduce_every_emission)

    def loss_one(xyz, ev):
        return jlosses.l1_loss(jtrainer.render_scene(js.replace(xyz=xyz), ev, settings, jnp.zeros(3))["render"], gt)

    j1 = jax.jit(jax.grad(lambda xyz: loss_one(xyz, ev1)))(js.xyz)
    j2 = jax.jit(jax.grad(lambda xyz: loss_one(xyz, ev1) + loss_one(xyz, ev2)))(js.xyz)
    g1, g2, counts = tdispatch.build(N, W, H, "cpu")
    assert counts[0]["num_instances"] == need and all(c["overflow"] == c["grad_overflow"] == 0 for c in counts)
    for name, a, b in (("one camera", j1, g1()), ("two cameras", j2, g2())):
        assert_normalized(t2n(b), np.asarray(a), FAST_TOL, name)
    assert not torch.equal(g1(), g2())


# ------------------------------------------------------------ cumsum_probe
def jax_cumsum_tool(rows, monkeypatch):
    """tools/cumsum_probe.py with ROWS patched, and its matmul_hp (defined
    inside main()) lifted to the module."""
    jtool = load_jax_tool("tools/cumsum_probe.py")
    src = open(os.path.join(REPO, "tools/cumsum_probe.py")).read()
    (node,) = [n for n in ast.walk(ast.parse(src)) if isinstance(n, ast.FunctionDef) and n.name == "matmul_hp"]
    exec(textwrap.dedent(ast.get_source_segment(src, node)), jtool.__dict__)
    monkeypatch.setattr(jtool, "ROWS", rows)
    return jtool


@pytest.mark.parametrize("name", list(tcumsum.FORMULATIONS))
def test_cumsum_formulations_match_jax(name, monkeypatch):
    rows = 8 * tcumsum.K
    monkeypatch.setattr(tcumsum, "ROWS", rows)
    jtool = jax_cumsum_tool(rows, monkeypatch)
    x = np.random.default_rng(0).normal(size=(rows, tcumsum.COLS)).astype(np.float32)
    xt = torch.as_tensor(x)
    got = tcumsum.transposed(xt.T.contiguous()).T if name == "transposed" else tcumsum.FORMULATIONS[name](xt)
    if name == "matmul_bf16":
        y = t2n(torch.as_tensor(x).to(torch.bfloat16).float()).astype(np.float64)
        want = np.cumsum(y, 0)
    else:
        jfn = {"cumsum": jtool.xla_cumsum, "transposed": jtool.xla_cumsum, "twolevel": jtool.twolevel,
               "matmul": jtool.matmul_prefix, "matmul_hp": jtool.matmul_hp}[name]
        want = np.asarray(jax.jit(jfn)(jnp.asarray(x)))
        oracle = np.cumsum(x.astype(np.float64), 0)
        assert np.abs(want - oracle).max() < 1e-4
    assert got.shape == (rows, tcumsum.COLS)
    np.testing.assert_allclose(t2n(got), want, atol=1e-4, rtol=0)


def test_cumsum_probe_main_prints_each_formulation(monkeypatch, capsys):
    monkeypatch.setattr(tcumsum, "ROWS", 4 * tcumsum.K)
    res = tcumsum.main(["--device", "cpu", "--calls", "1"])
    out = capsys.readouterr().out.splitlines()
    assert [x.split()[0] for x in out[:-1]] == list(tcumsum.FORMULATIONS)
    assert json.loads(out[-1]) == res["formulations"]
    assert all(v["max_abs_err"] < 1e-4 for k, v in res["formulations"].items() if k != "matmul_bf16")
    assert all(isinstance(v["equals_sequential_fp32"], bool) for v in res["formulations"].values())
    assert 0 < res["sequential_fp32_err"] < 1e-4


# -------------------------------------------------------------- no card
@pytest.mark.parametrize("tool", list(TOOLS))
def test_tools_need_a_card_unless_told_cpu(tool, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TOOLS[tool].main([])
