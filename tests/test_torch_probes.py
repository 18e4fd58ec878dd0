"""The port's probes (c3dgs_tpu_torch.tools: saturation_probe, clamp_probe,
scale_train_probe, dcn_probe) against the JAX package's tools/*.py on
the CPU.

Bars:
- parsers: the JAX tools' options, defaults, types and actions; the port
  adds --device everywhere and --out_dir to clamp_probe (whose JAX version
  writes the repo's output/CLAMP_PROBE.json) and dcn_probe (JAX:
  MULTIPROC_r04.json); output-directory defaults differ;
- numpy draws bitwise: the saturation and clamp scenes (captured from
  the JAX tools, which build them inside main(), with from_point_cloud
  replaced by a stub and the render stopping the run), the scale probe's
  GT scene (from_point_cloud's scales at atol 1e-6,
  tests/test_torch_data.py), its cameras at 1e-6 and its noisy init;
- scale_train_probe at the JAX smoke's size (tests/test_tools_smoke.py:
  6 steps, 1500 / 1200 points, 2 views, 256x128) in both packages, the
  JAX tool in a child process: SCALE_TRAIN.json's and the log's keys;
  step, active and capacity exactly; instances exactly at step 0 (the
  first render) and within 0.1% at step 5; ema_psnr at atol 1e-3
  (tests/test_torch_cli.py's bar); the clamp rows' dropped counts obey
  dropped = true instances - capacity + tiles exactly in both packages,
  their true instances within 0.1% and PSNRs within 0.1 dB. After the
  first step the packages part: the default fast_grad reduction sums
  without compensation, and on this dense frame (22k instances in 64
  tiles) its covariance gradients lie 24% (JAX) and 5.9% (the port) of
  their largest entry from the oracle's, normalized, in different
  entries (with fast_grad False both agree with it to 7.6e-5); Adam's
  eps of 1e-15 turns each such entry into a +-lr move (tests/ply_bars.py),
  which moves a few splats across tiles;
- a port run with the densify cadence moved early reaches a densify and
  the capacity growth; the loop's schedule equals the JAX tool's
  conditions at every step of the default 2000 and of 500;
- the clamp helper on a small clamped frame against
  c3dgs_tpu.train.trainer.render_scene: true instances and dropped
  counts equal, images at atol 2e-5 / rtol 1e-4 (tests/test_render.py:
  113), PSNRs at rtol 1e-3; clamp_probe's JSON keys are the JAX tool's;
- the saturation report against the JAX tool's own statements on the
  same arrays, and on the freezing wall scene (tests/test_torch_render.py)
  the port's report against the one made from JAX's K1 outputs;
- dcn_probe --device cpu end to end: two torchrun nodes of 4 gloo ranks,
  each tiles group on one node, parameters within 5e-5 of the
  single-device step, loss within 1e-5, route_dropped 0;
- the capacity policy stops at MAX_BINNING_CAP where the JAX policy's
  next bucket makes resolve_caps refuse (a reference fault, ROADMAP C);
  at that ceiling render_full and calc_importance refuse an overflowing
  frame and finetune prints each step it trains clamped; the clamp
  helper refuses an exact frame that overflows;
- the scale probe's first-frame instance count (tests/scale_init_counts.py)
  equal in both packages with the exact and the Morton-window kNN init;
- each tool raises without a card unless given --device cpu.
"""
import ast
import dataclasses
import json
import math
import os
import runpy
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_cpu  # noqa: F401  (one torch thread per test worker)
from test_torch_evidence import _Stop, load_jax_tool, parser_of  # noqa: E402
from test_torch_gpu import EV, SCENES  # noqa: E402
from test_torch_render import staged  # noqa: E402
from test_torch_serve import carry_over  # noqa: E402

from c3dgs_tpu import config as jconfig  # noqa: E402
from c3dgs_tpu.eval import metrics as jmetrics  # noqa: E402
from c3dgs_tpu.models import gaussians as jgmod  # noqa: E402
from c3dgs_tpu.render import rasterizer as jrast  # noqa: E402
from c3dgs_tpu.render.capacity import CapacityPolicy as JPolicy  # noqa: E402
from c3dgs_tpu.render.types import RasterSettings as JSettings  # noqa: E402
from c3dgs_tpu.train import trainer as jtrainer  # noqa: E402
from c3dgs_tpu_torch.render.types import RasterSettings as TSettings  # noqa: E402
from c3dgs_tpu_torch.tools import clamp_probe as tcp  # noqa: E402
from c3dgs_tpu_torch.tools import dcn_probe as tdcn  # noqa: E402
from c3dgs_tpu_torch.tools import saturation_probe as tsat  # noqa: E402
from c3dgs_tpu_torch.tools import scale_train_probe as tstp  # noqa: E402
from c3dgs_tpu_torch.tools import scenes  # noqa: E402
from c3dgs_tpu_torch.train import trainer as ttrainer  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = ["--device", "cpu"]
SMOKE = ["--steps", "6", "--n_init", "1500", "--n_gt", "1200", "--n_views", "2", "--res", "256x128"]
IMG_TOL = dict(atol=2e-5, rtol=1e-4)  # tests/test_render.py:113
TOOLS = {"saturation_probe": tsat, "clamp_probe": tcp, "scale_train_probe": tstp, "dcn_probe": tdcn}

jsat = load_jax_tool("tools/saturation_probe.py")
jcp = load_jax_tool("tools/clamp_probe.py")
jstp = load_jax_tool("tools/scale_train_probe.py")


def jax_source(name):
    return open(os.path.join(REPO, "tools", f"{name}.py")).read()


def main_statements(tree, first, last):
    """The statements of the JAX tool's main() from the one assigning
    `first` through the one assigning `last`."""
    main = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")
    names = [[ast.unparse(t) for t in getattr(s, "targets", [])] for s in main.body]
    i = next(k for k, t in enumerate(names) if first in t)
    j = next(k for k, t in enumerate(names) if last in t)
    return ast.Module(body=main.body[i:j + 1], type_ignores=[])


def dict_with(tree, key):
    """The first dict literal of the tree that has `key` among its keys."""
    return next(n for n in ast.walk(tree) if isinstance(n, ast.Dict)
                and any(isinstance(k, ast.Constant) and k.value == key for k in n.keys))


def keys_of(node):
    """A dict literal's keys, nested dicts as (key, keys)."""
    return [(k.value, keys_of(v)) if isinstance(v, ast.Dict) else k.value for k, v in zip(node.keys, node.values)]


def port_keys(d):
    return [(k, port_keys(v)) if isinstance(v, dict) else k for k, v in d.items()]


# ------------------------------------------------------ scale_train_probe
@pytest.fixture(scope="module")
def jax_smoke(tmp_path_factory):
    """The JAX tool at the smoke size in a child process (as
    tests/test_tools_smoke.py runs it), started first: its ~50 s overlap
    the port's tests in this file."""
    out = tmp_path_factory.mktemp("jax_scale_train")
    proc = subprocess.Popen([sys.executable, "tools/scale_train_probe.py", *SMOKE, "--out_dir", str(out)], cwd=REPO,
                            env=dict(os.environ, C3DGS_FORCE_CPU="1"), stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    try:
        yield out, proc
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def port_smoke(jax_smoke, tmp_path_factory):
    out = tmp_path_factory.mktemp("port_scale_train")
    return tstp.main([*SMOKE, "--out_dir", str(out), *CPU]), out


def read_log(out):
    return [json.loads(line) for line in open(out / "scale_train_log.jsonl")]


def test_scale_train_probe_writes_the_jax_keys(port_smoke):
    res, out = port_smoke
    assert res == json.loads((out / "SCALE_TRAIN.json").read_text())
    tree = ast.parse(jax_source("scale_train_probe"))
    assert list(res) == keys_of(dict_with(tree, "clamp_experiment")) + ["card", "clamped_steps", "max_overflow"]
    assert res["card"] == "cpu" and res["clamped_steps"] == res["max_overflow"] == 0
    assert [list(r) for r in res["clamp_experiment"]] == [keys_of(dict_with(tree, "dropped"))] * 4
    assert [list(r) for r in read_log(out)] == [keys_of(dict_with(tree, "ema_psnr"))] * 2
    assert res["steps"] == 6 and res["capacity_growths"] == 0 and math.isfinite(res["final_ema_psnr"])


def clamp_identity(rows, true_inst, tiles):
    for r in rows:
        cap = int(true_inst * r["capacity_fraction"]) // 128 * 128
        assert r["dropped"] == true_inst - cap + tiles, r


def test_scale_train_probe_schedule_matches_jax():
    """The loop's conditions, the JAX tool's own expressions evaluated at
    every step."""
    tree = ast.parse(jax_source("scale_train_probe"))
    main = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")
    consts = [s for s in main.body if isinstance(s, ast.Assign) and ast.unparse(s.targets[0]) in
              ("densify_every", "densify_from", "densify_until", "reset_every", "degree_every")]
    loop = next(s for s in main.body if isinstance(s, ast.For))
    tests = [ast.unparse(s.test) for s in ast.walk(loop) if isinstance(s, ast.If)]
    assert len(tests) == 5  # densify, the growth inside it, reset, degree, log
    marks = {"densify": "densify_from", "reset": "reset_every", "degree": "degree_every", "log": "steps - 1"}
    conds = {k: next(c for c in tests if m in c) for k, m in marks.items()}
    for steps in (2000, 500):
        ns = {"steps": steps, "int": int, "max": max}
        exec(compile(ast.Module(body=consts, type_ignores=[]), "jax_cadence", "exec"), ns)
        for it in range(steps):
            want = {k: bool(eval(c, dict(ns, it=it))) for k, c in conds.items()}
            assert tstp.schedule(it, steps) == want, (steps, it)
    at = [it for it in range(500) if tstp.schedule(it, 500)["densify"]]
    assert at == [300]


def test_scale_train_probe_densifies_and_grows(tmp_path, monkeypatch):
    """The cadence moved to step 2 of 6: 1500 points in 1792 rows leave
    292 free, under max(4096, 375), so the capacity doubles first."""
    monkeypatch.setattr(tstp, "DENSIFY_FROM", 1)
    monkeypatch.setattr(tstp, "DENSIFY_EVERY", 2)
    calls = []
    real = ttrainer.densify_step

    def counted(state, *a, **kw):
        calls.append(state.scene.capacity)
        return real(state, *a, **kw)

    monkeypatch.setattr(ttrainer, "densify_step", counted)
    res = tstp.main([*SMOKE, "--out_dir", str(tmp_path), *CPU])
    assert calls == [3584] and res["capacity_growths"] == 1 and res["final_capacity"] == 3584
    log = read_log(tmp_path)
    assert [r["capacity"] for r in log] == [1792, 3584] and log[-1]["active"] >= 1500


def test_scale_train_probe_counts_its_clamped_steps(tmp_path, monkeypatch, capsys):
    """A first bucket of 8,192 slots: step 0's frame of 22,213 instances
    trains clamped (as in the JAX tool, it is not rendered again), the
    policy grows and no later step clamps."""
    real = tstp.CapacityPolicy
    monkeypatch.setattr(tstp, "CapacityPolicy", lambda initial: real(initial=min(initial, 8192)))
    from c3dgs_tpu_torch.render import capacity

    monkeypatch.setattr(capacity, "MIN_CAPACITY", 1024)
    res = tstp.main([*SMOKE, "--out_dir", str(tmp_path), *CPU])
    first = read_log(tmp_path)[0]["instances"]
    tiles = TSettings(width=256, height=128, tanfovx=1, tanfovy=1).num_tiles
    assert res["clamped_steps"] == 1 and res["max_overflow"] == first - (8192 - tiles)
    lines = [x for x in capsys.readouterr().out.splitlines() if "trained clamped" in x]
    assert len(lines) == 1 and lines[0].startswith("[capacity] step 0: trained clamped below the ceiling"), lines


def test_scale_train_probe_draws_match_jax(monkeypatch):
    seen = {"scenes": [], "evs": []}
    real = jgmod.from_point_cloud

    def capture_scene(pts, cols, **kw):
        seen["scenes"].append((pts, cols, kw))
        if len(seen["scenes"]) == 2:
            raise _Stop
        return real(pts, cols, **kw)

    def blank(scene, ev, settings, bg, policy=None):
        seen.update(gt=scene, settings=settings)
        seen["evs"].append(np.asarray(ev))
        return {"render": jnp.zeros((3, settings.height, settings.width))}

    monkeypatch.setattr(jconfig, "setup_jax_cache", lambda *a, **k: None)
    monkeypatch.setattr(jgmod, "from_point_cloud", capture_scene)
    monkeypatch.setattr(jmetrics, "render_full", blank)
    monkeypatch.setattr(sys, "argv", ["scale_train_probe.py", "--n_gt", "1200", "--n_init", "1500", "--n_views", "3"])
    with pytest.raises(_Stop):
        jstp.main()
    rng = np.random.default_rng(11)
    a = tstp.gt_arrays(rng, 1200)
    gt = tstp.make_gt_scene(a, "cpu")
    jgt = seen["gt"]
    for f in ("xyz", "features_dc", "features_rest", "opacity", "rotation", "active"):
        np.testing.assert_array_equal(getattr(gt, f).detach().numpy(), np.asarray(getattr(jgt, f)), err_msg=f)
    for f in ("scaling_factor", "scaling"):
        np.testing.assert_allclose(getattr(gt, f).detach().numpy(), np.asarray(getattr(jgt, f)), atol=1e-6, rtol=0)
    assert gt.active_sh_degree == jgt.active_sh_degree == 3
    for i, ev in enumerate(seen["evs"]):
        np.testing.assert_allclose(tstp.cam(2 * math.pi * i / 3), ev, atol=1e-6, rtol=0)
    st = seen["settings"]
    assert (st.width, st.height, st.tanfovx, st.tanfovy, st.sh_degree) == (1920, 1080, math.tan(0.5), math.tan(0.32), 3)
    pts0, cols0 = tstp.init_arrays(rng, 1500)
    np.testing.assert_array_equal(pts0, seen["scenes"][1][0])
    np.testing.assert_array_equal(cols0, seen["scenes"][1][1])
    assert seen["scenes"][1][2] == {"capacity": 1792, "quantization": True}


def test_capacity_policy_stops_at_the_slot_domain():
    """The 1M-point init's first 1080p frame on the card held 17,163,249
    instances: the JAX policy grows its bucket to 23,068,672 slots and the
    next render raises (a reference fault, ROADMAP C); the port's stops at
    MAX_BINNING_CAP and renders the frame clamped, once. Below the ceiling
    both policies move alike."""
    from c3dgs_tpu_torch.render.capacity import CapacityPolicy
    from c3dgs_tpu_torch.render.types import MAX_BINNING_CAP

    jp, tp = JPolicy(initial=1 << 22), CapacityPolicy(initial=1 << 22)
    for inst, ovf in ((3_000_000, 0), (5_000_000, 900_000), (4_000_000, 0)):
        assert jp.update(inst, ovf) == tp.update(inst, ovf) and jp.capacity == tp.capacity
    assert jp.update(17_163_249, 12_000_000) and jp.capacity == 23_068_672
    with pytest.raises(AssertionError, match="2\\^24"):
        JSettings(width=1920, height=1080, tanfovx=1, tanfovy=1, instance_capacity=jp.capacity).resolve_caps(10**6)
    assert tp.update(17_163_249, 12_000_000) and tp.capacity == MAX_BINNING_CAP and not tp.clamped
    assert not tp.update(17_163_249, 1_438_689) and tp.capacity == MAX_BINNING_CAP and tp.clamped
    with pytest.raises(RuntimeError, match="slot domain"):
        tp.check_whole(17_163_249, 1_438_689)
    assert not tp.update(15_000_000, 0) and not tp.clamped
    tp.check_whole(15_000_000, 0)
    st = tp.apply(TSettings(width=1920, height=1080, tanfovx=1, tanfovy=1))
    assert st.resolve_caps(10**6)[0] == MAX_BINNING_CAP
    assert CapacityPolicy(initial=1 << 24).capacity == MAX_BINNING_CAP


@pytest.fixture
def low_ceiling(monkeypatch):
    """The slot domain cut to 512 slots (the smallest bucket to 256), so a
    128x64 frame of 1000 splats overflows it."""
    from c3dgs_tpu_torch.render import capacity

    monkeypatch.setattr(capacity, "MIN_CAPACITY", 256)
    monkeypatch.setattr(capacity, "MAX_BINNING_CAP", 512)


@pytest.mark.parametrize("path", ["render_full", "calc_importance", "finetune"])
def test_a_frame_past_the_slot_domain_is_refused_or_reported(path, low_ceiling, capsys):
    """Eval and sensitivity need the whole frame and raise; finetune goes
    on and prints one line for each step that trained clamped."""
    from types import SimpleNamespace

    from c3dgs_tpu_torch.compress.importance import calc_importance
    from c3dgs_tpu_torch.config import OptimizationParams
    from c3dgs_tpu_torch.eval.metrics import render_full
    from c3dgs_tpu_torch.render.capacity import CapacityPolicy
    from c3dgs_tpu_torch.render.types import settings_from_intrinsic
    from c3dgs_tpu_torch.train.finetune import finetune

    scene = scenes.bench_recipe_scene(1000, 4, 0.1, device="cpu")
    intr = np.zeros((3, 3), np.float32)
    intr[0, 0] = intr[1, 1] = 1.2
    intr[0, 2], intr[1, 2] = 128, 64
    cam = SimpleNamespace(extrinsic_vector=np.asarray(EV), intrinsic=intr,
                          original_image=np.zeros((3, 64, 128), np.float32))
    if path == "render_full":
        with pytest.raises(RuntimeError, match="slot domain"):
            render_full(scene, cam.extrinsic_vector, settings_from_intrinsic(intr), torch.zeros(3),
                        CapacityPolicy(initial=256), device="cpu")
    elif path == "calc_importance":
        with pytest.raises(RuntimeError, match="slot domain"):
            calc_importance(scene, [cam], device="cpu")
    else:
        finetune(scene.to_indexed(), [cam], OptimizationParams(), 2, log_every=0, device="cpu")
        lines = [x for x in capsys.readouterr().out.splitlines() if "trained clamped" in x]
        assert [x.split(":")[0] for x in lines] == ["[capacity] finetune step 0", "[capacity] finetune step 1"]
        assert all("(512 slots)" in x for x in lines), lines


@pytest.mark.parametrize("knn", ["exact", "window"])
def test_scale_init_count_matches_jax(knn):
    """The first frame of scale_train_probe's init (3,000 points here),
    counted by both packages with each kNN scale init: the TPU record's
    7,155,545 at 1M points came from the exact 3-NN (JAX's exact-path
    ceiling was 1.5M points then) with the TPU's bf16 distance product,
    the 17,163,249 of the port and of the JAX package today from the
    Morton-window approximation (ROADMAP C)."""
    import scale_init_counts as sic

    port = sic.count_port(3000, 1200, knn, "cpu")
    ref = sic.count_jax(3000, 1200, knn)
    for k in ("instances", "clipped", "visible"):
        assert port[k] == ref[k], (k, port, ref)


# --------------------------------------------------------- the other tools
class _StubScene:
    """Stands in for the JAX scene the bench-recipe tools build: holds
    what they set on it."""

    def __init__(self, pts, cols, **kw):
        self.pts, self.cols, self.kw = pts, cols, kw
        self.scaling_factor = np.zeros((len(pts), 1), np.float32)
        self.opacity = None

    def replace(self, **kw):
        for k, v in kw.items():
            setattr(self, k, v)
        return self


def capture_bench_recipe(tool, monkeypatch):
    """Run a bench-recipe JAX tool up to its first render: (the stub
    scene, the render's settings)."""
    seen = {}

    def stop(scene, ev, settings, bg, **kw):
        seen.update(scene=scene, settings=settings)
        raise _Stop

    monkeypatch.setattr(jconfig, "setup_jax_cache", lambda *a, **k: None)
    monkeypatch.setattr(jgmod, "from_point_cloud", _StubScene)
    monkeypatch.setattr(jtrainer, "render_scene", stop)
    monkeypatch.setattr(jax, "jit", lambda f, *a, **k: f)
    with pytest.raises(_Stop):
        tool.main()
    return seen["scene"], seen["settings"]


@pytest.mark.parametrize("tool", ["saturation_probe", "clamp_probe"])
def test_bench_recipe_draws_match_jax(tool, monkeypatch):
    n, seed, scale = (2000, 0, 0.15) if tool == "saturation_probe" else (tcp.N, 4, 0.1)
    monkeypatch.setenv("C3DGS_BENCH_N", str(n))
    scene, settings = capture_bench_recipe(jsat if tool == "saturation_probe" else jcp, monkeypatch)
    pts, cols, logits = scenes.bench_arrays(n, seed)
    np.testing.assert_array_equal(pts, scene.pts)
    np.testing.assert_array_equal(cols, scene.cols)
    np.testing.assert_array_equal(logits, np.asarray(scene.opacity))
    np.testing.assert_array_equal(np.asarray(scene.scaling_factor), np.float32(math.log(scale)))
    assert scene.kw == {"capacity": n, "quantization": False}
    port = TOOLS[tool].SETTINGS
    assert (port.width, port.height, port.tanfovx, port.tanfovy, port.sh_degree) == \
        (settings.width, settings.height, settings.tanfovx, settings.tanfovy, settings.sh_degree)
    # the port's main builds the same recipe
    got = {}

    def capture(n_, seed, scale, trained=True, device=None):
        got.update(n=n_, seed=seed, scale=scale, trained=trained)
        raise _Stop

    monkeypatch.setattr(TOOLS[tool], "bench_recipe_scene", capture)
    with pytest.raises(_Stop):
        TOOLS[tool].main(CPU)
    assert got == {"n": n, "seed": seed, "scale": scale, "trained": True}


def test_saturation_probe_opacity_switch_matches_jax(monkeypatch):
    monkeypatch.setenv("C3DGS_BENCH_N", "500")
    monkeypatch.setenv("C3DGS_BENCH_OPACITY", "init")
    scene, _ = capture_bench_recipe(jsat, monkeypatch)
    assert scene.opacity is None
    pts, cols, logits = scenes.bench_arrays(500, 0, trained=False)
    assert logits is None
    np.testing.assert_array_equal(pts, scene.pts)
    np.testing.assert_array_equal(cols, scene.cols)


def clamp_scene(n=3000):
    """The clamp probe's recipe at n splats, built by JAX."""
    pts, cols, logits = scenes.bench_arrays(n, 4)
    js = jgmod.from_point_cloud(pts, cols, capacity=n, quantization=False)
    return js.replace(scaling_factor=js.scaling_factor + math.log(0.1), opacity=jnp.asarray(logits))


def test_clamp_curve_matches_jax_render_scene():
    js = clamp_scene()
    ts = carry_over(js)
    kw = dict(width=256, height=144, tanfovx=math.tan(0.6), tanfovy=math.tan(0.6), sh_degree=3)
    jst, tst = JSettings(**kw), TSettings(**kw)
    ev, bg = np.asarray(EV), np.zeros(3, np.float32)
    render = jax.jit(jtrainer.render_scene, static_argnums=(2,))
    true_j = int(render(js, ev, JPolicy(initial=1 << 18).apply(jst), bg)["num_instances"])
    full_j = JPolicy(initial=int(true_j * 1.12)).apply(jst)
    exact_j = np.asarray(render(js, ev, full_j, bg)["render"])
    true_t, rows = tcp.clamp_curve(ts, ev, TSettings(**kw, instance_capacity=1 << 18), tst, bg, grad_capacity=0,
                                   device="cpu")
    assert true_t == true_j
    full_t = tcp.CapacityPolicy(initial=int(true_t * 1.12)).apply(tst)
    tiles = tst.num_tiles
    for frac, dropped, psnr in rows:
        cap = int(true_j * frac) // 128 * 128
        out_j = render(js, ev, dataclasses.replace(full_j, instance_capacity=cap, grad_capacity=0), bg)
        img_j = np.asarray(out_j["render"])
        with torch.no_grad():
            out_t = ttrainer.render_scene(ts, ev, tcp.clamped_settings(full_t, true_t, frac, 0), bg, device="cpu")
        assert dropped == int(out_j["overflow"]) == int(out_t["overflow"]) == true_j - cap + tiles
        np.testing.assert_allclose(out_t["render"].numpy(), img_j, **IMG_TOL)
        psnr_j = 10 * math.log10(1.0 / max(float(np.mean((img_j - exact_j) ** 2)), 1e-12))
        np.testing.assert_allclose(psnr, psnr_j, rtol=1e-3)
    assert [r[0] for r in rows] == [0.95, 0.85, 0.70, 0.50]
    assert all(a[2] > b[2] for a, b in zip(rows, rows[1:]))


def test_clamp_curve_refuses_an_overflowing_exact_frame(monkeypatch):
    """Past the slot domain the policy stops growing, and a frame that does
    not fit has no exact image to hold the clamped ones against."""
    class Ceiling:  # a policy stopped at 1024 slots, below the frame
        def __init__(self, initial):
            pass

        def apply(self, settings):
            return dataclasses.replace(settings, instance_capacity=1024)

    monkeypatch.setattr(tcp, "CapacityPolicy", Ceiling)
    ts = carry_over(clamp_scene(1000))
    st = TSettings(width=128, height=64, tanfovx=math.tan(0.6), tanfovy=math.tan(0.6), sh_degree=3)
    with pytest.raises(RuntimeError, match="exact frame overflows"):
        tcp.clamp_curve(ts, np.asarray(EV), dataclasses.replace(st, instance_capacity=1 << 17), st,
                        np.zeros(3, np.float32), device="cpu")


def test_clamp_probe_writes_the_jax_keys(tmp_path, monkeypatch):
    monkeypatch.setattr(tcp, "N", 2000)
    monkeypatch.setattr(tcp, "SETTINGS", dataclasses.replace(tcp.SETTINGS, width=256, height=144))
    real_policy = tcp.CapacityPolicy
    # the probe's 2^23-slot first bucket, scaled to the small frame
    monkeypatch.setattr(tcp, "CapacityPolicy", lambda initial: real_policy(initial=min(initial, 1 << 18)))
    res = tcp.main(["--out_dir", str(tmp_path), *CPU])
    assert res == json.loads((tmp_path / "CLAMP_PROBE.json").read_text())
    tree = ast.parse(jax_source("clamp_probe"))
    report = dict_with(tree, "curve")
    assert list(res) == keys_of(report) + ["card"]
    assert [list(r) for r in res["curve"]] == [keys_of(dict_with(tree, "instances_dropped"))] * 4
    tiles = tcp.SETTINGS.num_tiles
    clamp_identity([dict(r, dropped=r["instances_dropped"]) for r in res["curve"]], res["true_instances"], tiles)
    assert res["n_gaussians"] == 2000 and res["note"] == ast.literal_eval(report.values[3])


def jax_saturation_report(out, starts, ends, chunks_exec, num_inst, t_count, n):
    """The JAX tool's own statements from `frz = ...` to `report = {...}`
    (tools/saturation_probe.py:104-149), run on the given arrays."""
    body = main_statements(ast.parse(jax_source("saturation_probe")), "frz", "report")
    ns = dict(out=out, starts=starts, ends=ends, chunks_exec=chunks_exec, num_inst=num_inst, t_count=t_count, n=n,
              np=np, CHUNK=128)
    exec(compile(body, "jax_saturation_report", "exec"), ns)
    return ns["report"]


def rounded(report):
    """The port's report with the JAX tool's rounding of its two fractions."""
    r = json.loads(json.dumps(report))
    r.pop("card", None)
    r["freeze"]["skip_fraction_of_exec"] = round(r["freeze"]["skip_fraction_of_exec"], 4)
    r["saturation"]["pixels_saturated_fraction"] = round(r["saturation"]["pixels_saturated_fraction"], 4)
    return r


def test_saturation_report_matches_jax_statements():
    """Arrays with frozen tiles, freezes inside and past a tile's range,
    saturated pixels and single-chunk tiles."""
    rng = np.random.default_rng(3)
    t, cap = 40, 128 * 60
    bounds = np.sort(rng.choice(np.arange(1, cap // 2), size=t - 1, replace=False))
    starts = np.concatenate([[0], bounds]).astype(np.int32)
    ends = np.concatenate([bounds, [cap // 2]]).astype(np.int32) - 1
    out = np.zeros((t, 8, 512), np.float32)
    out[:, 3] = np.where(rng.random((t, 512)) < 0.3, 1e-6, rng.random((t, 512)))
    out[::3, 3] = 1e-7
    frz = np.where(rng.random(t) < 0.5, rng.integers(starts, ends + 1), cap)
    out[:, 5] = frz[:, None]
    chunks_exec = int(ends.max()) // 128 + 1
    want = jax_saturation_report(out, starts, ends, chunks_exec, 12345, t, 999)
    got = tsat.saturation_report(out, starts, ends, chunks_exec, 12345, t, 999)
    assert got["freeze"]["tiles_frozen"] > 0 and got["freeze"]["chunks_skipped_by_freeze"] > 0
    assert got["saturation"]["tiles_fully_saturated_final"] > 0
    assert rounded(got) == want


def test_saturation_report_on_the_wall_scene_matches_jax_k1():
    sc, kw = SCENES["wall"]()
    js, fields, tile_lo, meta, b = staged(sc, kw)
    out_j = np.asarray(jrast._blend_forward_call_packed(js.num_tiles, fields.shape[1], fields, tile_lo, meta))
    n = len(sc["means"])
    want = jax_saturation_report(out_j, np.asarray(b.starts), np.asarray(b.ends), int(b.chunks_exec),
                                 int(b.num_instances), js.num_tiles, n)

    def t(x):
        return None if x is None else torch.as_tensor(np.asarray(x))

    out, starts, ends, chunks_exec, instances = tsat.packed_blocks(
        t(sc["means"]), t(sc["cov"]), t(sc["op"]), EV, TSettings(**kw), t(sc["shs"]), t(sc["colors"]))
    np.testing.assert_array_equal(out[:, 5], out_j[:, 5])
    got = tsat.saturation_report(out, starts, ends, chunks_exec, instances, js.num_tiles, n)
    assert got["freeze"]["tiles_frozen"] >= 2
    assert rounded(got) == want


def test_saturation_probe_writes_the_jax_keys(monkeypatch, capsys):
    monkeypatch.setenv("C3DGS_BENCH_N", "2000")
    monkeypatch.setattr(tsat, "SETTINGS", dataclasses.replace(tsat.SETTINGS, width=256, height=144))
    res = tsat.main(CPU)
    assert json.loads(capsys.readouterr().out) == res
    want = keys_of(dict_with(ast.parse(jax_source("saturation_probe")), "workload"))
    assert port_keys(res) == want + ["card"]
    w, f = res["workload"], res["freeze"]
    assert w["n_gaussians"] == 2000 and w["tiles"] == tsat.SETTINGS.num_tiles and w["instances"] > 0
    p = res["per_tile_chunks"]
    assert f["chunks_skipped_by_freeze"] <= p["interior_flush_free_chunks"] <= p["total_segment_chunks"]
    assert f["tiles_frozen"] <= w["tiles"]


# ------------------------------------------------------------------ dcn
def test_dcn_probe_two_nodes_on_cpu(tmp_path):
    res = tdcn.main(["--out_dir", str(tmp_path), *CPU])
    assert res == json.loads((tmp_path / "MULTIPROC.json").read_text())
    tree = ast.parse(jax_source("dcn_probe"))
    assert list(res)[:10] == [k.value for k in dict_with(tree, "hybrid_branch").keys]
    assert res["processes"] == 2 and res["devices_global"] == 8 and res["mesh"] == {"dp": 2, "tiles": 4}
    assert res["failures"] == [] and res["shard_route_dropped"] == 0
    assert res["max_param_update_diff_vs_single_device"] < 5e-5 and abs(res["loss"] - res["ref_loss"]) < 1e-5
    ranks = res["ranks"]
    assert [r["rank"] for r in ranks] == list(range(8)) and [r["node"] for r in ranks] == [0] * 4 + [1] * 4
    for r in ranks:
        assert r["tiles_group_nodes"] == [r["node"]] * 4 and r["dp_group_nodes"] == [0, 1]
        assert (r["dp_index"], r["tile_index"]) == divmod(r["rank"], 4)
        assert r["launches"] == [0, 0]  # the CPU runs the plain versions
        # the hybrid step's one blend and its backward, the reference's two
        assert r["calls"] == [3, 3]


def test_dcn_probe_check_rank_flags_each_bar():
    good = {"tiles_group_nodes": [1] * 4, "dp_group_nodes": [0, 1], "per_param_diffs": {"xyz": 0.0},
            "loss": 0.5, "ref_loss": 0.5, "shard_route_dropped": 0}
    assert tdcn.check_rank(good) == []
    for bad in ({"tiles_group_nodes": [0, 0, 1, 1]}, {"dp_group_nodes": [0, 0]}, {"per_param_diffs": {"xyz": 5e-5}},
                {"loss": 0.5 + 2e-5}, {"shard_route_dropped": 3}):
        assert len(tdcn.check_rank({**good, **bad})) == 1, bad


# ------------------------------------------------------------- the parsers
def jax_dcn_parser(monkeypatch):
    """tools/dcn_probe.py builds its parser under `__main__`."""
    import argparse

    seen = {}

    def spy(self, args=None, namespace=None):
        seen["parser"] = self
        raise _Stop

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", spy)
    with pytest.raises(_Stop):
        runpy.run_path(os.path.join(REPO, "tools", "dcn_probe.py"), run_name="__main__")
    monkeypatch.undo()
    return {tuple(a.option_strings): (a.default, a.type, type(a).__name__, a.nargs, a.choices)
            for a in seen["parser"]._actions if a.option_strings != ["-h", "--help"]}


@pytest.mark.parametrize("tool", list(TOOLS))
def test_parsers_match_the_jax_tools(tool, monkeypatch):
    tp = parser_of(TOOLS[tool].main, [[]])
    assert tp.pop(("--device",)) == (None, str, "_StoreAction", None, None)
    out_dir = (os.path.join("output", "torch"), str, "_StoreAction", None, None)
    if tool in ("saturation_probe", "clamp_probe"):
        # the JAX tools take no options
        assert "ArgumentParser" not in jax_source(tool)
        assert tp == ({} if tool == "saturation_probe" else {("--out_dir",): out_dir})
        return
    if tool == "dcn_probe":
        jp = jax_dcn_parser(monkeypatch)
        # the JAX tool writes the repo's MULTIPROC_r04.json
        assert tp.pop(("--out_dir",)) == out_dir
    else:
        jp = parser_of(jstp.main, [])
        # the JAX tool writes into the repo's output/ by default
        assert tp[("--out_dir",)][0] == os.path.join("output", "torch")
        jp[("--out_dir",)], tp[("--out_dir",)] = jp[("--out_dir",)][1:], tp[("--out_dir",)][1:]
    assert tp == jp


@pytest.mark.parametrize("tool", list(TOOLS))
def test_tools_need_a_card_unless_told_cpu(tool, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TOOLS[tool].main([])
    assert os.listdir(tmp_path) == []


# ------------------------------------ the smoke run against JAX's (last)
def test_scale_train_probe_matches_jax(jax_smoke, port_smoke):
    jout, proc = jax_smoke
    text, _ = proc.communicate(timeout=600)
    assert proc.returncode == 0, text[-3000:]
    jres = json.loads((jout / "SCALE_TRAIN.json").read_text())
    tres, tout = port_smoke
    jlog, tlog = read_log(jout), read_log(tout)
    assert [list(r) for r in tlog] == [list(r) for r in jlog] and len(tlog) == 2
    for t, j in zip(tlog, jlog):
        assert (t["step"], t["active"], t["capacity"]) == (j["step"], j["active"], j["capacity"])
        np.testing.assert_allclose(t["ema_psnr"], j["ema_psnr"], atol=1e-3)
    assert tlog[0]["instances"] == jlog[0]["instances"]
    np.testing.assert_allclose(tlog[1]["instances"], jlog[1]["instances"], rtol=1e-3)
    for k in ("steps", "resolution", "final_active", "final_capacity", "capacity_growths"):
        assert tres[k] == jres[k], k
    np.testing.assert_allclose(tres["final_ema_psnr"], jres["final_ema_psnr"], atol=1e-3)
    np.testing.assert_allclose(tres["true_instances_view0"], jres["true_instances_view0"], rtol=1e-3)
    tiles = TSettings(width=256, height=128, tanfovx=1, tanfovy=1).num_tiles
    clamp_identity(tres["clamp_experiment"], tres["true_instances_view0"], tiles)
    clamp_identity(jres["clamp_experiment"], jres["true_instances_view0"], tiles)
    for t, j in zip(tres["clamp_experiment"], jres["clamp_experiment"], strict=True):
        assert t["capacity_fraction"] == j["capacity_fraction"]
        np.testing.assert_allclose(t["psnr_vs_exact"], j["psnr_vs_exact"], atol=0.1)
