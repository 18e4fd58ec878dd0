"""The port's compression evidence tools (c3dgs_tpu_torch.tools:
convergence_run, robustness_runs, scale_compress_probe, bench_compression)
against the JAX package's tools/*.py and bench_compression.py on the CPU.

Bars:
- parsers: the JAX tools' option strings, defaults, types and actions;
  the port adds --device everywhere, and an output directory to
  robustness_runs (--out_root) and bench_compression (--out_dir), whose
  JAX versions write to fixed paths; output-directory defaults differ;
- generators: the numpy-drawn fields bitwise, scales at from_point_cloud's
  bar (atol 1e-6, tests/test_torch_data.py), the ring cameras at 1e-6.
  The JAX scale probe and bench_compression build their scenes inside
  main() or at module level, so they run with the render replaced by a
  blank image (their cameras need no real one) and stop at the first
  call that receives the scene: to_compressed in the probe, the .ply
  write in bench_compression (which would write /tmp before compressing);
- the Blender writer against tests/synth.py's (oracle renders) at 32 px,
  4 + 2 views, init_subsample 4: points3d.ply and the transforms JSONs
  equal, PNGs within one code value with >= 99.9% of them equal;
- convergence_run --no_compress on one such folder, both packages, 2
  epochs of one step each (the JAX tool's CLI call made in process):
  train_log.jsonl to tests/test_torch_cli.py's bars (it, active, epoch
  exactly, ema_loss rtol 1e-4, ema_psnr and test_psnr atol 1e-3);
- compression wiring at tiny sizes: the keys of SCALE_COMPRESS.json and
  ROBUSTNESS.json are the JAX tools' (read from their dict literals), the
  accounting equals the JAX tool's own statements run on fixed results,
  PSNRs finite, size_bytes > 0; convergence_run --fast compresses a
  trained model through the resume path;
- each tool raises without a card unless given --device cpu.
"""
import argparse
import ast
import functools
import importlib.util
import json
import math
import os
import random
import shutil
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch_cpu  # noqa: F401  (one torch thread per test worker)
from PIL import Image

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from c3dgs_tpu import config as jconfig  # noqa: E402
from c3dgs_tpu.compress import pipeline as jpipeline  # noqa: E402
from c3dgs_tpu.models import io_ply as jio_ply  # noqa: E402
from c3dgs_tpu.train import trainer as jtrainer  # noqa: E402
from c3dgs_tpu_torch.tools import bench_compression as tbench  # noqa: E402
from c3dgs_tpu_torch.tools import convergence_run as tconv  # noqa: E402
from c3dgs_tpu_torch.tools import datasets  # noqa: E402
from c3dgs_tpu_torch.tools import robustness_runs as trob  # noqa: E402
from c3dgs_tpu_torch.tools import scale_compress_probe as tscp  # noqa: E402
from tests import synth  # noqa: E402

CPU = ["--device", "cpu"]
FIELDS = ("xyz", "features_dc", "features_rest", "opacity", "rotation", "active")
SCALES = ("scaling_factor", "scaling")
TINY = ["--res", "32", "--n_gt", "300", "--views", "6", "--epochs", "2"]
# compress.py's results.json keys (tests/test_torch_cli.py::RESULTS_KEYS)
RESULTS_KEYS = ["psnr", "ssim", "lpips", "num_views", "lpips_reason", "size_bytes", "uncompressed_psnr",
                "psnr_drop", "ply_size_bytes", "compression_ratio"]


def load_jax_tool(rel):
    spec = importlib.util.spec_from_file_location("jax_" + os.path.basename(rel)[:-3], os.path.join(REPO, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jconv = load_jax_tool("tools/convergence_run.py")
jrob = load_jax_tool("tools/robustness_runs.py")
jscp = load_jax_tool("tools/scale_compress_probe.py")


class _Stop(Exception):
    """Raised by a spy once it has what the test needs."""


def parser_of(main, argv):
    """{option strings: (default, type, action, nargs, choices)} of the
    parser `main` builds; main stops at parse_args."""
    seen = {}

    def spy(self, args=None, namespace=None):
        seen["parser"] = self
        raise _Stop

    with pytest.MonkeyPatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", spy)
        with pytest.raises(_Stop):
            main(*argv)
    return {
        tuple(a.option_strings): (a.default, a.type, type(a).__name__, a.nargs, a.choices)
        for a in seen["parser"]._actions
        if a.option_strings != ["-h", "--help"]
    }


# The JAX tool's --no_compress run, in a child process that starts as soon
# as the folder exists (its jit compiles take ~30 s, which the port's runs
# in this process overlap): the CLI call made in process through
# train.main, Python's `random` seeded as in the parent.
JAX_RUN = r"""
import importlib.util, random, sys
repo, root = sys.argv[1], sys.argv[2]
sys.path.insert(0, repo)
import jax
jax.config.update("jax_platforms", "cpu")
import train
from c3dgs_tpu import config
config.setup_jax_cache = lambda *a, **k: None
spec = importlib.util.spec_from_file_location("jax_convergence_run", repo + "/tools/convergence_run.py")
tool = importlib.util.module_from_spec(spec)
spec.loader.exec_module(tool)
tool.sh = lambda cmd, retries=2: train.main(cmd[2:])
sys.argv = ["convergence_run.py", "--no_compress", *sys.argv[3:], "--out_root", root]
random.seed(0)
tool.main()
"""


@pytest.fixture(scope="module")
def folders(tmp_path_factory):
    """(JAX root, port root, port-written data, the JAX run's process):
    both roots hold one Blender folder from synth.write_blender_dataset
    (oracle renders) of the JAX tool's 300-splat GT at 32 px, 4 train + 2
    test views, and the JAX tool's --no_compress run on its root has
    started; the port's writer wrote the third from the port's GT."""
    base = tmp_path_factory.mktemp("evidence")
    jroot, troot, tdata = base / "jax", base / "port", base / "port_written"
    kw = dict(res=32, num_train=4, num_test=2, fov=0.9, init_noise=0.08, init_subsample=4)
    synth.write_blender_dataset(str(jroot / "data"), scene=jconv.make_gt_scene(n=300, seed=7), use_pallas=False, **kw)
    shutil.copytree(jroot / "data", troot / "data")
    proc = subprocess.Popen([sys.executable, "-c", JAX_RUN, REPO, str(jroot), *TINY], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    try:
        datasets.write_blender_dataset(str(tdata), scene=tconv.make_gt_scene(n=300, seed=7, device="cpu"),
                                       device="cpu", **kw)
        yield jroot, troot, tdata, proc
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.communicate()


def test_blender_writer_matches_synth(folders):
    jroot, _, tdata, _ = folders
    jdata = jroot / "data"
    assert (tdata / "points3d.ply").read_bytes() == (jdata / "points3d.ply").read_bytes()
    for split in ("train", "test"):
        assert json.loads((tdata / f"transforms_{split}.json").read_text()) == \
            json.loads((jdata / f"transforms_{split}.json").read_text())
    pngs = sorted(p.relative_to(jdata) for p in jdata.glob("*/*.png"))
    assert len(pngs) == 6
    a = np.stack([np.asarray(Image.open(tdata / p), np.int16) for p in pngs])
    b = np.stack([np.asarray(Image.open(jdata / p), np.int16) for p in pngs])
    assert np.abs(a - b).max() <= 1
    assert (a == b).mean() >= 0.999


@pytest.fixture(scope="module")
def trained(folders):
    """(port log, port root): the port's convergence_run --no_compress on
    its copy of the folder, Python's `random` seeded as the JAX run's."""
    _, troot, _, _ = folders
    random.seed(0)
    tconv.main(["--no_compress", *TINY, "--out_root", str(troot), *CPU])
    return [json.loads(line) for line in open(troot / "model" / "train_log.jsonl")], troot


def test_fast_compress_resumes_the_trained_model(trained, monkeypatch):
    tlog, troot = trained
    mtime = os.path.getmtime(troot / "model" / "train_log.jsonl")
    monkeypatch.delenv("C3DGS_FORCE_RETRAIN", raising=False)
    out = tconv.main(["--fast", *TINY, "--out_root", str(troot), *CPU])
    assert os.path.getmtime(troot / "model" / "train_log.jsonl") == mtime  # not trained again
    assert out == json.loads((troot / "convergence.json").read_text())
    assert (troot / "RESULTS.md").exists()
    assert list(out["results"]) == RESULTS_KEYS
    r = out["results"]
    assert math.isfinite(r["psnr"]) and math.isfinite(r["uncompressed_psnr"]) and r["size_bytes"] > 0
    assert r["compression_ratio"] == r["ply_size_bytes"] / r["size_bytes"]
    assert list(out["times"]) == ["sensitivity_calculation", "clustering", "finetune", "encode", "eval", "total"]
    assert out["protocol"]["compress_argv"] == ["--finetune_iterations", "10", "--color_cluster_iterations", "3",
                                                "--gaussian_cluster_iterations", "5"]
    assert out["train_curve"] == tlog and out["held_out_curve"][-1]["test_psnr"] == tlog[-1]["test_psnr"]


def test_robustness_rows_have_the_jax_keys(trained, tmp_path, monkeypatch):
    """One tiny config, its trained folder in place (the resume path):
    ROBUSTNESS.json's keys and row keys are the JAX tool's."""
    tlog, troot = trained
    monkeypatch.setattr(trob, "CONFIGS", [{"scene": "A", "n_gt": 300, "seed": 7}])
    shutil.copytree(troot / "data", tmp_path / "A7" / "data")
    shutil.copytree(troot / "model", tmp_path / "A7" / "model")
    res = trob.main(["--res", "32", "--views", "6", "--epochs", "2", "--out_root", str(tmp_path), *CPU])
    assert res == json.loads((tmp_path / "ROBUSTNESS.json").read_text())
    tree = ast.parse(open(os.path.join(REPO, "tools", "robustness_runs.py")).read())
    dicts = [n for n in ast.walk(tree) if isinstance(n, ast.Dict) and n.keys and isinstance(n.keys[0], ast.Constant)]
    jax_keys = {tuple(k.value for k in d.keys) for d in dicts}
    assert tuple(res) in jax_keys and tuple(res["protocol"]) in jax_keys and tuple(res["runs"][0]) in jax_keys
    row = res["runs"][0]
    assert row["final_test_psnr"] == tlog[-1]["test_psnr"] and not row["diverged"]
    assert trob.run_row({"scene": "B", "seed": 1, "n_gt": 5}, [{"epoch": 0, "test_psnr": 7.9, "ema_psnr": 8}])["diverged"]


def jax_scale_accounting(results, base_psnr, active, args, timings, peak, npz_path):
    """The JAX scale probe's own statements from `results[...] =
    base["psnr"]` to `out = {...}` (tools/scale_compress_probe.py), run on
    the given values."""
    tree = ast.parse(open(os.path.join(REPO, "tools", "scale_compress_probe.py")).read())
    main = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")
    wanted = []
    for stmt in main.body:
        targets = getattr(stmt, "targets", [])
        names = [ast.unparse(t) for t in targets]
        if any(n.startswith("results[") or n in ("raw_bytes", "out") for n in names):
            wanted.append(stmt)
    ns = {"results": dict(results), "base": {"psnr": base_psnr}, "np": np, "args": args, "n": args.n,
          "timings": timings,
          "compressed": SimpleNamespace(num_active=active), "hbm_peak": lambda: peak, "npz_path": npz_path}
    exec(compile(ast.Module(body=wanted, type_ignores=[]), "jax_scale_accounting", "exec"), ns)
    return ns["out"]


@pytest.mark.parametrize("base_psnr", [math.inf, 41.25])
def test_scale_accounting_matches_jax(base_psnr):
    results = {"psnr": 38.5, "ssim": 0.97, "size_bytes": 1234567}
    timings = {"sensitivity_calculation": 12.34, "clustering": 56.78, "finetune": 90.12, "encode": 3.45,
               "eval": 6.78, "total": 169.47}
    args = SimpleNamespace(n=1_200_000, n_views=12, res="1920x1080", finetune_iters=1000)
    peak = 37 * 2**30 + 12345
    got = tscp.summarize(args.n, args.n_views, args.res, args.finetune_iters, 1_150_000, results, base_psnr, timings,
                         peak, "x.npz", "card")
    want = jax_scale_accounting(results, base_psnr, 1_150_000, args, timings, peak, "x.npz")
    assert got.pop("card") == "card"
    assert got.pop("times") == timings and want.pop("times") == {k: round(v, 1) for k, v in timings.items()}
    assert list(got) == list(want)
    assert got == want


def test_scale_probe_runs_the_pipeline(tmp_path, monkeypatch):
    # few k-means steps, as convergence_run's --fast config: the VQ itself
    # is held to JAX's in tests/test_torch_compress.py
    monkeypatch.setattr(tscp, "CompressionParams", functools.partial(
        tscp.CompressionParams, color_cluster_iterations=3, gaussian_cluster_iterations=5))
    out = tscp.main(["--n", "3000", "--n_views", "2", "--res", "64x32", "--finetune_iters", "3",
                     "--out_dir", str(tmp_path), *CPU])
    assert out == json.loads((tmp_path / "SCALE_COMPRESS.json").read_text())
    tree = ast.parse(open(os.path.join(REPO, "tools", "scale_compress_probe.py")).read())
    jax_keys = next(
        [k.value for k in n.value.keys] for n in ast.walk(tree)
        if isinstance(n, ast.Assign) and ast.unparse(n.targets[0]) == "out"
    )
    assert list(out) == jax_keys + ["card"] and out["card"] == "cpu"
    assert math.isfinite(out["psnr"]) and out["size_bytes"] > 0 and out["compression_ratio_vs_ply"] > 1
    # the GT renders are the base scene's eval renders
    assert out["uncompressed_psnr"] == math.inf and out["psnr_drop"] is None
    assert 0 < out["active_after_prune"] <= 3000 and os.path.exists(out["npz"])
    assert list(out["times"]) == ["sensitivity_calculation", "clustering", "finetune", "encode", "eval", "total"]


@pytest.mark.parametrize("tool", [tconv, trob, tscp, tbench], ids=lambda m: m.__name__.rsplit(".", 1)[1])
def test_tools_need_a_card_unless_told_cpu(tool, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tool.main([])
    assert os.listdir(tmp_path) == []



DEVICE_OPT = {("--device",): (None, str, "_StoreAction", None, None)}


@pytest.mark.parametrize("tool", ["convergence_run", "robustness_runs", "scale_compress_probe", "bench_compression"])
def test_parsers_match_the_jax_tools(tool):
    port = {"convergence_run": tconv, "robustness_runs": trob, "scale_compress_probe": tscp,
            "bench_compression": tbench}[tool]
    tp = parser_of(port.main, [[]])
    for opt, spec in DEVICE_OPT.items():
        assert tp.pop(opt) == spec
    if tool == "bench_compression":
        # the JAX script takes no options (CR_N / CR_FT from the environment)
        # and writes /tmp/cr_*; the port takes where to write
        assert tp == {("--out_dir",): (os.path.join("output", "torch", "bench_compression"), str, "_StoreAction",
                                       None, None)}
        return
    jp = parser_of({"convergence_run": jconv, "robustness_runs": jrob, "scale_compress_probe": jscp}[tool].main, [])
    if tool == "robustness_runs":
        # the JAX tool writes under the repo's output/robust
        assert tp.pop(("--out_root",)) == (os.path.join("output", "torch", "robust"), str, "_StoreAction", None, None)
    if tool == "scale_compress_probe":
        # the JAX tool writes into the repo's output/ by default
        assert tp[("--out_dir",)][0] == os.path.join("output", "torch")
        jp[("--out_dir",)], tp[("--out_dir",)] = jp[("--out_dir",)][1:], tp[("--out_dir",)][1:]
    assert tp == jp


def assert_scenes_match(t, j, n):
    assert t.capacity == n and t.active_sh_degree == j.active_sh_degree == 3
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(t, f).detach().numpy(), np.asarray(getattr(j, f)), err_msg=f)
    for f in SCALES:
        np.testing.assert_allclose(getattr(t, f).detach().numpy(), np.asarray(getattr(j, f)), rtol=0, atol=1e-6,
                                   err_msg=f)


def test_convergence_gt_scene_matches_jax():
    assert_scenes_match(tconv.make_gt_scene(n=1000, seed=7, device="cpu"), jconv.make_gt_scene(n=1000, seed=7), 1000)


def _blank_render(scene, ev, settings, bg, **kw):
    import jax.numpy as jnp

    return {"render": jnp.zeros((3, settings.height, settings.width)), "num_instances": jnp.int32(0),
            "overflow": jnp.int32(0)}


def test_scale_probe_scene_and_cameras_match_jax(tmp_path, monkeypatch):
    seen = {}

    def capture(scene, cams, comp, **kw):
        seen.update(scene=scene, cams=cams, comp=comp)
        raise _Stop

    monkeypatch.setattr(jconfig, "setup_jax_cache", lambda *a, **k: None)
    monkeypatch.setattr(jtrainer, "render_scene", _blank_render)
    monkeypatch.setattr(jpipeline, "to_compressed", capture)
    monkeypatch.setattr(sys, "argv", ["scale_compress_probe.py", "--n", "3000", "--n_views", "2", "--res", "64x32",
                                      "--finetune_iters", "3", "--out_dir", str(tmp_path)])
    with pytest.raises(_Stop):
        jscp.main()
    assert seen["comp"].finetune_iterations == 3
    assert_scenes_match(tscp.make_scene(3000, device="cpu"), seen["scene"], 3000)
    settings, intrinsic = tscp.probe_settings(64, 32)
    for ev, cam in zip(tscp.ring_extrinsics(2), seen["cams"], strict=True):
        np.testing.assert_allclose(ev, cam.extrinsic_vector, rtol=0, atol=1e-6)
        np.testing.assert_array_equal(intrinsic, cam.intrinsic)


def test_bench_compression_scene_and_cameras_match_jax(monkeypatch):
    import jax

    real_update = jax.config.update
    # the script points JAX's compile cache at a directory outside the repo
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: None if "cache" in k else real_update(k, v))
    monkeypatch.setattr(jtrainer, "render_scene", _blank_render)

    def capture(scene, path):
        raise _Stop

    monkeypatch.setattr(jio_ply, "save_gaussians_ply", capture)
    monkeypatch.setenv("CR_N", "2000")
    path = os.path.join(REPO, "bench_compression.py")
    g = {"__name__": "jax_bench_compression", "__file__": path}
    with pytest.raises(_Stop):
        exec(compile(open(path).read(), path, "exec"), g)
    assert_scenes_match(tbench.make_scene(2000, device="cpu"), g["scene"], 2000)
    for ev, cam in zip(tbench.ring_extrinsics(), g["cams"], strict=True):
        np.testing.assert_array_equal(ev, cam.extrinsic_vector)
    geometry = lambda s: (s.width, s.height, s.tanfovx, s.tanfovy, s.sh_degree)  # noqa: E731
    assert geometry(tbench.SETTINGS) == geometry(g["S"])

def test_no_compress_run_matches_jax(folders, trained):
    """Last in the file, so that the tests above overlap the JAX run."""
    jroot, _, _, proc = folders
    tlog, _ = trained
    out, _ = proc.communicate(timeout=600)
    assert proc.returncode == 0, out[-3000:]
    jlog = [json.loads(line) for line in open(jroot / "model" / "train_log.jsonl")]
    assert [e["epoch"] for e in tlog] == [0, 1] and len(tlog) == len(jlog)
    for a, b in zip(tlog, jlog):
        assert list(a) == list(b) and "test_psnr" in a
        assert (a["epoch"], a["it"], a["active"]) == (b["epoch"], b["it"], b["active"])
        np.testing.assert_allclose(a["ema_loss"], b["ema_loss"], rtol=1e-4)
        np.testing.assert_allclose([a["ema_psnr"], a["test_psnr"]], [b["ema_psnr"], b["test_psnr"]], atol=1e-3)
