"""The port's config layer and CLIs (c3dgs_tpu_torch.config,
c3dgs_tpu_torch.cli) against c3dgs_tpu's and the JAX root scripts on the
CPU, on tests/synth.py's Blender folder at 32 px.

Bars:
- parsers: the same option strings, defaults, types and actions as the
  JAX scripts' (train, compress, render, metrics, train_camera,
  train_no_splatting, npz2ply, run_indexed), data_device's default
  ("cuda" here, "tpu" there) apart; the metrics, train_camera, npz2ply
  and run_indexed CLIs add --data_device;
- save_config / load_combined_args: files either package writes load in
  the other; a JAX `cfg_args` Namespace repr loads;
- the train CLI against train.main on one folder, 2 epochs of one step
  each, under one seed of Python's `random`: train_log.jsonl's `it`,
  `active` and `epoch` exactly, ema_loss at rtol 1e-4, ema_psnr at atol
  1e-3; the saved .ply at tests/ply_bars.py's bar (every entry within
  the steps times its field's learning rate, at most 1% of them beyond
  1e-5). With the default schedule 2 epochs reach no epoch-boundary
  step, so a second run of 4 epochs puts densify (with capacity growth),
  the 20 px screen-size prune and the opacity reset inside them and is
  held to the same bars on every epoch. It densifies by cloning only
  (--percent_dense 1): a split draws new positions from each package's
  own generator, and torch cannot reproduce jax.random;
- the compress, render and metrics CLIs write the files and keys the JAX
  scripts write (results.json, per_view.json, times.json, cfg_args.json,
  the PNG dump's layout); JAX's metrics.py on the port's dump gives the
  port's PSNR and SSIM at atol 1e-4, render_and_eval's bar
  (tests/test_torch_serve.py::test_render_and_eval_matches_jax); with an
  LPIPS weights file at both packages' default paths, per-view and mean
  LPIPS at rtol 1e-4;
- train_no_splatting for 1 epoch against train_no_splatting.py:
  optimized_poses.npy within 1e-5, the .ply by tests/ply_bars.py;
  train_camera against train_camera.py: the printed pose errors and
  losses to their printed digits; npz2ply's .ply equal to npz2ply.py's
  but for one-ulp log scales (atol 1e-6); run_indexed's wiring.
"""
import argparse
import json
import os
import random
import re
import sys

import numpy as np
import pytest
import torch
import torch_cpu  # noqa: F401,E402  (one torch thread per test worker)
from ply_bars import assert_trained_plys_close  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(__file__)))

import compress as jcompress_cli  # noqa: E402
import metrics as jmetrics_cli  # noqa: E402
import npz2ply as jnpz2ply_cli  # noqa: E402
import render as jrender_cli  # noqa: E402
import run_indexed as jrun_indexed_cli  # noqa: E402
import train as jtrain_cli  # noqa: E402
import train_camera as jtrain_camera_cli  # noqa: E402
import train_no_splatting as jtns_cli  # noqa: E402
from c3dgs_tpu import config as jconfig
from c3dgs_tpu.models import io_ply as jply
from c3dgs_tpu_torch import config as tconfig
from c3dgs_tpu_torch.cli import compress as tcompress_cli
from c3dgs_tpu_torch.cli import metrics as tmetrics_cli
from c3dgs_tpu_torch.cli import npz2ply as tnpz2ply_cli
from c3dgs_tpu_torch.cli import render as trender_cli
from c3dgs_tpu_torch.cli import run_indexed as trun_indexed_cli
from c3dgs_tpu_torch.cli import train as ttrain_cli
from c3dgs_tpu_torch.cli import train_camera as ttrain_camera_cli
from c3dgs_tpu_torch.cli import train_no_splatting as ttns_cli
from c3dgs_tpu_torch.models import io_npz, io_ply as tply
from c3dgs_tpu_torch.train import checkpoint
from tests import synth

CPU = ["--data_device", "cpu"]
# compress.py writes these keys, in this order (compress.py:110-156 and
# c3dgs_tpu/eval/metrics.py::render_and_eval)
RESULTS_KEYS = ["psnr", "ssim", "lpips", "num_views", "lpips_reason", "size_bytes", "uncompressed_psnr",
                "psnr_drop", "ply_size_bytes", "compression_ratio"]
TIMES_KEYS = ["sensitivity_calculation", "clustering", "finetune", "encode", "eval", "total"]
# densify with growth, the 20 px prune and the opacity reset inside 4
# epochs: calc_epoch puts densify_from at 1, densification_interval and
# opacity_reset_interval at 1 and densify_until at 4 (train.py:30-43)
BOUNDARIES = ["--epochs", "4", "--densify_from_iter", "0", "--densification_interval", "7500",
              "--opacity_reset_interval", "7500", "--densify_until_iter", "30000", "--percent_dense", "1.0"]
SMALL_VQ = ["--color_codebook_size", "16", "--gaussian_codebook_size", "16", "--color_cluster_iterations", "2",
            "--gaussian_cluster_iterations", "2"]


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("cli_scene"))
    synth.write_blender_dataset(out, res=32, num_train=3, num_test=1)
    return out


@pytest.fixture(scope="module")
def trained(dataset, tmp_path_factory):
    """(JAX model dir, port model dir): train.py and the port's train CLI
    on the same folder, 2 epochs, Python's `random` seeded alike."""
    jdir, tdir = str(tmp_path_factory.mktemp("jax_model")), str(tmp_path_factory.mktemp("port_model"))
    random.seed(0)
    jtrain_cli.main(["-s", dataset, "-m", jdir, "--epochs", "2"])
    random.seed(0)
    ttrain_cli.main(["-s", dataset, "-m", tdir, "--epochs", "2", *CPU])
    return jdir, tdir


@pytest.fixture(scope="module")
def trained_across_boundaries(dataset, tmp_path_factory):
    """(JAX model dir, port model dir) after 4 epochs of BOUNDARIES."""
    jdir, tdir = str(tmp_path_factory.mktemp("jax_bounds")), str(tmp_path_factory.mktemp("port_bounds"))
    random.seed(0)
    jtrain_cli.main(["-s", dataset, "-m", jdir, *BOUNDARIES])
    random.seed(0)
    ttrain_cli.main(["-s", dataset, "-m", tdir, *BOUNDARIES, *CPU])
    return jdir, tdir


def read_logs(jdir, tdir):
    return [[json.loads(line) for line in open(os.path.join(d, "train_log.jsonl"))] for d in (tdir, jdir)]


def assert_logs_match(tlog, jlog):
    assert len(tlog) == len(jlog)
    for a, b in zip(tlog, jlog):
        assert list(a) == list(b)
        assert (a["epoch"], a["it"], a["active"]) == (b["epoch"], b["it"], b["active"])
        np.testing.assert_allclose(a["ema_loss"], b["ema_loss"], rtol=1e-4)
        np.testing.assert_allclose(a["ema_psnr"], b["ema_psnr"], atol=1e-3)


class _Parsed(Exception):
    """Raised by parser_of's spy once the CLI's parser has parsed."""


def parser_of(main, argv):
    """The ArgumentParser `main` builds, each action by its option strings
    (a positional by its dest); `main` stops when it has parsed."""
    seen = {}
    real = argparse.ArgumentParser.parse_args

    def spy(self, args=None, namespace=None):
        seen["parser"] = self
        real(self, args, namespace)
        raise _Parsed

    with pytest.MonkeyPatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", spy)
        m.setattr(jconfig, "setup_jax_cache", lambda *a, **k: None)
        with pytest.raises(_Parsed):
            main(argv)
    return {
        tuple(a.option_strings) or a.dest: (a.default, a.type, type(a).__name__, a.nargs, a.choices)
        for a in seen["parser"]._actions
        if a.option_strings != ["-h", "--help"]
    }


JAX_CLIS = {"train": jtrain_cli, "compress": jcompress_cli, "render": jrender_cli, "metrics": jmetrics_cli,
            "train_camera": jtrain_camera_cli, "train_no_splatting": jtns_cli, "npz2ply": jnpz2ply_cli,
            "run_indexed": jrun_indexed_cli}
PORT_CLIS = {"train": ttrain_cli, "compress": tcompress_cli, "render": trender_cli, "metrics": tmetrics_cli,
             "train_camera": ttrain_camera_cli, "train_no_splatting": ttns_cli, "npz2ply": tnpz2ply_cli,
             "run_indexed": trun_indexed_cli}


@pytest.mark.parametrize("cli", list(JAX_CLIS))
def test_parsers_match_the_jax_scripts(cli, tmp_path):
    argv = {"npz2ply": ["in.npz", "out.ply"], "train_camera": ["-s", "src", "-m", str(tmp_path)],
            "run_indexed": ["-s", "src", "-m", str(tmp_path)]}.get(cli, ["-m", str(tmp_path)])
    jp = parser_of(JAX_CLIS[cli].main, argv)
    tp = parser_of(PORT_CLIS[cli].main, argv)
    dd = ("--data_device",)
    if cli in ("metrics", "train_camera", "npz2ply", "run_indexed"):
        # the port's addition: the JAX scripts run on JAX's default device
        assert tp.pop(dd) == ("cuda", str, "_StoreAction", None, None)
    if cli in ("train", "train_no_splatting"):
        assert (jp[dd][0], tp[dd][0]) == ("tpu", "cuda")
        jp[dd], tp[dd] = jp[dd][1:], tp[dd][1:]
    assert tp == jp


def test_param_groups_extract_like_jax():
    argv = ["-s", "src", "-m", "out", "-r", "2", "-w", "--eval", "--iterations", "700", "--feature_lr", "0.01",
            "--not_quantization_aware", "--color_codebook_size", "64", "--xyz_fp16", "--debug"]
    for jg, tg in ((jconfig.ModelParams, tconfig.ModelParams), (jconfig.OptimizationParams, tconfig.OptimizationParams),
                   (jconfig.PipelineParams, tconfig.PipelineParams),
                   (jconfig.CompressionParams, tconfig.CompressionParams)):
        jp, tp = argparse.ArgumentParser(), argparse.ArgumentParser()
        jg.add_to_parser(jp, "g")
        tg.add_to_parser(tp, "g")
        ja, ta = jp.parse_known_args(argv)[0], tp.parse_known_args(argv)[0]
        jd, td = jg.extract(ja).to_dict(), tg.extract(ta).to_dict()
        if tg is tconfig.ModelParams:
            assert (jd.pop("data_device"), td.pop("data_device")) == ("tpu", "cuda")
            jd2 = jg.extract(ja).post_extract().to_dict()
            assert tg.extract(ta).post_extract().source_path == jd2["source_path"] == os.path.abspath("src")
        assert td == jd and list(td) == list(jd)


def test_save_config_and_combined_args_cross_packages(tmp_path):
    groups = {"model": tconfig.ModelParams(source_path="/data/x", model_path=str(tmp_path), resolution=2),
              "optimization": tconfig.OptimizationParams(epochs=7)}
    tconfig.save_config(str(tmp_path), groups)
    with open(tmp_path / "cfg_args.json") as f:
        saved = json.load(f)
    assert list(saved) == ["model", "optimization"] and saved["model"]["data_device"] == "cuda"
    parsers = []
    for mod in (tconfig, jconfig):
        p = argparse.ArgumentParser()
        mod.ModelParams.add_to_parser(p, "model", fill_none=True)
        mod.OptimizationParams.add_to_parser(p, "optimization", fill_none=True)
        parsers.append(p)
    for mod, p in ((tconfig, parsers[0]), (jconfig, parsers[1])):
        args = mod.load_combined_args(p, ["-m", str(tmp_path), "--epochs", "9"])
        assert (args.resolution, args.epochs, args.source_path, args.data_device) == (2, 9, "/data/x", "cuda")
    # the reference-style Namespace repr, as the JAX CLI writes it
    jdir = tmp_path / "jax"
    jconfig.save_config(str(jdir), {"model": jconfig.ModelParams(model_path=str(jdir), resolution=4),
                                     "optimization": jconfig.OptimizationParams(iterations=123)})
    os.remove(jdir / "cfg_args.json")
    args = tconfig.load_combined_args(parsers[0], ["-m", str(jdir)])
    assert (args.resolution, args.iterations, args.data_device) == (4, 123, "tpu")
    # "tpu" names no torch device: the port's default takes its place,
    # while a device given on the command line wins
    assert tconfig.ModelParams.extract(args).post_extract().data_device == "cuda"
    args = tconfig.load_combined_args(parsers[0], ["-m", str(jdir), "--data_device", "cpu"])
    assert tconfig.ModelParams.extract(args).post_extract().data_device == "cpu"
    with pytest.raises(ValueError):
        tconfig._parse_namespace_repr("__import__('os')")


def test_train_cli_matches_train_py(trained):
    jdir, tdir = trained
    for name in ("cfg_args.json", "cfg_args", "cameras.json", "input.ply", "train_log.jsonl"):
        assert os.path.exists(os.path.join(tdir, name)), name
    tlog, jlog = read_logs(jdir, tdir)
    assert len(tlog) == 2
    assert_logs_match(tlog, jlog)
    jcfg, tcfg = (json.load(open(os.path.join(d, "cfg_args.json"))) for d in (jdir, tdir))
    assert (jcfg["model"].pop("data_device"), tcfg["model"].pop("data_device")) == ("tpu", "cpu")
    jcfg["model"]["model_path"] = tcfg["model"]["model_path"]
    assert tcfg == jcfg
    assert json.load(open(os.path.join(tdir, "cameras.json"))) == json.load(open(os.path.join(jdir, "cameras.json")))
    ply = os.path.join("point_cloud", "iteration_2", "point_cloud.ply")
    assert_trained_plys_close(tply.read_vertices(os.path.join(tdir, ply)), tply.read_vertices(os.path.join(jdir, ply)),
                              steps=2)


def test_train_cli_matches_train_py_across_epoch_boundaries(trained_across_boundaries):
    """Densify at epochs 2 and 3 (capacity 1600 grows at 3), the opacity
    reset after epochs 1-3, the 20 px prune armed from epoch 2: the same
    rows survive each boundary in both packages."""
    jdir, tdir = trained_across_boundaries
    tlog, jlog = read_logs(jdir, tdir)
    assert [e["it"] for e in tlog] == [1, 2, 3, 6]
    actives = [e["active"] for e in tlog]
    assert actives[0] == actives[1] == 400 and len(set(actives[1:])) == 3, actives
    assert_logs_match(tlog, jlog)
    ply = os.path.join("point_cloud", "iteration_6", "point_cloud.ply")
    assert_trained_plys_close(tply.read_vertices(os.path.join(tdir, ply)), tply.read_vertices(os.path.join(jdir, ply)),
                              steps=6)


def test_train_cli_compress_every_and_eval_every(dataset, tmp_path, capsys):
    """--compress_every N (tests/test_cli.py's wiring test in the port):
    the VQ pass runs at epoch 2 and training goes on over the re-unified
    scene; --eval_every logs test_psnr at epochs 0, 2 and the last."""
    model = str(tmp_path / "itc")
    random.seed(0)
    state = ttrain_cli.main(["-s", dataset, "-m", model, "--epochs", "4", "--compress_every", "2",
                             "--eval_every", "2", *SMALL_VQ, *CPU])
    assert "[compress@2]" in capsys.readouterr().out
    log = [json.loads(line) for line in open(os.path.join(model, "train_log.jsonl"))]
    assert len(log) == 4 and all(np.isfinite(e["ema_loss"]) for e in log)
    assert ["test_psnr" in e for e in log] == [True, False, True, True]
    # epochs 0-2 train one camera each, epoch 3 (cams[3::10] is empty)
    # all three; fresh Adam moments at the pass after epoch 2, the LR step
    # kept: 6 steps, 3 after it
    assert (state.step, state.opt_state.step, state.opt_state.count) == (6, 6, 3)
    assert not state.scene.is_color_indexed and os.path.isdir(os.path.join(model, "point_cloud"))


def test_compress_render_metrics_clis_write_jax_files(trained, tmp_path):
    _, tdir = trained
    ckpt = str(tmp_path / "start.npz")
    state = ttrain_cli.trainer.create_train_state(
        tply.load_gaussians_ply(os.path.join(tdir, "point_cloud", "iteration_2", "point_cloud.ply"), device="cpu"),
        tconfig.OptimizationParams(), 1.0, device="cpu")
    checkpoint.save_checkpoint(ckpt, state)
    renders = []
    real = tcompress_cli.metrics.render_full
    with pytest.MonkeyPatch.context() as m:
        m.setattr(tcompress_cli.metrics, "render_full", lambda *a, **k: renders.append(1) or real(*a, **k))
        compressed = tcompress_cli.main(["-m", tdir, "--finetune_iterations", "2", "--start_checkpoint", ckpt,
                                         *SMALL_VQ])
    vq = os.path.join(tdir, "vq")
    results = json.load(open(os.path.join(vq, "results.json")))
    assert list(results) == RESULTS_KEYS and len(renders) == 2
    assert list(json.load(open(os.path.join(vq, "times.json")))) == TIMES_KEYS
    assert list(json.load(open(os.path.join(vq, "per_view.json")))) == ["r_0"]
    assert list(json.load(open(os.path.join(vq, "cfg_args.json")))) == ["model", "optimization", "compression"]
    assert results["size_bytes"] == os.path.getsize(os.path.join(vq, "point_cloud.npz"))
    np.testing.assert_allclose(results["compression_ratio"], results["ply_size_bytes"] / results["size_bytes"])
    assert compressed.is_color_indexed and compressed.is_gaussian_indexed

    served = trender_cli.main(["-m", tdir])
    assert {k: v["num_views"] for k, v in served.items()} == {"train": 3, "test": 1}
    for split, names in (("train", ["r_0.png", "r_1.png", "r_2.png"]), ("test", ["r_0.png"])):
        for sub in ("renders", "gt"):
            assert sorted(os.listdir(os.path.join(tdir, split, "ours_2", sub))) == names
    tmetrics_cli.main(["-m", tdir, *CPU])
    tres = json.load(open(os.path.join(tdir, "results.json")))
    tper = json.load(open(os.path.join(tdir, "per_view.json")))
    jmetrics_cli.main(["-m", tdir])
    jres = json.load(open(os.path.join(tdir, "results.json")))
    jper = json.load(open(os.path.join(tdir, "per_view.json")))
    assert list(tres) == list(jres) == ["ours", "test/ours_2", "train/ours_2"]
    for k in ("test/ours_2", "train/ours_2"):
        assert list(tres[k]) == list(jres[k]) and tres[k]["LPIPS"] is None
        assert tres[k]["LPIPS_reason"] == jres[k]["LPIPS_reason"]
        np.testing.assert_allclose([tres[k]["PSNR"], tres[k]["SSIM"]], [jres[k]["PSNR"], jres[k]["SSIM"]], atol=1e-4)
    assert list(tper) == list(jper)


def test_clis_raise_without_a_card_unless_cpu(dataset, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ttrain_cli.main(["-s", dataset, "-m", str(tmp_path / "m"), "--epochs", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        tmetrics_cli.main(["-m", str(tmp_path)])
    with pytest.raises(RuntimeError, match="CUDA"):
        ttns_cli.main(["-s", dataset, "-m", str(tmp_path / "j"), "--epochs", "1"])
    for main, argv in ((ttrain_camera_cli.main, ["-s", dataset, "-m", str(tmp_path)]),
                       (trun_indexed_cli.main, ["-s", dataset, "-m", str(tmp_path)]),
                       (tnpz2ply_cli.main, [str(tmp_path / "in.npz"), str(tmp_path / "out.ply")])):
        with pytest.raises(RuntimeError, match="CUDA"):
            main(argv)


def test_train_cli_snapshots_and_raises_on_a_non_finite_loss(dataset, tmp_path, monkeypatch):
    """train.py:110-138: a non-finite loss writes the step's camera and
    scene tensors to snapshot_step_<it>.npz and raises."""
    real = ttrain_cli.trainer.train_step

    def nan_step(*a, **k):
        state, m = real(*a, **k)
        return state, {**m, "loss": torch.tensor(float("nan"))}

    monkeypatch.setattr(ttrain_cli.trainer, "train_step", nan_step)
    model = str(tmp_path / "nan")
    with pytest.raises(FloatingPointError, match="non-finite loss at step 1"):
        ttrain_cli.main(["-s", dataset, "-m", model, "--epochs", "1", *CPU])
    snap = np.load(os.path.join(model, "snapshot_step_1.npz"))
    assert {"extrinsic_vector", "intrinsic", "scene_xyz", "scene_active", "scene_scaling_factor"} <= set(snap.files)
    assert snap["scene_xyz"].shape == (1600, 3) and snap["intrinsic"].shape == (3, 3)


# ------------------------------------------- pose, joint and small CLIs
POSE_LINE = re.compile(r"^\[(\S+)\] pose error (\S+) -> (\S+) \(loss (\S+)\)$", re.M)


def test_train_no_splatting_cli_matches_jax(dataset, tmp_path):
    """One epoch (camera 0 only, at a pose perturbed from its anchor)
    in both packages: optimized_poses.npy within 1e-5, the .ply by
    tests/ply_bars.py, cfg_args.json alike. The port's run adds
    --compress: point_cloud_vq.npz loads as a codebook-indexed scene."""
    argv = ["-s", dataset, "--epochs", "1", "--perturb_poses", "0.005", "--anchor_weight", "0.5"]
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jtns_cli.main([*argv, "-m", jdir])
    js = ttns_cli.main([*argv, "-m", tdir, "--compress", *CPU])
    jposes, tposes = (np.load(os.path.join(d, "optimized_poses.npy")) for d in (jdir, tdir))
    assert tposes.shape == jposes.shape == (3, 7) and np.isfinite(tposes).all()
    np.testing.assert_allclose(tposes, jposes, atol=1e-5, rtol=0)
    np.testing.assert_allclose(np.linalg.norm(tposes[:, :4], axis=1), 1.0, atol=1e-6)
    assert float(js.ev_t[0]) == 1.0 and float(js.ev_t[1:].sum()) == 0.0
    ply = os.path.join("point_cloud", "iteration_1", "point_cloud.ply")
    assert_trained_plys_close(tply.read_vertices(os.path.join(tdir, ply)), tply.read_vertices(os.path.join(jdir, ply)),
                              steps=1)
    jcfg, tcfg = (json.load(open(os.path.join(d, "cfg_args.json"))) for d in (jdir, tdir))
    assert (jcfg["model"].pop("data_device"), tcfg["model"].pop("data_device")) == ("tpu", "cpu")
    jcfg["model"]["model_path"] = tcfg["model"]["model_path"]
    assert tcfg == jcfg
    vq = io_npz.load_npz(os.path.join(tdir, "point_cloud_vq.npz"), device="cpu")
    assert vq.is_color_indexed and vq.is_gaussian_indexed and vq.capacity == js.train.scene.num_active


def test_train_camera_cli_matches_jax(dataset, trained, tmp_path, capsys):
    """Two cameras, 5 Adam steps each, from np.random.default_rng(0)'s
    perturbations, against the port-trained .ply in both packages: the
    printed errors agree to their 4 decimals (1.5e-4) and the losses to
    their 5 (1.5e-5); --dump_dir writes one PNG per camera."""
    _, tdir = trained
    argv = ["-s", dataset, "-m", tdir, "--num_cameras", "2", "--iterations", "5"]
    jtrain_camera_cli.main(argv)
    jlines = POSE_LINE.findall(capsys.readouterr().out)
    dump = str(tmp_path / "dump")
    results = ttrain_camera_cli.main([*argv, "--dump_dir", dump, *CPU])
    tlines = POSE_LINE.findall(capsys.readouterr().out)
    assert [t[0] for t in tlines] == [j[0] for j in jlines] == ["r_0", "r_1"]
    for t, j in zip(tlines, jlines):
        np.testing.assert_allclose([float(v) for v in t[1:3]], [float(v) for v in j[1:3]], atol=1.5e-4)
        np.testing.assert_allclose(float(t[3]), float(j[3]), atol=1.5e-5)
    assert [r["image_name"] for r in results] == ["r_0", "r_1"] and all(np.isfinite(r["loss"]) for r in results)
    assert sorted(os.listdir(dump)) == ["r_0_opt.png", "r_1_opt.png"]
    from PIL import Image

    assert Image.open(os.path.join(dump, "r_0_opt.png")).size == (32, 32)


def test_npz2ply_cli_matches_jax(tmp_path):
    """tests/test_cli.py::test_npz2ply_cli's npz through both CLIs: the
    same columns, equal arrays but for the log scales, which pass through
    each package's exp and norm and part by one ulp in a few rows (3 of 50
    here, 1.19e-7): those at test_torch_model_io.py's cross-package .ply
    bar, 1e-6."""
    from c3dgs_tpu.models import gaussians as jgauss
    from c3dgs_tpu.models import io_npz as jnpz

    rng = np.random.default_rng(0)
    pts = rng.normal(size=(50, 3)).astype(np.float32)
    cols = rng.random(size=(50, 3)).astype(np.float32)
    scene = jgauss.from_point_cloud(pts, cols, capacity=50, quantization=True)
    scene = scene.replace(quant=scene.update_observers().quant)
    npz = str(tmp_path / "pc.npz")
    jnpz.save_npz(scene, npz)
    jout, tout = str(tmp_path / "jax.ply"), str(tmp_path / "port.ply")
    jnpz2ply_cli.main([npz, jout])
    tnpz2ply_cli.main([npz, tout, *CPU])
    got, ref = tply.read_vertices(tout), tply.read_vertices(jout)
    assert list(got) == list(ref)
    for name in ref:
        if name.startswith("scale_"):
            np.testing.assert_allclose(got[name], ref[name], atol=1e-6, rtol=0, err_msg=name)
        else:
            np.testing.assert_array_equal(got[name], ref[name], err_msg=name)


def test_run_indexed_cli(dataset, trained, tmp_path):
    """run_indexed.py's wiring in the port: to_compressed over the test
    split's first camera, 2 finetune steps, one inference render to
    --out."""
    _, tdir = trained
    out = str(tmp_path / "preview.png")
    compressed, rendered = trun_indexed_cli.main(["-s", dataset, "-m", tdir, "--finetune_iterations", "2", "--out", out,
                                                  *CPU])
    assert compressed.is_color_indexed and compressed.is_gaussian_indexed
    assert bool(torch.isfinite(rendered["render"]).all()) and int(rendered["overflow"]) == 0
    from PIL import Image

    assert Image.open(out).size == (32, 32)


def test_metrics_cli_computes_lpips_when_weights_exist(tmp_path, monkeypatch):
    """Both metrics CLIs given one random-weights file at their default
    paths (tests/test_lpips.py's recipe): per-view and mean LPIPS at
    rtol 1e-4, no LPIPS_reason."""
    from c3dgs_tpu.eval import lpips as jlpips
    from c3dgs_tpu_torch.eval import lpips as tlpips
    from PIL import Image
    from test_lpips import _random_weights

    rng = np.random.default_rng(0)
    weights = str(tmp_path / "lpips_vgg.npz")
    np.savez(weights, **_random_weights(rng))
    for mod in (jlpips, tlpips):
        monkeypatch.setattr(mod, "default_weights", lambda net_type="vgg": weights)
    model = tmp_path / "model"
    for sub in ("renders", "gt"):
        os.makedirs(model / "test" / "ours_1" / sub)
    for i in range(2):
        img = (rng.random(size=(32, 32, 3)) * 255).astype(np.uint8)
        noisy = np.clip(img + rng.normal(size=img.shape) * 20, 0, 255).astype(np.uint8)
        Image.fromarray(img).save(model / "test" / "ours_1" / "gt" / f"{i}.png")
        Image.fromarray(noisy).save(model / "test" / "ours_1" / "renders" / f"{i}.png")
    scores = []
    for run in (lambda: tmetrics_cli.main(["-m", str(model), *CPU]), lambda: jmetrics_cli.main(["-m", str(model)])):
        run()
        scores.append((json.load(open(model / "results.json")), json.load(open(model / "per_view.json"))))
    (tres, tper), (jres, jper) = scores
    assert list(tres["test/ours_1"]) == list(jres["test/ours_1"]) == ["SSIM", "PSNR", "LPIPS"]
    np.testing.assert_allclose(tres["test/ours_1"]["LPIPS"], jres["test/ours_1"]["LPIPS"], rtol=1e-4)
    for name in jper:
        np.testing.assert_allclose(tper[name]["lpips"], jper[name]["lpips"], rtol=1e-4)
