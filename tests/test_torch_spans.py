"""The port's layer spans (c3dgs_tpu_torch/spans.py) on the CPU.

- With no profiler, a train_step and a render_full make no
  `record_function` call (it is made to raise), and every span is the one
  shared no-op context.
- Under torch.profiler, a tiny train_step opens exactly the spans of its
  layers, in both kernel families and on a quantized codebook-indexed scene
  (the table gradients' span included); a render_full opens the view's.
  A camera_step opens the pose step's spans. Every layer span lies in
  time inside the one root span of its step or view.
- train_step returns the binning's `clipped` counter, and finetune prints
  a `[binning]` line for a step that dropped tiles.
"""
import math
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from c3dgs_tpu_torch import spans
from c3dgs_tpu_torch.config import OptimizationParams
from c3dgs_tpu_torch.eval import metrics as tmetrics
from c3dgs_tpu_torch.models import gaussians as tgauss
from c3dgs_tpu_torch.render.capacity import CapacityPolicy
from c3dgs_tpu_torch.render.types import RasterSettings
from c3dgs_tpu_torch.train import camera_opt
from c3dgs_tpu_torch.train import finetune as tfinetune
from c3dgs_tpu_torch.train import trainer
import torch_cpu  # noqa: F401,E402  (one torch thread per test worker)

KW = dict(width=32, height=32, tanfovx=math.tan(0.5), tanfovy=math.tan(0.5), sh_degree=0,
          instance_capacity=4096)
EV = np.array([0, 0, 0, 1, 0, 0, 0], np.float32)
BG = np.zeros(3, np.float32)
CPU = dict(device="cpu")
TRAIN = {"train_step", "accessors", "preprocess", "binning", "stage", "blend", "loss", "backward", "blend_bwd",
         "reduction", "optimizer"}
VIEW = {"view", "accessors", "preprocess", "binning", "stage", "blend"}
POSE = TRAIN - {"train_step", "optimizer"} | {"pose_step", "pose_optimizer"}


def scene(quantization=False, indexed=False, n=60, cap=96):
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(n, 3)).astype(np.float32) * 0.5
    pts[:, 2] += 3.0
    s = tgauss.from_point_cloud(pts, rng.random(size=(n, 3)).astype(np.float32), capacity=cap,
                                quantization=quantization, **CPU)
    if indexed:
        # 16-row colour and shape tables, each row read by several splats
        f = torch.cat([s.features_dc, s.features_rest], 1)[:16].detach()
        s = s.set_color_indexed(f, torch.as_tensor(rng.integers(0, 16, cap)))
        s = s.set_gaussian_indexed(s.rotation[:16].detach(), s.scaling[:16].detach(),
                                   torch.as_tensor(rng.integers(0, 16, cap)))
    return s.update_observers()


def step(s, settings):
    state = trainer.create_train_state(s, OptimizationParams(), 1.0, **CPU)
    target = np.full((3, 32, 32), 0.25, np.float32)
    return trainer.train_step(state, EV, target, settings, BG, OptimizationParams(), 1.0, **CPU)


def view(s):
    return tmetrics.render_full(s, EV, RasterSettings(**KW, inference=True), BG, CapacityPolicy(), **CPU)


def recorded(fn):
    """(name without the prefix, start, end) of each span `fn` opens under
    a CPU profiler."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return [(e.name[len(spans.PREFIX):], e.time_range.start, e.time_range.end)
            for e in prof.events() if e.name.startswith(spans.PREFIX)]


def test_no_profiler_makes_no_record_function_call(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function called with no profiler")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert spans.span("train_step") is spans.span("view")
    _, m = step(scene(quantization=True, indexed=True), RasterSettings(**KW))
    assert math.isfinite(float(m["loss"]))
    assert view(scene())["renders"] == 1


def _hold(got, root, names):
    assert {n for n, _, _ in got} == names | {root}
    roots = [(a, b) for n, a, b in got if n == root]
    assert len(roots) == 1
    a0, b0 = roots[0]
    for n, a, b in got:
        assert a0 <= a and b <= b0, (n, a, b, a0, b0)


@pytest.mark.parametrize("packed", [True, False])
def test_dense_train_step_opens_the_layer_spans(packed):
    s = scene()
    _hold(recorded(lambda: step(s, RasterSettings(**KW, packed=packed))), "train_step", TRAIN - {"train_step"})


def test_indexed_quantized_train_step_opens_the_table_gradients_span():
    s = scene(quantization=True, indexed=True)
    got = recorded(lambda: step(s, RasterSettings(**KW)))
    _hold(got, "train_step", (TRAIN | {"table_grads"}) - {"train_step"})
    # colour and shape tables, one segment sum each
    assert sum(n == "table_grads" for n, _, _ in got) == 2


def test_camera_step_opens_the_pose_spans():
    """The pose step's root, its render's layers, the loss, the backward
    (K2 and the reduction inside it) and the 7-vector's Adam."""
    s = scene()
    ev = torch.tensor([0.01, -0.01, 0.005, 1.0, 0.05, -0.04, 0.02])
    target = torch.full((3, 32, 32), 0.25)
    state = trainer.adam_init({"ev": ev})
    got = recorded(lambda: camera_opt.camera_step(s, ev, state, target, RasterSettings(**KW), torch.zeros(3)))
    _hold(got, "pose_step", POSE - {"pose_step"})


def test_render_full_opens_the_view_spans():
    s = scene(quantization=True, indexed=True)
    _hold(recorded(lambda: view(s)), "view", VIEW - {"view"})


def test_train_step_returns_clipped():
    """One tile a splat at most: every splat over both tiles drops one."""
    s = scene()
    settings = RasterSettings(**KW, max_tiles_per_gaussian=1)
    with torch.no_grad():
        want = int(trainer.render_scene(s, EV, settings, BG, **CPU)["clipped"])
    _, m = step(s, settings)
    assert int(m["clipped"]) == want > 0


def test_finetune_prints_a_binning_line_for_a_clipped_step(monkeypatch, capsys):
    real = trainer.train_step

    def clipped_step(*a, **k):
        state, m = real(*a, **k)
        return state, {**m, "clipped": torch.tensor(7, dtype=torch.int32)}

    monkeypatch.setattr(tfinetune.trainer, "train_step", clipped_step)
    s = scene(quantization=True, indexed=True)
    intr = np.array([[1.0, 0, 32], [0, 1.0, 32], [0, 0, 1]], np.float32)
    cam = SimpleNamespace(extrinsic_vector=EV, intrinsic=intr, original_image=np.full((3, 32, 32), 0.25, np.float32))
    tfinetune.finetune(s, [cam], OptimizationParams(), iterations=2, log_every=0, **CPU)
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("[binning]")]
    assert lines == [f"[binning] finetune step {i}: 7 tiles dropped past the per-splat tile cap" for i in range(2)]
