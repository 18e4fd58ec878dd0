"""Named ranges at the layer boundaries of a training step, a pose step
and a served view, for `torch.profiler`.

While a profiler records, `span(name)` is a `record_function` range named
`c3dgs.<name>`: it sits in the profiler's trace beside the kernels it
launches, on one clock, and the profiler keeps it with the rest of its
events. Otherwise `span(name)` is one shared no-op context, returned after
one check. There is no switch: the ranges exist exactly when a profiler
records.

The ranges (where each opens, what it covers):

- `train_step`: `train/trainer.py::train_step`, the root of one step;
- `pose_step`: `train/camera_opt.py::camera_step`, the root of one pose
  step against a frozen scene;
- `view`: `eval/metrics.py::render_full`, the root of one served view,
  re-renders included;
- `accessors`: `GaussianScene.update_observers` and `trainer.render_scene`
  up to its `render` call (fake-quant getters, fp16 positions, codebook
  gathers, covariances, SH features or blocked colours);
- `preprocess`, `binning`: `render/rasterizer.py::render`;
- `stage`, `blend`: the forwards of the blend functions (staging, K1/K3),
  then `render` (`assemble_image`);
- `loss`, `backward`: `trainer.loss_and_grads` and
  `camera_opt.pose_loss_and_grad` (the photometric loss, the
  `torch.autograd.grad` call: in a pose step its self time is the chain
  from the screen-space gradients back to the 7-vector); `loss` again in
  SSIM's hand-written backward;
- `blend_bwd`, `reduction`: the backwards of the blend functions (K2/K4,
  the per-instance gradient reduction);
- `table_grads`: `ops/segment.py::_GatherRows.backward` (a codebook
  table's segment sums);
- `optimizer`: `train_step` (Adam and the densification statistics);
- `pose_optimizer`: `camera_step` (the 7-vector's Adam and the
  quaternion's renormalisation).

A range opened in a backward runs on the autograd engine's thread; it lies
inside `backward` in time. Every range of one step or view lies in time
inside the one root range that encloses it.
"""
from __future__ import annotations

import contextlib

import torch

PREFIX = "c3dgs."
_OFF = contextlib.nullcontext()


def span(name: str):
    """The range `c3dgs.<name>` while a profiler records, else a no-op."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return torch.autograd.profiler.record_function(PREFIX + name)
