"""QAT finetune of a compressed (indexed) scene through the renderer (port
of c3dgs_tpu/train/finetune.py; finetune.py:10-66): random-camera steps
for `iterations` through the indexed render path (K1 forward, K2
backward), observers EMA-ing so the int8 ranges adapt, Adam with the
training LRs, no densification.

The port's train_step updates its state in place, and a compressed scene
shares tensors with the scene it came from; finetune trains a clone, so
the caller's scene keeps its bits.
"""
from __future__ import annotations

import random
import time
from typing import List, Optional

import torch

from ..config import OptimizationParams
from ..device import DeviceLike
from ..models.gaussians import GaussianScene
from ..render.capacity import CapacityPolicy
from ..render.types import settings_from_intrinsic
from . import trainer


def finetune(
    scene: GaussianScene,
    cameras: List,
    opt: OptimizationParams,
    iterations: int,
    bg=None,
    spatial_lr_scale: float = 1.0,
    log_every: int = 500,
    seed: int = 0,
    history: Optional[list] = None,
    device: DeviceLike = None,
) -> GaussianScene:
    """The finetuned copy of `scene`. random.Random(seed) picks each step's
    camera, as in the JAX package, so both pick the same sequence. One
    probe render of cameras[0] seeds the capacity policy (twice its
    instances, at least 2^18 slots; twice its grad_total), which then
    follows the frames. `history`, if given, receives each step's metrics
    as numbers and its host-clock `ms` (the metrics' read waits for the
    step's device work). Runs on the scene's device, which must be `device` (CUDA
    unless the caller names another)."""
    if not (scene.is_color_indexed and scene.is_gaussian_indexed):
        raise ValueError("finetune expects a compressed (indexed) scene")
    trainer._check_device(scene, device)
    scene = scene.clone()
    dev = scene.device
    bg = torch.zeros(3, device=dev) if bg is None else torch.as_tensor(bg, dtype=torch.float32, device=dev)
    state = trainer.create_train_state(scene, opt, spatial_lr_scale, device=dev)
    rng = random.Random(seed)
    probe_cam = cameras[0]
    with torch.no_grad():
        probe = trainer.render_scene(scene, probe_cam.extrinsic_vector, settings_from_intrinsic(probe_cam.intrinsic),
                                     bg, device=dev)
    capacity = CapacityPolicy(
        initial=max(int(probe["num_instances"]) * 2, 1 << 18),
        grad_initial=int(probe["grad_total"]) * 2,
    )
    ema_loss = None
    t0 = time.time()
    for it in range(iterations):
        t_step = time.perf_counter()
        cam = rng.choice(cameras)
        settings = capacity.apply(settings_from_intrinsic(cam.intrinsic))
        state, metrics = trainer.train_step(state, cam.extrinsic_vector, cam.original_image, settings, bg, opt,
                                            spatial_lr_scale, device=dev)
        m = {k: float(v) if k in ("loss", "psnr") else int(v) for k, v in metrics.items()}
        m["ms"] = (time.perf_counter() - t_step) * 1e3
        capacity.update(m["num_instances"], m["overflow"], m["grad_total"], m["grad_overflow"])
        capacity.note_clamped(f"finetune step {it}", m["num_instances"], m["overflow"])
        if history is not None:
            history.append(m)
        ema_loss = m["loss"] if ema_loss is None else 0.6 * ema_loss + 0.4 * m["loss"]
        if log_every and (it % log_every == 0 or it == iterations - 1):
            print(
                f"[finetune {it}/{iterations}] loss={m['loss']:.4f} ema={ema_loss:.4f} psnr={m['psnr']:.2f} "
                f"inst={m['num_instances']} ovf={m['overflow']} ({time.time() - t0:.1f}s)"
            )
    return state.scene
