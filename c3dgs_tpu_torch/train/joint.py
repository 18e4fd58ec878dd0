"""Joint scene + camera-pose training (port of c3dgs_tpu/train/joint.py;
the reference's train_no_splatting.py).

Parity: train_no_splatting.py:1-283: every camera's 7-vector extrinsic is
optimized jointly with the scene, an anchor penalty w * mean(exp(|orig -
cur|) - 1) keeping each pose near its initialization (:120-122). Pose
gradients come back through K2 and the preprocess autograd.

Per-camera Adam state is carried as (C, 7) moment tensors and a (C,)
float32 step count, and only the stepped camera's row advances: the
reference's one optimizer per camera extrinsic. As the port's train_step,
joint_step updates the state's tensors in place and returns the state.
"""
from __future__ import annotations

import dataclasses

import torch

from ..config import OptimizationParams
from ..device import DeviceLike
from ..models.gaussians import GaussianScene
from ..ops import losses as L
from . import densify as D
from . import trainer
from .camera_opt import POSE_ADAM_EPS, anchor_penalty, normalize_quaternion


@dataclasses.dataclass
class JointTrainState:
    train: trainer.TrainState
    evs: torch.Tensor  # (C, 7) current extrinsics
    anchors: torch.Tensor  # (C, 7) initial extrinsics (anchor penalty target)
    ev_m: torch.Tensor  # (C, 7) Adam first moments
    ev_v: torch.Tensor  # (C, 7) Adam second moments
    ev_t: torch.Tensor  # (C,) float32 per-camera step counts


def create_joint_state(
    scene: GaussianScene,
    opt: OptimizationParams,
    spatial_lr_scale: float,
    extrinsics,
    seed: int = 0,
    device: DeviceLike = None,
) -> JointTrainState:
    """A fresh state on the scene's device, which must be `device` (CUDA
    unless the caller names another); `extrinsics` is (C, 7)."""
    train = trainer.create_train_state(scene, opt, spatial_lr_scale, seed, device=device)
    evs = torch.as_tensor(extrinsics, dtype=torch.float32, device=scene.device).clone()
    return JointTrainState(
        train=train,
        evs=evs,
        anchors=evs.clone(),
        ev_m=torch.zeros_like(evs),
        ev_v=torch.zeros_like(evs),
        ev_t=torch.zeros(evs.shape[0], dtype=torch.float32, device=scene.device),
    )


def joint_step(
    js: JointTrainState,
    cam_idx: int,
    gt_image,
    settings,
    bg,
    opt: OptimizationParams = OptimizationParams(),
    spatial_lr_scale: float = 1.0,
    pose_lr: float = 1e-4,
    anchor_weight: float = 0.0,
    device: DeviceLike = None,
):
    """One joint step on (scene params, camera cam_idx's extrinsic):
    observers, render, photometric loss (+ anchor penalty), one
    autograd.grad over the scene params, the extrinsic and the viewspace
    offset, the scene's Adam, the camera's Adam (eps 1e-8) on its row,
    densify statistics. Returns (js, metrics) with the metrics as tensors
    on the device."""
    state = js.train
    trainer._check_device(state.scene, device)
    scene = state.scene.update_observers()
    dev = scene.device
    gt = torch.as_tensor(gt_image, dtype=torch.float32, device=dev)
    bg = torch.as_tensor(bg, dtype=torch.float32, device=dev)
    params = trainer.scene_params(scene)
    ev = js.evs[cam_idx].clone().requires_grad_(True)
    anchor = js.anchors[cam_idx]
    vs = torch.zeros((scene.capacity, 2), dtype=torch.float32, device=dev, requires_grad=True)

    out = trainer.render_scene(scene, ev, settings, bg, viewspace_offset=vs, device=dev)
    loss = L.photometric_loss(out["render"], gt, opt.lambda_dssim)
    if anchor_weight > 0:
        loss = loss + anchor_penalty(ev, anchor, anchor_weight)
    g = torch.autograd.grad(loss, [*params.values(), ev, vs], allow_unused=True)
    grads = {k: torch.zeros_like(p) if gk is None else gk for (k, p), gk in zip(params.items(), g)}
    g_ev, vs_grad = g[-2], g[-1]

    trainer.adam_update(state.opt_state, params, grads, trainer.make_lr_schedules(opt, spatial_lr_scale))

    # per-camera Adam on the stepped extrinsic only
    cam = trainer.AdamState(mu={"ev": js.ev_m[cam_idx]}, nu={"ev": js.ev_v[cam_idx]},
                            count=int(js.ev_t[cam_idx].item()))
    ev = ev.detach()
    trainer.adam_update(cam, {"ev": ev}, {"ev": g_ev}, {"ev": lambda step: pose_lr}, eps=POSE_ADAM_EPS)
    normalize_quaternion(ev)
    js.evs[cam_idx] = ev
    js.ev_m[cam_idx] = cam.mu["ev"]
    js.ev_v[cam_idx] = cam.nu["ev"]
    js.ev_t[cam_idx] += 1.0

    state.stats = D.add_densification_stats(state.stats, vs_grad, out["radii"])
    state.step += 1
    metrics = {
        "loss": loss.detach(),
        "psnr": L.psnr(out["render"].detach(), gt)[0, 0],
        "num_instances": out["num_instances"],
        "overflow": out["overflow"],
        "grad_total": out["grad_total"],
        "grad_overflow": out["grad_overflow"],
        "pose_delta": torch.max(torch.abs(ev - anchor)),
    }
    return js, metrics
