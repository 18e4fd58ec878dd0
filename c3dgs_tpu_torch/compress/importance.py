"""Sensitivity (importance): per-view |grad| of the photometric loss with
respect to the SH features and the de-scaled covariance, summed over the
views (port of c3dgs_tpu/compress/importance.py; compress.py
calc_importance_experimental :81-119 = GaussianModel.calc_importance
gaussian_model.py:912-952).

Each view renders with an explicit cov3d = (cov3d / scaling_factor^2) *
scaling_factor^2 whose de-scaled factor is the differentiated input, with
color clamping off, and backpropagates L1 + 0.2 (1 - SSIM) against the
view's image through K2. The capacity policy renders a view again until
it fits, so no view is counted with dropped instances.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ..device import DeviceLike
from ..models.gaussians import GaussianScene
from ..ops import losses as L
from ..render.capacity import CapacityPolicy
from ..render.types import settings_from_intrinsic
from ..train import trainer


def _importance_step(scene: GaussianScene, extrinsic_vector, gt_image, settings, use_gt: bool):
    """|grad| of one view with respect to (features_dc, features_rest,
    cov3d / scaling_factor^2), and the render's (num_instances, overflow)."""
    coeff = scene.get_scaling_factor().detach() ** 2  # (P, 1)
    cov_descaled = (scene.get_covariance().detach() / coeff).requires_grad_()
    out = trainer.render_scene(scene, extrinsic_vector, settings, torch.zeros(3), cov3d=cov_descaled * coeff,
                               device=scene.device)
    image = out["render"]
    if use_gt:
        loss = L.photometric_loss(image, gt_image, 0.2)  # compress.py:104-108
    else:
        loss = image.sum()
    g_dc, g_rest, g_cov = torch.autograd.grad(loss, [scene.features_dc, scene.features_rest, cov_descaled])
    return g_dc.abs(), g_rest.abs(), g_cov.abs(), (int(out["num_instances"]), int(out["overflow"]))


def calc_importance(
    scene: GaussianScene,
    cameras,
    use_gt: bool = True,
    render_settings_fn=None,
    device: DeviceLike = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sum over `cameras` -> (color importance (F, K*3), gaussian
    sensitivity (P, 6)), both divided by the pixel count (compress.py:
    111-119). Cameras have .extrinsic_vector, .intrinsic and (with use_gt)
    .original_image. For an indexed scene the color gradients land on the
    codebook rows, as in the reference. Runs on the scene's device, which
    must be `device` (CUDA unless the caller names another)."""
    trainer._check_device(scene, device)
    dev = scene.device
    accum_dc = torch.zeros_like(scene.features_dc, requires_grad=False)
    accum_rest = torch.zeros_like(scene.features_rest, requires_grad=False)
    accum_cov = None
    num_pixels = 0
    policy = CapacityPolicy()
    for cam in cameras:
        settings = render_settings_fn(cam) if render_settings_fn else settings_from_intrinsic(cam.intrinsic)
        settings = dataclasses.replace(settings, clamp_color=False)  # compress.py:102
        gt = torch.as_tensor(cam.original_image, dtype=torch.float32, device=dev) if use_gt else None
        for _ in range(8):
            g_dc, g_rest, g_cov, (n_inst, overflow) = _importance_step(
                scene, cam.extrinsic_vector, gt, policy.apply(settings), use_gt
            )
            if not policy.update(n_inst, overflow):
                break
        policy.check_whole(n_inst, overflow)
        accum_dc += g_dc
        accum_rest += g_rest
        accum_cov = g_cov if accum_cov is None else accum_cov + g_cov
        num_pixels += settings.width * settings.height
    color = torch.cat([accum_dc, accum_rest], 1)
    return color.reshape(color.shape[0], -1) / num_pixels, accum_cov / num_pixels
