"""Trainer (port of c3dgs_tpu/train/trainer.py). So far only the scene-level
render entry point; the optimizer, train step and densify schedule come
with the training slice."""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..device import DeviceLike, resolve_device
from ..models.gaussians import GaussianScene
from ..render.rasterizer import render
from ..render.types import RasterSettings


def settings_with_degree(settings: RasterSettings, degree: int) -> RasterSettings:
    if settings.sh_degree == degree:
        return settings
    return dataclasses.replace(settings, sh_degree=degree)


def render_scene(
    scene: GaussianScene,
    extrinsic_vector,
    settings: RasterSettings,
    bg,
    viewspace_offset: Optional[torch.Tensor] = None,
    cov3d: Optional[torch.Tensor] = None,
    scaling_modifier: float = 1.0,
    device: DeviceLike = None,
) -> dict:
    """GaussianModel.render on a dense scene: accessors -> rasterize.

    Runs on `device` (CUDA unless the caller names another); the scene must
    already live there, while the camera vector and bg may be numpy arrays
    or tensors anywhere."""
    dev = resolve_device(device)
    if scene.device.type != dev.type or (
        dev.index is not None and scene.device.index != dev.index
    ):
        raise ValueError(f"scene lives on {scene.device}, render asked for {dev}")
    ev = torch.as_tensor(extrinsic_vector, dtype=torch.float32, device=scene.device)
    bg = torch.as_tensor(bg, dtype=torch.float32, device=scene.device)
    settings = settings_with_degree(settings, scene.active_sh_degree)
    cov = scene.get_covariance(scaling_modifier) if cov3d is None else cov3d
    return render(
        scene.get_xyz(),
        cov,
        scene.get_opacity()[:, 0],
        ev,
        settings,
        bg,
        shs=scene.get_features(),
        viewspace_offset=viewspace_offset,
    )
