"""Training (port of c3dgs_tpu/train/trainer.py): Adam with per-attribute
learning rates, the train step, densify scheduling and capacity growth.

Parity: GaussianModel.training_setup (gaussian_model.py:292-314: per-group
LRs, Adam eps 1e-15, the exponential xyz schedule :316-322) and the fork's
epoch trainer (train.py:58-106: L1 + lambda(1 - SSIM), observer updates,
densify statistics).

The optimizer is written as plain functions over dicts of tensors (`mu`,
`nu` per field, and the counts), as optax holds its state, and not as
torch.optim.Adam: grow_capacity pads the moments and zero_moments_at masks
them per field and per row, and densification rewrites parameter rows in
place, which would leave a torch optimizer's per-Parameter state keyed to
replaced tensors. The JAX step returns new arrays; here train_step,
densify_step and reset_opacity_step update the state's tensors in place
and return the state.

Every entry point (create_train_state, train_step, grow_capacity,
densify_step, reset_opacity_step) runs on the scene's device, which must
be the `device` argument: CUDA unless the caller names another.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from ..config import OptimizationParams
from ..device import DeviceLike, resolve_device
from ..models.gaussians import GaussianScene
from ..ops import losses as L
from ..ops import camera_math, misc
from ..ops import sh as sh_ops
from ..render.rasterizer import render
from ..render.types import RasterSettings
from . import densify as D

PARAM_FIELDS = (
    "xyz",
    "features_dc",
    "features_rest",
    "opacity",
    "scaling",
    "scaling_factor",
    "rotation",
)
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-15


def scene_params(scene: GaussianScene) -> Dict[str, torch.nn.Parameter]:
    p = {k: getattr(scene, k) for k in PARAM_FIELDS}
    if scene.scaling_factor is None:
        p.pop("scaling_factor")
    return p


def make_lr_schedules(opt: OptimizationParams, spatial_lr_scale: float) -> dict:
    """Per-attribute LR schedules, step -> float (gaussian_model.py:297-314)."""
    xyz_sched = misc.get_expon_lr_func(
        lr_init=opt.position_lr_init * spatial_lr_scale,
        lr_final=opt.position_lr_final * spatial_lr_scale,
        lr_delay_mult=opt.position_lr_delay_mult,
        max_steps=opt.position_lr_max_steps,
    )
    const = lambda v: (lambda step: v)
    return {
        "xyz": xyz_sched,
        "features_dc": const(opt.feature_lr),
        "features_rest": const(opt.feature_lr / 20.0),
        "opacity": const(opt.opacity_lr),
        "scaling": const(opt.scaling_lr),
        "scaling_factor": const(opt.scaling_lr),
        "rotation": const(opt.rotation_lr),
    }


@dataclasses.dataclass
class AdamState:
    """optax.scale_by_adam's state (count, mu, nu) plus the LR step."""

    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]
    count: int = 0
    step: int = 0


def adam_init(params: Dict[str, torch.Tensor]) -> AdamState:
    return AdamState(
        mu={k: torch.zeros_like(v) for k, v in params.items()},
        nu={k: torch.zeros_like(v) for k, v in params.items()},
    )


@torch.no_grad()
def adam_update(state: AdamState, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
                schedules: dict) -> None:
    """One Adam(b1 0.9, b2 0.999, eps 1e-15) step, in place:
    param += -lr_k(step) * mu_hat / (sqrt(nu_hat) + eps), with the LR step
    read before it is incremented (trainer.make_optimizer)."""
    count = state.count + 1
    # optax's bias corrections 1 - b**count in float32, with a float
    # exponent: torch's integer-exponent pow rounds differently at some
    # counts, and 1 - 0.999**count amplifies one ulp to ~1e-5 of the update
    f32 = lambda v: torch.tensor(v, dtype=torch.float32)
    bc1 = float(1.0 - torch.pow(f32(ADAM_B1), f32(count)))
    bc2 = float(1.0 - torch.pow(f32(ADAM_B2), f32(count)))
    for k, p in params.items():
        g = grads[k]
        mu = (1 - ADAM_B1) * g + ADAM_B1 * state.mu[k]
        nu = (1 - ADAM_B2) * (g * g) + ADAM_B2 * state.nu[k]
        state.mu[k], state.nu[k] = mu, nu
        # full-size divisors: torch applies a one-element divisor as a
        # product with its reciprocal, which rounds differently from the
        # division optax performs
        mu_hat = mu / torch.full_like(mu, bc1)
        nu_hat = nu / torch.full_like(nu, bc2)
        p.add_(-schedules[k](state.step) * (mu_hat / (torch.sqrt(nu_hat) + ADAM_EPS)))
    state.count = count
    state.step += 1


@dataclasses.dataclass
class TrainState:
    scene: GaussianScene
    opt_state: AdamState
    stats: D.DensifyStats
    generator: torch.Generator  # the JAX state's PRNG key
    step: int = 0


def create_train_state(
    scene: GaussianScene,
    opt: OptimizationParams,
    spatial_lr_scale: float,
    seed: int = 0,
    device: DeviceLike = None,
) -> TrainState:
    """A fresh state on the scene's device, which must be `device` (CUDA
    unless the caller names another)."""
    _check_device(scene, device)
    gen = torch.Generator(device=scene.device)
    gen.manual_seed(seed)
    return TrainState(
        scene=scene,
        opt_state=adam_init(scene_params(scene)),
        stats=D.DensifyStats.zeros(scene.capacity, scene.device),
        generator=gen,
    )


def _check_device(scene: GaussianScene, device: DeviceLike) -> torch.device:
    dev = resolve_device(device)
    if scene.device.type != dev.type or (dev.index is not None and scene.device.index != dev.index):
        raise ValueError(f"scene lives on {scene.device}, the call asked for {dev}")
    return dev


def settings_with_degree(settings: RasterSettings, degree: int) -> RasterSettings:
    if settings.sh_degree == degree:
        return settings
    return dataclasses.replace(settings, sh_degree=degree)


# indexed scenes at or above this capacity evaluate SH colors block by block
# from the codebook instead of gathering a dense (P, K, 3) SH array first
# (ops/sh.py::sh_to_rgb_indexed_blocked)
BLOCKED_COLORS_MIN = 1 << 20


def render_scene(
    scene: GaussianScene,
    extrinsic_vector,
    settings: RasterSettings,
    bg,
    viewspace_offset: Optional[torch.Tensor] = None,
    cov3d: Optional[torch.Tensor] = None,
    scaling_modifier: float = 1.0,
    blocked_colors: Optional[bool] = None,
    device: DeviceLike = None,
) -> dict:
    """GaussianModel.render on a scene, dense or codebook-indexed:
    accessors -> rasterize.

    blocked_colors: for a color-indexed scene, compute per-splat RGB block
    by block from the (C, K, 3) codebook instead of gathering dense SH
    first; None = on at >= BLOCKED_COLORS_MIN splats.

    Runs on `device` (CUDA unless the caller names another); the scene must
    already live there, while the camera vector and bg may be numpy arrays
    or tensors anywhere."""
    _check_device(scene, device)
    ev = torch.as_tensor(extrinsic_vector, dtype=torch.float32, device=scene.device)
    bg = torch.as_tensor(bg, dtype=torch.float32, device=scene.device)
    settings = settings_with_degree(settings, scene.active_sh_degree)
    cov = scene.get_covariance(scaling_modifier) if cov3d is None else cov3d
    use_blocked = scene.is_color_indexed and (
        blocked_colors or (blocked_colors is None and scene.capacity >= BLOCKED_COLORS_MIN)
    )
    shs = colors = None
    xyz = scene.get_xyz()
    if use_blocked:
        dirs = xyz - camera_math.camera_center_from_extrinsic(ev)
        # the guarded normalization of preprocess (NaN-free padded rows)
        dirs = dirs * torch.rsqrt(torch.sum(dirs * dirs, -1, keepdim=True) + 1e-20)
        colors = sh_ops.sh_to_rgb_indexed_blocked(
            settings.sh_degree, scene.get_features_raw(), scene.feature_indices, dirs,
            clamp_color=settings.clamp_color,
        )
    else:
        shs = scene.get_features()
    return render(
        xyz,
        cov,
        scene.get_opacity()[:, 0],
        ev,
        settings,
        bg,
        shs=shs,
        colors_precomp=colors,
        viewspace_offset=viewspace_offset,
    )


def loss_and_grads(scene: GaussianScene, extrinsic_vector, gt_image, settings: RasterSettings, bg,
                   opt: OptimizationParams):
    """The step's forward and backward on the scene as it is: (loss, render
    output, grads by parameter field, viewspace-offset grad)."""
    params = scene_params(scene)
    vs = torch.zeros((scene.capacity, 2), dtype=torch.float32, device=scene.device, requires_grad=True)
    out = render_scene(scene, extrinsic_vector, settings, bg, viewspace_offset=vs, device=scene.device)
    gt = torch.as_tensor(gt_image, dtype=torch.float32, device=scene.device)
    loss = L.photometric_loss(out["render"], gt, opt.lambda_dssim)
    g = torch.autograd.grad(loss, [*params.values(), vs], allow_unused=True)
    grads = {k: torch.zeros_like(p) if gk is None else gk for (k, p), gk in zip(params.items(), g)}
    return loss.detach(), out, grads, g[-1]


def train_step(
    state: TrainState,
    extrinsic_vector,
    gt_image,
    settings: RasterSettings,
    bg,
    opt: OptimizationParams = OptimizationParams(),
    spatial_lr_scale: float = 1.0,
    device: DeviceLike = None,
) -> Tuple[TrainState, dict]:
    """One optimization step (train.py:58-106): observer EMA -> render ->
    photometric loss -> grads -> Adam -> densify stats. Updates the state in
    place; the metrics are tensors on the scene's device."""
    _check_device(state.scene, device)
    scene = state.scene.update_observers()
    gt = torch.as_tensor(gt_image, dtype=torch.float32, device=scene.device)
    loss, out, grads, vs_grad = loss_and_grads(scene, extrinsic_vector, gt, settings, bg, opt)
    adam_update(state.opt_state, scene_params(scene), grads, make_lr_schedules(opt, spatial_lr_scale))
    state.stats = D.add_densification_stats(state.stats, vs_grad, out["radii"])
    state.step += 1
    metrics = {
        "loss": loss,
        "psnr": L.psnr(out["render"].detach(), gt)[0, 0],
        "num_instances": out["num_instances"],
        "overflow": out["overflow"],
        "grad_total": out["grad_total"],
        "grad_overflow": out["grad_overflow"],
    }
    return state, metrics


def grow_capacity(state: TrainState, new_capacity: int, device: DeviceLike = None) -> TrainState:
    """Grow the row budget without resetting the optimizer: the scene gets
    inactive padding rows, the Adam moments and densify stats zero rows,
    and every count is kept (cat_tensors_to_optimizer,
    gaussian_model.py:1161-1185)."""
    _check_device(state.scene, device)
    extra = new_capacity - state.scene.capacity
    if extra <= 0:
        return state

    def pad(v):
        return torch.cat([v, torch.zeros((extra, *v.shape[1:]), dtype=v.dtype, device=v.device)])

    opt = state.opt_state
    return dataclasses.replace(
        state,
        scene=state.scene.pad_to_capacity(new_capacity),
        opt_state=AdamState(
            mu={k: pad(v) for k, v in opt.mu.items()},
            nu={k: pad(v) for k, v in opt.nu.items()},
            count=opt.count,
            step=opt.step,
        ),
        stats=D.DensifyStats(*(pad(v) for v in dataclasses.astuple(state.stats))),
    )


@torch.no_grad()
def zero_moments_at(opt_state: AdamState, written: torch.Tensor, fields=None) -> AdamState:
    """Zero the Adam moments of rewritten rows, in place (the reference's
    optimizer surgery, gaussian_model.py:1061-1185)."""
    for tree in (opt_state.mu, opt_state.nu):
        for k, v in tree.items():
            if fields is None or k in fields:
                v[written] = 0.0
    return opt_state


def densify_step(
    state: TrainState,
    extent: float,
    opt: OptimizationParams,
    max_screen_size: Optional[float] = None,
    min_opacity: float = 0.005,
    device: DeviceLike = None,
):
    """The ADC step and the Adam-moment reset of rewritten rows, in place.
    Returns (state, dropped)."""
    _check_device(state.scene, device)
    scene, written, stats, dropped = D.densify_and_prune(
        state.scene,
        state.stats,
        state.generator,
        max_grad=opt.densify_grad_threshold,
        min_opacity=min_opacity,
        extent=extent,
        max_screen_size=max_screen_size,
        percent_dense=opt.percent_dense,
    )
    zero_moments_at(state.opt_state, written)
    state.scene, state.stats = scene, stats
    return state, dropped


def reset_opacity_step(state: TrainState, device: DeviceLike = None) -> TrainState:
    """reset_opacity and zero its Adam moments (gaussian_model.py:1391 +
    replace_tensor_to_optimizer :1061), in place."""
    _check_device(state.scene, device)
    D.reset_opacity(state.scene)
    zero_moments_at(
        state.opt_state, torch.ones(state.scene.capacity, dtype=torch.bool, device=state.scene.device),
        fields={"opacity"},
    )
    return state
