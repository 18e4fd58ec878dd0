"""Camera-pose optimization against a frozen scene (port of
c3dgs_tpu/train/camera_opt.py).

Parity: train_camera.py (:1-197): perturb a camera's 7-vector extrinsic,
then Adam on the extrinsic alone until the photometric loss against the
reference view recovers the pose, optionally with the anchor penalty
w * mean(exp(|anchor - ev|) - 1) of train_no_splatting.py:120-122. The
pose is a differentiated input of the render: its gradient comes back
through K2 and the preprocess autograd, not through the reference's
generated pose Jacobians (…no_camera/__init__.py:537-866).

The scene is frozen: each step takes torch.autograd.grad with the
extrinsic as its only input, so autograd prunes the scene's parameter
branches and nothing accumulates into their .grad. As in the JAX step,
the scene's observers are not updated.

Given a `CapacityPolicy`, `optimize_camera` renders each step at the
policy's buckets and feeds it the step's counters, as cli/train.py feeds
its policy (`feed_policy`).
"""
from __future__ import annotations

from typing import Optional

import torch

from ..device import DeviceLike
from ..models.gaussians import GaussianScene
from ..ops import losses as L
from ..render.capacity import CapacityPolicy
from ..render.types import RasterSettings
from ..spans import span
from . import trainer

# optax.adam's default eps (camera_opt.py:55 uses optax.adam(lr); joint.py
# writes the same step out by hand)
POSE_ADAM_EPS = 1e-8
# the render's counters that camera_step returns beside the loss
COUNTERS = ("num_instances", "overflow", "grad_total", "grad_overflow", "clipped")


def anchor_penalty(ev: torch.Tensor, anchor: torch.Tensor, weight: float) -> torch.Tensor:
    """weight * mean(exp(|anchor - ev|) - 1) (train_no_splatting.py:120-122).

    |d| has derivative 1 at d == 0, JAX's convention (losses.abs_like_jax).
    It decides the first step of every camera whose pose starts at its
    anchor: the penalty's gradient there is -weight/7 in each component,
    where torch.abs would give 0."""
    return weight * torch.mean(torch.exp(L.abs_like_jax(anchor - ev)) - 1.0)


def pose_loss_and_grad(
    scene: GaussianScene,
    ev: torch.Tensor,
    gt: torch.Tensor,
    settings: RasterSettings,
    bg: torch.Tensor,
    anchor: Optional[torch.Tensor] = None,
    anchor_weight: float = 0.0,
):
    """(loss, d loss / d ev, render output) of the pose loss: the
    photometric loss at its default lambda, plus the anchor penalty when
    anchor_weight > 0. Only `ev` is differentiated."""
    ev = ev.detach().requires_grad_(True)
    out = trainer.render_scene(scene, ev, settings, bg, device=scene.device)
    with span("loss"):
        loss = L.photometric_loss(out["render"], gt)
        if anchor is not None and anchor_weight > 0:
            loss = loss + anchor_penalty(ev, anchor, anchor_weight)
    with span("backward"):
        (grad,) = torch.autograd.grad(loss, [ev])
    return loss.detach(), grad, out


@torch.no_grad()
def normalize_quaternion(ev: torch.Tensor) -> torch.Tensor:
    """ev[:4] /= max(||ev[:4]||, 1e-12), in place."""
    q = ev[:4]
    q /= torch.clamp(torch.sqrt(torch.sum(q * q)), min=1e-12)
    return ev


def camera_step(
    scene: GaussianScene,
    ev: torch.Tensor,
    adam_state: trainer.AdamState,
    gt: torch.Tensor,
    settings: RasterSettings,
    bg: torch.Tensor,
    lr: float = 1e-3,
    anchor: Optional[torch.Tensor] = None,
    anchor_weight: float = 0.0,
):
    """One Adam step (optax.adam(lr): eps 1e-8) on the camera extrinsic,
    then the quaternion renormalized. `ev` is a (7,) float32 tensor on the
    scene's device, updated in place (the JAX step donates it), and
    `adam_state` holds its moments under "ev". Returns (ev, adam_state,
    metrics): the loss and the render's `COUNTERS` as tensors on the
    device (`clipped`: tiles dropped past the per-splat tile cap, which
    the step's gradient left out)."""
    with span("pose_step"):
        loss, grad, out = pose_loss_and_grad(scene, ev, gt, settings, bg, anchor, anchor_weight)
        with span("pose_optimizer"):
            trainer.adam_update(adam_state, {"ev": ev}, {"ev": grad}, {"ev": lambda step: lr}, eps=POSE_ADAM_EPS)
            normalize_quaternion(ev)
        metrics = {"loss": loss, **{k: out[k] for k in COUNTERS}}
    return ev, adam_state, metrics


def feed_policy(policy: CapacityPolicy, metrics: dict, where: str) -> dict:
    """A step's counters read on the host in one transfer and fed to
    `policy`, as cli/train.py feeds its policy: an overflowed frame grows
    the bucket for the next step (the step itself is not taken again), a
    frame clamped at the slot domain and one that dropped tiles are each
    printed. Returns the counters as ints."""
    c = dict(zip(COUNTERS, torch.stack([metrics[k].to(torch.int64) for k in COUNTERS]).tolist()))
    if policy.update(c["num_instances"], c["overflow"], c["grad_total"], c["grad_overflow"]):
        print(f"[capacity] overflow -> bucket {policy.capacity}")
    policy.note_clamped(where, c["num_instances"], c["overflow"])
    if c["clipped"]:
        print(f"[binning] {where}: {c['clipped']} tiles dropped past the per-splat tile cap")
    return c


def optimize_camera(
    scene: GaussianScene,
    initial_ev,
    gt_image,
    settings: RasterSettings,
    bg=None,
    iterations: int = 200,
    lr: float = 1e-3,
    anchor=None,
    anchor_weight: float = 0.0,
    log_every: int = 0,
    capacity: Optional[CapacityPolicy] = None,
    device: DeviceLike = None,
):
    """Optimize a single camera pose (train_camera.py's inner loop).
    Returns (ev, final loss); the loss is read on the host only when a
    step logs, and after the last. With a `capacity` policy every step
    renders at its buckets and its counters are fed to it (`feed_policy`);
    without one the steps render at `settings` as given. Runs on the
    scene's device, which must be `device` (CUDA unless the caller names
    another)."""
    trainer._check_device(scene, device)
    dev = scene.device
    # a copy: the step updates ev in place, and the caller's initial pose
    # may also be the anchor
    ev = torch.as_tensor(initial_ev, dtype=torch.float32, device=dev).detach().clone()
    bg = torch.zeros(3, device=dev) if bg is None else torch.as_tensor(bg, dtype=torch.float32, device=dev)
    gt = torch.as_tensor(gt_image, dtype=torch.float32, device=dev)
    anchor = None if anchor is None else torch.as_tensor(anchor, dtype=torch.float32, device=dev)
    adam_state = trainer.adam_init({"ev": ev})
    loss = torch.tensor(float("nan"))
    for it in range(iterations):
        step_settings = settings if capacity is None else capacity.apply(settings)
        ev, adam_state, metrics = camera_step(scene, ev, adam_state, gt, step_settings, bg, lr, anchor, anchor_weight)
        if capacity is not None:
            feed_policy(capacity, metrics, f"camera step {it}")
        loss = metrics["loss"]
        if log_every and it % log_every == 0:
            print(f"[camera {it}] loss={float(loss):.5f}")
    return ev, float(loss)
