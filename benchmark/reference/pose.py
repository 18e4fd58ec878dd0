"""The plain reference of pose recovery against a frozen scene: the
photometric loss of a view rendered at a camera's 7-vector, its gradient
with respect to that 7-vector, and the Adam steps on it, in plain PyTorch
on top of `reference/splat.py`. It imports nothing of the program.

What it follows: the fork's train_camera.py (optax.adam(lr) on the
world-to-camera 7-vector (qx, qy, qz, qw, tx, ty, tz), eps 1e-8, the
quaternion renormalised after each step, L1 + 0.2 D-SSIM against the
query image). The camera enters the render three ways and the gradient
keeps all three: the projected means (the full transform and the divide
by w), the 2D covariances (through the view rotation and the EWA
Jacobian) and the SH-3 colours (through the view direction from the
camera centre). The scene is frozen: its accessors run once without
gradients, and only `project` onwards is differentiated, block by block
as `splat.Scene.loss_and_grads` differentiates a training step.

Departures from train_camera.py: no anchor penalty (its default weight is
0); the scene's observers are those of the scene as served
(`splat.observe` once), which the program's step does not update either;
the bias corrections of Adam are taken in double precision.

Two float32 renders of one scene agree to about 1e-3 of the gradient's
norm (at 5M splats), and the loss's culling and compositing thresholds
make its gradient jump between poses 1e-6 apart; Adam's first steps
divide each component by its own size. A component near zero therefore
takes a different step on either side of a sound comparison, so the
reference does not follow its own trajectory beside the program's:
`follow` evaluates the loss and the gradient at each pose the program
stood at, and takes its Adam steps on the program's own gradients.

`fault` plants a fault in place of the program for the control
(benchmark/control.py): "mean2d_only", the gradient through the projected
means alone (the fork's CUDA camera mode contracted only d uv / d pose
with dL/dmean2D); "colour_cut", the colour branch cut (the camera centre
detached); "scaled", each gradient's largest component times 1.5
where the backward produces it; "unchanged", the pose left where it is
(Adam's moments move, the 7-vector does not; the renormalisation still
runs).
"""
from __future__ import annotations

from typing import Optional

import torch

from . import splat

POSE_ADAM_EPS = 1e-8
FAULTS = ("mean2d_only", "colour_cut", "scaled", "unchanged")


def frozen_attributes(scene: "splat.Scene"):
    """The scene's per-splat position, opacity, covariance and SH, without
    gradients: the part of a frame that the camera does not enter."""
    with torch.no_grad():
        return splat.splat_attributes(scene.p, scene.obs, scene.idx)


def _screen(attrs, ev: torch.Tensor, intrinsic, fault: Optional[str]) -> "splat.Screen":
    """`project` at the camera of `ev`, under autograd from `ev`; with a
    fault, the conics and colours (mean2d_only) or the colours
    (colour_cut) taken from a camera detached from `ev`."""
    cam = splat.Camera(ev, intrinsic, ev.device)
    scr = splat.project(*attrs, cam)
    if fault in ("mean2d_only", "colour_cut"):
        cut = splat.project(*attrs, splat.Camera(ev.detach(), intrinsic, ev.device))
        conic = cut.conic if fault == "mean2d_only" else scr.conic
        scr = splat.Screen(scr.vis, scr.mean2d, scr.depth, conic, scr.opacity, cut.color, scr.rect)
    return scr


def loss_and_grad(scene: "splat.Scene", attrs, ev, intrinsic, gt, bg, lambda_dssim: float,
                  fault: Optional[str] = None):
    """(loss, d loss / d ev) of the view at `ev` against `gt`."""
    ev = ev.detach().clone().requires_grad_(True)
    cam = splat.Camera(ev.detach(), intrinsic, ev.device)
    with torch.enable_grad():
        scr = _screen(attrs, ev, intrinsic, fault)
    bins = splat.Bins(scr, cam)
    rows = splat.render_tiles(scr, bins, bg, scene.budget)
    img = splat.tiles_to_image(rows, bins, cam).detach().requires_grad_(True)
    with torch.enable_grad():
        loss = splat.photometric_loss(img, gt, lambda_dssim)
    (g_img,) = torch.autograd.grad(loss, [img])
    g_rows = splat.image_to_tiles(g_img, bins)
    leaves = [t.detach().requires_grad_(True) for t in scr.leaves()]
    for tiles, length in bins.blocks(scene.budget):
        with torch.enable_grad():
            out = splat.composite_block(leaves, bins, tiles, length, bg)
        torch.autograd.backward(out, g_rows[torch.as_tensor(tiles, device=out.device)])
    outs = [(o, l.grad) for o, l in zip(scr.leaves(), leaves) if l.grad is not None and o.requires_grad]
    (g_ev,) = torch.autograd.grad([o for o, _ in outs], [ev], [g for _, g in outs])
    if fault == "scaled":
        g_ev = g_ev.clone()
        g_ev[int(torch.argmax(g_ev.abs()))] *= 1.5
    return float(loss.detach()), g_ev


def _renormalise(ev: torch.Tensor) -> None:
    """ev[:4] /= max(||ev[:4]||, 1e-12), in place."""
    with torch.no_grad():
        ev[:4] /= torch.clamp(torch.sqrt(torch.sum(ev[:4] * ev[:4])), min=1e-12)


def renormalised(ev) -> torch.Tensor:
    """A float32 copy of `ev` with its quaternion renormalised: where a
    step from `ev` starts to move by Adam (the first renormalisation of a
    perturbed start pose moves the quaternion by more than three steps)."""
    out = torch.as_tensor(ev, dtype=torch.float32).detach().clone()
    _renormalise(out)
    return out


def _step(ev: torch.Tensor, g: torch.Tensor, state: dict, lr: float, frozen: bool = False) -> None:
    """One Adam step on `ev` in place, then the quaternion's
    renormalisation; `frozen`, the pose left where it is while the moments
    move (the "unchanged" fault)."""
    moved = {"ev": ev.clone()} if frozen else {"ev": ev}
    splat.adam_step(moved, {"ev": g.detach().to(ev)}, state, {"ev": lr}, eps=POSE_ADAM_EPS)
    _renormalise(ev)


def pose_steps(scene: "splat.Scene", ev0, intrinsic, gt, bg, lambda_dssim: float, lr: float, steps: int,
               fault: Optional[str] = None) -> dict:
    """`steps` Adam steps on the 7-vector from `ev0` along the reference's
    own trajectory, each followed by the quaternion's renormalisation.
    Returns each step's loss, the pose it started from (`poses`) and its
    gradient (`grads`), and the 7-vector after the last step (float32, on
    ev0's device)."""
    attrs = frozen_attributes(scene)
    ev = torch.as_tensor(ev0, dtype=torch.float32).detach().clone()
    state, losses, poses, grads = {}, [], [], []
    for _ in range(steps):
        poses.append(ev.detach().clone())
        loss, g = loss_and_grad(scene, attrs, ev, intrinsic, gt, bg, lambda_dssim, fault)
        losses.append(loss)
        grads.append(g.detach().clone())
        _step(ev, g, state, lr, fault == "unchanged")
    return dict(losses=losses, poses=poses, grads=grads, ev=ev)


def follow(scene: "splat.Scene", poses, grads, ev0, intrinsic, gt, bg, lambda_dssim: float, lr: float) -> dict:
    """The reference beside a run of steps that stood at `poses` and took
    `grads`: the loss and the gradient at each of those poses, and the
    7-vector that Adam and the renormalisation reach from `ev0` on the
    run's own gradients. Returns `losses`, `grads` and `ev`, as
    `pose_steps` does."""
    attrs = frozen_attributes(scene)
    losses, ref_grads = [], []
    for pose in poses:
        loss, g = loss_and_grad(scene, attrs, pose.to(torch.float32), intrinsic, gt, bg, lambda_dssim)
        losses.append(loss)
        ref_grads.append(g.detach().clone())
    ev, state = torch.as_tensor(ev0, dtype=torch.float32).detach().clone(), {}
    for g in grads:
        _step(ev, g, state, lr)
    return dict(losses=losses, grads=ref_grads, ev=ev)
