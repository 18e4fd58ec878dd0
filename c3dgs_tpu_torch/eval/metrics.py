"""Evaluation: render views through the capacity policy and score them with
PSNR / SSIM, and LPIPS through a given `lpips_fn` (port of
c3dgs_tpu/eval/metrics.py: render_full, render_and_eval, write_results).
Without one LPIPS is reported as null with the reason, as the JAX package
does.
"""
from __future__ import annotations

import json
import os
from typing import List, Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..ops import losses as L
from ..render.capacity import CapacityPolicy
from ..render.types import settings_from_intrinsic
from ..spans import span
from ..train import trainer
from .lpips import UNAVAILABLE_REASON as LPIPS_UNAVAILABLE_REASON


@torch.no_grad()
def render_full(scene, extrinsic_vector, settings, bg, policy=None, device: DeviceLike = None):
    """Render with an overflow-free guarantee: if the frame's (gaussian,
    tile) instances exceed the capacity bucket, grow it and render again
    (at most 8 tries); a frame that overflows the binning's slot domain
    (MAX_BINNING_CAP) raises. The returned dict carries `renders`, the
    number of renders the frame took. Only the slot bucket follows the
    frame: as in the JAX package the grad bucket stays as the policy has
    it, which for a forward-only render sizes nothing (a per-tile render's
    grad_overflow is counted against the settings' grad capacity, the slot
    domain plus two chunks per tile unless set)."""
    with span("view"):
        dev = resolve_device(device)
        policy = policy or CapacityPolicy()
        for attempt in range(1, 9):
            out = trainer.render_scene(scene, extrinsic_vector, policy.apply(settings), bg, device=dev)
            if not policy.update(int(out["num_instances"]), int(out["overflow"])):
                break
        policy.check_whole(int(out["num_instances"]), int(out["overflow"]))
        out["renders"] = attempt
    return out


def view_psnr(img: torch.Tensor, gt) -> float:
    """PSNR of one rendered view against its image (the PSNR half of the
    JAX package's _jit_metrics)."""
    return float(L.psnr(img, torch.as_tensor(gt, dtype=torch.float32, device=img.device))[0, 0])


def _to_png(path: str, img_chw: np.ndarray) -> None:
    from PIL import Image

    arr = (np.clip(img_chw, 0, 1).transpose(1, 2, 0) * 255).astype(np.uint8)
    Image.fromarray(arr).save(path)


@torch.no_grad()
def render_and_eval(
    scene,
    cameras: List,
    bg: Optional[np.ndarray] = None,
    dump_dir: Optional[str] = None,
    npz_path: Optional[str] = None,
    lpips_fn=None,
    device: DeviceLike = None,
    packed: bool = True,
) -> dict:
    """Per-view PSNR/SSIM (+LPIPS via lpips_fn if given) and their means,
    in the reference's results.json schema. `packed` picks the kernel
    family (RasterSettings.packed): the packed pair by default, the
    per-tile pair (K3) when False; both give the same image within the
    reference's bar.

    `cameras` are objects with `intrinsic` (3x3, FoV radians + W/H),
    `extrinsic_vector` (7,), `original_image` (3,H,W) and optionally
    `image_name`. PNG dumps need PIL. `num_renders` counts every render,
    re-renders after an overflow included."""
    dev = resolve_device(device)
    bg = torch.zeros(3, device=dev) if bg is None else torch.as_tensor(bg, dtype=torch.float32, device=dev)
    psnrs, ssims, lpipss, per_view = [], [], [], {}
    if dump_dir:
        os.makedirs(os.path.join(dump_dir, "renders"), exist_ok=True)
        os.makedirs(os.path.join(dump_dir, "gt"), exist_ok=True)
    policy = CapacityPolicy()
    renders = 0
    for i, cam in enumerate(cameras):
        settings = settings_from_intrinsic(cam.intrinsic, inference=True, packed=packed)
        out = render_full(scene, cam.extrinsic_vector, settings, bg, policy, device=dev)
        renders += out["renders"]
        img = out["render"]
        gt = torch.as_tensor(cam.original_image, dtype=torch.float32, device=dev)
        p = view_psnr(img, gt)
        s = float(L.ssim(img, gt))
        psnrs.append(p)
        ssims.append(s)
        entry = {"psnr": p, "ssim": s}
        if lpips_fn is not None:
            lp = float(lpips_fn(img, gt))
            lpipss.append(lp)
            entry["lpips"] = lp
        else:
            entry["lpips"] = None
            entry["lpips_reason"] = LPIPS_UNAVAILABLE_REASON
        name = getattr(cam, "image_name", None)
        per_view[name if name is not None else str(i)] = entry
        if dump_dir:
            fname = (name if name is not None else f"{i:05d}") + ".png"
            _to_png(os.path.join(dump_dir, "renders", fname), img.cpu().numpy())
            _to_png(os.path.join(dump_dir, "gt", fname), gt.cpu().numpy())

    results = {
        "psnr": float(np.mean(psnrs)) if psnrs else None,
        "ssim": float(np.mean(ssims)) if ssims else None,
        "lpips": float(np.mean(lpipss)) if lpipss else None,
        "num_views": len(psnrs),
        "num_renders": renders,
    }
    if lpips_fn is None:
        results["lpips_reason"] = LPIPS_UNAVAILABLE_REASON
    if npz_path and os.path.exists(npz_path):
        results["size_bytes"] = os.path.getsize(npz_path)
    results["per_view"] = per_view
    return results


def write_results(model_path: str, results: dict) -> None:
    """results.json (the means) and per_view.json; pops `per_view`."""
    per_view = results.pop("per_view", {})
    with open(os.path.join(model_path, "results.json"), "w") as f:
        json.dump(results, f, indent=2)
    with open(os.path.join(model_path, "per_view.json"), "w") as f:
        json.dump(per_view, f, indent=2)
