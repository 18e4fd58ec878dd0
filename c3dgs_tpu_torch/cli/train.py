"""Training CLI (port of the JAX package's train.py): the fork's epoch-based
trainer on the port's device.

    python -m c3dgs_tpu_torch.cli.train -s <dataset> -m <model dir> [flags]

Parity: train.py:15-246 (epoch loop over every-10th train camera :58,
L1+0.2(1-SSIM) loss :76-79, per-epoch densify/prune + opacity reset
:161-170, SH degree warmup :172-173, checkpoint saves). Flags are the JAX
CLI's; --data_device (default cuda) picks the device, and a missing card
is an error.
"""
import argparse
import dataclasses
import json
import os
import time

import numpy as np
import torch

from ..compress import pipeline
from ..config import CompressionParams, ModelParams, OptimizationParams, PipelineParams, save_config
from ..data import Scene
from ..device import resolve_device
from ..eval import metrics
from ..models.gaussians import TENSOR_FIELDS
from ..render.capacity import CapacityPolicy
from ..render.types import settings_from_intrinsic
from ..train import trainer


def epoch_schedule(opt_p):
    """The reference's iteration->epoch knob recast (train.py:30-43):
    calc_epoch(i) = max(1, i * epochs // iterations). Training is
    epoch-driven (--epochs); iterations keeps its role as the budget the
    knobs are expressed in."""
    calc_epoch = lambda i: max(1, i * opt_p.epochs // opt_p.iterations)
    return {
        "densify_until_epoch": calc_epoch(opt_p.densify_until_iter),
        "densify_from_epoch": calc_epoch(opt_p.densify_from_iter),
        "densification_interval": calc_epoch(opt_p.densification_interval),
        "opacity_reset_interval": calc_epoch(opt_p.opacity_reset_interval),
        "degree_up": calc_epoch(1000),
    }


def _snapshot(path, cam, scene) -> None:
    """The failing step's camera and scene tensors, so it can be replayed
    offline (the reference dumps its kernel arguments on a CUDA error)."""
    np.savez_compressed(
        path,
        extrinsic_vector=np.asarray(cam.extrinsic_vector),
        intrinsic=np.asarray(cam.intrinsic),
        **{f"scene_{f}": getattr(scene, f).detach().cpu().numpy()
           for f in TENSOR_FIELDS if getattr(scene, f) is not None},
    )


def training(
    model_p,
    opt_p,
    pipe_p,
    save_epochs=(),
    quantization=True,
    comp_p=None,
    compress_every=0,
    eval_every=0,
):
    dev = resolve_device(model_p.data_device)
    scene = Scene(
        source_path=model_p.source_path,
        model_path=model_p.model_path,
        resolution=model_p.resolution,
        eval_split=model_p.eval,
        white_background=model_p.white_background,
        max_sh_degree=model_p.sh_degree,
        quantization=quantization,
        shuffle=True,
        device=dev,
    )
    gaussians = scene.gaussians
    if gaussians is None:
        raise ValueError(f"no initial point cloud found in {model_p.source_path}")
    spatial_lr_scale = scene.cameras_extent

    state = trainer.create_train_state(gaussians, opt_p, spatial_lr_scale, device=dev)
    bg = torch.tensor([1.0, 1.0, 1.0] if model_p.white_background else [0.0, 0.0, 0.0], device=dev)
    capacity = CapacityPolicy(initial=1 << 20)

    cams = scene.get_train_cameras()
    sched = epoch_schedule(opt_p)
    densify_until_epoch = sched["densify_until_epoch"]
    densify_from_epoch = sched["densify_from_epoch"]
    densification_interval = sched["densification_interval"]
    opacity_reset_interval = sched["opacity_reset_interval"]
    degree_up = sched["degree_up"]
    ema = None
    ema_psnr = None
    t0 = time.time()
    it = 0
    with open(os.path.join(model_p.model_path, "train_log.jsonl"), "w") as log_f:
        for epoch in range(opt_p.epochs):
            # every-10th camera per epoch (train.py:58)
            epoch_cams = cams[epoch % 10 :: 10] or cams
            for cam in epoch_cams:
                settings = capacity.apply(settings_from_intrinsic(cam.intrinsic))
                state, m = trainer.train_step(
                    state, cam.extrinsic_vector, cam.original_image, settings, bg, opt_p, spatial_lr_scale,
                    device=dev,
                )
                n_inst, overflow = int(m["num_instances"]), int(m["overflow"])
                if capacity.update(n_inst, overflow, int(m["grad_total"]), int(m["grad_overflow"])):
                    # this frame trained with clipped instances (a soft
                    # degradation); later frames render at the grown bucket
                    print(f"[capacity] overflow -> bucket {capacity.capacity}")
                capacity.note_clamped(f"step {it}", n_inst, overflow)
                clipped = int(m["clipped"])
                if clipped:
                    print(f"[binning] step {it}: {clipped} tiles dropped past the per-splat tile cap")
                it += 1
                loss = float(m["loss"])
                if not np.isfinite(loss):
                    snap = os.path.join(model_p.model_path, f"snapshot_step_{it}.npz")
                    _snapshot(snap, cam, state.scene)
                    raise FloatingPointError(f"non-finite loss at step {it}; state snapshot: {snap}")
                psnr = float(m["psnr"])
                ema = loss if ema is None else 0.6 * ema + 0.4 * loss
                ema_psnr = psnr if ema_psnr is None else 0.9 * ema_psnr + 0.1 * psnr
            # epoch boundary: densify / prune / reset / SH warmup, on the
            # reference's cadence (train.py:161-173)
            n_active = int(state.scene.num_active)
            if epoch < densify_until_epoch:
                if epoch > densify_from_epoch and epoch % densification_interval == 0:
                    free = state.scene.capacity - n_active
                    if free < max(1024, n_active // 4):
                        # grow without resetting the Adam moments of
                        # existing splats (gaussian_model.py:1161-1185)
                        state = trainer.grow_capacity(state, state.scene.capacity * 2, device=dev)
                    # screen-size pruning arms after the first opacity
                    # reset (train.py:164)
                    size_thr = 20.0 if epoch > opacity_reset_interval else None
                    state, dropped = trainer.densify_step(
                        state, scene.cameras_extent, opt_p, max_screen_size=size_thr, device=dev
                    )
                    if int(dropped) > 0:
                        print(f"[densify] dropped {int(dropped)} writes (capacity)")
                if epoch > 0 and epoch % opacity_reset_interval == 0:
                    state = trainer.reset_opacity_step(state, device=dev)
            if compress_every > 0 and comp_p is not None and epoch > 0 and epoch % compress_every == 0:
                # in-training compression (train.py:50-56,111-146, off by
                # default there too): sensitivity over this epoch's cameras
                # -> VQ -> keep training the re-unified (de-indexed) scene,
                # with no importance pruning; fresh Adam moments and
                # densify stats for the rewritten rows, the LR step kept
                cp = dataclasses.replace(comp_p, prune_threshold=-1.0)
                cap_before = state.scene.capacity
                sc = pipeline.to_compressed(state.scene, epoch_cams, cp, silent=True, device=dev)
                sc = sc.to_unindexed().pad_to_capacity(cap_before)
                fresh = trainer.create_train_state(sc, opt_p, spatial_lr_scale, device=dev)
                fresh.opt_state.step = state.opt_state.step
                fresh.step = state.step
                fresh.generator = state.generator
                state = fresh
                print(f"[compress@{epoch}] in-training VQ: active={int(sc.num_active)}")
            if epoch % degree_up == 0:
                # "Every 1000 its we increase the levels of SH" (train.py:172)
                state.scene = state.scene.oneup_sh_degree()
            # periodic held-out evaluation on observers one EMA step on,
            # in a scene of its own: the training state keeps its own
            test_psnr = None
            if eval_every and (epoch % eval_every == 0 or epoch == opt_p.epochs - 1):
                test_cams = scene.get_test_cameras()
                if test_cams:
                    eval_scene = state.scene._replace().update_observers()
                    vals = []
                    for tc in test_cams:
                        out = metrics.render_full(
                            eval_scene, tc.extrinsic_vector,
                            settings_from_intrinsic(tc.intrinsic, inference=True), bg, device=dev,
                        )
                        vals.append(metrics.view_psnr(out["render"], tc.original_image))
                    test_psnr = sum(vals) / len(vals)
                    print(f"[eval @{epoch}] test_psnr={test_psnr:.2f}")
            print(
                f"[epoch {epoch}] it={it} ema_loss={ema:.4f} ema_psnr={ema_psnr:.2f} "
                f"active={int(state.scene.num_active)} ({time.time() - t0:.0f}s)"
            )
            entry = {
                "epoch": epoch,
                "it": it,
                "ema_loss": round(ema, 5),
                "ema_psnr": round(ema_psnr, 3),
                "active": int(state.scene.num_active),
                "seconds": round(time.time() - t0, 1),
            }
            if test_psnr is not None:
                entry["test_psnr"] = round(test_psnr, 3)
            log_f.write(json.dumps(entry) + "\n")
            log_f.flush()
            if epoch in save_epochs or epoch == opt_p.epochs - 1:
                scene.gaussians = state.scene
                scene.save(it)
    return state


def main(argv=None):
    parser = argparse.ArgumentParser(description="c3dgs_tpu_torch training")
    ModelParams.add_to_parser(parser, "model")
    OptimizationParams.add_to_parser(parser, "optimization")
    PipelineParams.add_to_parser(parser, "pipeline")
    CompressionParams.add_to_parser(parser, "compression")
    parser.add_argument("--save_epochs", nargs="+", type=int, default=[])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument(
        "--eval_every",
        type=int,
        default=0,
        help="evaluate held-out test PSNR every N epochs (0 = off); logged as test_psnr in train_log.jsonl",
    )
    parser.add_argument(
        "--compress_every",
        type=int,
        default=0,
        help="run in-training VQ compression every N epochs (0 = off, the reference's default; "
        "train.py:50). Each pass rewrites most rows (VQ + compaction) and resets Adam moments and "
        "densify stats for the re-unified scene, as the reference's replace_tensor_to_optimizer "
        "zeroes the moments of every rewritten tensor (gaussian_model.py:1061-1079)",
    )
    args = parser.parse_args(argv)

    model_p = ModelParams.extract(args).post_extract()
    opt_p = OptimizationParams.extract(args)
    pipe_p = PipelineParams.extract(args)
    comp_p = CompressionParams.extract(args)
    if not model_p.model_path:
        model_p = dataclasses.replace(model_p, model_path="./output/run")
    os.makedirs(model_p.model_path, exist_ok=True)
    save_config(model_p.model_path, {"model": model_p, "optimization": opt_p, "pipeline": pipe_p})
    return training(
        model_p,
        opt_p,
        pipe_p,
        save_epochs=set(args.save_epochs),
        quantization=not opt_p.not_quantization_aware,
        comp_p=comp_p,
        compress_every=args.compress_every,
        eval_every=args.eval_every,
    )


if __name__ == "__main__":
    main()
