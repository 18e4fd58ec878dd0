"""Joint scene + camera-pose trainer CLI (port of the JAX package's
train_no_splatting.py).

    python -m c3dgs_tpu_torch.cli.train_no_splatting -s <dataset> -m <model dir> [flags]

Parity: train_no_splatting.py (:1-283): the fork's epoch trainer that
optimizes every camera's quaternion extrinsic jointly with the scene, with
an anchor penalty exp(|orig-cur|)*weight (:120-122) and optional
compression at the end (:43,71,159-194). Each epoch steps the cameras
whose index is the epoch mod 10. Writes cfg_args, point_cloud/
iteration_N/point_cloud.ply, optimized_poses.npy and, with --compress,
point_cloud_vq.npz (Morton-sorted). Flags are the JAX CLI's;
--data_device (default cuda) picks the device, and a missing card is an
error.
"""
import argparse
import dataclasses
import os
import time

import numpy as np
import torch

from ..compress.pipeline import to_compressed
from ..config import CompressionParams, ModelParams, OptimizationParams, save_config
from ..data import Scene
from ..device import resolve_device
from ..models import io_npz
from ..render.capacity import CapacityPolicy
from ..render.types import settings_from_intrinsic
from ..train import joint as J


def training(model_p, opt_p, args):
    dev = resolve_device(model_p.data_device)
    scene = Scene(
        source_path=model_p.source_path,
        model_path=model_p.model_path,
        resolution=model_p.resolution,
        eval_split=model_p.eval,
        white_background=model_p.white_background,
        max_sh_degree=model_p.sh_degree,
        quantization=not opt_p.not_quantization_aware,
        shuffle=False,  # pose state is per camera index
        device=dev,
    )
    if scene.gaussians is None:
        raise ValueError(f"no initial point cloud found in {model_p.source_path}")
    cams = scene.get_train_cameras()
    evs = np.stack([np.asarray(c.extrinsic_vector) for c in cams])
    if args.perturb_poses > 0:
        rng = np.random.default_rng(0)
        evs = evs + rng.normal(scale=args.perturb_poses, size=evs.shape).astype(np.float32)
        evs[:, :4] /= np.linalg.norm(evs[:, :4], axis=1, keepdims=True)

    js = J.create_joint_state(scene.gaussians, opt_p, scene.cameras_extent, evs, device=dev)
    bg = torch.tensor([1.0, 1.0, 1.0] if model_p.white_background else [0.0, 0.0, 0.0], device=dev)
    capacity = CapacityPolicy(initial=1 << 20)
    ema = None
    t0 = time.time()
    it = 0
    for epoch in range(opt_p.epochs):
        idxs = list(range(epoch % 10, len(cams), 10)) or list(range(len(cams)))
        for i in idxs:
            cam = cams[i]
            settings = capacity.apply(settings_from_intrinsic(cam.intrinsic))
            js, metrics = J.joint_step(
                js, i, cam.original_image, settings, bg, opt_p, scene.cameras_extent, args.pose_lr,
                args.anchor_weight, device=dev,
            )
            n_inst, overflow = int(metrics["num_instances"]), int(metrics["overflow"])
            capacity.update(n_inst, overflow, int(metrics["grad_total"]), int(metrics["grad_overflow"]))
            capacity.note_clamped(f"step {it}", n_inst, overflow)
            it += 1
            loss = float(metrics["loss"])
            ema = loss if ema is None else 0.6 * ema + 0.4 * loss
        print(
            f"[epoch {epoch}] it={it} ema_loss={ema:.4f} "
            f"pose_delta={float(metrics['pose_delta']):.4f} "
            f"({time.time() - t0:.0f}s)"
        )
        if epoch == opt_p.epochs - 1 or epoch in set(args.save_epochs):
            scene.gaussians = js.train.scene
            scene.save(it)
            np.save(os.path.join(model_p.model_path, "optimized_poses.npy"), js.evs.cpu().numpy())
    if args.compress:
        compressed = to_compressed(js.train.scene, cams[:: max(len(cams) // 8, 1)], CompressionParams(), device=dev)
        out = os.path.join(model_p.model_path, "point_cloud_vq.npz")
        io_npz.save_npz(compressed.morton_sorted(), out)
        print(f"compressed -> {out} ({os.path.getsize(out)} bytes)")
    return js


def main(argv=None):
    parser = argparse.ArgumentParser(description="c3dgs_tpu_torch joint scene+pose training")
    ModelParams.add_to_parser(parser, "model")
    OptimizationParams.add_to_parser(parser, "optimization")
    parser.add_argument("--pose_lr", type=float, default=1e-4)
    parser.add_argument("--anchor_weight", type=float, default=1.0)
    parser.add_argument(
        "--perturb_poses",
        type=float,
        default=0.0,
        help="std of gaussian noise added to initial poses (testing)",
    )
    parser.add_argument("--save_epochs", nargs="+", type=int, default=[])
    parser.add_argument("--compress", action="store_true")
    args = parser.parse_args(argv)

    model_p = ModelParams.extract(args).post_extract()
    opt_p = OptimizationParams.extract(args)
    if not model_p.model_path:
        model_p = dataclasses.replace(model_p, model_path="./output/joint")
    os.makedirs(model_p.model_path, exist_ok=True)
    save_config(model_p.model_path, {"model": model_p, "optimization": opt_p})
    return training(model_p, opt_p, args)


if __name__ == "__main__":
    main()
