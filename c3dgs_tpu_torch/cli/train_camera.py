"""Camera-pose trainer CLI (port of the JAX package's train_camera.py):
optimize camera extrinsics against a frozen, possibly compressed, scene.

    python -m c3dgs_tpu_torch.cli.train_camera -s <dataset> -m <model dir> [flags]

Parity: train_camera.py (:1-197): load the trained model
(point_cloud/iteration_N/point_cloud.{ply,npz}; an npz is served
codebook-indexed), perturb each camera's extrinsic 7-vector with
np.random.default_rng(0) noise, recover it by Adam through the renderer,
print the pose error before and after; --dump_dir writes each recovered
view as a PNG. One CapacityPolicy follows every step of the run, as in
cli/train.py. Flags are the JAX CLI's; --data_device (default cuda)
picks the device, and a missing card is an error.
"""
import argparse
import os

import numpy as np
import torch

from ..data import Scene
from ..device import resolve_device
from ..eval.metrics import _to_png
from ..render.capacity import CapacityPolicy
from ..render.types import settings_from_intrinsic
from ..train import camera_opt, trainer


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--source_path", "-s", required=True)
    parser.add_argument("--model_path", "-m", required=True)
    parser.add_argument("--load_iteration", type=int, default=-1)
    parser.add_argument("--iterations", type=int, default=300)
    parser.add_argument("--lr", type=float, default=1e-3)
    parser.add_argument("--perturb", type=float, default=0.02)
    parser.add_argument("--num_cameras", type=int, default=4)
    parser.add_argument("--dump_dir", default="")
    parser.add_argument("--data_device", type=str, default="cuda")
    args = parser.parse_args(argv)
    dev = resolve_device(args.data_device)

    scene = Scene(
        source_path=args.source_path,
        model_path=args.model_path,
        load_iteration=args.load_iteration,
        shuffle=False,
        device=dev,
    )
    rng = np.random.default_rng(0)
    capacity = CapacityPolicy(initial=1 << 20)
    results = []
    for cam in scene.get_train_cameras()[: args.num_cameras]:
        settings = settings_from_intrinsic(cam.intrinsic)
        ev_true = np.asarray(cam.extrinsic_vector)
        ev0 = ev_true + rng.normal(size=7).astype(np.float32) * args.perturb
        ev_opt, loss = camera_opt.optimize_camera(
            scene.gaussians,
            ev0,
            cam.original_image,
            settings,
            iterations=args.iterations,
            lr=args.lr,
            log_every=50,
            capacity=capacity,
            device=dev,
        )
        ev_opt = ev_opt.cpu().numpy()
        err0 = float(np.abs(ev0 - ev_true).max())
        err1 = float(np.abs(ev_opt - ev_true).max())
        print(f"[{cam.image_name}] pose error {err0:.4f} -> {err1:.4f} (loss {loss:.5f})")
        results.append({"image_name": cam.image_name, "ev0": ev0, "ev": ev_opt, "loss": loss,
                        "error_before": err0, "error_after": err1})
        if args.dump_dir:
            os.makedirs(args.dump_dir, exist_ok=True)
            with torch.no_grad():
                out = trainer.render_scene(scene.gaussians, ev_opt, settings, np.zeros(3), device=dev)
            _to_png(os.path.join(args.dump_dir, f"{cam.image_name}_opt.png"), out["render"].cpu().numpy())
    return results


if __name__ == "__main__":
    main()
