"""Compressed-pipeline smoke CLI (port of the JAX package's
run_indexed.py): load -> to_compressed -> finetune -> render one view.

    python -m c3dgs_tpu_torch.cli.run_indexed -s <dataset> -m <model dir> [flags]

Parity: run_indexed.py:1-46, without its hard-coded paths: the trained
model (point_cloud/iteration_N/) compressed with the default
CompressionParams over the first 8 of get_some_cameras(), finetuned for
--finetune_iterations steps on the train cameras, and the first of those
8 cameras rendered with inference=True to --out. --data_device (default
cuda) picks the device, and a missing card is an error.
"""
import argparse

import numpy as np
import torch

from ..compress.pipeline import to_compressed
from ..config import CompressionParams, OptimizationParams
from ..data import Scene
from ..device import resolve_device
from ..eval.metrics import _to_png
from ..render.types import settings_from_intrinsic
from ..train import trainer
from ..train.finetune import finetune


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--source_path", "-s", required=True)
    parser.add_argument("--model_path", "-m", required=True)
    parser.add_argument("--load_iteration", type=int, default=-1)
    parser.add_argument("--finetune_iterations", type=int, default=500)
    parser.add_argument("--out", default="indexed_preview.png")
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
    cams, _ = scene.get_some_cameras()
    compressed = to_compressed(scene.gaussians, cams[:8], CompressionParams(), device=dev)
    if args.finetune_iterations > 0:
        compressed = finetune(
            compressed,
            scene.get_train_cameras(),
            OptimizationParams(),
            args.finetune_iterations,
            spatial_lr_scale=scene.cameras_extent,
            device=dev,
        )
    cam = cams[0]
    settings = settings_from_intrinsic(cam.intrinsic, inference=True)
    with torch.no_grad():
        out = trainer.render_scene(compressed, cam.extrinsic_vector, settings, np.zeros(3), device=dev)
    _to_png(args.out, out["render"].cpu().numpy())
    print(f"wrote {args.out}")
    return compressed, out


if __name__ == "__main__":
    main()
