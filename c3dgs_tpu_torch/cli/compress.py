"""Compression CLI (port of the JAX package's compress.py, the reference's
primary entry point).

    python -m c3dgs_tpu_torch.cli.compress -m <model dir> [flags]

Parity: compress.py run_vq (:202-303): load the trained scene ->
sensitivity (calc_importance, per-view |grad| accumulation) -> weighted
k-means VQ of SH colors + covariance shapes -> QAT finetune through the
indexed renderer -> Morton-sorted int8 .npz -> PSNR/SSIM eval; per-stage
wall-clock times -> times.json, metrics + file sizes -> results.json.
Flags not given are taken from the model dir's cfg_args.json.
"""
import argparse
import glob
import json
import os
import time

from ..compress import pipeline
from ..config import (
    CompressionParams,
    ModelParams,
    OptimizationParams,
    PipelineParams,
    load_combined_args,
    save_config,
)
from ..data import Scene
from ..device import resolve_device
from ..eval import lpips as lpips_mod
from ..eval import metrics
from ..models import io_npz
from ..train import checkpoint, finetune


def run_vq(model_p, opt_p, pipe_p, comp_p):
    """Compress, write the npz and the result files; returns the scene as
    written."""
    dev = resolve_device(model_p.data_device)
    out_dir = comp_p.output_vq or os.path.join(model_p.model_path, "vq")
    os.makedirs(out_dir, exist_ok=True)

    scene = Scene(
        source_path=model_p.source_path,
        model_path=model_p.model_path,
        load_iteration=comp_p.load_iteration,
        resolution=model_p.resolution,
        eval_split=model_p.eval,
        white_background=model_p.white_background,
        max_sh_degree=model_p.sh_degree,
        quantization=True,
        shuffle=True,
        device=dev,
    )
    gaussians = scene.gaussians
    if comp_p.start_checkpoint:
        gaussians = checkpoint.load_checkpoint(comp_p.start_checkpoint, opt_p, device=dev).scene
        scene.gaussians = gaussians
        print(f"Loaded start checkpoint: {comp_p.start_checkpoint}")
    timings = {}

    t0 = time.time()
    cams, split = scene.get_some_cameras()
    compressed = pipeline.to_compressed(gaussians, cams, comp_p, timings=timings, device=dev)
    # the reference splits sensitivity_calculation vs clustering
    # (compress.py:218-292); to_compressed filled the former
    timings["clustering"] = time.time() - t0 - timings.get("sensitivity_calculation", 0.0)

    save_config(out_dir, {"model": model_p, "optimization": opt_p, "compression": comp_p})

    t0 = time.time()
    if comp_p.finetune_iterations > 0:
        compressed = finetune.finetune(
            compressed,
            scene.get_train_cameras(),
            opt_p,
            comp_p.finetune_iterations,
            spatial_lr_scale=scene.cameras_extent,
            device=dev,
        )
    timings["finetune"] = time.time() - t0

    t0 = time.time()
    npz_path = os.path.join(out_dir, "point_cloud.npz")
    compressed = io_npz.save_npz(
        compressed, npz_path, sort_morton=not comp_p.not_sort_morton, xyz_u16=not comp_p.xyz_fp16
    )
    timings["encode"] = time.time() - t0

    t0 = time.time()
    eval_cams = scene.get_test_cameras() or scene.get_train_cameras()[:8]
    # LPIPS when converted weights exist (the reference reports
    # PSNR/SSIM/LPIPS, compress.py:150-163; eval/lpips.py)
    if lpips_mod.available():
        lpips_fn = lpips_mod.LPIPS(device=dev)
    else:
        lpips_fn = None
        print(lpips_mod.unavailable_hint())
    results = metrics.render_and_eval(compressed, eval_cams, npz_path=npz_path, lpips_fn=lpips_fn, device=dev)
    # the uncompressed baseline on the same split: the compression ratio
    # (against the trained .ply) and the PSNR drop, the reference's
    # headline numbers (>= 26-31x at <= 0.5 dB)
    base = metrics.render_and_eval(gaussians, eval_cams, lpips_fn=lpips_fn, device=dev)
    del results["num_renders"]  # the port's count; compress.py writes JAX's keys
    results["uncompressed_psnr"] = base["psnr"]
    if results.get("psnr") is not None and base.get("psnr") is not None:
        results["psnr_drop"] = base["psnr"] - results["psnr"]
    plys = sorted(glob.glob(os.path.join(model_p.model_path, "point_cloud", "*", "point_cloud.ply")))
    if plys:
        ply_bytes = os.path.getsize(plys[-1])
        results["ply_size_bytes"] = ply_bytes
        if results.get("size_bytes"):
            results["compression_ratio"] = ply_bytes / results["size_bytes"]
    timings["eval"] = time.time() - t0
    timings["total"] = sum(timings.values())

    metrics.write_results(out_dir, results)
    with open(os.path.join(out_dir, "times.json"), "w") as f:
        json.dump(timings, f, indent=2)
    print(json.dumps(results))
    print("times:", json.dumps(timings))
    return compressed


def main(argv=None):
    parser = argparse.ArgumentParser(description="c3dgs_tpu_torch compression")
    ModelParams.add_to_parser(parser, "model", fill_none=True)
    OptimizationParams.add_to_parser(parser, "optimization", fill_none=True)
    PipelineParams.add_to_parser(parser, "pipeline", fill_none=True)
    CompressionParams.add_to_parser(parser, "compression", fill_none=True)
    args = load_combined_args(parser, argv)
    return run_vq(
        ModelParams.extract(args).post_extract(),
        OptimizationParams.extract(args),
        PipelineParams.extract(args),
        CompressionParams.extract(args),
    )


if __name__ == "__main__":
    main()
