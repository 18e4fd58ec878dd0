"""Compression pipeline: prune -> VQ colors -> VQ covariance -> indexed
scene (port of c3dgs_tpu/compress/pipeline.py; compression/vq.py
compress_color :117, compress_covariance :149, compress_gaussians :194
and GaussianModel.to_compressed gaussian_model.py:954-991).

Keep thresholds are importance quantiles (0.9 color, 0.75 covariance by
default); the rows above them stay dense after the codebook. Covariance
VQ is trace-normalized and goes back to quaternion + scale by eigh.
Host-orchestrated, as the table sizes depend on the keep counts; the
k-means and the sensitivity run on the scene's device.
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from ..device import DeviceLike
from ..models.gaussians import GaussianScene
from ..ops import quat
from ..ops.segment import segment_sum
from .vq import CompressionSettings, join_features, vq_features


def compress_color(
    scene: GaussianScene,
    color_importance,
    color_comp: CompressionSettings,
    color_compress_non_dir: bool,
    silent: bool = False,
) -> GaussianScene:
    """compression/vq.py:117-147. color_importance: (P,) numpy."""
    color_importance = np.asarray(color_importance)
    keep_mask = color_importance > color_comp.importance_include
    if not silent:
        print(f"color keep: {keep_mask.mean() * 100:.2f}%")
    vq_mask = ~keep_mask
    dev = scene.device
    vq_t = torch.as_tensor(vq_mask, device=dev)
    with torch.no_grad():
        features = scene.get_features()  # (P, K, 3), fake-quantized
    n, k, _ = features.shape
    # the default (arguments/__init__.py:97) clusters the whole (K*3) SH
    # vector; otherwise DC stays out of the distance, and each codebook row
    # gets the importance-weighted mean DC of its rows (the JAX package's
    # repair of the reference's band shift, compression/vq.py:134-147)
    color_features = features.reshape(n, -1) if color_compress_non_dir else features[:, 1:].reshape(n, -1)
    imp_vq = torch.as_tensor(color_importance[vq_mask], dtype=torch.float32, device=dev)
    if vq_mask.any():
        if not silent:
            print("compressing color...")
        codebook, vq_indices = vq_features(
            color_features[vq_t], imp_vq, color_comp.codebook_size, color_comp.batch_size,
            color_comp.steps, decay=color_comp.decay,
        )
    else:
        codebook = color_features.new_zeros((0, color_features.shape[-1]))
        vq_indices = torch.zeros(0, dtype=torch.int64, device=dev)
    if not color_compress_non_dir and codebook.shape[0] > 0:
        dc_vq = features[vq_t, 0].reshape(-1, 3)
        sums = segment_sum(torch.cat([dc_vq * imp_vq[:, None], imp_vq[:, None]], 1), vq_indices, codebook.shape[0])
        dc_codebook = sums[:, :3] / torch.clamp(sums[:, 3:], min=1e-12)
        codebook = torch.cat([dc_codebook, codebook], 1)
        color_features = features.reshape(n, -1)
    compressed, indices = join_features(color_features, keep_mask, codebook, vq_indices)
    return scene.set_color_indexed(torch.as_tensor(compressed.reshape(-1, k, 3), device=dev), indices)


def compress_covariance(
    scene: GaussianScene,
    gaussian_importance,
    gaussian_comp: CompressionSettings,
    silent: bool = False,
) -> GaussianScene:
    """compression/vq.py:149-191. gaussian_importance: (P,) numpy."""
    gaussian_importance = np.asarray(gaussian_importance)
    keep_mask = gaussian_importance > gaussian_comp.importance_include
    if not silent:
        print(f"gaussians keep: {keep_mask.mean() * 100:.2f}%")
    vq_mask = ~keep_mask
    dev = scene.device
    with torch.no_grad():
        covariance = scene.get_normalized_covariance()  # (P, 6)
    if vq_mask.any():
        if not silent:
            print("compressing gaussian splats...")
        codebook, vq_indices = vq_features(
            covariance[torch.as_tensor(vq_mask, device=dev)],
            torch.as_tensor(gaussian_importance[vq_mask], dtype=torch.float32, device=dev),
            gaussian_comp.codebook_size, gaussian_comp.batch_size, gaussian_comp.steps,
            decay=gaussian_comp.decay, scale_normalize=True,
        )
    else:
        codebook = covariance.new_zeros((0, 6))
        vq_indices = torch.zeros(0, dtype=torch.int64, device=dev)
    compressed_cov, cov_indices = join_features(covariance, keep_mask, codebook, vq_indices)
    rot_vq, scale_vq = quat.extract_rot_scale(quat.to_full_cov(torch.as_tensor(compressed_cov, device=dev)))
    # the stored scaling is the direction (identity inverse activation); the
    # accessor normalizes it
    return scene.set_gaussian_indexed(rot_vq, scale_vq, cov_indices)


def compress_gaussians(
    scene: GaussianScene,
    color_importance,
    gaussian_importance,
    color_comp: Optional[CompressionSettings],
    gaussian_comp: Optional[CompressionSettings],
    color_compress_non_dir: bool = False,
    prune_threshold: float = 0.0,
    silent: bool = False,
) -> GaussianScene:
    """compression/vq.py:194-223: importance prune (rows above the
    threshold kept), quantile-autoset keep thresholds, then the two VQ
    stages. Importances are (P,) arrays over the scene's rows; the
    caller's scene is left as it is."""
    color_importance = np.asarray(color_importance)
    gaussian_importance = np.asarray(gaussian_importance)
    if prune_threshold >= 0:
        non_prune = color_importance > prune_threshold
        active = scene.active.cpu().numpy()
        if not silent:
            print(f"prune: {(1 - non_prune[active].mean()) * 100:.2f}%")
        keep = non_prune & active
        scene = scene._replace(active=torch.as_tensor(keep, device=scene.device)).compact()
        color_importance = color_importance[keep]
        gaussian_importance = gaussian_importance[keep]
    else:
        scene = scene.compact()

    if color_comp is not None and color_comp.importance_include is None:
        color_comp.importance_include = float(np.quantile(color_importance, color_comp.importance_include_relative))
        if not silent:
            print(f"Setting color threshold to {color_comp.importance_include}")
    if gaussian_comp is not None and gaussian_comp.importance_include is None:
        gaussian_comp.importance_include = float(
            np.quantile(gaussian_importance, gaussian_comp.importance_include_relative)
        )
        if not silent:
            print(f"Setting gaussian threshold to {gaussian_comp.importance_include}")

    if color_comp is not None:
        scene = compress_color(scene, color_importance, color_comp, color_compress_non_dir, silent)
    if gaussian_comp is not None:
        scene = compress_covariance(scene, gaussian_importance, gaussian_comp, silent)
    return scene


def to_compressed(scene, cameras, comp_params, silent: bool = False, timings: Optional[dict] = None,
                  device: DeviceLike = None) -> GaussianScene:
    """GaussianModel.to_compressed (gaussian_model.py:954-991): importance
    -> settings -> compress; comp_params is a config.CompressionParams.
    `timings`, if given, receives the reference's times.json split:
    sensitivity_calculation, then clustering (everything after it). Runs
    on the scene's device, which must be `device` (CUDA unless the caller
    names another)."""
    from .importance import calc_importance

    t0 = time.perf_counter()
    scene = scene.to_unindexed().compact()
    color_imp, gaussian_sens = calc_importance(scene, cameras, use_gt=True, device=device)
    color_importance_n = color_imp.max(-1).values.cpu().numpy()
    gaussian_importance_n = gaussian_sens.max(-1).values.cpu().numpy()
    t1 = time.perf_counter()

    def settings(prefix):
        return CompressionSettings(
            codebook_size=getattr(comp_params, f"{prefix}_codebook_size"),
            importance_include=None,
            importance_include_relative=getattr(comp_params, f"{prefix}_keep_quantile"),
            steps=int(getattr(comp_params, f"{prefix}_cluster_iterations")),
            decay=getattr(comp_params, f"{prefix}_decay"),
            batch_size=getattr(comp_params, f"{prefix}_batch_size"),
        )

    out = compress_gaussians(
        scene,
        color_importance_n,
        gaussian_importance_n,
        None if comp_params.not_compress_color else settings("color"),
        None if comp_params.not_compress_gaussians else settings("gaussian"),
        comp_params.color_compress_non_dir,
        prune_threshold=comp_params.prune_threshold,
        silent=silent,
    )
    if timings is not None:
        if out.device.type == "cuda":
            torch.cuda.synchronize(out.device)
        timings["sensitivity_calculation"] = t1 - t0
        timings["clustering"] = time.perf_counter() - t1
    return out
