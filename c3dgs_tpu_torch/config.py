"""Training and compression hyperparameters (port of c3dgs_tpu/config.py's
OptimizationParams and CompressionParams, arguments/__init__.py:85-137,
defaults preserved exactly). The argparse ParamGroup machinery and the
other parameter groups come with the CLI slice."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class OptimizationParams:
    iterations: int = 30_000
    epochs: int = 100
    position_lr_init: float = 0.00016
    position_lr_final: float = 0.0000016
    position_lr_delay_mult: float = 0.01
    position_lr_max_steps: int = 30_000
    feature_lr: float = 0.0025
    opacity_lr: float = 0.05
    scaling_lr: float = 0.005
    rotation_lr: float = 0.001
    percent_dense: float = 0.01
    lambda_dssim: float = 0.2
    densification_interval: int = 100
    opacity_reset_interval: int = 3000
    densify_from_iter: int = 500
    densify_until_iter: int = 15_000
    densify_grad_threshold: float = 0.0002
    not_quantization_aware: bool = False


@dataclasses.dataclass(frozen=True)
class CompressionParams:
    """The compression stage's settings (arguments/__init__.py:85-114 and
    the JAX package's extensions: keep quantiles, xyz_fp16).
    importance_include, importance_prune, color_importance_include and
    color_importance_prune are vestigial, as in the reference: declared,
    never read (pruning is prune_threshold, keep thresholds are the
    *_keep_quantile autoset)."""

    load_iteration: int = -1
    start_checkpoint: str = ""
    output_vq: str = ""
    importance_include: float = 0.0
    importance_prune: float = 1.0

    color_codebook_size: int = 2**12
    color_cluster_iterations: int = 100
    color_decay: float = 0.8
    color_batch_size: int = 2**18
    color_compress_non_dir: bool = True
    color_importance_include: float = 0.6 * 1e-6
    color_importance_prune: float = 0.0

    gaussian_codebook_size: int = 2**12
    gaussian_cluster_iterations: int = 800
    gaussian_decay: float = 0.8
    gaussian_batch_size: int = 2**20
    gaussian_importance_include: float = 0.3 * 1e-5

    not_compress_color: bool = False
    not_compress_gaussians: bool = False
    not_sort_morton: bool = False
    not_prune: bool = False
    prune_threshold: float = 0.0

    finetune_iterations: int = 5000

    # keep-quantile autoset of the keep thresholds (compress.py:212-219)
    color_keep_quantile: float = 0.9
    gaussian_keep_quantile: float = 0.75

    # fixed-point uint16 xyz in the npz unless set (models/io_npz.py)
    xyz_fp16: bool = False
