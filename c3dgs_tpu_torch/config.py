"""Training hyperparameters (port of c3dgs_tpu/config.py's
OptimizationParams, arguments/__init__.py:116-137, defaults preserved
exactly). The argparse ParamGroup machinery comes with the CLI slice."""
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
