"""c3dgs_tpu_torch — the PyTorch/CUDA port of c3dgs_tpu.

The package mirrors c3dgs_tpu's layout (ops/, models/, render/, train/,
eval/) so every module's counterpart sits at the same path. It imports
torch and numpy only — never jax, flax, optax or anything of c3dgs_tpu.
Every Pallas TPU kernel on a ported path becomes a kernel written by hand
for Hopper (csrc/), launched through a wrapper that keeps a plain PyTorch
version beside it for CPU tensors.

Entry points (from_point_cloud, scene_from_numpy, render_scene,
render_full, render_and_eval, create_train_state, train_step,
densify_step, reset_opacity_step, grow_capacity) run on the CUDA device
unless the caller passes device="cpu".
"""
from .device import resolve_device

__all__ = ["resolve_device"]
