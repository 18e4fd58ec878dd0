"""c3dgs_tpu_torch — the PyTorch/CUDA port of c3dgs_tpu.

The package mirrors c3dgs_tpu's layout (ops/, models/, render/, train/,
eval/, compress/, data/) so every module's counterpart sits at the same
path; cli/ holds the ports of the root scripts. It imports
torch and numpy only — never jax, flax, optax or anything of c3dgs_tpu.
Every Pallas TPU kernel on a ported path becomes a kernel written by hand
for Hopper (csrc/), launched through a wrapper that keeps a plain PyTorch
version beside it for CPU tensors.

Entry points (from_point_cloud, scene_from_numpy, render_scene,
render_full, render_and_eval, create_train_state, train_step,
densify_step, reset_opacity_step, grow_capacity, calc_importance,
to_compressed, finetune, load_npz, load_gaussians_ply, load_checkpoint,
data.Scene) run on the CUDA device unless the caller passes
device="cpu"; the CLIs (python -m c3dgs_tpu_torch.cli.{train,compress,
render,metrics}) run on --data_device, "cuda" by default.
"""
from .device import resolve_device

__all__ = ["resolve_device"]
