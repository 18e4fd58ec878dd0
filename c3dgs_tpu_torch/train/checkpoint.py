"""Full-training-state checkpointing (port of c3dgs_tpu/train/checkpoint.py;
GaussianModel.capture/restore, gaussian_model.py:176-210).

The complete TrainState (scene parameters and observers, Adam moments,
densify statistics, random state, step) goes into one compressed .npz
under the JAX package's key names, so that a file either package writes
loads in the other:

    scene/<field>, scene/quant/<observer>/{min_val,max_val,initialized},
    opt_state/0/{mu,nu}/<field>, opt_state/0/count (Adam's count),
    opt_state/1 (the LR-schedule step), stats/<field>, key, step,
    __meta__ (the scene's static settings as JSON bytes).

Random state: torch cannot reproduce jax.random, so the port keeps its
generator's state under one extra key, `torch_generator`, which the JAX
loader ignores, and writes `key` as a valid uint32[2] PRNG key:
jax.random.PRNGKey(seed) of the generator's initial seed, (seed >> 32,
seed & 0xffffffff). Loading a file without `torch_generator` (a JAX file)
seeds the generator with (key[0] << 32) | key[1]; a file written on
another device type (the states of CPU and CUDA generators differ in
kind) is seeded the same way.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from ..config import OptimizationParams
from ..device import DeviceLike, resolve_device
from ..models.gaussians import QUANT_FIELDS, scene_from_numpy
from . import densify as D
from . import trainer

GENERATOR_KEY = "torch_generator"
_SCENE_FIELDS = ("xyz", "opacity", "scaling_factor", "active", "features_dc", "features_rest", "scaling",
                 "rotation", "feature_indices", "gaussian_indices")


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def save_checkpoint(path: str, state: trainer.TrainState) -> None:
    scene = state.scene
    meta = {
        "max_sh_degree": scene.max_sh_degree,
        "active_sh_degree": scene.active_sh_degree,
        "quantization": scene.quantization,
        "use_factor_scaling": scene.use_factor_scaling,
        "has_scaling_factor": scene.scaling_factor is not None,
        "is_color_indexed": scene.is_color_indexed,
        "is_gaussian_indexed": scene.is_gaussian_indexed,
        "generator_device": state.generator.device.type,
    }
    payload = {}
    for f in _SCENE_FIELDS:
        v = getattr(scene, f)
        if v is not None:
            # the JAX scene holds its index arrays as int32
            payload[f"scene/{f}"] = _np(v).astype(np.int32) if f.endswith("_indices") else _np(v)
    for f in QUANT_FIELDS:
        for part, v in zip(("min_val", "max_val", "initialized"), scene.observer(f)):
            payload[f"scene/quant/{f}/{part}"] = _np(v)
    opt = state.opt_state
    payload["opt_state/0/count"] = np.asarray(opt.count, np.int32)
    for tree, moments in (("mu", opt.mu), ("nu", opt.nu)):
        for k, v in moments.items():
            payload[f"opt_state/0/{tree}/{k}"] = _np(v)
    payload["opt_state/1"] = np.asarray(opt.step, np.int32)
    for f in ("xyz_gradient_accum", "denom", "max_radii2d"):
        payload[f"stats/{f}"] = _np(getattr(state.stats, f))
    seed = state.generator.initial_seed()
    payload["key"] = np.asarray([seed >> 32, seed & 0xFFFFFFFF], np.uint32)
    payload["step"] = np.asarray(state.step, np.int32)
    payload[GENERATOR_KEY] = _np(state.generator.get_state())
    payload["__meta__"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez_compressed(path, **payload)


def load_checkpoint(
    path: str, opt: OptimizationParams, spatial_lr_scale: float = 1.0, device: DeviceLike = None
) -> trainer.TrainState:
    """The TrainState of a checkpoint either package wrote, on `device`
    (CUDA unless the caller names another)."""
    dev = resolve_device(device)
    data = np.load(path)
    meta = json.loads(bytes(data["__meta__"]).decode())
    params = {f: data[f"scene/{f}"] if f"scene/{f}" in data else None for f in _SCENE_FIELDS}
    quant = {f: tuple(data[f"scene/quant/{f}/{p}"] for p in ("min_val", "max_val", "initialized"))
             for f in QUANT_FIELDS}
    scene = scene_from_numpy(
        params,
        max_sh_degree=meta["max_sh_degree"],
        active_sh_degree=meta["active_sh_degree"],
        quantization=meta["quantization"],
        use_factor_scaling=meta["use_factor_scaling"],
        quant=quant,
        device=dev,
    )

    state = trainer.create_train_state(scene, opt, spatial_lr_scale, device=dev)
    t = lambda key: torch.as_tensor(data[key], device=dev)
    adam = state.opt_state
    adam.mu = {k: t(f"opt_state/0/mu/{k}") for k in adam.mu}
    adam.nu = {k: t(f"opt_state/0/nu/{k}") for k in adam.nu}
    adam.count = int(data["opt_state/0/count"])
    adam.step = int(data["opt_state/1"])
    state.stats = D.DensifyStats(*(t(f"stats/{f}") for f in ("xyz_gradient_accum", "denom", "max_radii2d")))
    state.step = int(data["step"])
    if GENERATOR_KEY in data and meta.get("generator_device") == dev.type:
        state.generator.set_state(torch.as_tensor(data[GENERATOR_KEY]))
    else:
        k0, k1 = (int(w) for w in data["key"])
        state.generator.manual_seed((k0 << 32) | k1)
    return state
