"""The compressed .npz container (port of c3dgs_tpu/models/io_npz.py,
modeled on the reference's save_npz/load_npz, gaussian_model.py:505-740).

Quantized layout: fp16 xyz; int8 `int_repr` + (scale, zero_point) for
features_dc / features_rest (raw), opacity (post-sigmoid), scaling
(post-normalize), scaling_factor (pre-exp log value) and rotation
(post-normalize); feature_indices / gaussian_indices when indexed; the
bool `quantization` flag; np.savez_compressed. Unquantized layout: plain
float arrays under the same keys.

The file format is the contract: a file either package writes loads in
the other. The two documented deviations from the reference (PARITY.md)
hold here too:
1. index arrays are uint16 when the codebook fits in 2^16 rows (the
   reference writes int32); `int32_indices=True` or
   C3DGS_NPZ_INT32_INDICES=1 writes int32, and load_npz reads either;
2. with `xyz_u16=True` (the compress CLI's default) xyz is fixed-point
   uint16 with a per-axis min/step header, step = extent / 65535;
   load_npz dispatches on the stored dtype.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..ops import quantize, quat
from . import gaussians as gmod


def _np(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def _q(x: np.ndarray, obs: quantize.ObserverState):
    scale, zp = quantize.qparams(obs)
    q = np.clip(np.round(x / float(scale) + float(zp)), quantize.QMIN, quantize.QMAX)
    return q.astype(np.int8), np.asarray([float(scale)]), np.asarray([int(zp)])


@torch.no_grad()
def save_npz(
    scene: gmod.GaussianScene,
    path,
    compress: bool = True,
    half_precision: bool = False,
    sort_morton: bool = False,
    int32_indices: bool | None = None,
    xyz_u16: bool = False,
) -> gmod.GaussianScene:
    """Serialize the scene's active rows. Returns the scene as written
    (compacted, and Morton-reordered with sort_morton), mirroring the
    reference's in-place sort (gaussian_model.py:513-514)."""
    scene = scene.compact()
    if sort_morton:
        scene = scene.morton_sorted()
    if isinstance(path, (str, os.PathLike)):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)

    dtype = np.float16 if half_precision else np.float32
    d: dict = {"quantization": scene.quantization}
    obs = scene.observer

    if scene.quantization:
        xyz = _np(scene.get_xyz()).astype(np.float32)
        if xyz_u16:
            mn = xyz.min(axis=0)
            step = np.maximum(xyz.max(axis=0) - mn, 1e-12) / 65535.0
            d["xyz"] = np.clip(np.round((xyz - mn) / step), 0, 65535).astype(np.uint16)
            d["xyz_min"] = mn.astype(np.float32)
            d["xyz_step"] = step.astype(np.float32)
        else:
            d["xyz"] = xyz.astype(np.float16)
        seen = {
            "features_dc": scene.features_dc,
            "features_rest": scene.features_rest,
            "opacity": torch.sigmoid(scene.opacity),
            "scaling": quat.normalize(torch.relu(scene.scaling)),
            "scaling_factor": scene.scaling_factor,
            "rotation": quat.normalize(scene.rotation),
        }
        for name, x in seen.items():
            if x is not None:
                d[name], d[f"{name}_scale"], d[f"{name}_zero_point"] = _q(_np(x), obs(name))
    else:
        d["xyz"] = _np(scene.xyz)
        d["features_dc"] = _np(scene.features_dc)
        d["features_rest"] = _np(scene.features_rest)
        d["opacity"] = _np(scene.opacity).astype(dtype)
        d["scaling"] = _np(scene.scaling).astype(dtype)
        if scene.scaling_factor is not None:
            d["scaling_factor"] = _np(scene.scaling_factor).astype(dtype)
        d["rotation"] = _np(scene.rotation).astype(dtype)

    if int32_indices is None:
        int32_indices = bool(os.environ.get("C3DGS_NPZ_INT32_INDICES"))

    def idx_dtype(rows: int):
        # the smallest dtype that addresses the codebook (deviation 1)
        return np.int32 if int32_indices or rows > (1 << 16) else np.uint16

    if scene.is_color_indexed:
        d["feature_indices"] = _np(scene.feature_indices).astype(idx_dtype(scene.features_dc.shape[0]))
    if scene.is_gaussian_indexed:
        d["gaussian_indices"] = _np(scene.gaussian_indices).astype(idx_dtype(scene.scaling.shape[0]))

    (np.savez_compressed if compress else np.savez)(path, **d)
    return scene


def _deq(d, name) -> np.ndarray:
    q = d[name].astype(np.float32)
    return (q - float(d[f"{name}_zero_point"])) * float(d[f"{name}_scale"])


def load_npz(
    path,
    max_sh_degree: int = 3,
    use_factor_scaling: bool = True,
    override_quantization: bool = False,
    quantization: bool = True,
    device: DeviceLike = None,
) -> gmod.GaussianScene:
    """The scene of an npz that either package wrote, on `device` (CUDA
    unless the caller names another): every row active, SH degree
    max_sh_degree active, each quantized attribute's observer pinned to
    its dequantized range (gaussian_model.py:648-719). Index arrays of any
    integer dtype (uint16 or int32) become int64."""
    dev = resolve_device(device)
    d = np.load(path)
    file_quant = bool(d["quantization"])
    if override_quantization:
        quantization = file_quant
    elif quantization != file_quant:
        print("WARNING: model is not quantisation aware but loaded model is")

    if d["xyz"].dtype == np.uint16:  # fixed-point container extension
        xyz = d["xyz"].astype(np.float32) * d["xyz_step"] + d["xyz_min"]
    else:
        xyz = d["xyz"].astype(np.float32)
    n = xyz.shape[0]
    quant = None
    if file_quant:
        f_dc, f_rest = _deq(d, "features_dc"), _deq(d, "features_rest")
        opacity_act = _deq(d, "opacity")
        opacity = np.log(np.clip(opacity_act, 1e-6, 1 - 1e-6) / (1 - np.clip(opacity_act, 1e-6, 1 - 1e-6)))
        scaling, rotation = _deq(d, "scaling"), _deq(d, "rotation")
        ranges = dict(features_dc=f_dc, features_rest=f_rest, opacity=opacity_act, scaling=scaling,
                      rotation=rotation)
        scaling_factor = _deq(d, "scaling_factor") if "scaling_factor" in d else None
        if scaling_factor is not None:
            ranges["scaling_factor"] = scaling_factor
        quant = {k: quantize.set_range(float(v.min()), float(v.max()), device=dev) for k, v in ranges.items()}
    else:
        f_dc = d["features_dc"].astype(np.float32)
        f_rest = d["features_rest"].astype(np.float32)
        opacity = d["opacity"].astype(np.float32)
        scaling = d["scaling"].astype(np.float32)
        rotation = d["rotation"].astype(np.float32)
        scaling_factor = d["scaling_factor"].astype(np.float32) if "scaling_factor" in d else None

    if not use_factor_scaling and scaling_factor is not None:
        raise ValueError("file has scaling_factor but use_factor_scaling=False")

    t = lambda v, dtype=torch.float32: None if v is None else torch.as_tensor(
        np.ascontiguousarray(v), device=dev).to(dtype)
    idx = lambda key: t(d[key].astype(np.int64), torch.int64) if key in d else None
    return gmod.GaussianScene(
        xyz=t(xyz),
        opacity=t(opacity.astype(np.float32).reshape(n, 1)),
        scaling_factor=None if scaling_factor is None else t(scaling_factor.reshape(-1, 1)),
        active=torch.ones(n, dtype=torch.bool, device=dev),
        features_dc=t(f_dc),
        features_rest=t(f_rest),
        scaling=t(scaling),
        rotation=t(rotation),
        quant=quant,
        feature_indices=idx("feature_indices"),
        gaussian_indices=idx("gaussian_indices"),
        max_sh_degree=max_sh_degree,
        active_sh_degree=max_sh_degree,
        quantization=quantization,
        use_factor_scaling=scaling_factor is not None,
    )
