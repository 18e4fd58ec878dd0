"""PLY codec for Gaussian scenes + point clouds, numpy-only (no plyfile
dep; port of c3dgs_tpu/models/io_ply.py, the same files both ways).

Parity: scene/gaussian_model.py save_ply (:339, full 3DGS attribute layout
x/y/z nx/ny/nz f_dc_* f_rest_* opacity scale_* rot_*) and load_ply (:398,
including the RGB-point-cloud fallback with kNN scale init :458-461 and
active-degree detection from the f_rest count :434-437).

Binary little-endian PLY, the format every 3DGS tool exchanges.
"""
from __future__ import annotations

import io
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike
from ..ops import misc
from . import gaussians as gmod

_PLY_DTYPES = {
    "float": np.float32,
    "float32": np.float32,
    "double": np.float64,
    "float64": np.float64,
    "uchar": np.uint8,
    "uint8": np.uint8,
    "char": np.int8,
    "short": np.int16,
    "ushort": np.uint16,
    "int": np.int32,
    "int32": np.int32,
    "uint": np.uint32,
}
_INV_DTYPES = {np.dtype(np.float32): "float", np.dtype(np.uint8): "uchar"}


def _read_header(f) -> Tuple[List[Tuple[str, np.dtype]], int, str]:
    if f.readline().strip() != b"ply":
        raise ValueError(f"{f.name} is not a ply file")
    fmt = None
    count = 0
    props: List[Tuple[str, np.dtype]] = []
    while True:
        line = f.readline().strip().decode("ascii")
        if line == "end_header":
            break
        parts = line.split()
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element" and parts[1] == "vertex":
            count = int(parts[2])
        elif parts[0] == "property" and parts[1] != "list":
            props.append((parts[2], np.dtype(_PLY_DTYPES[parts[1]])))
    return props, count, fmt


def read_vertices(path) -> Dict[str, np.ndarray]:
    """Read the vertex element into a dict of column arrays."""
    with open(path, "rb") as f:
        props, count, fmt = _read_header(f)
        if fmt == "binary_little_endian":
            dtype = np.dtype([(n, d) for n, d in props])
            data = np.frombuffer(f.read(dtype.itemsize * count), dtype=dtype)
        elif fmt == "ascii":
            raw = np.loadtxt(io.StringIO(f.read().decode("ascii")), max_rows=count)
            raw = raw.reshape(count, len(props))
            data = {n: raw[:, i].astype(d) for i, (n, d) in enumerate(props)}
            return data
        else:
            raise ValueError(f"unsupported ply format {fmt}")
    return {n: np.ascontiguousarray(data[n]) for n, _ in props}


def write_vertices(path, columns: Dict[str, np.ndarray]) -> None:
    names = list(columns.keys())
    count = len(next(iter(columns.values())))
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(b"ply\nformat binary_little_endian 1.0\n")
        f.write(f"element vertex {count}\n".encode())
        for n in names:
            tname = _INV_DTYPES.get(np.dtype(columns[n].dtype), "float")
            f.write(f"property {tname} {n}\n".encode())
        f.write(b"end_header\n")
        rec = np.empty(count, dtype=[(n, columns[n].dtype) for n in names])
        for n in names:
            rec[n] = columns[n]
        f.write(rec.tobytes())


def read_point_cloud(path):
    """Plain xyz+rgb point cloud -> readers.PointCloud."""
    from ..data.readers import PointCloud

    v = read_vertices(path)
    pts = np.stack([v["x"], v["y"], v["z"]], 1).astype(np.float32)
    if "red" in v:
        cols = np.stack([v["red"], v["green"], v["blue"]], 1).astype(np.float32) / 255.0
    else:
        cols = np.full_like(pts, 0.5)
    if "nx" in v:
        nrm = np.stack([v["nx"], v["ny"], v["nz"]], 1).astype(np.float32)
    else:
        nrm = np.zeros_like(pts)
    return PointCloud(pts, cols, nrm)


@torch.no_grad()
def save_gaussians_ply(scene: gmod.GaussianScene, path: str) -> None:
    """Full 3DGS attribute dump (gaussian_model.py:339-387). Indexed scenes
    are de-indexed to dense attributes (with the reference's warning)."""
    if scene.is_color_indexed or scene.is_gaussian_indexed:
        print(
            "WARNING: indexed colors/gaussians are not supported for ply "
            "files and are converted to dense attributes"
        )
    s = scene.compact()
    np_ = lambda t: t.detach().cpu().numpy()
    feats = np_(s.get_features())  # (N,K,3) quantized view
    xyz = np_(s.xyz)
    n = xyz.shape[0]
    cols: Dict[str, np.ndarray] = {}
    for i, ax in enumerate("xyz"):
        cols[ax] = xyz[:, i].astype(np.float32)
    for i, ax in enumerate(["nx", "ny", "nz"]):
        cols[ax] = np.zeros(n, np.float32)
    # f_dc / f_rest stored channel-major like the reference's
    # transpose+flatten (gaussian_model.py:351-366)
    f_dc = feats[:, :1].transpose(0, 2, 1).reshape(n, -1)
    f_rest = feats[:, 1:].transpose(0, 2, 1).reshape(n, -1)
    for i in range(f_dc.shape[1]):
        cols[f"f_dc_{i}"] = f_dc[:, i].astype(np.float32)
    for i in range(f_rest.shape[1]):
        cols[f"f_rest_{i}"] = f_rest[:, i].astype(np.float32)
    cols["opacity"] = np_(s.opacity)[:, 0].astype(np.float32)
    # scale stored as log of the *actual* per-splat scale (:368-373)
    scale = np.log(np.maximum(np_(s.get_scaling()), 1e-12))
    for i in range(3):
        cols[f"scale_{i}"] = scale[:, i].astype(np.float32)
    rot = np_(s.get_rotation())
    for i in range(4):
        cols[f"rot_{i}"] = rot[:, i].astype(np.float32)
    write_vertices(path, cols)


def load_gaussians_ply(
    path: str,
    max_sh_degree: int = 3,
    quantization: bool = True,
    use_factor_scaling: bool = True,
    capacity: Optional[int] = None,
    device: DeviceLike = None,
) -> gmod.GaussianScene:
    """Load a 3DGS ply (or a bare RGB point cloud) into a GaussianScene
    (gaussian_model.py:398-502) on `device` (CUDA unless the caller names
    another). Rows past the file's up to `capacity` are inactive padding,
    their rotation rows (1, 0, 0, 0)."""
    v = read_vertices(path)
    keys = set(v.keys())
    assert {"x", "y", "z"} <= keys
    xyz = np.stack([v["x"], v["y"], v["z"]], 1).astype(np.float32)
    n = xyz.shape[0]

    is_raw_cloud = "red" in keys
    if is_raw_cloud or "f_rest_0" not in keys:
        # RGB / colorless point cloud init path
        if is_raw_cloud:
            colors = np.stack([v["red"], v["green"], v["blue"]], 1).astype(np.float32)
            colors /= 255.0
        else:
            colors = None
        scene = gmod.from_point_cloud(
            xyz,
            colors,
            max_sh_degree=max_sh_degree,
            capacity=capacity,
            quantization=quantization,
            use_factor_scaling=use_factor_scaling,
            knn_scale_init="scale_0" not in keys,
            device=device,
        )
        if "opacity" in keys:
            cap = scene.capacity
            op = np.full((cap, 1), -4.0, np.float32)
            op[:n, 0] = v["opacity"]
            scene = scene._replace(opacity=torch.as_tensor(op, device=scene.device))
        return scene

    cap = capacity or n

    def padded(arr, fill=0.0):
        out = np.full((cap,) + arr.shape[1:], fill, np.float32)
        out[:n] = arr
        return out

    k_total = (max_sh_degree + 1) ** 2

    f_dc = np.stack([v[f"f_dc_{i}"] for i in range(3)], 1).reshape(n, 1, 3)
    rest_names = sorted(
        (k for k in keys if k.startswith("f_rest_")), key=lambda s: int(s.split("_")[-1])
    )
    # channel-major on disk -> (n, coeffs, 3)
    rest = np.stack([v[k] for k in rest_names], 1)
    n_rest = len(rest_names) // 3
    f_rest = rest.reshape(n, 3, n_rest).transpose(0, 2, 1)
    # active degree from coefficient count (gaussian_model.py:434-437)
    degree_map = {((d + 1) ** 2 - 1): d for d in range(max_sh_degree + 1)}
    active_degree = degree_map.get(n_rest, max_sh_degree)
    if n_rest < k_total - 1:
        f_rest = np.concatenate(
            [f_rest, np.zeros((n, k_total - 1 - n_rest, 3), np.float32)], 1
        )

    scale_names = sorted(
        (k for k in keys if k.startswith("scale_") and not k.startswith("scale_factor")),
        key=lambda s: int(s.split("_")[-1]),
    )
    log_scale = np.stack([v[k] for k in scale_names], 1).astype(np.float32)
    rot_names = sorted(
        (k for k in keys if k.startswith("rot_")), key=lambda s: int(s.split("_")[-1])
    )
    rots = np.stack([v[k] for k in rot_names], 1).astype(np.float32)
    opacity = v["opacity"].astype(np.float32)[:, None]

    if use_factor_scaling:
        lin = np.exp(log_scale)
        norm = np.maximum(np.linalg.norm(lin, axis=1, keepdims=True), 1e-12)
        scaling = (lin / norm).astype(np.float32)
        scaling_factor = np.log(norm).astype(np.float32)
    else:
        scaling = log_scale
        scaling_factor = None

    active = np.zeros(cap, bool)
    active[:n] = True
    rotation = padded(rots)
    rotation[n:, 0] = 1.0
    return gmod.scene_from_numpy(
        dict(
            xyz=padded(xyz),
            opacity=padded(opacity, misc.inverse_sigmoid(1e-4)),
            scaling_factor=None if scaling_factor is None else padded(scaling_factor, -10.0),
            active=active,
            features_dc=padded(f_dc),
            features_rest=padded(f_rest),
            scaling=padded(scaling, 1.0),
            rotation=rotation,
        ),
        max_sh_degree=max_sh_degree,
        active_sh_degree=active_degree,
        quantization=quantization,
        use_factor_scaling=use_factor_scaling,
        device=device,
    )
