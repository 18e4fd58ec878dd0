"""Seeded synthetic datasets on disk, rendered by the port itself: a
Blender (NeRF-Synthetic) folder and a COLMAP sparse model with its images.
Test tools for chip_smoke.py and the card's tests, which cannot import the
JAX package's tests/synth.py; not a user feature.

- write_blender_dataset: transforms_{train,test}.json with OpenGL-axis
  camera-to-world matrices, PNGs, points3d.ply (tests/synth.py's layout).
- write_colmap_dataset: images/<name>.png and sparse/0/{cameras.bin (one
  PINHOLE camera), images.bin, points3D.bin} in COLMAP's binary layout
  (tracks empty).

Views are rendered through eval/metrics.py::render_full on `device`
(CUDA unless the caller names another; K1 on the card).
"""
from __future__ import annotations

import json
import math
import os
import struct
from typing import Optional, Sequence

import numpy as np
import torch

from ..data import colmap
from ..data.cameras import make_intrinsic
from ..device import DeviceLike, resolve_device
from ..eval import metrics
from ..models import gaussians as gmod
from ..models import io_ply
from ..ops import camera_math, sh
from ..render.types import settings_from_intrinsic


def gt_scene(n: int = 400, seed: int = 3, device: DeviceLike = None) -> gmod.GaussianScene:
    """tests/synth.py::gt_scene: n splats around the origin, enlarged and
    with normal opacity logits."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(n, 3)).astype(np.float32) * 0.7
    cols = rng.random(size=(n, 3)).astype(np.float32)
    scene = gmod.from_point_cloud(pts, cols, capacity=n, quantization=False, device=device)
    with torch.no_grad():
        scene.scaling_factor += math.log(1.6)
        scene.opacity.copy_(torch.as_tensor(rng.normal(size=(n, 1)).astype(np.float32) * 1.5 + 1.0))
    return scene


def ring_cameras(num: int = 12, radius: float = 4.0, height: float = 1.2):
    """(world-to-camera 7-vector, camera-to-world 4x4) of `num` cameras on
    a ring looking at the origin (tests/synth.py::ring_cameras)."""
    cams = []
    for i in range(num):
        theta = 2 * math.pi * i / num
        eye = np.array([radius * math.cos(theta), height, radius * math.sin(theta)])
        fwd = -eye / np.linalg.norm(eye)
        right = np.cross(np.array([0.0, 1.0, 0.0]), fwd)
        right /= np.linalg.norm(right)
        c2w = np.eye(4)
        c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, np.cross(fwd, right), fwd, eye
        cams.append((np.asarray(camera_math.mat_to_extrinsic(np.linalg.inv(c2w)), np.float32), c2w))
    return cams


def render_png(path: str, scene: gmod.GaussianScene, extrinsic_vector, intrinsic, device: DeviceLike = None) -> None:
    """Render one view (black background) and write it as an 8-bit PNG."""
    from PIL import Image

    out = metrics.render_full(scene, extrinsic_vector, settings_from_intrinsic(intrinsic, inference=True),
                              np.zeros(3), device=device)
    img = np.clip(out["render"].cpu().numpy(), 0, 1)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    # zlib level 1: a 1080p frame encodes several times faster than at
    # PIL's default 6, and decodes the same
    Image.fromarray((img.transpose(1, 2, 0) * 255).astype(np.uint8)).save(path, compress_level=1)


def dc_colors_u8(scene: gmod.GaussianScene) -> np.ndarray:
    """(P, 3) uint8 RGB of the scene's SH DC band."""
    dc = scene.features_dc.detach().cpu().numpy()[:, 0]
    return (np.clip(sh.sh_dc_to_rgb(dc), 0, 1) * 255).astype(np.uint8)


def write_blender_dataset(
    out_dir: str,
    res: int = 64,
    num_train: int = 12,
    num_test: int = 4,
    fov: float = 0.9,
    scene: Optional[gmod.GaussianScene] = None,
    radius: float = 4.0,
    init_noise: float = 0.05,
    device: DeviceLike = None,
) -> gmod.GaussianScene:
    """tests/synth.py::write_blender_dataset with the port's renderer:
    train views on a ring of `radius`, test views on one 7.5% wider,
    points3d.ply the scene's points with seeded noise and DC colors.
    Returns the scene rendered."""
    dev = resolve_device(device)
    scene = gt_scene(device=dev) if scene is None else scene
    intrinsic = make_intrinsic(fov, fov, res, res)
    for split, num, r in (("train", num_train, radius), ("test", num_test, radius * 1.075)):
        frames = []
        for i, (ev, c2w) in enumerate(ring_cameras(num, radius=r)):
            path = f"{split}/r_{i}.png"
            render_png(os.path.join(out_dir, path), scene, ev, intrinsic, device=dev)
            c2w_gl = c2w.copy()
            c2w_gl[:3, 1:3] *= -1  # Blender json stores OpenGL camera axes
            frames.append({"file_path": path, "transform_matrix": c2w_gl.tolist()})
        with open(os.path.join(out_dir, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": fov, "frames": frames}, f)
    rng = np.random.default_rng(0)
    pts = scene.xyz.detach().cpu().numpy()
    pts = pts + rng.normal(size=pts.shape).astype(np.float32) * init_noise
    cols = dc_colors_u8(scene)
    io_ply.write_vertices(
        os.path.join(out_dir, "points3d.ply"),
        {"x": pts[:, 0], "y": pts[:, 1], "z": pts[:, 2], "red": cols[:, 0], "green": cols[:, 1], "blue": cols[:, 2]},
    )
    return scene


def write_colmap_model(
    sparse_dir: str,
    width: int,
    height: int,
    fx: float,
    fy: float,
    extrinsics: Sequence[np.ndarray],
    names: Sequence[str],
    points: np.ndarray,
    colors: np.ndarray,
) -> None:
    """cameras.bin (camera 1: PINHOLE fx, fy, cx = W/2, cy = H/2),
    images.bin (image i + 1 with the world-to-camera pose of
    extrinsics[i], a (qx, qy, qz, qw, tx, ty, tz) 7-vector; no 2-D
    points) and points3D.bin (ids from 1, error 0, empty tracks)."""
    os.makedirs(sparse_dir, exist_ok=True)
    pinhole = colmap.CAMERA_MODEL_NAMES["PINHOLE"].model_id
    with open(os.path.join(sparse_dir, "cameras.bin"), "wb") as f:
        f.write(struct.pack("<Q", 1))
        f.write(struct.pack("<iiQQ", 1, pinhole, width, height))
        f.write(struct.pack("<dddd", fx, fy, width / 2, height / 2))
    with open(os.path.join(sparse_dir, "images.bin"), "wb") as f:
        f.write(struct.pack("<Q", len(extrinsics)))
        for i, (ev, name) in enumerate(zip(extrinsics, names)):
            x, y, z, w, tx, ty, tz = (float(v) for v in ev)
            f.write(struct.pack("<idddddddi", i + 1, w, x, y, z, tx, ty, tz, 1))
            f.write(name.encode() + b"\x00")
            f.write(struct.pack("<Q", 0))
    n = len(points)
    rec = np.zeros(n, dtype=[("id", "<u8"), ("xyz", "<f8", 3), ("rgb", "u1", 3), ("error", "<f8"),
                             ("track_len", "<u8")])
    rec["id"] = np.arange(1, n + 1)
    rec["xyz"] = points
    rec["rgb"] = colors
    with open(os.path.join(sparse_dir, "points3D.bin"), "wb") as f:
        f.write(struct.pack("<Q", n))
        f.write(rec.tobytes())


def write_colmap_dataset(
    out_dir: str,
    scene: gmod.GaussianScene,
    extrinsics: Sequence[np.ndarray],
    width: int,
    height: int,
    fovx: float,
    fovy: float,
    device: DeviceLike = None,
) -> list:
    """A COLMAP dataset whose photos are the scene's renders: images/
    view_<i>.png for each world-to-camera 7-vector, and the sparse model
    with one PINHOLE camera of the given FoVs (radians) and the scene's
    active points with their DC colors. Returns the image names."""
    dev = resolve_device(device)
    intrinsic = make_intrinsic(fovx, fovy, width, height)
    names = [f"view_{i:03d}.png" for i in range(len(extrinsics))]
    for ev, name in zip(extrinsics, names):
        render_png(os.path.join(out_dir, "images", name), scene, ev, intrinsic, device=dev)
    active = scene.active.cpu().numpy()
    write_colmap_model(
        os.path.join(out_dir, "sparse", "0"), width, height,
        camera_math.fov_to_focal(fovx, width), camera_math.fov_to_focal(fovy, height),
        extrinsics, names, scene.xyz.detach().cpu().numpy()[active], dc_colors_u8(scene)[active],
    )
    return names
