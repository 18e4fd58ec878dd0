"""Dataset readers: COLMAP / Blender(NeRF-Synthetic) / DUSt3R (port of
c3dgs_tpu/data/readers.py, numpy and PIL as there).

Parity: scene/dataset_readers.py — readColmapSceneInfo (:147, with
llffhold-8 eval split :169-174 and points3D->ply conversion :181-187),
readNerfSyntheticInfo (:311, random 100k-point init :325-335),
readDustrInfo (:304), getNerfppNorm (:50), CameraInfo (:27) / SceneInfo
(:42). Intrinsics carry FoV in radians (the fork's convention, :103,258).
"""
from __future__ import annotations

import dataclasses
import json
import os
from pathlib import Path
from typing import List, Optional

import numpy as np

from ..ops.camera_math import focal_to_fov, fov_to_focal
from . import colmap


@dataclasses.dataclass
class CameraInfo:
    uid: int
    R: np.ndarray  # (3,3) world-to-camera rotation
    T: np.ndarray  # (3,) world-to-camera translation
    fovx: float  # radians
    fovy: float  # radians
    image_path: str
    image_name: str
    width: int
    height: int
    flip_image: bool = False


@dataclasses.dataclass
class PointCloud:
    points: np.ndarray  # (N,3)
    colors: np.ndarray  # (N,3) in [0,1]
    normals: np.ndarray  # (N,3)


@dataclasses.dataclass
class SceneInfo:
    point_cloud: Optional[PointCloud]
    train_cameras: List[CameraInfo]
    test_cameras: List[CameraInfo]
    nerf_normalization: dict
    ply_path: Optional[str]


def get_nerfpp_norm(cam_infos: List[CameraInfo]) -> dict:
    """Camera-centroid radius normalization (scene/dataset_readers.py:50)."""
    centers = []
    for cam in cam_infos:
        w2c = np.eye(4)
        w2c[:3, :3] = cam.R
        w2c[:3, 3] = cam.T
        c2w = np.linalg.inv(w2c)
        centers.append(c2w[:3, 3:4])
    centers = np.hstack(centers)
    avg = centers.mean(axis=1, keepdims=True)
    dist = np.linalg.norm(centers - avg, axis=0)
    diagonal = float(dist.max())
    radius = diagonal * 1.1
    return {"translate": (-avg[:, 0]).tolist(), "radius": radius}


def read_colmap_scene(
    path: str, images_dir: str = "images", eval_split: bool = False, llffhold: int = 8
) -> SceneInfo:
    """scene/dataset_readers.py:147-198."""
    sparse = Path(path) / "sparse" / "0"
    cams, imgs, pts = colmap.load_model(sparse)

    cam_infos: List[CameraInfo] = []
    for idx, key in enumerate(sorted(imgs.keys())):
        im = imgs[key]
        intr = cams[im.camera_id]
        R = colmap.qvec2rotmat(im.qvec)
        T = np.array(im.tvec)
        if intr.model == "SIMPLE_PINHOLE":
            focal_x = focal_y = intr.params[0]
        elif intr.model == "PINHOLE":
            focal_x, focal_y = intr.params[0], intr.params[1]
        else:
            raise ValueError(
                "Colmap camera model not handled: only undistorted datasets "
                "(PINHOLE or SIMPLE_PINHOLE) supported!"
            )
        fovx = focal_to_fov(focal_x, intr.width)
        fovy = focal_to_fov(focal_y, intr.height)
        cam_infos.append(
            CameraInfo(
                uid=im.camera_id,
                R=R,
                T=T,
                fovx=fovx,
                fovy=fovy,
                image_path=os.path.join(path, images_dir, im.name),
                image_name=Path(im.name).stem,
                width=intr.width,
                height=intr.height,
            )
        )
    cam_infos.sort(key=lambda c: c.image_name)

    if eval_split:
        train = [c for i, c in enumerate(cam_infos) if i % llffhold != 0]
        test = [c for i, c in enumerate(cam_infos) if i % llffhold == 0]
    else:
        train, test = cam_infos, []

    pcd = None
    ply_path = os.path.join(path, "sparse/0/points3D.ply")
    if pts is not None:
        xyz, rgb, _ = pts
        pcd = PointCloud(
            points=xyz.astype(np.float32),
            colors=(rgb.astype(np.float32) / 255.0),
            normals=np.zeros_like(xyz, dtype=np.float32),
        )

    return SceneInfo(
        point_cloud=pcd,
        train_cameras=train,
        test_cameras=test,
        nerf_normalization=get_nerfpp_norm(train),
        ply_path=ply_path,
    )


def _read_transforms_cameras(path: str, transforms_file: str, extension: str = ".png") -> List[CameraInfo]:
    """scene/dataset_readers.py readCamerasFromTransforms (:200-260):
    Blender c2w matrices use OpenGL axes — flip y,z to COLMAP convention."""
    infos: List[CameraInfo] = []
    with open(os.path.join(path, transforms_file)) as f:
        contents = json.load(f)
    fovx = contents.get("camera_angle_x")
    for idx, frame in enumerate(contents["frames"]):
        file_path = frame["file_path"]
        if not file_path.endswith(extension) and "." not in Path(file_path).name:
            file_path = file_path + extension
        image_path = os.path.join(path, file_path)
        c2w = np.array(frame["transform_matrix"])
        c2w[:3, 1:3] *= -1  # OpenGL -> COLMAP camera axes
        w2c = np.linalg.inv(c2w)
        R = w2c[:3, :3]
        T = w2c[:3, 3]
        # image size: read lazily from the file header
        from PIL import Image

        with Image.open(image_path) as im:
            width, height = im.size
        if "camera_angle_x" in frame:
            fovx_frame = frame["camera_angle_x"]
        else:
            fovx_frame = fovx
        if "fl_x" in contents:
            fovx_frame = focal_to_fov(contents["fl_x"], width)
        fovy = focal_to_fov(fov_to_focal(fovx_frame, width), height)
        infos.append(
            CameraInfo(
                uid=idx,
                R=R,
                T=T,
                fovx=fovx_frame,
                fovy=fovy,
                image_path=image_path,
                image_name=Path(file_path).stem,
                width=width,
                height=height,
            )
        )
    return infos


def read_nerf_synthetic_scene(
    path: str, eval_split: bool = True, extension: str = ".png"
) -> SceneInfo:
    """scene/dataset_readers.py:311-346; random 100k-point init when no ply."""
    train = _read_transforms_cameras(path, "transforms_train.json", extension)
    test = (
        _read_transforms_cameras(path, "transforms_test.json", extension)
        if eval_split and os.path.exists(os.path.join(path, "transforms_test.json"))
        else []
    )
    if not eval_split:
        train = train + test
        test = []

    ply_path = os.path.join(path, "points3d.ply")
    if os.path.exists(ply_path):
        from ..models import io_ply

        pcd = io_ply.read_point_cloud(ply_path)
    else:
        num_pts = 100_000
        print(f"Generating random point cloud ({num_pts})...")
        rng = np.random.default_rng(0)
        xyz = (rng.random((num_pts, 3)) * 2.6 - 1.3).astype(np.float32)
        rgb = rng.random((num_pts, 3)).astype(np.float32)
        pcd = PointCloud(xyz, rgb, np.zeros_like(xyz))

    return SceneInfo(
        point_cloud=pcd,
        train_cameras=train,
        test_cameras=test,
        nerf_normalization=get_nerfpp_norm(train),
        ply_path=ply_path,
    )


def read_dust3r_scene(path: str, eval_split: bool = False) -> SceneInfo:
    """scene/dataset_readers.py:304-309: transforms_dust3r.json + scene.ply;
    images are stored flipped (scene/cameras.py:76-77)."""
    train = _read_transforms_cameras(path, "transforms_dust3r.json")
    for c in train:
        c.flip_image = True
    from ..models import io_ply

    ply_path = os.path.join(path, "scene.ply")
    pcd = io_ply.read_point_cloud(ply_path) if os.path.exists(ply_path) else None
    return SceneInfo(
        point_cloud=pcd,
        train_cameras=train,
        test_cameras=[],
        nerf_normalization=get_nerfpp_norm(train),
        ply_path=ply_path,
    )


def detect_scene_type(path: str) -> str:
    """Marker-file autodetect (scene/__init__.py:48-55)."""
    if os.path.exists(os.path.join(path, "sparse")):
        return "Colmap"
    if os.path.exists(os.path.join(path, "transforms_dust3r.json")):
        return "Dust3r"
    if os.path.exists(os.path.join(path, "transforms_train.json")):
        return "Blender"
    raise ValueError(f"Could not recognize scene type for {path}")
