"""COLMAP sparse-reconstruction parsers (binary + text; port of
c3dgs_tpu/data/colmap.py). load_model reads points3D.bin through the
host codec (native.py), as the JAX package does; read_points3D_binary is
its numpy version.

Parity: scene/colmap_loader.py — read_extrinsics_binary (:180),
read_intrinsics_binary (:215), read_points3D_binary (:125), the text
variants (:83,156,244), qvec2rotmat (:43).
Written from the COLMAP file-format spec; model structs mirror the
reference's namedtuples so downstream readers are drop-in.
"""
from __future__ import annotations

import collections
import struct
from pathlib import Path

import numpy as np

from .. import native

CameraModel = collections.namedtuple("CameraModel", ["model_id", "model_name", "num_params"])
ColmapCamera = collections.namedtuple("Camera", ["id", "model", "width", "height", "params"])
BaseImage = collections.namedtuple(
    "Image", ["id", "qvec", "tvec", "camera_id", "name", "xys", "point3D_ids"]
)

CAMERA_MODELS = [
    CameraModel(0, "SIMPLE_PINHOLE", 3),
    CameraModel(1, "PINHOLE", 4),
    CameraModel(2, "SIMPLE_RADIAL", 4),
    CameraModel(3, "RADIAL", 5),
    CameraModel(4, "OPENCV", 8),
    CameraModel(5, "OPENCV_FISHEYE", 8),
    CameraModel(6, "FULL_OPENCV", 12),
    CameraModel(7, "FOV", 5),
    CameraModel(8, "SIMPLE_RADIAL_FISHEYE", 4),
    CameraModel(9, "RADIAL_FISHEYE", 5),
    CameraModel(10, "THIN_PRISM_FISHEYE", 12),
]
CAMERA_MODEL_IDS = {m.model_id: m for m in CAMERA_MODELS}
CAMERA_MODEL_NAMES = {m.model_name: m for m in CAMERA_MODELS}


def qvec2rotmat(qvec):
    """COLMAP (w,x,y,z) quaternion -> rotation matrix."""
    w, x, y, z = qvec
    return np.array(
        [
            [1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * w * z, 2 * x * z + 2 * w * y],
            [2 * x * y + 2 * w * z, 1 - 2 * x * x - 2 * z * z, 2 * y * z - 2 * w * x],
            [2 * x * z - 2 * w * y, 2 * y * z + 2 * w * x, 1 - 2 * x * x - 2 * y * y],
        ]
    )


def _read(fid, num_bytes, fmt):
    return struct.unpack("<" + fmt, fid.read(num_bytes))


def read_extrinsics_binary(path) -> dict:
    images = {}
    with open(path, "rb") as fid:
        num = _read(fid, 8, "Q")[0]
        for _ in range(num):
            props = _read(fid, 64, "idddddddi")
            image_id = props[0]
            qvec = np.array(props[1:5])
            tvec = np.array(props[5:8])
            camera_id = props[8]
            name = b""
            c = fid.read(1)
            while c != b"\x00":
                name += c
                c = fid.read(1)
            num_points = _read(fid, 8, "Q")[0]
            data = np.frombuffer(fid.read(24 * num_points), dtype=np.float64)
            data = data.reshape(num_points, 3) if num_points else data.reshape(0, 3)
            xys = data[:, :2].copy()
            ids = data[:, 2].copy().view(np.int64) if num_points else np.zeros(0, np.int64)
            images[image_id] = BaseImage(
                image_id, qvec, tvec, camera_id, name.decode("utf-8"), xys, ids
            )
    return images


def read_intrinsics_binary(path) -> dict:
    cameras = {}
    with open(path, "rb") as fid:
        num = _read(fid, 8, "Q")[0]
        for _ in range(num):
            cam_id, model_id, width, height = _read(fid, 24, "iiQQ")
            model = CAMERA_MODEL_IDS[model_id]
            params = np.array(_read(fid, 8 * model.num_params, "d" * model.num_params))
            cameras[cam_id] = ColmapCamera(
                cam_id, model.model_name, width, height, params
            )
    return cameras


def read_points3D_binary(path):
    with open(path, "rb") as fid:
        num = _read(fid, 8, "Q")[0]
        xyzs = np.empty((num, 3))
        rgbs = np.empty((num, 3), np.uint8)
        errors = np.empty(num)
        for i in range(num):
            vals = _read(fid, 43, "QdddBBBd")
            xyzs[i] = vals[1:4]
            rgbs[i] = vals[4:7]
            errors[i] = vals[7]
            track_len = _read(fid, 8, "Q")[0]
            fid.read(8 * track_len)
    return xyzs, rgbs, errors


def read_extrinsics_text(path) -> dict:
    images = {}
    with open(path) as fid:
        lines = [l.strip() for l in fid if l.strip() and not l.startswith("#")]
    for i in range(0, len(lines), 2):
        elems = lines[i].split()
        image_id = int(elems[0])
        qvec = np.array(list(map(float, elems[1:5])))
        tvec = np.array(list(map(float, elems[5:8])))
        camera_id = int(elems[8])
        name = elems[9]
        pts = lines[i + 1].split() if i + 1 < len(lines) else []
        xys = np.array(list(map(float, pts))).reshape(-1, 3)[:, :2] if pts else np.zeros((0, 2))
        ids = (
            np.array(list(map(float, pts))).reshape(-1, 3)[:, 2].astype(np.int64)
            if pts
            else np.zeros(0, np.int64)
        )
        images[image_id] = BaseImage(image_id, qvec, tvec, camera_id, name, xys, ids)
    return images


def read_intrinsics_text(path) -> dict:
    cameras = {}
    with open(path) as fid:
        for line in fid:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            elems = line.split()
            cam_id = int(elems[0])
            cameras[cam_id] = ColmapCamera(
                cam_id,
                elems[1],
                int(elems[2]),
                int(elems[3]),
                np.array(list(map(float, elems[4:]))),
            )
    return cameras


def read_points3D_text(path):
    xyzs, rgbs, errors = [], [], []
    with open(path) as fid:
        for line in fid:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            elems = line.split()
            xyzs.append(list(map(float, elems[1:4])))
            rgbs.append(list(map(int, elems[4:7])))
            errors.append(float(elems[7]))
    return (
        np.array(xyzs),
        np.array(rgbs, np.uint8),
        np.array(errors),
    )


def load_model(sparse_dir):
    """Read (cameras, images, points) preferring binary, falling back to
    text (scene/dataset_readers.py:148-157 behavior)."""
    sparse = Path(sparse_dir)
    try:
        cams = read_intrinsics_binary(sparse / "cameras.bin")
        imgs = read_extrinsics_binary(sparse / "images.bin")
    except FileNotFoundError:
        cams = read_intrinsics_text(sparse / "cameras.txt")
        imgs = read_extrinsics_text(sparse / "images.txt")
    try:
        # the host codec (csrc/codec.cpp): per-point Python parsing is slow
        # at 5M+ points; read_points3D_binary gives the same arrays
        pts = native.read_points3d_binary(sparse / "points3D.bin")
    except FileNotFoundError:
        try:
            pts = read_points3D_text(sparse / "points3D.txt")
        except FileNotFoundError:
            pts = None
    return cams, imgs, pts
