"""Camera containers + image loading (port of c3dgs_tpu/data/cameras.py,
numpy and PIL as there; the scene's tensors are made by its consumers on
their device).

Parity: scene/cameras.py (Camera with lazy image load, 7-vector extrinsics,
FoV-radian intrinsic with W,H in the last column) and utils/camera_utils.py
(resolution ladder, >1600px auto-downscale warning, camera_to_JSON).

Divergences:
- PIL reads and resizes the images where the reference uses cv2;
  premultiplied alpha kept.
- the reference unconditionally flips images upside-down+left-right with a
  "DUST3R ONLY!" comment (scene/cameras.py:76-77) — here the flip is an
  explicit flag set only by the DUSt3R reader.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..ops.camera_math import extrinsic_to_mat, fov_to_focal, mat_to_extrinsic

WARNED_RESOLUTION = False


@dataclasses.dataclass
class Camera:
    uid: int
    colmap_id: int
    extrinsic_vector: np.ndarray  # (7,) f32 (qx,qy,qz,qw,tx,ty,tz) of W2C
    intrinsic: np.ndarray  # (3,3) f32: FoVx@[0,0], FoVy@[1,1], W@[0,2], H@[1,2]
    image_name: str
    image_path: Optional[str] = None
    flip_image: bool = False
    save_memory: bool = False
    white_background: bool = False
    _image: Optional[np.ndarray] = dataclasses.field(default=None, repr=False)

    @property
    def width(self) -> int:
        return int(self.intrinsic[0, 2])

    @property
    def height(self) -> int:
        return int(self.intrinsic[1, 2])

    @property
    def fovx(self) -> float:
        return float(self.intrinsic[0, 0])

    @property
    def fovy(self) -> float:
        return float(self.intrinsic[1, 1])

    def load_image(self) -> np.ndarray:
        """CHW float32 in [0,1], resized to the intrinsic's W,H
        (scene/cameras.py:67-92 incl. alpha premultiply + caching)."""
        if self._image is not None:
            if self.save_memory:
                img, self._image = self._image, None
                return img
            return self._image
        img = _read_image(self.image_path)
        if img.shape[2] == 4:
            # alpha-composite over the training background
            # (readCamerasFromTransforms in the reference blends onto
            # white for Blender scenes; cameras.py:70-75 premultiplies)
            bg = 1.0 if self.white_background else 0.0
            img = img[:, :, :3] * img[:, :, 3:4] + bg * (1.0 - img[:, :, 3:4])
        if self.flip_image:
            img = img[::-1, ::-1, :]
        img = _resize(img, self.width, self.height)
        img = np.clip(np.transpose(img, (2, 0, 1)), 0.0, 1.0).astype(np.float32)
        if not self.save_memory:
            self._image = img
        return img

    @property
    def original_image(self) -> np.ndarray:
        return self.load_image()


def _read_image(path) -> np.ndarray:
    """HWC float32 [0,1]. PNG/JPG via PIL (shipped with torch stacks)."""
    from PIL import Image

    with Image.open(path) as im:
        arr = np.asarray(im).astype(np.float32) / 255.0
    if arr.ndim == 2:
        arr = arr[:, :, None].repeat(3, axis=2)
    return arr


def _resize(img: np.ndarray, w: int, h: int) -> np.ndarray:
    if img.shape[1] == w and img.shape[0] == h:
        return img
    from PIL import Image

    im = Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8))
    out = np.asarray(im.resize((w, h), Image.BILINEAR)).astype(np.float32) / 255.0
    if out.ndim == 2:
        out = out[:, :, None].repeat(3, axis=2)
    return out


def make_intrinsic(fovx: float, fovy: float, width: int, height: int) -> np.ndarray:
    intr = np.zeros((3, 3), np.float32)
    intr[0, 0] = fovx
    intr[1, 1] = fovy
    intr[0, 2] = width
    intr[1, 2] = height
    intr[2, 2] = 1.0
    return intr


def resolve_resolution(
    orig_w: int, orig_h: int, resolution: int, resolution_scale: float = 1.0
):
    """The resolution ladder of utils/camera_utils.py:17-43: -1 means
    auto-downscale so width <= 1600; 1/2/4/8 divide."""
    global WARNED_RESOLUTION
    if resolution in (1, 2, 4, 8):
        return (
            round(orig_w / (resolution_scale * resolution)),
            round(orig_h / (resolution_scale * resolution)),
        )
    if resolution == -1:
        if orig_w > 1600:
            if not WARNED_RESOLUTION:
                print(
                    "[ INFO ] Encountered quite large input images (>1600 px "
                    "wide), rescaling to 1600 px width. Use --resolution 1 to "
                    "keep the original size."
                )
                WARNED_RESOLUTION = True
            scale = orig_w / 1600
        else:
            scale = 1.0
    else:
        scale = orig_w / resolution
    scale = resolution_scale * scale
    return round(orig_w / scale), round(orig_h / scale)


def camera_from_info(
    cam_info,
    uid: int,
    resolution: int = -1,
    resolution_scale: float = 1.0,
    white_background: bool = False,
) -> Camera:
    """Build a Camera from a reader CameraInfo, applying the resolution
    ladder (utils/camera_utils.py:17-43)."""
    w, h = resolve_resolution(cam_info.width, cam_info.height, resolution, resolution_scale)
    intr = make_intrinsic(cam_info.fovx, cam_info.fovy, w, h)
    w2c = np.eye(4, dtype=np.float64)
    w2c[:3, :3] = cam_info.R
    w2c[:3, 3] = cam_info.T
    ev = np.asarray(mat_to_extrinsic(w2c), np.float32)
    return Camera(
        uid=uid,
        colmap_id=cam_info.uid,
        extrinsic_vector=ev,
        intrinsic=intr,
        image_name=cam_info.image_name,
        image_path=cam_info.image_path,
        flip_image=getattr(cam_info, "flip_image", False),
        white_background=white_background,
    )


def camera_to_json(idx: int, cam: Camera) -> dict:
    """cameras.json entry (utils/camera_utils.py:47-68)."""
    w2c = extrinsic_to_mat(torch.as_tensor(cam.extrinsic_vector)).numpy().astype(np.float64)
    c2w = np.linalg.inv(w2c)
    pos = c2w[:3, 3]
    rot = c2w[:3, :3]
    return {
        "id": idx,
        "img_name": cam.image_name,
        "width": cam.width,
        "height": cam.height,
        "position": pos.tolist(),
        "rotation": [r.tolist() for r in rot],
        "fy": fov_to_focal(cam.fovy, cam.height),
        "fx": fov_to_focal(cam.fovx, cam.width),
    }
