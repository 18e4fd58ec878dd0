"""Scene container: dataset autodetect, camera lists, checkpoint discovery
(port of c3dgs_tpu/data/scene.py; the Gaussian scene lives on `device`,
CUDA unless the caller names another).

Parity: scene/__init__.py — dataset autodetect (:48-55), cameras.json dump
(:62-71), shuffle (:73-75), cameras_extent (:77), checkpoint-iteration
discovery (:37-43) via searchForMaxIteration (utils/system_utils.py:26),
point_cloud.{ply,npz} glob load (:84-98), save (:100-102), getSomeCameras
preferring the test split (:110-114).
"""
from __future__ import annotations

import glob
import json
import os
import random
from typing import List, Optional

from ..device import DeviceLike, resolve_device
from ..models import gaussians as gmod
from ..models import io_npz, io_ply
from . import readers
from .cameras import Camera, camera_from_info, camera_to_json


def search_max_iteration(folder: str) -> int:
    """utils/system_utils.py:26."""
    saved = [int(fname.split("_")[-1]) for fname in os.listdir(folder)]
    return max(saved)


class Scene:
    def __init__(
        self,
        source_path: str,
        model_path: str,
        scene: Optional[gmod.GaussianScene] = None,
        load_iteration: Optional[int] = None,
        shuffle: bool = True,
        resolution: int = -1,
        resolution_scales=(1.0,),
        images_dir: str = "images",
        eval_split: bool = False,
        white_background: bool = False,
        max_sh_degree: int = 3,
        quantization: bool = True,
        capacity_multiplier: float = 4.0,
        save_memory: bool = True,
        device: DeviceLike = None,
    ):
        self.device = resolve_device(device)
        self.source_path = source_path
        self.model_path = model_path
        self.loaded_iter = None

        if load_iteration is not None:
            if load_iteration == -1:
                self.loaded_iter = search_max_iteration(
                    os.path.join(model_path, "point_cloud")
                )
            else:
                self.loaded_iter = load_iteration
            print(f"Loading trained model at iteration {self.loaded_iter}")

        scene_type = readers.detect_scene_type(source_path)
        if scene_type == "Colmap":
            info = readers.read_colmap_scene(
                source_path, images_dir, eval_split=eval_split
            )
        elif scene_type == "Blender":
            print("Found transforms_train.json file, assuming Blender data set!")
            # the background blends in at image load (cameras.Camera)
            info = readers.read_nerf_synthetic_scene(source_path, eval_split=True)
        else:
            print("Found transforms_dust3r.json file, assuming DUST3R data set!")
            info = readers.read_dust3r_scene(source_path)
        self.scene_info = info

        if not self.loaded_iter and model_path:
            os.makedirs(model_path, exist_ok=True)
            if info.ply_path and os.path.exists(info.ply_path):
                import shutil

                shutil.copyfile(info.ply_path, os.path.join(model_path, "input.ply"))
            cam_json = [
                camera_to_json(i, camera_from_info(c, i, resolution))
                for i, c in enumerate(info.train_cameras + info.test_cameras)
            ]
            with open(os.path.join(model_path, "cameras.json"), "w") as f:
                json.dump(cam_json, f)

        if shuffle:
            random.shuffle(info.train_cameras)
            random.shuffle(info.test_cameras)

        self.cameras_extent = info.nerf_normalization["radius"]

        self.train_cameras: List[Camera] = []
        self.test_cameras: List[Camera] = []
        for scale in resolution_scales:
            self.train_cameras = [
                camera_from_info(c, i, resolution, scale, white_background)
                for i, c in enumerate(info.train_cameras)
            ]
            self.test_cameras = [
                camera_from_info(c, i, resolution, scale, white_background)
                for i, c in enumerate(info.test_cameras)
            ]
        for c in self.train_cameras + self.test_cameras:
            c.save_memory = save_memory

        # model
        self.gaussians = scene
        if self.gaussians is None:
            if self.loaded_iter:
                folder = os.path.join(
                    model_path, "point_cloud", f"iteration_{self.loaded_iter}"
                )
                candidates = glob.glob(os.path.join(folder, "point_cloud.*"))
                assert candidates, f"no point_cloud.* in {folder}"
                self.gaussians = load_model_file(
                    candidates[0], max_sh_degree, quantization, device=self.device
                )
            elif info.point_cloud is not None:
                n = info.point_cloud.points.shape[0]
                cap = max(int(n * capacity_multiplier), n)
                self.gaussians = gmod.from_point_cloud(
                    info.point_cloud.points,
                    info.point_cloud.colors,
                    max_sh_degree=max_sh_degree,
                    capacity=cap,
                    quantization=quantization,
                    device=self.device,
                )

    def save(self, iteration: int) -> None:
        folder = os.path.join(
            self.model_path, "point_cloud", f"iteration_{iteration}"
        )
        io_ply.save_gaussians_ply(
            self.gaussians, os.path.join(folder, "point_cloud.ply")
        )

    def save_npz(self, iteration: int, **kw) -> None:
        folder = os.path.join(
            self.model_path, "point_cloud", f"iteration_{iteration}"
        )
        os.makedirs(folder, exist_ok=True)
        self.gaussians = io_npz.save_npz(
            self.gaussians, os.path.join(folder, "point_cloud.npz"), **kw
        )

    def get_train_cameras(self) -> List[Camera]:
        return self.train_cameras

    def get_test_cameras(self) -> List[Camera]:
        return self.test_cameras

    def get_some_cameras(self):
        """Prefer the test split (scene/__init__.py:110-114)."""
        if self.test_cameras:
            return self.test_cameras, "test"
        return self.train_cameras, "train"

    def __len__(self) -> int:
        return len(self.train_cameras)


def load_model_file(
    path: str, max_sh_degree: int = 3, quantization: bool = True, device: DeviceLike = None, **kw
) -> gmod.GaussianScene:
    """Load .ply or .npz (GaussianModel.load, gaussian_model.py:389-396)
    onto `device` (CUDA unless the caller names another)."""
    ext = os.path.splitext(path)[1]
    if ext == ".ply":
        return io_ply.load_gaussians_ply(
            path, max_sh_degree=max_sh_degree, quantization=quantization, device=device, **kw
        )
    if ext == ".npz":
        return io_npz.load_npz(path, max_sh_degree=max_sh_degree, device=device, **kw)
    raise NotImplementedError(f"file ending '{ext}' not supported")
