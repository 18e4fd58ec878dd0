"""The system under test as the pose cells drive it: pose recovery against a
frozen, served scene, as `cli/train_camera.py` runs it
(`train/camera_opt.camera_step`, each step's counters read on the host
and fed to the port's `CapacityPolicy` through `camera_opt.feed_policy`,
the path of `optimize_camera` given a policy), and the query images
rendered through the served path (`eval/metrics.render_full` at
`inference=True` settings). With `benchmark/program.py`, the only modules
of the benchmark that import the program.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch.profiler import record_function

from c3dgs_tpu_torch.eval import metrics as port_metrics
from c3dgs_tpu_torch.models.gaussians import GaussianScene
from c3dgs_tpu_torch.render.capacity import CapacityPolicy
from c3dgs_tpu_torch.render.types import settings_from_intrinsic
from c3dgs_tpu_torch.train import camera_opt, trainer
from c3dgs_tpu_torch.train.camera_opt import feed_policy


class Localiser:
    """One localiser: the map as served (its int8 ranges set once), the
    pose step's settings, one capacity policy for its steps and one for
    the query renders."""

    def __init__(self, scene: GaussianScene, cfg: dict, cams: dict, lr: float, device):
        self.device = torch.device(device)
        self.scene = scene.update_observers()
        intrinsic = np.asarray(cams["intrinsic"], dtype=np.float64)
        fast = bool(cfg["render"]["fast_grad"])
        self.settings = settings_from_intrinsic(intrinsic, fast_grad=fast)
        self.serving = settings_from_intrinsic(intrinsic, inference=True, fast_grad=fast)
        self.bg = torch.tensor(cfg["render"]["background"], dtype=torch.float32, device=self.device)
        self.lr = float(lr)
        self.view_policy = CapacityPolicy()
        self.policy = None
        self.ev = self.adam = None
        self.steps = 0

    def query_image(self, ev) -> tuple:
        """The query's image, served at its true pose, and its instances;
        raises if the frame is clamped at the slot domain."""
        with torch.no_grad():
            out = port_metrics.render_full(self.scene, ev, self.serving, self.bg, self.view_policy,
                                           device=self.device)
        return out["render"], int(out["num_instances"])

    def seed_policy(self, instances: int) -> None:
        """The steps' policy at the bucket it would grow to on a frame of
        `instances` (the policy's own headroom over them)."""
        self.policy = CapacityPolicy(initial=int(instances * CapacityPolicy().headroom))

    def start(self, ev0) -> None:
        """A query's start: its 7-vector and fresh Adam moments."""
        self.ev = torch.as_tensor(ev0, dtype=torch.float32, device=self.device).detach().clone()
        self.adam = trainer.adam_init({"ev": self.ev})

    def step(self, gt) -> dict:
        """One camera_step and the host's read of its counters; the policy
        follows the frame. Returns the counters, the loss and `failed`: a
        frame that overflowed a bucket, was clamped at the slot domain or
        dropped tiles past the per-splat cap stepped on a part of itself."""
        with record_function("bench.pose_step"):
            self.ev, self.adam, m = camera_opt.camera_step(self.scene, self.ev, self.adam, gt,
                                                           self.policy.apply(self.settings), self.bg, self.lr)
        with record_function("bench.read"):
            c = feed_policy(self.policy, m, f"pose step {self.steps}")
            loss = float(m["loss"])
        self.steps += 1
        c["loss"] = loss
        c["failed"] = bool(c["overflow"] or c["grad_overflow"] or c["clipped"] or self.policy.clamped
                           or not math.isfinite(loss))
        return c

    def moment(self) -> torch.Tensor:
        """Adam's first moment of the 7-vector, a float64 copy."""
        return self.adam.mu["ev"].detach().double().clone()

    def step_grad(self, before: torch.Tensor) -> torch.Tensor:
        """The last step's 7-vector gradient as Adam's first moment holds
        it, given the moment before the step (`moment()`):
        (mu - b1 before) / (1 - b1), in float64."""
        return (self.moment() - trainer.ADAM_B1 * before) / (1.0 - trainer.ADAM_B1)
