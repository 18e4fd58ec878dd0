"""The system under test, `c3dgs_tpu_torch`, as the benchmark drives it: the
scene built from the benchmark's inputs, the training step of
`cli/train.py` (`trainer.train_step`, its counters read on the host and fed
to the port's `CapacityPolicy`) and the served view of `render.py`
(`eval/metrics.render_full` at `inference=True` settings). The only module
of the benchmark that imports the program.
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
from torch.profiler import record_function

from c3dgs_tpu_torch.config import OptimizationParams
from c3dgs_tpu_torch.eval import metrics as port_metrics
from c3dgs_tpu_torch.models.gaussians import GaussianScene
from c3dgs_tpu_torch.render.capacity import CapacityPolicy
from c3dgs_tpu_torch.render.types import settings_from_intrinsic
from c3dgs_tpu_torch.train import trainer

OPT_KEYS = ("position_lr_init", "position_lr_final", "position_lr_delay_mult", "position_lr_max_steps",
            "feature_lr", "opacity_lr", "scaling_lr", "rotation_lr", "lambda_dssim")
COUNTERS = ("num_instances", "overflow", "grad_total", "grad_overflow")


def build_scene(p: Dict[str, torch.Tensor], cfg: dict) -> GaussianScene:
    """The scene as training (dense) or c3dgs's compression (tables and
    indices, as `set_color_indexed` / `set_gaussian_indexed` leave it)
    hands it over, SH degree 3 active. Shares the input tensors."""
    sc = cfg["scene"]
    n = p["xyz"].shape[0]
    deg = int(sc["sh_degree"])
    return GaussianScene(
        xyz=p["xyz"], opacity=p["opacity"], scaling_factor=p["scaling_factor"],
        active=torch.ones(n, dtype=torch.bool, device=p["xyz"].device),
        features_dc=p["features_dc"], features_rest=p["features_rest"],
        scaling=p["scaling"], rotation=p["rotation"],
        feature_indices=p.get("feature_indices"), gaussian_indices=p.get("gaussian_indices"),
        max_sh_degree=deg, active_sh_degree=deg, quantization=bool(sc["quantization"]), use_factor_scaling=True,
    )


class Trainer:
    """One training run: the train state, one capacity policy, the settings
    of the configuration's camera."""

    def __init__(self, scene: GaussianScene, cfg: dict, cams: dict, first_step: int, seed: int, device):
        self.device = torch.device(device)
        self.opt = OptimizationParams(**{k: cfg["train"][k] for k in OPT_KEYS})
        self.extent = cams["extent"]
        self.state = trainer.create_train_state(scene, self.opt, self.extent, seed=seed, device=self.device)
        self.state.opt_state.step = first_step  # the LR schedule's step, as a resumed run has it
        self.settings = settings_from_intrinsic(np.asarray(cams["intrinsic"], dtype=np.float64),
                                                fast_grad=bool(cfg["render"]["fast_grad"]))
        self.bg = torch.tensor(cfg["render"]["background"], dtype=torch.float32, device=self.device)
        self.policy = None

    def probe(self, ev) -> None:
        """One render seeds the capacity policy, as train/finetune.py does:
        twice its instances (at least 2^18 slots) and twice its grad_total."""
        with torch.no_grad():
            out = trainer.render_scene(self.state.scene, ev, self.settings, self.bg, device=self.device)
        self.policy = CapacityPolicy(initial=max(int(out["num_instances"]) * 2, 1 << 18),
                                     grad_initial=int(out["grad_total"]) * 2)

    def step(self, ev, gt) -> dict:
        """One train_step and the host's read of its counters; the policy
        follows the frame. Returns the counters, the loss and `failed`."""
        with record_function("bench.train_step"):
            self.state, m = trainer.train_step(self.state, ev, gt, self.policy.apply(self.settings), self.bg,
                                               self.opt, self.extent, device=self.device)
        with record_function("bench.read"):
            c = dict(zip(COUNTERS, torch.stack([m[k].to(torch.int64) for k in COUNTERS]).tolist()))
            loss = float(m["loss"])
        with record_function("bench.policy"):
            self.policy.update(c["num_instances"], c["overflow"], c["grad_total"], c["grad_overflow"])
        c["loss"] = loss
        # a frame that overflowed or was clamped at the slot domain trained
        # on a part of itself (train_step does not report `clipped`)
        c["failed"] = bool(c["overflow"] or c["grad_overflow"] or self.policy.clamped or not math.isfinite(loss))
        return c

    def first_grad_norms(self) -> Dict[str, float]:
        """Each field's first gradient as Adam holds it after one step from
        zero moments: mu / (1 - b1)."""
        st = self.state.opt_state
        if st.count != 1:
            raise RuntimeError(f"first gradient read after {st.count} steps")
        return {k: float(torch.linalg.vector_norm(v.double())) / (1.0 - trainer.ADAM_B1) for k, v in st.mu.items()}

    def params(self) -> Dict[str, torch.Tensor]:
        return {k: v.detach() for k, v in trainer.scene_params(self.state.scene).items()}


class Viewer:
    """One viewer: the scene, the serving settings and one capacity policy."""

    def __init__(self, scene: GaussianScene, cfg: dict, cams: dict, device):
        self.device = torch.device(device)
        self.scene = scene.update_observers()  # the int8 ranges of the scene as served
        self.settings = settings_from_intrinsic(np.asarray(cams["intrinsic"], dtype=np.float64), inference=True,
                                                fast_grad=bool(cfg["render"]["fast_grad"]))
        self.bg = torch.tensor(cfg["render"]["background"], dtype=torch.float32, device=self.device)
        self.policy = CapacityPolicy()

    def view(self, ev) -> dict:
        """One served view through render_full. Returns its image, its
        counters and `failed`: a frame clamped at the slot domain (which
        raises in render_full) or one that dropped tiles past the
        binning's per-splat cap (`clipped`)."""
        with record_function("bench.render_full"):
            try:
                out = port_metrics.render_full(self.scene, ev, self.settings, self.bg, self.policy,
                                               device=self.device)
            except RuntimeError as e:
                if "overflows the binning's slot domain" not in str(e):
                    raise
                return dict(image=None, num_instances=None, clipped=None, renders=0, failed=True)
        clipped = int(out["clipped"])
        return dict(image=out["render"], num_instances=int(out["num_instances"]), clipped=clipped,
                    renders=int(out["renders"]), failed=clipped > 0)
