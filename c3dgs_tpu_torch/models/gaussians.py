"""GaussianScene — the dense scene of the port (c3dgs_tpu/models/gaussians.py).

An nn.Module holding the pre-activation fields as nn.Parameters and the
`active` mask plus the six fake-quant observers as buffers. Accessors apply
fake-quant + activation exactly like the JAX scene, so a scene carried over
with `scene_from_numpy` renders the same image, and autograd carries the
straight-through fake-quant gradients back to the parameters.

The JAX scene is immutable; here the operations that keep the capacity
(update_observers, oneup_sh_degree, mask_splats) update the module in
place and return it, and pad_to_capacity returns a new scene. Codebook-
indexed scenes (`to_indexed` and the index paths) come with the indexed
slice: a scene built with index arrays raises NotImplementedError.
"""
from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch
from torch import nn

from ..device import DeviceLike, resolve_device
from ..ops import misc, quantize, quat, sh as sh_ops
from ..ops.quantize import ObserverState

# observer order of the JAX QuantState
QUANT_FIELDS = (
    "features_dc",
    "features_rest",
    "opacity",
    "scaling",
    "scaling_factor",
    "rotation",
)

INDEXED_SLICE = "codebook-indexed scenes arrive with the port's indexed/compression slice"


class GaussianScene(nn.Module):
    """Capacity-padded Gaussian scene parameters (pre-activation)."""

    def __init__(
        self,
        xyz: torch.Tensor,
        opacity: torch.Tensor,
        scaling_factor: Optional[torch.Tensor],
        active: torch.Tensor,
        features_dc: torch.Tensor,
        features_rest: torch.Tensor,
        scaling: torch.Tensor,
        rotation: torch.Tensor,
        quant: Optional[Mapping[str, ObserverState]] = None,
        feature_indices: Optional[torch.Tensor] = None,
        gaussian_indices: Optional[torch.Tensor] = None,
        max_sh_degree: int = 3,
        active_sh_degree: int = 0,
        quantization: bool = True,
        use_factor_scaling: bool = True,
    ):
        super().__init__()
        if feature_indices is not None or gaussian_indices is not None:
            raise NotImplementedError(INDEXED_SLICE)
        self.xyz = nn.Parameter(xyz)  # (P, 3)
        self.opacity = nn.Parameter(opacity)  # (P, 1) logit
        self.scaling_factor = (
            None if scaling_factor is None else nn.Parameter(scaling_factor)
        )  # (P, 1) log, or None
        self.features_dc = nn.Parameter(features_dc)  # (P, 1, 3)
        self.features_rest = nn.Parameter(features_rest)  # (P, K-1, 3)
        self.scaling = nn.Parameter(scaling)  # (P, 3)
        self.rotation = nn.Parameter(rotation)  # (P, 4)
        self.register_buffer("active", active.to(torch.bool))  # (P,)
        for name in QUANT_FIELDS:
            obs = (quant or {}).get(name) or quantize.init_observer(device=xyz.device)
            self.register_buffer(
                f"quant_{name}",
                torch.stack([torch.as_tensor(v, dtype=torch.float32) for v in obs]).to(xyz.device),
            )
        self.max_sh_degree = max_sh_degree
        self.active_sh_degree = active_sh_degree
        self.quantization = quantization
        self.use_factor_scaling = use_factor_scaling

    # ---------------------------------------------------------------- basics
    @property
    def capacity(self) -> int:
        return self.xyz.shape[0]

    @property
    def device(self) -> torch.device:
        return self.xyz.device

    @property
    def num_active(self) -> torch.Tensor:
        return self.active.sum()

    def check_state(self) -> None:
        """Invariant asserts (gaussian_model.py:138-154)."""
        p = self.xyz.shape[0]
        for name in ("opacity", "active", "rotation", "scaling", "features_dc", "features_rest"):
            assert getattr(self, name).shape[0] == p, name
        if self.scaling_factor is not None:
            assert self.scaling_factor.shape[0] == p

    def observer(self, name: str) -> ObserverState:
        v = getattr(self, f"quant_{name}")
        return ObserverState(v[0], v[1], v[2])

    # ----------------------------------------------------------- activations
    def _fq(self, x: torch.Tensor, name: str) -> torch.Tensor:
        return quantize.fake_quant(x, self.observer(name)) if self.quantization else x

    def get_xyz(self) -> torch.Tensor:
        """(P,3); fp16 fake-quant when QAT is on."""
        return quantize.fake_quant_half(self.xyz) if self.quantization else self.xyz

    def get_opacity(self) -> torch.Tensor:
        """(P,1) in [0,1]; 0 for inactive rows."""
        op = self._fq(torch.sigmoid(self.opacity), "opacity")
        return torch.where(self.active[:, None], op, torch.zeros_like(op))

    def get_scaling_normalized(self) -> torch.Tensor:
        """(P,3) unit-norm non-negative direction."""
        s = quat.normalize(torch.relu(self.scaling))
        return self._fq(s, "scaling")

    def get_scaling_factor(self) -> torch.Tensor:
        """(P,1) positive scalar."""
        if self.scaling_factor is None:
            return torch.ones((self.capacity, 1), dtype=self.xyz.dtype, device=self.device)
        return torch.exp(self._fq(self.scaling_factor, "scaling_factor"))

    def get_scaling(self) -> torch.Tensor:
        """(P,3) actual per-splat scale."""
        s = self.get_scaling_normalized()
        if self.scaling_factor is None:
            return s
        return self.get_scaling_factor() * s

    def get_rotation_raw(self) -> torch.Tensor:
        """(P,4) normalized quats."""
        return quat.normalize(self._fq(self.rotation, "rotation"))

    def get_rotation(self) -> torch.Tensor:
        return self.get_rotation_raw()

    def get_features_raw(self) -> torch.Tensor:
        """(P,K,3) fake-quantized SH table."""
        dc = self._fq(self.features_dc, "features_dc")
        rest = self._fq(self.features_rest, "features_rest")
        return torch.cat([dc, rest], dim=1)

    def get_features(self) -> torch.Tensor:
        return self.get_features_raw()

    def get_covariance(self, scaling_modifier: float = 1.0) -> torch.Tensor:
        """(P,6) upper-triangle world covariance."""
        return quat.cov6_from_scaling_rotation(
            scaling_modifier * self.get_scaling(), self.get_rotation()
        )

    def get_normalized_covariance(self, scaling_modifier: float = 1.0) -> torch.Tensor:
        """(P,6) covariance of the normalized scale."""
        return quat.cov6_from_scaling_rotation(
            scaling_modifier * self.get_scaling_normalized(), self.get_rotation()
        )

    # ------------------------------------------------------------- observers
    @torch.no_grad()
    def update_observers(self) -> "GaussianScene":
        """One observer EMA step over every quantized attribute, observing
        the raw or activated fields exactly as the JAX scene does; no-op
        without quantization."""
        if not self.quantization:
            return self
        seen = {
            "features_dc": self.features_dc,
            "features_rest": self.features_rest,
            "opacity": torch.sigmoid(self.opacity),
            "scaling": quat.normalize(torch.relu(self.scaling)),
            "scaling_factor": self.scaling_factor,
            "rotation": self.rotation,
        }
        for name, x in seen.items():
            if x is not None:
                getattr(self, f"quant_{name}").copy_(torch.stack(quantize.observe(self.observer(name), x)))
        return self

    # --------------------------------------------------------- reorg / modes
    def oneup_sh_degree(self) -> "GaussianScene":
        if self.active_sh_degree < self.max_sh_degree:
            self.active_sh_degree += 1
        return self

    @torch.no_grad()
    def mask_splats(self, keep: torch.Tensor) -> "GaussianScene":
        """Deactivate rows (gaussian_model.py:1027, masked, not sliced)."""
        self.active &= keep
        return self

    @torch.no_grad()
    def pad_to_capacity(self, capacity: int) -> "GaussianScene":
        """A scene with `capacity` rows: these rows, then inactive padding
        (opacity logit(1e-4), scaling 1, scaling_factor -10, identity
        rotation, zero elsewhere)."""
        cur = self.capacity
        if capacity < cur:
            raise ValueError(f"capacity {capacity} is below the current {cur}")
        if capacity == cur:
            return self
        extra = capacity - cur

        def pad(x, fill=0.0):
            return torch.cat([x.detach(), torch.full((extra, *x.shape[1:]), fill, dtype=x.dtype, device=x.device)])

        rotation = pad(self.rotation)
        rotation[cur:, 0] = 1.0
        return GaussianScene(
            xyz=pad(self.xyz),
            opacity=pad(self.opacity, float(misc.inverse_sigmoid(1e-4))),
            scaling_factor=None if self.scaling_factor is None else pad(self.scaling_factor, -10.0),
            active=pad(self.active, False),
            features_dc=pad(self.features_dc),
            features_rest=pad(self.features_rest),
            scaling=pad(self.scaling, 1.0),
            rotation=rotation,
            quant={name: self.observer(name) for name in QUANT_FIELDS},
            max_sh_degree=self.max_sh_degree,
            active_sh_degree=self.active_sh_degree,
            quantization=self.quantization,
            use_factor_scaling=self.use_factor_scaling,
        )


# --------------------------------------------------------------- constructors
def scene_from_numpy(
    params: Mapping[str, Optional[np.ndarray]],
    *,
    max_sh_degree: int,
    active_sh_degree: int,
    quantization: bool,
    use_factor_scaling: bool,
    quant: Optional[Mapping[str, tuple]] = None,
    device: DeviceLike = None,
) -> GaussianScene:
    """Build the port's scene from a JAX GaussianScene's leaves as numpy
    arrays: xyz, opacity, scaling_factor, active, features_dc,
    features_rest, scaling, rotation, and feature_indices /
    gaussian_indices (None for a dense scene). `quant` maps each observer
    name to its (min, max, initialized) triple."""
    dev = resolve_device(device)

    def t(name, dtype=torch.float32):
        v = params.get(name)
        return None if v is None else torch.tensor(np.asarray(v), dtype=dtype, device=dev)

    obs = None
    if quant is not None:
        obs = {
            k: ObserverState(*(torch.tensor(np.asarray(x), dtype=torch.float32, device=dev) for x in v))
            for k, v in quant.items()
        }
    return GaussianScene(
        xyz=t("xyz"),
        opacity=t("opacity"),
        scaling_factor=t("scaling_factor"),
        active=t("active", torch.bool),
        features_dc=t("features_dc"),
        features_rest=t("features_rest"),
        scaling=t("scaling"),
        rotation=t("rotation"),
        quant=obs,
        feature_indices=t("feature_indices", torch.int32),
        gaussian_indices=t("gaussian_indices", torch.int32),
        max_sh_degree=max_sh_degree,
        active_sh_degree=active_sh_degree,
        quantization=quantization,
        use_factor_scaling=use_factor_scaling,
    )


def from_point_cloud(
    points: np.ndarray,
    colors: Optional[np.ndarray] = None,
    max_sh_degree: int = 3,
    capacity: Optional[int] = None,
    quantization: bool = True,
    use_factor_scaling: bool = True,
    initial_opacity: float = 0.1,
    knn_scale_init: bool = True,
    device: DeviceLike = None,
) -> GaussianScene:
    """Initialize from a sparse point cloud: SH-DC from RGB, opacity
    logit(initial_opacity), scale from sqrt(mean 3-NN squared distance),
    identity rotations; rows past the cloud are inactive padding."""
    dev = resolve_device(device)
    n = points.shape[0]
    cap = capacity or n
    if cap < n:
        raise ValueError(f"capacity {cap} is below the point count {n}")
    k = (max_sh_degree + 1) ** 2

    xyz = np.zeros((cap, 3), np.float32)
    xyz[:n] = points
    features_dc = np.zeros((cap, 1, 3), np.float32)
    if colors is not None:
        features_dc[:n, 0] = sh_ops.rgb_to_sh_dc(colors.astype(np.float32))
    features_rest = np.zeros((cap, k - 1, 3), np.float32)
    opacity = np.full((cap, 1), float(misc.inverse_sigmoid(initial_opacity)), np.float32)

    if knn_scale_init and n > 3:
        if n > misc.EXACT_KNN_MAX_POINTS:
            raise NotImplementedError(
                f"kNN scale init above {misc.EXACT_KNN_MAX_POINTS} points needs the "
                "Morton-window kNN, which arrives with a later slice"
            )
        dist2 = misc.mean_knn_sq_dist(torch.as_tensor(points, dtype=torch.float32, device=dev))
        dist2 = np.maximum(dist2.cpu().numpy(), 1e-7)
        log_scale = 0.5 * np.log(dist2)
    else:
        log_scale = np.zeros(n, np.float32)
    scales = np.zeros((cap, 3), np.float32)
    scales[:n] = log_scale[:, None]

    rotation = np.zeros((cap, 4), np.float32)
    rotation[:, 0] = 1.0
    active = np.zeros(cap, bool)
    active[:n] = True

    if use_factor_scaling:
        lin = np.exp(scales)
        norm = np.maximum(np.linalg.norm(lin, axis=1, keepdims=True), 1e-12)
        scaling = (lin / norm).astype(np.float32)
        scaling_factor = np.log(norm).astype(np.float32)
    else:
        scaling = scales
        scaling_factor = None

    return scene_from_numpy(
        dict(
            xyz=xyz,
            opacity=opacity,
            scaling_factor=scaling_factor,
            active=active,
            features_dc=features_dc,
            features_rest=features_rest,
            scaling=scaling,
            rotation=rotation,
        ),
        max_sh_degree=max_sh_degree,
        active_sh_degree=0,
        quantization=quantization,
        use_factor_scaling=use_factor_scaling,
        device=dev,
    )
