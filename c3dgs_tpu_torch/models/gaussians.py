"""GaussianScene — the scene of the port (c3dgs_tpu/models/gaussians.py).

An nn.Module holding the pre-activation fields as nn.Parameters and the
`active` mask, the six fake-quant observers and, for a codebook-indexed
scene, the per-splat index arrays as buffers. Accessors apply fake-quant +
activation + index gather exactly like the JAX scene, so a scene carried
over with `scene_from_numpy` renders the same image, and autograd carries
the straight-through fake-quant gradients back to the parameters.

Per-splat rows (xyz, opacity, scaling_factor, active) have the capacity P.
The color table (features_dc, features_rest) and the shape table (scaling,
rotation) have P rows when dense and the codebook's rows when indexed
(feature_indices / gaussian_indices, int64, (P,)); a table's gradient is
then a deterministic segment sum over the splats that read each row
(ops/segment.py).

The JAX scene is immutable; here the operations that keep every shape
(update_observers, oneup_sh_degree, mask_splats) update the module in
place and return it. The others (to_indexed, to_unindexed, the set_*
methods, permute, compact, morton_sorted, pad_to_capacity) return a new
scene, which shares the tensors it does not change with this one, as the
JAX scene's `replace` does. Train on `clone()` to keep a scene as it is.
"""
from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch
from torch import nn

from .. import native
from ..device import DeviceLike, resolve_device
from ..ops import misc, quantize, quat, sh as sh_ops
from ..ops.quantize import ObserverState
from ..ops.segment import gather_rows
from ..spans import span

# observer order of the JAX QuantState
QUANT_FIELDS = (
    "features_dc",
    "features_rest",
    "opacity",
    "scaling",
    "scaling_factor",
    "rotation",
)
TENSOR_FIELDS = (
    "xyz",
    "opacity",
    "scaling_factor",
    "active",
    "features_dc",
    "features_rest",
    "scaling",
    "rotation",
    "feature_indices",
    "gaussian_indices",
)


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
        self.xyz = nn.Parameter(xyz)  # (P, 3)
        self.opacity = nn.Parameter(opacity)  # (P, 1) logit
        self.scaling_factor = (
            None if scaling_factor is None else nn.Parameter(scaling_factor)
        )  # (P, 1) log, or None
        self.features_dc = nn.Parameter(features_dc)  # (F, 1, 3)
        self.features_rest = nn.Parameter(features_rest)  # (F, K-1, 3)
        self.scaling = nn.Parameter(scaling)  # (G, 3)
        self.rotation = nn.Parameter(rotation)  # (G, 4)
        self.register_buffer("active", active.to(torch.bool))  # (P,)
        for name, idx in (("feature_indices", feature_indices), ("gaussian_indices", gaussian_indices)):
            self.register_buffer(name, None if idx is None else idx.to(torch.int64))  # (P,) or None
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

    def _replace(self, **fields) -> "GaussianScene":
        """A new scene with `fields` (tensors or the static settings)
        replaced; every other tensor is shared with this scene."""
        kw = {k: getattr(self, k) for k in TENSOR_FIELDS}
        kw = {k: None if v is None else v.detach() for k, v in kw.items()}
        kw.update(
            quant={name: self.observer(name) for name in QUANT_FIELDS},
            max_sh_degree=self.max_sh_degree,
            active_sh_degree=self.active_sh_degree,
            quantization=self.quantization,
            use_factor_scaling=self.use_factor_scaling,
        )
        kw.update(fields)
        return GaussianScene(**kw)

    @torch.no_grad()
    def clone(self) -> "GaussianScene":
        """A copy that shares no tensor with this scene."""
        return self._replace(**{k: None if getattr(self, k) is None else getattr(self, k).detach().clone()
                                for k in TENSOR_FIELDS})

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

    @property
    def is_color_indexed(self) -> bool:
        return self.feature_indices is not None

    @property
    def is_gaussian_indexed(self) -> bool:
        return self.gaussian_indices is not None

    def check_state(self) -> None:
        """Invariant asserts (gaussian_model.py:138-154)."""
        p = self.xyz.shape[0]
        for name in ("opacity", "active"):
            assert getattr(self, name).shape[0] == p, name
        if self.scaling_factor is not None:
            assert self.scaling_factor.shape[0] == p
        for idx, tables in ((self.gaussian_indices, ("scaling", "rotation")),
                            (self.feature_indices, ("features_dc", "features_rest"))):
            rows = {getattr(self, t).shape[0] for t in tables}
            assert len(rows) == 1, tables
            if idx is None:
                assert rows == {p}, tables
            else:
                assert idx.shape == (p,), tables
                assert p == 0 or (int(idx.min()) >= 0 and int(idx.max()) < rows.pop()), tables

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
        """(G,3) unit-norm non-negative direction, un-gathered."""
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
        if self.is_gaussian_indexed:
            s = gather_rows(s, self.gaussian_indices)
        if self.scaling_factor is None:
            return s
        return self.get_scaling_factor() * s

    def get_rotation_raw(self) -> torch.Tensor:
        """(G,4) normalized quats, un-gathered."""
        return quat.normalize(self._fq(self.rotation, "rotation"))

    def get_rotation(self) -> torch.Tensor:
        """(P,4) per-splat quats."""
        r = self.get_rotation_raw()
        return gather_rows(r, self.gaussian_indices) if self.is_gaussian_indexed else r

    def get_features_raw(self) -> torch.Tensor:
        """(F,K,3) fake-quantized SH table, un-gathered."""
        dc = self._fq(self.features_dc, "features_dc")
        rest = self._fq(self.features_rest, "features_rest")
        return torch.cat([dc, rest], dim=1)

    def get_features(self) -> torch.Tensor:
        """(P,K,3) per-splat SH coefficients."""
        f = self.get_features_raw()
        return gather_rows(f, self.feature_indices) if self.is_color_indexed else f

    def _gathered_shape(self):
        """(P,3) normalized scale and (P,4) quat of an indexed scene from one
        gather of the packed (G,7) rows."""
        packed = torch.cat([self.get_scaling_normalized(), self.get_rotation_raw()], 1)
        rows = gather_rows(packed, self.gaussian_indices)
        return rows[:, :3], rows[:, 3:]

    def get_covariance(self, scaling_modifier: float = 1.0) -> torch.Tensor:
        """(P,6) upper-triangle world covariance."""
        if self.is_gaussian_indexed:
            s, r = self._gathered_shape()
            if self.scaling_factor is not None:
                s = self.get_scaling_factor() * s
            return quat.cov6_from_scaling_rotation(scaling_modifier * s, r)
        return quat.cov6_from_scaling_rotation(
            scaling_modifier * self.get_scaling(), self.get_rotation()
        )

    def get_normalized_covariance(self, scaling_modifier: float = 1.0) -> torch.Tensor:
        """(P,6) covariance of the normalized scale (covariance VQ's input)."""
        if self.is_gaussian_indexed:
            s, r = self._gathered_shape()
            return quat.cov6_from_scaling_rotation(scaling_modifier * s, r)
        return quat.cov6_from_scaling_rotation(
            scaling_modifier * self.get_scaling_normalized(), self.get_rotation()
        )

    # ------------------------------------------------------------- observers
    @torch.no_grad()
    def update_observers(self) -> "GaussianScene":
        """One observer EMA step over every quantized attribute, observing
        the raw or activated fields (the tables as stored, codebook rows for
        an indexed scene) exactly as the JAX scene does; no-op without
        quantization."""
        if not self.quantization:
            return self
        with span("accessors"):
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
        """Deactivate rows (gaussian_model.py:1027, masked, not sliced), in
        place."""
        self.active &= keep
        return self

    @torch.no_grad()
    def to_indexed(self) -> "GaussianScene":
        """Identity indices for the tables not indexed yet
        (gaussian_model.py:902)."""
        if self.is_color_indexed and self.is_gaussian_indexed:
            return self
        ident = lambda: torch.arange(self.capacity, dtype=torch.int64, device=self.device)
        return self._replace(
            feature_indices=self.feature_indices if self.is_color_indexed else ident(),
            gaussian_indices=self.gaussian_indices if self.is_gaussian_indexed else ident(),
        )

    @torch.no_grad()
    def to_unindexed(self) -> "GaussianScene":
        """Gather the codebooks to dense rows (gaussian_model.py:889)."""
        if not self.is_color_indexed and not self.is_gaussian_indexed:
            return self
        kw = {}
        if self.is_color_indexed:
            fi = self.feature_indices
            kw.update(features_dc=self.features_dc[fi], features_rest=self.features_rest[fi], feature_indices=None)
        if self.is_gaussian_indexed:
            gi = self.gaussian_indices
            kw.update(scaling=self.scaling[gi], rotation=self.rotation[gi], gaussian_indices=None)
        return self._replace(**kw)

    @torch.no_grad()
    def set_color_indexed(self, features: torch.Tensor, indices: torch.Tensor) -> "GaussianScene":
        """(gaussian_model.py:1048) features: (C,K,3), indices: (P,)."""
        features = torch.as_tensor(features, dtype=torch.float32, device=self.device)
        return self._replace(
            features_dc=features[:, :1].contiguous(),
            features_rest=features[:, 1:].contiguous(),
            feature_indices=torch.as_tensor(indices, device=self.device).long(),
        )

    @torch.no_grad()
    def set_gaussian_indexed(self, rotation: torch.Tensor, scaling: torch.Tensor,
                             indices: torch.Tensor) -> "GaussianScene":
        """(gaussian_model.py:1054)."""
        dev = self.device
        return self._replace(
            rotation=torch.as_tensor(rotation, dtype=torch.float32, device=dev),
            scaling=torch.as_tensor(scaling, dtype=torch.float32, device=dev),
            gaussian_indices=torch.as_tensor(indices, device=dev).long(),
        )

    @torch.no_grad()
    def permute(self, order) -> "GaussianScene":
        """Reorder the per-splat rows (and the dense tables, or the index
        arrays of the indexed ones) by `order` (gaussian_model.py:997-1023)."""
        order = torch.as_tensor(order, device=self.device).long()
        kw = dict(xyz=self.xyz[order], opacity=self.opacity[order], active=self.active[order])
        if self.scaling_factor is not None:
            kw["scaling_factor"] = self.scaling_factor[order]
        if self.is_color_indexed:
            kw["feature_indices"] = self.feature_indices[order]
        else:
            kw.update(features_dc=self.features_dc[order], features_rest=self.features_rest[order])
        if self.is_gaussian_indexed:
            kw["gaussian_indices"] = self.gaussian_indices[order]
        else:
            kw.update(scaling=self.scaling[order], rotation=self.rotation[order])
        return self._replace(**kw)

    @torch.no_grad()
    def compact(self) -> "GaussianScene":
        """Drop inactive rows (capacity becomes num_active), and drop the
        codebook rows no splat reads, rebuilding the index arrays (the
        reference's calc_valid, gaussian_model.py:1104)."""
        keep = self.active.cpu().numpy()
        out = self.permute(np.nonzero(keep)[0])
        kw = dict(active=torch.ones(int(keep.sum()), dtype=torch.bool, device=self.device))
        for idx_name, tables in (("feature_indices", ("features_dc", "features_rest")),
                                 ("gaussian_indices", ("scaling", "rotation"))):
            idx = getattr(out, idx_name)
            if idx is not None:
                used, inv = np.unique(idx.cpu().numpy(), return_inverse=True)
                used = torch.as_tensor(used, device=self.device)
                kw.update({t: getattr(out, t)[used] for t in tables})
                kw[idx_name] = torch.as_tensor(inv.reshape(-1), dtype=torch.int64, device=self.device)
        return out._replace(**kw)

    @torch.no_grad()
    def pad_to_capacity(self, capacity: int) -> "GaussianScene":
        """A scene with `capacity` rows: these rows, then inactive padding
        (opacity logit(1e-4), scaling 1, scaling_factor -10, identity
        rotation, zero elsewhere). Dense scenes only."""
        if self.is_color_indexed or self.is_gaussian_indexed:
            raise ValueError("pad_to_capacity grows dense scenes only")
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
        return self._replace(
            xyz=pad(self.xyz),
            opacity=pad(self.opacity, float(misc.inverse_sigmoid(1e-4))),
            scaling_factor=None if self.scaling_factor is None else pad(self.scaling_factor, -10.0),
            active=pad(self.active, False),
            features_dc=pad(self.features_dc),
            features_rest=pad(self.features_rest),
            scaling=pad(self.scaling, 1.0),
            rotation=rotation,
        )

    @torch.no_grad()
    def morton_sorted(self) -> "GaussianScene":
        """Morton reorder of the active rows (the host codec's order);
        inactive rows go last."""
        active = self.active.cpu().numpy()
        order = native.morton_order(self.xyz.detach().cpu().numpy())
        order = np.concatenate([order[active[order]], order[~active[order]]])
        return self.permute(order)


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
    gaussian_indices (None for a dense scene; any integer dtype, held as
    int64). `quant` maps each observer name to its (min, max, initialized)
    triple."""
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
        feature_indices=t("feature_indices", torch.int64),
        gaussian_indices=t("gaussian_indices", torch.int64),
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
        pts = torch.as_tensor(points, dtype=torch.float32, device=dev)
        if n > misc.EXACT_KNN_MAX_POINTS:
            dist2 = misc.mean_knn_sq_dist_large(pts)
        else:
            dist2 = misc.mean_knn_sq_dist(pts)
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
