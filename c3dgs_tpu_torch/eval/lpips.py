"""LPIPS perceptual metric (port of c3dgs_tpu/eval/lpips.py; the
reference's lpipsPyTorch/ modules/lpips.py:8-36, modules/networks.py:12-20:
VGG16 or AlexNet feature taps, per-layer 1x1 linear heads on
unit-normalized activations, the ImageNet scaling layer).

The pretrained weights are not in the repository. LPIPS(weights_npz)
computes the metric from a weights file in the JAX package's key layout
(conv{i}/kernel|bias, lin{i}/kernel), which `convert_torch_weights` writes
on a machine that has torchvision and network access; without one it
raises, and callers gate on `available()`. A file converted for either
package serves the other once copied to its default path.

The convolutions run in full fp32: cuDNN's default on the card is TF32.
"""
from __future__ import annotations

import contextlib
import os
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..device import DeviceLike, resolve_device

# VGG16 feature-extractor structure: (out_channels, n_convs) per block;
# LPIPS taps activations after the ReLU of each block (networks.py VGG16
# slices at indices 4, 9, 16, 23, 30).
VGG_BLOCKS = [(64, 2), (128, 2), (256, 3), (512, 3), (512, 3)]

# AlexNet feature extractor (networks.py:12-20 AlexNet slices at indices
# 1, 4, 7, 9, 11 of torchvision alexnet.features): per conv
# (out_channels, kernel, stride, padding, maxpool_after_tap); LPIPS taps
# after every ReLU, and maxpool(3, stride 2) sits between taps 1-2 and 2-3.
ALEX_CONVS = [
    (64, 11, 4, 2, True),
    (192, 5, 1, 2, True),
    (384, 3, 1, 1, False),
    (256, 3, 1, 1, False),
    (256, 3, 1, 1, False),
]

# the scaling layer of lpipsPyTorch (modules/lpips.py): shift/scale on
# [-1, 1]-scaled inputs
SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
SCALE = np.array([0.458, 0.448, 0.450], np.float32)

_WEIGHTS_DIR = os.path.join(os.path.dirname(__file__), "weights")

# machine-readable reason written next to every null LPIPS in results.json
# and per_view.json (the reference always reports LPIPS, metrics.py:72-79;
# only its pretrained weights need a download)
UNAVAILABLE_REASON = "weights unavailable (zero egress)"


def default_weights(net_type: str = "vgg") -> str:
    return os.path.join(_WEIGHTS_DIR, f"lpips_{net_type}.npz")


def available(weights_npz: Optional[str] = None, net_type: str = "vgg") -> bool:
    return os.path.exists(weights_npz or default_weights(net_type))


def unavailable_hint(net_type: str = "vgg") -> str:
    """One-line instruction for enabling LPIPS."""
    return (
        f"LPIPS ({net_type}) skipped: {UNAVAILABLE_REASON}. Enable it by "
        "running, on a machine with network access, "
        f"c3dgs_tpu_torch.eval.lpips.convert_torch_weights(net_type={net_type!r}) "
        f"and copying the npz to {default_weights(net_type)}"
    )


def convert_torch_weights(out_npz: Optional[str] = None, net_type: str = "vgg") -> None:
    """One-time conversion: torchvision VGG16/AlexNet + the LPIPS linear
    heads -> npz. Requires torchvision and network access. net_type:
    'vgg' | 'alex' (networks.py:12-20; the reference's SqueezeNet variant
    is not ported)."""
    import torchvision

    out_npz = out_npz or default_weights(net_type)
    if net_type == "vgg":
        feats = torchvision.models.vgg16(weights="IMAGENET1K_V1").features
    elif net_type == "alex":
        feats = torchvision.models.alexnet(weights="IMAGENET1K_V1").features
    else:
        raise ValueError(f"unsupported net_type {net_type!r}")
    state: Dict[str, np.ndarray] = {}
    conv_idx = 0
    for layer in feats:
        if isinstance(layer, torch.nn.Conv2d):
            state[f"conv{conv_idx}/kernel"] = layer.weight.detach().numpy()
            state[f"conv{conv_idx}/bias"] = layer.bias.detach().numpy()
            conv_idx += 1
    url = (
        "https://raw.githubusercontent.com/richzhang/PerceptualSimilarity/"
        f"master/lpips/weights/v0.1/{net_type}.pth"
    )
    lin = torch.hub.load_state_dict_from_url(url, progress=False)
    for i in range(5):
        state[f"lin{i}/kernel"] = lin[f"lin{i}.model.1.weight"].numpy()
    os.makedirs(os.path.dirname(out_npz), exist_ok=True)
    np.savez(out_npz, **state)


@contextlib.contextmanager
def ieee_fp32_convs():
    """cuDNN convolutions in full fp32 inside the block."""
    c = torch.backends.cudnn.conv
    prev = c.fp32_precision
    c.fp32_precision = "ieee"
    try:
        yield
    finally:
        c.fp32_precision = prev


def _scaling_layer(x: torch.Tensor) -> torch.Tensor:
    # the reference scales to [-1, 1], then normalizes (ScalingLayer)
    shift = torch.as_tensor(SHIFT, device=x.device)[None, :, None, None]
    scale = torch.as_tensor(SCALE, device=x.device)[None, :, None, None]
    return (x * 2.0 - 1.0 - shift) / scale


def _vgg_features(params, x: torch.Tensor) -> List[torch.Tensor]:
    """x: (B, 3, H, W) in [0, 1]. The 5 tapped activations."""
    h = _scaling_layer(x)
    feats = []
    conv_idx = 0
    for block, (_, n_convs) in enumerate(VGG_BLOCKS):
        for _ in range(n_convs):
            h = F.relu(F.conv2d(h, params[f"conv{conv_idx}/kernel"], params[f"conv{conv_idx}/bias"], padding=1))
            conv_idx += 1
        feats.append(h)
        if block < len(VGG_BLOCKS) - 1:
            h = F.max_pool2d(h, 2, 2)
    return feats


def _alex_features(params, x: torch.Tensor) -> List[torch.Tensor]:
    """AlexNet taps (networks.py AlexNet slices): after each of the 5
    ReLUs, maxpool(3, stride 2) after taps 1 and 2."""
    h = _scaling_layer(x)
    feats = []
    for i, (_, _, stride, pad, pool_after) in enumerate(ALEX_CONVS):
        h = F.relu(F.conv2d(h, params[f"conv{i}/kernel"], params[f"conv{i}/bias"], stride=stride, padding=pad))
        feats.append(h)
        if pool_after:
            h = F.max_pool2d(h, 3, 2)
    return feats


_FEATURES = {"vgg": _vgg_features, "alex": _alex_features}


def _unit_normalize(f: torch.Tensor) -> torch.Tensor:
    return f * torch.rsqrt(torch.sum(f * f, dim=1, keepdim=True) + 1e-10)


class LPIPS:
    """Callable LPIPS(img1, img2) on CHW or BCHW images in [0, 1], on
    `device` (CUDA unless the caller names another; the images are moved
    there). net_type: 'vgg' (the reference's quality-protocol backbone)
    or 'alex' (networks.py:12-20)."""

    def __init__(self, weights_npz: Optional[str] = None, net_type: str = "vgg", device: DeviceLike = None):
        path = weights_npz or default_weights(net_type)
        if net_type not in _FEATURES:
            raise ValueError(f"unsupported net_type {net_type!r}")
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"LPIPS weights not found at {path}; run "
                "c3dgs_tpu_torch.eval.lpips.convert_torch_weights(net_type="
                f"{net_type!r}) on a machine with torchvision + network access."
            )
        self.device = resolve_device(device)
        with np.load(path) as data:
            self.params = {k: torch.as_tensor(data[k], device=self.device) for k in data.files}
        self._features = _FEATURES[net_type]

    @torch.no_grad()
    def __call__(self, img1, img2) -> torch.Tensor:
        x = torch.as_tensor(img1, dtype=torch.float32, device=self.device)
        y = torch.as_tensor(img2, dtype=torch.float32, device=self.device)
        if x.ndim == 3:
            x, y = x[None], y[None]
        with ieee_fp32_convs():
            fx, fy = self._features(self.params, x), self._features(self.params, y)
        total = 0.0
        for i, (a, b) in enumerate(zip(fx, fy)):
            d = (_unit_normalize(a) - _unit_normalize(b)) ** 2
            w = self.params[f"lin{i}/kernel"].reshape(-1)
            total = total + torch.sum(d * w[None, :, None, None], dim=1).mean(dim=(1, 2))
        return total.mean()
