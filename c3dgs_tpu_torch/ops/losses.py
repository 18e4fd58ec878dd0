"""Losses and image metrics: L1/L2, windowed SSIM, PSNR and the training
objective (port of c3dgs_tpu/ops/losses.py).

Images are CHW float tensors in [0,1], optionally with a leading batch axis.
"""
from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..spans import span


def abs_like_jax(x: torch.Tensor) -> torch.Tensor:
    """|x| whose derivative at 0 is 1, as jnp.abs's is; torch.abs's is 0.
    Where a residual is exactly 0 (a pose at its anchor, a pixel equal to
    its target) the two conventions give different gradients."""
    return torch.where(x >= 0, x, -x)


def l1_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return abs_like_jax(pred - target).mean()


def l2_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return ((pred - target) ** 2).mean()


def mse(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Per-image MSE, (B, 1)."""
    diff = (pred - target) ** 2
    return diff.reshape(diff.shape[0], -1).mean(1, keepdim=True)


def psnr(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """PSNR in dB per image, (B, 1); inputs CHW or BCHW."""
    if pred.ndim == 3:
        pred, target = pred[None], target[None]
    return 20.0 * torch.log10(1.0 / torch.sqrt(mse(pred, target)))


@functools.lru_cache(maxsize=4)
def _gaussian_window(window_size: int, sigma: float) -> np.ndarray:
    xs = np.arange(window_size, dtype=np.float64)
    gauss = np.exp(-((xs - window_size // 2) ** 2) / (2.0 * sigma**2))
    gauss = gauss / gauss.sum()
    return np.outer(gauss, gauss).astype(np.float32)


def _conv_fp32(img: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Depthwise 'same' correlation with cuDNN switched off, which sends it
    to PyTorch's own fp32 kernel on the card (cuDNN runs fp32
    convolutions in TF32 by default)."""
    with torch.backends.cudnn.flags(enabled=False):
        return F.conv2d(img, kernel, padding=kernel.shape[-1] // 2, groups=img.shape[1])


class _DepthwiseConvSame(torch.autograd.Function):
    """The forward AND its input gradient in full fp32. Autograd would run
    conv2d's backward later, outside any flags context, under whatever the
    global cuDNN flags say (TF32 allowed by default); this backward is the
    'same' correlation of the cotangent with the flipped window, under the
    same flags as the forward."""

    @staticmethod
    def forward(ctx, img, kernel):
        ctx.save_for_backward(kernel)
        return _conv_fp32(img, kernel)

    @staticmethod
    def backward(ctx, grad_out):
        (kernel,) = ctx.saved_tensors
        with span("loss"):
            return _conv_fp32(grad_out.contiguous(), torch.flip(kernel, (-2, -1))), None


def _depthwise_conv_same(img: torch.Tensor, window: torch.Tensor) -> torch.Tensor:
    """Per-channel 2D conv with zero 'same' padding. img: [B, C, H, W].

    Full fp32 is required in both directions: SSIM's variance terms
    (conv(img^2) - mu^2) cancel catastrophically."""
    c = img.shape[1]
    kernel = window.to(img.dtype).expand(c, 1, *window.shape).contiguous()
    return _DepthwiseConvSame.apply(img, kernel)


def ssim(
    img1: torch.Tensor,
    img2: torch.Tensor,
    window_size: int = 11,
    size_average: Optional[bool] = True,
) -> torch.Tensor:
    """Structural similarity (11x11 gaussian window, sigma 1.5, zero
    padding), CHW or BCHW."""
    if img1.ndim == 3:
        img1, img2 = img1[None], img2[None]
    window = torch.as_tensor(_gaussian_window(window_size, 1.5), device=img1.device)

    mu1 = _depthwise_conv_same(img1, window)
    mu2 = _depthwise_conv_same(img2, window)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2

    sigma1_sq = _depthwise_conv_same(img1 * img1, window) - mu1_sq
    sigma2_sq = _depthwise_conv_same(img2 * img2, window) - mu2_sq
    sigma12 = _depthwise_conv_same(img1 * img2, window) - mu1_mu2

    c1, c2 = 0.01**2, 0.03**2
    ssim_map = ((2 * mu1_mu2 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2)
    )
    if size_average is None:  # the raw (B, C, H, W) map (the sharded slab loss)
        return ssim_map
    if size_average:
        return ssim_map.mean()
    return ssim_map.mean(dim=(1, 2, 3))


def photometric_loss(pred: torch.Tensor, target: torch.Tensor, lambda_dssim: float = 0.2) -> torch.Tensor:
    """The training objective: (1-lambda)*L1 + lambda*(1-SSIM)."""
    return (1.0 - lambda_dssim) * l1_loss(pred, target) + lambda_dssim * (1.0 - ssim(pred, target))
