"""Sensitivity-weighted vector quantization (weighted k-means), port of
c3dgs_tpu/compress/vq.py (compression/vq.py: VectorQuantize, ema_inplace,
vq_features, join_features, CompressionSettings).

The nearest-codebook search is one matmul plus an argmin:
argmin_c ||x - c||^2 = argmin_c (||c||^2 - 2 x.c). It runs in full fp32
(TF32 off for the call, whatever the caller's setting): with TF32, near
ties flip the argmin. The JAX package ran this product at the TPU's
default bf16-pass precision; the port keeps fp32.

The random draws are apart from the update: vq_features draws the initial
codebook and the per-step batch indices from a seeded torch.Generator on
the features' device, and kmeans_loop takes them as tensors, so a caller
can feed it any draws (the tests feed JAX's). The segment sums are
deterministic (ops/segment.py), so one seed gives the same codebook bits
on every run.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..ops.segment import segment_sum


@dataclasses.dataclass
class CompressionSettings:
    """compression/vq.py:106-114; mutable, as compress_gaussians autosets
    importance_include from a quantile."""

    codebook_size: int
    importance_include: Optional[float]
    importance_include_relative: float
    steps: int
    decay: float
    batch_size: int


@contextlib.contextmanager
def _ieee_fp32_matmul():
    m = torch.backends.cuda.matmul
    prev = m.fp32_precision
    m.fp32_precision = "ieee"
    try:
        yield
    finally:
        m.fp32_precision = prev


def nearest_codebook(x: torch.Tensor, codebook: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(min squared distances, argmin) over codebook rows; x (B, D),
    codebook (C, D)."""
    c_sq = torch.sum(codebook * codebook, 1)
    with _ieee_fp32_matmul():
        cross = x @ codebook.T
    scores = c_sq[None, :] - 2.0 * cross
    idx = torch.argmin(scores, 1)
    min_d = torch.gather(scores, 1, idx[:, None])[:, 0] + torch.sum(x * x, 1)
    return torch.clamp(min_d, min=0.0), idx


def kmeans_loop(
    features: torch.Tensor,
    importance: torch.Tensor,
    codebook: torch.Tensor,
    batch_idx: torch.Tensor,
    decay: float,
    scale_normalize: bool,
):
    """The weighted k-means of compression/vq.py:61-77 from given draws:
    codebook (C, D) the initial codebook, batch_idx (steps, B) the rows
    each step reads. Each step assigns its batch to the nearest entries,
    EMA-updates each entry's importance and its importance-weighted mean,
    and with scale_normalize divides each entry (a 6-vector covariance) by
    its trace. Returns (codebook, entry_importance, mean error per step)."""
    c = codebook.shape[0]
    entry_importance = torch.zeros(c, dtype=features.dtype, device=features.device)
    importance_n = importance / torch.clamp(importance.max(), min=1e-30)
    eps = 1e-5
    errors = []
    for idx_b in batch_idx:
        x = features[idx_b]
        imp = importance_n[idx_b]
        min_d, idx = nearest_codebook(x, codebook)
        sums = segment_sum(torch.cat([imp[:, None], x * imp[:, None]], 1), idx, c)
        acc_imp = sums[:, 0]
        entry_importance = decay * entry_importance + (1 - decay) * acc_imp
        codebook = decay * codebook + (1 - decay) * (sums[:, 1:] / (acc_imp[:, None] + eps))
        if scale_normalize:
            tr = codebook[:, 0] + codebook[:, 3] + codebook[:, 5]
            codebook = codebook / tr[:, None]
        errors.append(min_d.mean())
    return codebook, entry_importance, torch.stack(errors) if errors else features.new_zeros(0)


def kmeans_draws(features: torch.Tensor, codebook_size: int, batch_size: int, steps: int, seed: int):
    """The initial codebook, uniform over [min, max] of all features, and
    the (steps, batch_size) batch indices, from one seeded generator on the
    features' device."""
    gen = torch.Generator(device=features.device)
    gen.manual_seed(seed)
    amin, amax = features.min(), features.max()
    u = torch.rand((codebook_size, features.shape[1]), generator=gen, device=features.device)
    batch_idx = torch.randint(0, features.shape[0], (steps, batch_size), generator=gen, device=features.device)
    return u * (amax - amin) + amin, batch_idx


def assign_indices(features: torch.Tensor, codebook: torch.Tensor, chunk: int = 2**16) -> torch.Tensor:
    """The nearest entry of every row, in chunks of `chunk` rows."""
    out = [nearest_codebook(features[s : s + chunk], codebook)[1] for s in range(0, features.shape[0], chunk)]
    return torch.cat(out) if out else torch.zeros(0, dtype=torch.int64, device=features.device)


@torch.no_grad()
def vq_features(
    features: torch.Tensor,
    importance: torch.Tensor,
    codebook_size: int,
    vq_chunk: int = 2**16,
    steps: int = 1000,
    decay: float = 0.8,
    scale_normalize: bool = False,
    seed: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Weighted k-means -> (codebook (C, D), indices (N,) int64), with the
    defaults and loop of compression/vq.py:49-87."""
    batch = min(vq_chunk, max(int(features.shape[0]), 1))
    codebook, batch_idx = kmeans_draws(features, codebook_size, batch, steps, seed)
    codebook, _, _ = kmeans_loop(features, importance, codebook, batch_idx, decay, scale_normalize)
    return codebook, assign_indices(features, codebook)


def join_features(all_features, keep_mask, codebook, codebook_indices):
    """Codebook rows, then the kept rows dense; per-splat indices into that
    table (compression/vq.py:90-103). Host-side numpy, as the table's size
    depends on the keep count; returns numpy (table, int64 indices)."""
    as_np = lambda v: v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
    all_features, keep_mask = as_np(all_features), as_np(keep_mask)
    codebook, codebook_indices = as_np(codebook), as_np(codebook_indices)
    keep_features = all_features[keep_mask]
    compressed = np.concatenate([codebook, keep_features], 0)
    indices = np.zeros(len(all_features), np.int64)
    indices[~keep_mask] = codebook_indices
    indices[keep_mask] = np.arange(len(keep_features)) + len(codebook)
    return compressed, indices
