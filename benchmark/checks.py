"""The numbers that decide `correct`: what the timed path produced against
the plain reference, each held to the limit in `checks/<cell>.json`.

Training cells (three steps through the window's own call):
- loss_gap: the largest relative gap of a step's loss;
- grad_gap: the first gradient's norm, by the worst leaf;
- step_gap: the norm of each parameter's change after the three steps,
  by the worst leaf.
A leaf's gap is |program norm - reference norm| over the larger of the
reference's norm of that leaf and of the median leaf. Leaves whose first
gradient in the reference is under a thousandth of the median leaf's
(zero to rounding: Adam moves them by round-off alone) are left out of
both norms' gaps.

View cells: image_gap, the mean absolute pixel gap of the worst of the
sampled views.
"""
from __future__ import annotations

import math
import statistics
from typing import Dict, List, Optional

import torch

NOUGHT_SHARE = 1e-3


def _norms(d: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in d.items()}


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], keep) -> Dict[str, float]:
    med = statistics.median(ref.values())
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in keep}


def kept_leaves(ref_grad_norms: Dict[str, float]) -> List[str]:
    med = statistics.median(ref_grad_norms.values())
    return [k for k, v in ref_grad_norms.items() if v >= NOUGHT_SHARE * med]


def train_numbers(prog: dict, ref: dict, leaves: Optional[dict] = None) -> Dict[str, float]:
    """prog: losses, grad_norms, step_norms (floats) from the program;
    ref: the reference's train_steps output. `leaves`, if given, receives
    each leaf's two gaps (None where the leaf is left out)."""
    g_ref = _norms(ref["first_grads"])
    d_ref = {k: float(torch.linalg.vector_norm((ref["p"][k].detach() - ref["p0"][k]).double())) for k in ref["p0"]}
    keep = kept_leaves(g_ref)
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"]))
    g_gaps = leaf_gaps(prog["grad_norms"], g_ref, keep)
    d_gaps = leaf_gaps(prog["step_norms"], d_ref, keep)
    if leaves is not None:
        leaves.update({k: (g_gaps.get(k), d_gaps.get(k)) for k in g_ref})
    return dict(loss_gap=loss_gap, grad_gap=max(g_gaps.values()), step_gap=max(d_gaps.values()))


def image_gap(prog_images: List[torch.Tensor], ref_images: List[torch.Tensor]) -> float:
    if not prog_images:
        return math.inf
    return max(float(torch.abs(a.double() - b.double()).mean()) for a, b in zip(prog_images, ref_images))


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number present, finite and within its limit."""
    return set(numbers) == set(limits) and all(math.isfinite(numbers[k]) and numbers[k] <= limits[k] for k in limits)
