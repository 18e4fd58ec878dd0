"""Micro-bench: prefix-sum formulations for the gradient reduction's
cumsum (port of the repo's tools/cumsum_probe.py).

    python -m c3dgs_tpu_torch.tools.cumsum_probe [--calls 30] [--device cpu]

The reduction takes a prefix sum over (exec_cap, 9) f32 rows; at the
1080p bench frame that is ~475k rows. Formulations, each on the same
N(0, 1) rows from seed 0:
  cumsum      torch.cumsum(x, 0): the scan over the outer dimension;
  transposed  torch.cumsum(xt, 1) on the (COLS, ROWS) layout, the scan
              over the contiguous dimension the port's reduction runs
              (render/rasterizer.py::_segment_prefix_diff);
  twolevel    within-block cumsum (512 rows) + block-offset cumsum + add;
  matmul      blocked lower-triangular matmul prefix over a three-pass
              bf16 split of the rows, on the tensor cores in TF32 (each
              piece holds at most 9 significant bits, so its products are
              exact), fp32 sums, + block offsets;
  matmul_hp   the same matmul in one pass of IEEE fp32 (TF32 off);
  matmul_bf16 one pass of the rows rounded to bf16 (TF32, fp32 sums): the
              error class the split avoids.
These are plain torch ops; no hand kernel lies behind any of them. Prints
the JAX tool's line per formulation (ms per call over --calls calls
between two syncs, max abs error against a float64 oracle), then one JSON
line of the same figures and whether each output equals, bit for bit,
the sequential fp32 scan (numpy's float32 cumsum: one add a row, in
order), and returns them with that scan's own error.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import time
from typing import Optional

import numpy as np
import torch

from ..device import resolve_device
from . import roofline

ROWS, COLS, K = 475136, 9, 512


@contextlib.contextmanager
def fp32_matmul(precision: str):
    """CUDA fp32 matmuls at `precision` ("tf32" on the tensor cores, or
    "ieee") inside the block."""
    m = torch.backends.cuda.matmul
    prev = m.fp32_precision
    m.fp32_precision = precision
    try:
        yield
    finally:
        m.fp32_precision = prev


def _tri(x: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """The (K, K) inclusive lower-triangular ones."""
    return torch.ones((K, K), dtype=dtype, device=x.device).tril()


def _add_offsets(within: torch.Tensor) -> torch.Tensor:
    """(nb, K, COLS) block prefixes -> the (ROWS, COLS) prefix."""
    offs = torch.cumsum(within[:, -1, :], 0)
    offs = torch.cat([torch.zeros_like(offs[:1]), offs[:-1]], 0)
    return (within + offs[:, None, :]).reshape(ROWS, COLS)


def cumsum(x):
    return torch.cumsum(x, 0)


def transposed(xt):
    return torch.cumsum(xt, 1)


def twolevel(x):
    within = torch.cumsum(x.reshape(ROWS // K, K, COLS), 1)
    return _add_offsets(within)


def _bf16(v):
    return v.to(torch.bfloat16).to(torch.float32)


def matmul(x):
    y = x.reshape(ROWS // K, K, COLS)
    tri = _tri(x)
    h1 = _bf16(y)
    r1 = y - h1
    h2 = _bf16(r1)
    h3 = r1 - h2
    with fp32_matmul("tf32"):
        return _add_offsets(torch.matmul(tri, h1) + torch.matmul(tri, h2) + torch.matmul(tri, h3))


def matmul_hp(x):
    with fp32_matmul("ieee"):
        return _add_offsets(torch.matmul(_tri(x), x.reshape(ROWS // K, K, COLS)))


def matmul_bf16(x):
    with fp32_matmul("tf32"):
        return _add_offsets(torch.matmul(_tri(x), _bf16(x.reshape(ROWS // K, K, COLS))))


FORMULATIONS = {"cumsum": cumsum, "transposed": transposed, "twolevel": twolevel, "matmul": matmul,
                "matmul_hp": matmul_hp, "matmul_bf16": matmul_bf16}


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv: Optional[list] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--calls", type=int, default=30, help="timed calls per formulation (the JAX tool's 30)")
    ap.add_argument("--device", type=str, default=None, help="torch device (default cuda; a missing card is an error)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    x_np = np.random.default_rng(0).normal(size=(ROWS, COLS)).astype(np.float32)
    oracle = np.cumsum(x_np.astype(np.float64), 0)
    sequential = np.cumsum(x_np, 0)  # one fp32 add a row, in order
    x = torch.as_tensor(x_np, device=dev)
    xt = x.T.contiguous()
    result = {}
    for name, fn in FORMULATIONS.items():
        arg = xt if name == "transposed" else x
        out = fn(arg)
        got = (out.T if name == "transposed" else out).cpu().numpy()
        err = float(np.abs(got.astype(np.float64) - oracle).max())
        sync(dev)
        t0 = time.perf_counter()
        for _ in range(args.calls):
            out = fn(arg)
        sync(dev)
        ms = (time.perf_counter() - t0) / args.calls * 1e3
        print(f"{name:11s} {ms:8.4f} ms   maxerr {err:.3e}", flush=True)
        result[name] = {"ms": ms, "max_abs_err": err, "equals_sequential_fp32": bool(np.array_equal(got, sequential))}
    print(json.dumps(result), flush=True)
    return {"formulations": result, "sequential_fp32_err": float(np.abs(sequential - oracle).max()), "timed_calls": args.calls, "shape": [ROWS, COLS, K], "card": roofline.card(dev)}


if __name__ == "__main__":
    main()
