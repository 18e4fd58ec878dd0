"""Per-splat sums of the packed backward's per-slot gradient rows: the
training reduction in exact mode (rasterizer._reduce_instance_grads_packed
with exact=True).

For splat g, its emissions seg = [emit_cum[g-1], emit_cum[g]) (emit_cum[-1]
:= 0) are contiguous in emission order, and perm maps each emission to its
sorted slot, so

    d_table[g, f] = sum over e in seg with e < len(perm), perm[e] < live of
                    grads[f, perm[e]]                     f < NUM_USED_FIELDS
    d_table[g, NUM_USED_FIELDS:] = 0

summed in float64 and rounded once to float32, where live =
min(rows, meta[0] * CHUNK) by K1/K2's meta (K2 writes no slot past its
executed chunks). Emissions whose sorted slot lies at or past `live` add
nothing; the whole permutation is read, past the execution bucket's index
too.

`segment_sum` launches the hand-written Hopper kernels (csrc/segment_sum.cu)
for CUDA tensors and runs `segment_sum_plain` for CPU tensors; there is no
fallback from one to the other.
"""
from __future__ import annotations

import ctypes

import torch

from .. import kernels
from .binning import CHUNK, NUM_FIELDS, NUM_USED_FIELDS

# one launch runs both of the source's passes
KERNEL = kernels.register(
    kernels.Kernel(
        name="segment_sum",
        source="segment_sum.cu",
        symbol="c3dgs_segment_sum",
        argtypes=(
            ctypes.c_void_p,  # grads (16, rows)
            ctypes.c_longlong,  # rows
            ctypes.c_void_p,  # meta
            ctypes.c_void_p,  # perm
            ctypes.c_longlong,  # len(perm)
            ctypes.c_void_p,  # emit_cum
            ctypes.c_longlong,  # n
            ctypes.c_void_p,  # rec (rows, 12) scratch
            ctypes.c_void_p,  # out (n, 16)
            ctypes.c_void_p,  # stream
        ),
        # XLA's gather, scans and prefix differences; no Pallas kernel
        replaces="c3dgs_tpu/render/rasterizer.py:272",
    )
)


REC = 12  # floats of a slot's record in the kernels' scratch


def _check(grads, perm, emit_cum, meta) -> None:
    dev = grads.device
    named = [("grads", grads, torch.float32), ("perm", perm, torch.int32), ("emit_cum", emit_cum, torch.int32),
             ("meta", meta, torch.int32)]
    for name, t, dt in named:
        if t.dtype != dt or t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dt} tensor on {dev}")
    if grads.ndim != 2 or grads.shape[0] != NUM_FIELDS:
        raise ValueError(f"grads must be ({NUM_FIELDS}, rows), got {tuple(grads.shape)}")
    if perm.ndim != 1 or emit_cum.ndim != 1 or meta.shape != (4,):
        raise ValueError("perm and emit_cum must be 1-D, meta (4,)")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")


def segment_sum(grads: torch.Tensor, perm: torch.Tensor, emit_cum: torch.Tensor,
                meta: torch.Tensor) -> torch.Tensor:
    """(NUM_FIELDS, rows) per-slot grads -> (N, NUM_FIELDS) per splat; meta
    is K1/K2's [chunks_exec, ...] on the grads' device. CUDA tensors launch
    the kernels (or raise); CPU tensors run segment_sum_plain."""
    _check(grads, perm, emit_cum, meta)
    if grads.device.type == "cpu":
        return segment_sum_plain(grads, perm, emit_cum, meta)
    rec = torch.empty((grads.shape[1], REC), dtype=torch.float32, device=grads.device)
    out = torch.empty((emit_cum.shape[0], NUM_FIELDS), dtype=torch.float32, device=grads.device)
    launch(grads, meta, perm, emit_cum, rec, out)
    return out


def launch(grads, meta, perm, emit_cum, rec, out) -> None:
    """One call of both passes on the current stream into `out` (`rec` their
    scratch), on tensors that `segment_sum` has validated (timing loops call
    it directly)."""
    with torch.cuda.device(grads.device):
        KERNEL.launch(
            grads.data_ptr(),
            grads.shape[1],
            meta.data_ptr(),
            perm.data_ptr(),
            perm.shape[0],
            emit_cum.data_ptr(),
            emit_cum.shape[0],
            rec.data_ptr(),
            out.data_ptr(),
            torch.cuda.current_stream(grads.device).cuda_stream,
        )


def segment_sum_plain(grads: torch.Tensor, perm: torch.Tensor, emit_cum: torch.Tensor,
                      meta: torch.Tensor) -> torch.Tensor:
    """The plain version: a float64 index_add_ of every kept emission's rows
    into its owner, the splat whose segment holds it (searchsorted over
    emit_cum), cast to float32."""
    n, rows = emit_cum.shape[0], grads.shape[1]
    p = perm.long()
    live = torch.clamp(meta[0].long() * CHUNK, max=rows)
    e = torch.arange(p.shape[0], device=grads.device)
    keep = (e < emit_cum[-1]) & (p >= 0) & (p < live)
    owner = torch.clamp(torch.searchsorted(emit_cum.long(), e, right=True), max=n - 1)
    rows_e = grads[:NUM_USED_FIELDS, torch.clamp(p, 0, rows - 1)].T.double()
    sums = torch.zeros((n, NUM_USED_FIELDS), dtype=torch.float64, device=grads.device)
    sums.index_add_(0, owner, torch.where(keep[:, None], rows_e, torch.zeros_like(rows_e)))
    return torch.nn.functional.pad(sums.float(), (0, NUM_FIELDS - NUM_USED_FIELDS))
