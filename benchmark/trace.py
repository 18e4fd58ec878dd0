"""Reading a `torch.profiler` trace of the traced window: the device's busy
time (the union of its kernels' intervals), each kernel's time and
launches, the device operations that took most time and the longest idle
gaps, each named by the host operation running at its middle.

The window is the host range `WINDOW` that the loops open around the
traced steps; every interval is clipped to it.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Tuple

import torch

WINDOW = "bench.window"


@contextlib.contextmanager
def profiled(device):
    """Profile the body, CPU and CUDA activity, inside a `WINDOW` range;
    yields a dict that holds the summary once the body has run."""
    from torch.profiler import ProfilerActivity, profile, record_function

    out: Dict[str, object] = {}
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.device(device).type == "cuda" else [])
    with profile(activities=acts) as prof:
        with record_function(WINDOW):
            yield out
            if torch.device(device).type == "cuda":
                torch.cuda.synchronize(device)
    out.update(summarize(prof.events()))


def _merge(iv: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def summarize(events) -> dict:
    """busy_s, window_s, kernels {name: [seconds, launches]}, device_ops and
    idle_gaps (the 10 largest, [name, seconds])."""
    cpu = [e for e in events if e.device_type == torch.autograd.DeviceType.CPU]
    win = [e for e in cpu if e.name == WINDOW]
    if not win:
        raise RuntimeError(f"the trace holds no {WINDOW} range")
    w0, w1 = win[0].time_range.start, win[0].time_range.end
    kernels: Dict[str, List[float]] = {}
    iv = []
    # a host range of record_function (WINDOW, the loops' bench.*) comes
    # back as a device-side annotation of the same name too: not work
    host_names = {e.name for e in cpu}
    for e in events:
        if e.device_type != torch.autograd.DeviceType.CUDA or e.name in host_names:
            continue
        a, b = max(e.time_range.start, w0), min(e.time_range.end, w1)
        if b <= a:
            continue
        iv.append((a, b))
        k = kernels.setdefault(e.name, [0.0, 0])
        k[0] += (b - a) * 1e-6
        k[1] += 1
    merged = _merge(iv)
    busy = sum(b - a for a, b in merged) * 1e-6
    edges = [w0] + [x for ab in merged for x in ab] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
    gaps.sort(key=lambda g: g[0] - g[1])
    named = []
    for a, b in gaps[:10]:
        mid = 0.5 * (a + b)
        inner = [e for e in cpu if e.name != WINDOW and e.time_range.start <= mid <= e.time_range.end]
        inner.sort(key=lambda e: (e.time_range.start, -e.time_range.end))
        spans = [e.name for e in inner if e.name.startswith("bench.")]
        name = inner[-1].name if inner else "(no host op)"
        if spans and spans[-1] != name:
            name = f"{name} in {spans[-1]}"
        named.append([name, (b - a) * 1e-6])
    ops = sorted(([k, v[0]] for k, v in kernels.items()), key=lambda r: -r[1])[:10]
    return dict(busy_s=busy, window_s=(w1 - w0) * 1e-6, kernels=kernels, device_ops=ops, idle_gaps=named)


def kernel_mean_s(kernels: Dict[str, List[float]], part: str):
    """Mean device seconds per launch of the kernels whose name holds
    `part`, or None if none ran."""
    hit = [v for k, v in kernels.items() if part in k]
    launches = sum(v[1] for v in hit)
    return sum(v[0] for v in hit) / launches if launches else None
