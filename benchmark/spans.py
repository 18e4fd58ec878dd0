"""The program's spans in a traced window: each moment of the card's
timeline given to the layer that accounts for it.

While a profiler records, the program opens a `record_function` range
`c3dgs.<layer>` at each layer boundary of a training step and a served
view (c3dgs_tpu_torch/spans.py; roots `c3dgs.train_step` and
`c3dgs.view`). Over the window of `trace.profiled`'s profile:

- busy time, the union of the kernels' intervals that `trace.summarize`
  counts, each moment given to the first-started kernel that covers it,
  goes to the span that launched the kernel: the innermost program span
  open at the launch (the runtime call of the kernel's correlation id, or
  failing one the host op the kernel is linked to) on the launching
  thread; if that thread has none open, the innermost, latest-opened one
  open then on any thread; if none, `unattributed`;
- idle time, the window less that union, goes at each moment to the
  innermost, latest-opened program span open on any thread, else to
  `unattributed`;
- a span's figures are its self figures, so over all names busy and idle
  add up to the window.

A backward's spans run on the autograd engine's thread, inside the step's
`c3dgs.backward` in time. A step's or a view's spans are those inside the
one root span that encloses them in time.

`attribute(events)` gives each span name's `busy_s`, `idle_s` and `count`
(spans opened in the window) and the window's 10 longest idle gaps, each
named by the host op running at its middle and its innermost `c3dgs.`
span, else its `bench.` range. `layer_ms` reads the per-layer figures of
`METRICS`: the card's time per step or view that a layer accounts for,
its kernels plus the idle time while the host was in its code.

As a module it makes one traced run of a cell, as `run.py --trace 1`
does, and adds the attribution: one stderr line per span (busy, idle and
count per step or view), the sum check, and the result line with
`spans`, `span_gaps`, `span_launches` and `layers` added:

    python3 -m benchmark.spans --workload <name> --seed <n>
"""
from __future__ import annotations

import argparse
import bisect
import json
import sys
from typing import Dict, List, Optional

import torch

from benchmark import trace

PREFIX = "c3dgs."
ROOTS = ("c3dgs.train_step", "c3dgs.view")
UNATTRIBUTED = "unattributed"

# metric: (span, loop); `autograd_ms.train` is the self time of
# c3dgs.backward, what the backward spends outside the layers' own spans
METRICS = {
    "accessors_ms.view": ("c3dgs.accessors", "view"),
    "preprocess_ms.view": ("c3dgs.preprocess", "view"),
    "binning_ms.view": ("c3dgs.binning", "view"),
    "stage_ms.view": ("c3dgs.stage", "view"),
    "blend_ms.view": ("c3dgs.blend", "view"),
    "accessors_ms.train": ("c3dgs.accessors", "train"),
    "preprocess_ms.train": ("c3dgs.preprocess", "train"),
    "binning_ms.train": ("c3dgs.binning", "train"),
    "stage_ms.train": ("c3dgs.stage", "train"),
    "blend_ms.train": ("c3dgs.blend", "train"),
    "loss_ms.train": ("c3dgs.loss", "train"),
    "blend_bwd_ms.train": ("c3dgs.blend_bwd", "train"),
    "reduction_ms.train": ("c3dgs.reduction", "train"),
    "autograd_ms.train": ("c3dgs.backward", "train"),
    "optimizer_ms.train": ("c3dgs.optimizer", "train"),
    "table_grads_ms.train": ("c3dgs.table_grads", "train"),
}


class _Spans:
    """The program spans sorted by start, all and by thread: innermost-open
    lookups."""

    def __init__(self, spans, split: bool = True):
        self.all = sorted(spans, key=lambda e: (e.time_range.start, -e.time_range.end))
        self.starts = [e.time_range.start for e in self.all]
        groups: Dict[int, list] = {}
        for e in self.all if split else ():
            groups.setdefault(e.thread, []).append(e)
        self.by_thread = {t: _Spans(g, False) for t, g in groups.items()}

    def innermost(self, t: float):
        """The latest-opened span open at `t`, or None."""
        for i in range(bisect.bisect_right(self.starts, t) - 1, -1, -1):
            if self.all[i].time_range.end >= t:
                return self.all[i]
        return None

    def at(self, thread: int, t: float):
        """The innermost span open at `t` on `thread`, else the
        latest-opened one open at `t` on any thread, or None."""
        own = self.by_thread.get(thread)
        found = own.innermost(t) if own is not None else None
        return found if found is not None else self.innermost(t)


def _launcher(k, spans: _Spans, runtime: dict, ops: dict):
    """(the span that launched kernel `k`, how its launch was found): the
    innermost open at its runtime call; failing one, the program span it is
    linked to, or the innermost open at the start of the host op it is
    linked to; failing both, the innermost open at its own start on any
    thread."""
    r = runtime.get(k.id)
    if r is not None:
        return spans.at(r.thread, r.time_range.start), "runtime"
    op = ops.get(getattr(k, "linked_correlation_id", 0) or -1)
    if op is not None:
        return (op if op.name.startswith(PREFIX) else spans.at(op.thread, op.time_range.start)), "linked"
    return spans.innermost(k.time_range.start), "own_start"


def attribute(events) -> dict:
    """{"spans": {name: {busy_s, idle_s, count}} (UNATTRIBUTED among them),
    "idle_gaps": [[name, seconds], ...], "launches": {how: kernels}} over
    the window, `launches` counting how each kernel's launch was found;
    see the module's docstring."""
    cpu = [e for e in events if e.device_type == torch.autograd.DeviceType.CPU]
    win = [e for e in cpu if e.name == trace.WINDOW]
    if not win:
        raise RuntimeError(f"the trace holds no {trace.WINDOW} range")
    w0, w1 = win[0].time_range.start, win[0].time_range.end
    host_names = {e.name for e in cpu}
    spans = _Spans([e for e in cpu if e.name.startswith(PREFIX)])
    runtime = {e.id: e for e in cpu if e.name.startswith("cu")}
    ops = {e.id: e for e in cpu if not e.name.startswith("cu")}
    out: Dict[str, Dict[str, float]] = {}

    def add(span, key: str, seconds: float) -> None:
        name = span.name if span is not None else UNATTRIBUTED
        out.setdefault(name, dict(busy_s=0.0, idle_s=0.0, count=0))[key] += seconds

    for e in spans.all:
        if w0 <= e.time_range.start <= w1:
            add(e, "count", 1)
    kernels = []
    for e in events:
        if e.device_type != torch.autograd.DeviceType.CUDA or e.name in host_names:
            continue
        a, b = max(e.time_range.start, w0), min(e.time_range.end, w1)
        if b > a:
            kernels.append((a, b, e))
    kernels.sort(key=lambda x: (x[0], x[1]))
    covered, idle, launches = w0, [], dict(runtime=0, linked=0, own_start=0)
    for a, b, k in kernels:
        if a > covered:
            idle.append((covered, a))
        span, how = _launcher(k, spans, runtime, ops)
        launches[how] += 1
        if b > covered:
            add(span, "busy_s", (b - max(a, covered)) * 1e-6)
            covered = b
    if w1 > covered:
        idle.append((covered, w1))
    edges = sorted({x for e in spans.all for x in (e.time_range.start, e.time_range.end)})
    for a, b in idle:
        cuts = [a] + edges[bisect.bisect_right(edges, a): bisect.bisect_left(edges, b)] + [b]
        for x, y in zip(cuts, cuts[1:]):
            add(spans.innermost(0.5 * (x + y)), "idle_s", (y - x) * 1e-6)
    out.setdefault(UNATTRIBUTED, dict(busy_s=0.0, idle_s=0.0, count=0))
    return dict(spans=out, idle_gaps=_name_gaps(cpu, idle), launches=launches)


def _name_gaps(cpu, idle) -> List[list]:
    """The 10 longest idle gaps, each named as `trace.summarize` names it
    but by its innermost `c3dgs.` span before its `bench.` range."""
    named = []
    for a, b in sorted(idle, key=lambda g: g[0] - g[1])[:10]:
        mid = 0.5 * (a + b)
        inner = [e for e in cpu if e.name != trace.WINDOW and e.time_range.start <= mid <= e.time_range.end]
        inner.sort(key=lambda e: (e.time_range.start, -e.time_range.end))
        ranges = ([e.name for e in inner if e.name.startswith(PREFIX)]
                  or [e.name for e in inner if e.name.startswith("bench.")])
        name = inner[-1].name if inner else "(no host op)"
        if ranges and ranges[-1] != name:
            name = f"{name} in {ranges[-1]}"
        named.append([name, (b - a) * 1e-6])
    return named


def layer_ms(spans: Dict[str, dict], metric: str, loop: str, steps: int) -> Optional[float]:
    """A per-layer metric of `METRICS`: 1e3 * (busy_s + idle_s) / steps of
    its span, or None in another loop's run or where the span never ran."""
    span, want = METRICS[metric]
    got = spans.get(span)
    if loop != want or not steps or not got or not got["count"]:
        return None
    return 1e3 * (got["busy_s"] + got["idle_s"]) / steps


def traced(name: str, seed: int, device="cuda", t0: Optional[float] = None, spec: Optional[dict] = None) -> dict:
    """One `--trace 1` run of the cell, through the harness as it stands,
    with the attribution of the same profile: the result object plus
    `spans`, `span_gaps`, `span_launches` and `layers`."""
    from benchmark import harness

    spec = spec or harness.load_cell(name)
    got: dict = {}
    summarize = trace.summarize

    def with_spans(events):
        out = summarize(events)
        got.update(attribute(events))
        return out

    trace.summarize = with_spans
    try:
        result = harness.run_cell(name, seed, 0.0, True, device, t0, spec)
    finally:
        trace.summarize = summarize
    loop, steps = spec["traffic"]["loop"], result["attempted"]
    result.update(spans=got["spans"], span_gaps=got["idle_gaps"], span_launches=got["launches"])
    result["layers"] = {m: v for m in METRICS if (v := layer_ms(got["spans"], m, loop, steps)) is not None}
    return result


def log_spans(result: dict) -> None:
    """One stderr line per span, ms and count per step or view, and the
    sum check against the window."""
    steps, window = result["attempted"], result["device"]["window_s"]
    total = roots = 0.0
    for name, v in sorted(result["spans"].items(), key=lambda kv: -(kv[1]["busy_s"] + kv[1]["idle_s"])):
        total += v["busy_s"] + v["idle_s"]
        if name in ROOTS or name == UNATTRIBUTED:
            roots += v["busy_s"] + v["idle_s"]
        print(f"[bench spans] {name} busy {1e3 * v['busy_s'] / steps:.3f} ms idle {1e3 * v['idle_s'] / steps:.3f} ms "
              f"count {v['count'] / steps:.2f} per step", file=sys.stderr, flush=True)
    print(f"[bench spans] sum {1e3 * total / steps:.3f} ms of a {1e3 * window / steps:.3f} ms window per step "
          f"({100 * (total / window - 1):+.4f}%); roots' self and unattributed {100 * roots / window:.2f}%",
          file=sys.stderr, flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    result = traced(args.workload, args.seed)
    log_spans(result)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
