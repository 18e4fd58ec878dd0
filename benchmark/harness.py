"""One run of one cell: inputs from the seed, set-up, the measured (or the
traced) window, the reference's verdict, the metrics.

Everything that belongs to one configuration, traffic mix, loop or
per-layer metric is a file found by its name: configs/<config>.json,
traffic/<traffic>.json (the parameters of a mix; its `loop` names the
code that drives it), loops/<loop>.py (`train`, a closed loop of training
steps; `view`, a closed loop of served views), checks/<cell>.json (the
limits of the numbers that decide `correct`) and metrics/<metric>.py (one
reader per per-layer metric).
"""
from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import re
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch

from . import checks
from .reference import splat

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "c3dgs_tpu")


def forbidden_modules(names) -> List[str]:
    """The loaded modules' top-level names (before the first dot, compared
    whole) that the measured process must not hold."""
    return sorted({n.split(".")[0] for n in names} & set(FORBIDDEN))


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, root: Path = ROOT) -> dict:
    """The cell's entry, configuration, traffic, limits and metric lists."""
    bench = _json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    mine = lambda m: name in m.get("workloads", [name])
    return dict(
        cell=cell,
        cfg=_json(root / cfg_entry["file"]),
        traffic=_json(HERE / "traffic" / f"{cell['traffic']}.json"),
        limits=_json(HERE / "checks" / f"{name}.json"),
        end_to_end=[m for m in bench["end_to_end"] if mine(m)],
        per_layer=[m for m in bench["per_layer"] if mine(m)],
    )


def load_reader(metric: str):
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{metric}", HERE / "metrics" / f"{metric}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def log(t0: float, msg: str) -> None:
    """A phase's end on standard error, seconds since the run began."""
    print(f"[bench {time.perf_counter() - t0:8.2f} s] {msg}", file=sys.stderr, flush=True)


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def inputs_made(dev, t0: float) -> None:
    """The inputs are made: from here the peak memory is the program's
    (its scene holds the inputs), not the scene maker's scratch."""
    sync(dev)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    log(t0, "inputs made")


def free() -> None:
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def count_work(ref: "splat.Scene", evs, cams: dict, bg) -> List[dict]:
    """The reference's work counts of each frame, one count per camera."""
    memo: Dict[bytes, dict] = {}
    out = []
    for ev in evs:
        key = ev.detach().cpu().numpy().tobytes()
        if key not in memo:
            w = splat.work_counts()
            ref.render(splat.Camera(ev, cams["intrinsic"], ev.device), bg, w)
            memo[key] = w
        out.append(memo[key])
    return out


LOOP_NAME = re.compile(r"[A-Za-z_][A-Za-z0-9_]*")


def load_loop(name: str):
    """The loop module `loops/<name>.py`: its `run(spec, seed, seconds,
    tracing, dev, t0)` makes the inputs, sets up, runs the window and
    returns what the reference judged; its `control_numbers` gives the
    control's readings (benchmark/control.py)."""
    if not LOOP_NAME.fullmatch(name):
        raise SystemExit(f"no loop {name!r}")
    return importlib.import_module(f"benchmark.loops.{name}")


def run_cell(name: str, seed: int, seconds: float, tracing: bool, device="cuda", t0: Optional[float] = None,
             spec: Optional[dict] = None) -> dict:
    """One run; returns the result line's object. `spec` (load_cell's) may
    be given to run a changed configuration (the tests' small sizes)."""
    t0 = time.perf_counter() if t0 is None else t0
    spec = spec or load_cell(name)
    dev = torch.device(device)
    out = load_loop(spec["traffic"]["loop"]).run(spec, seed, seconds, tracing, dev, t0)
    correct = checks.judge(out["numbers"], spec["limits"]) and out["attempted"] > 0
    if tracing:
        tr = out["trace"]
        ctx = dict(loop=spec["traffic"]["loop"], frames=out["frames"], pixels=out["pixels"],
                   scene_bytes=out["scene_bytes"], param_bytes=out["param_bytes"], instances=out["instances"],
                   steps=out["attempted"], kernels=tr["kernels"], busy_s=tr["busy_s"], window_s=tr["window_s"])
        metrics = {}
        for m in spec["per_layer"]:
            v = load_reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        values = dict(out["e2e"], setup_s=out["setup_s"])
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]} for m in spec["end_to_end"]}
    dev_info = dict(platform="gpu" if dev.type == "cuda" else dev.type,
                    kind=torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                    count=1, memory_peak_bytes=int(out["memory_peak_bytes"]))
    result = dict(correct=bool(correct), attempted=int(out["attempted"]), failed=int(out["failed"]),
                  metrics=metrics, device=dev_info)
    if tracing:
        tr = out["trace"]
        dev_info.update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        result["breakdown"] = dict(device_ops=tr["device_ops"], idle_gaps=tr["idle_gaps"])
    result["checks"] = {k: {"value": out["numbers"].get(k), "limit": v} for k, v in spec["limits"].items()}
    return result


def print_result(result: dict) -> None:
    """The compared numbers beside their limits as the last lines of
    standard error; the result as the last line of standard output."""
    for k, v in result["checks"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
