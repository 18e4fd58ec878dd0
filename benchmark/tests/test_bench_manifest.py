"""BENCHMARK.json against the benchmark's contract: keys, names, units,
lengths, bounds, and every configuration, traffic mix, loop, limit file and
per-layer reader that a name points at."""
import json
import re
from pathlib import Path

import pytest

from benchmark import harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["paths"]) <= 16 and all(PATH.match(p) and ".." not in p for p in BENCH["paths"])
    assert 1 <= len(BENCH["command"]) <= 32 and all(_line(w) and not w.startswith("/") for w in BENCH["command"])
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_configs(cfg):
    assert set(cfg) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(cfg["name"]) and _line(cfg["source"]) and _line(cfg["why"])
    assert cfg["file"].startswith(BENCH["paths"][0] + "/") and (ROOT / cfg["file"]).is_file()
    assert len(cfg["reduced"]) <= 16 and all(NAME.match(k) for k in cfg["reduced"])
    body = json.loads((ROOT / cfg["file"]).read_text())
    assert body["name"] == cfg["name"] and body["source"] == cfg["source"] and body["reduced"] == cfg["reduced"]
    assert any(w["config"] == cfg["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_cells(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(cell["name"]) and NAME.match(cell["traffic"]) and _line(cell["why"])
    assert cell["chips"] in (1, 4)
    assert cell["config"] in {c["name"] for c in BENCH["configs"]}
    traffic = ROOT / "benchmark" / "traffic" / f"{cell['traffic']}.json"
    assert traffic.is_file()
    loop = harness.load_loop(json.loads(traffic.read_text())["loop"])
    assert callable(loop.run) and callable(loop.control_numbers)
    limits = json.loads((ROOT / "benchmark" / "checks" / f"{cell['name']}.json").read_text())
    assert limits and all(isinstance(v, float) and v > 0 for v in limits.values())
    e2e = [m["name"] for m in BENCH["end_to_end"] if cell["name"] in m.get("workloads", [cell["name"]])]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert any(cell["name"] in m.get("workloads", [cell["name"]]) for m in BENCH["per_layer"])


def test_unique_pairs_and_names():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    for group in (BENCH["configs"], BENCH["workloads"], METRICS):
        names = [x["name"] for x in group]
        assert len(names) == len(set(names))
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(BENCH["workloads"]) // 4)


@pytest.mark.parametrize("m", METRICS, ids=lambda m: m["name"])
def test_metrics(m):
    per_layer = m in BENCH["per_layer"]
    keys = {"name", "unit", "better", "source"} | ({"layer", "moves"} if per_layer else {"bound"})
    assert set(m) - {"workloads"} == keys
    assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(m.get("workloads", cells)) <= cells
    if per_layer:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert _line(m["layer"])
        moved = {e["name"]: e for e in BENCH["end_to_end"]}[m["moves"]]
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))
        assert (ROOT / "benchmark" / "metrics" / f"{m['name']}.py").is_file()
        if m["name"].endswith("_roofline") or "mfu" in m["name"] or "roofline" in m["name"]:
            assert m["unit"] == "%"
    else:
        assert m["source"] in ("device_trace", "host_clock")
        assert 0.01 <= m["bound"] <= 0.25


@pytest.mark.parametrize("name", ["../harness", "loops.train", "train/../view", ""])
def test_a_loop_is_named_not_pathed(name):
    with pytest.raises(SystemExit):
        harness.load_loop(name)
