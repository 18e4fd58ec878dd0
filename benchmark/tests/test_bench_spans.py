"""The attribution of the card's timeline to the program's spans
(benchmark/spans.py), on synthetic profiler events (times in us; a
kernel's launch is the runtime call of its correlation id), and one traced
run of each loop at a CPU size."""
from types import SimpleNamespace

import pytest
import torch

from benchmark import spans, trace
from benchmark.tests.small import small_spec

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


def ev(name, a, b, thread=1, dev=CPU, id=0, linked=0):
    return SimpleNamespace(name=name, time_range=SimpleNamespace(start=a, end=b), thread=thread, device_type=dev,
                           id=id, linked_correlation_id=linked)


def kernel(id, a, b, launch_at, thread=1, name="k"):
    """A kernel on the card over [a, b) and its launch on `thread`."""
    return [ev(name, a, b, dev=CUDA, id=id), ev("cudaLaunchKernel", launch_at, launch_at + 1, thread, id=id)]


def window(*events, w=(0, 1000)):
    return [ev(trace.WINDOW, *w)] + [e for x in events for e in (x if isinstance(x, list) else [x])]


def figures(events):
    got = spans.attribute(events)["spans"]
    return {k: (round(v["busy_s"] * 1e6, 6), round(v["idle_s"] * 1e6, 6), v["count"]) for k, v in got.items()}


def sums_to_window(events):
    got = spans.attribute(events)["spans"]
    total = sum(v["busy_s"] + v["idle_s"] for v in got.values())
    s = trace.summarize(events)
    assert total == pytest.approx(s["window_s"], rel=1e-12)
    assert sum(v["busy_s"] for v in got.values()) == pytest.approx(s["busy_s"], rel=1e-12)


def test_nested_spans_busy_by_launch_idle_by_host():
    """A kernel launched in preprocess runs past its end: its busy time is
    preprocess's all the same; idle time follows the host."""
    events = window(ev("c3dgs.train_step", 0, 1000), ev("c3dgs.preprocess", 100, 300),
                    kernel(7, 200, 400, launch_at=150))
    assert figures(events) == {"c3dgs.train_step": (0, 700, 1), "c3dgs.preprocess": (200, 100, 1),
                               spans.UNATTRIBUTED: (0, 0, 0)}
    sums_to_window(events)


def test_backward_on_a_second_thread():
    """The autograd engine's spans (thread 2) inside c3dgs.backward (thread
    1): each kernel goes to its launching thread's innermost span, idle time
    to the latest-opened span on any thread; a launch on a thread with no
    span open goes to the latest-opened span then."""
    events = window(
        ev("c3dgs.train_step", 0, 1000), ev("c3dgs.backward", 100, 900),
        ev("c3dgs.blend_bwd", 300, 500, thread=2), ev("c3dgs.reduction", 500, 700, thread=2),
        kernel(1, 320, 420, launch_at=310, thread=2), kernel(2, 600, 650, launch_at=520, thread=2),
        kernel(3, 650, 700, launch_at=530, thread=1), kernel(4, 700, 720, launch_at=450, thread=3),
        kernel(5, 950, 1000, launch_at=940, thread=1),
    )
    assert figures(events) == {
        "c3dgs.train_step": (50, 150, 1),
        "c3dgs.backward": (50, 200 + 180, 1),
        "c3dgs.blend_bwd": (120, 100, 1),
        "c3dgs.reduction": (50, 100, 1),
        spans.UNATTRIBUTED: (0, 0, 0),
    }
    sums_to_window(events)


def test_launch_outside_every_span_and_host_outside_the_roots():
    events = window(ev("bench.train_step", 50, 900), ev("c3dgs.train_step", 100, 900),
                    kernel(1, 60, 160, launch_at=55), kernel(2, 500, 600, launch_at=400))
    assert figures(events) == {"c3dgs.train_step": (100, 640, 1), spans.UNATTRIBUTED: (100, 160, 0)}
    sums_to_window(events)


def test_overlapping_kernels_count_once():
    """Two streams: the overlap goes to the kernel that started first, and
    busy time is the union that trace.summarize counts."""
    events = window(ev("c3dgs.view", 0, 1000), ev("c3dgs.blend", 100, 200), ev("c3dgs.binning", 200, 300),
                    kernel(1, 100, 500, launch_at=150), kernel(2, 300, 700, launch_at=250))
    assert figures(events) == {"c3dgs.view": (0, 400, 1), "c3dgs.blend": (400, 0, 1), "c3dgs.binning": (200, 0, 1),
                               spans.UNATTRIBUTED: (0, 0, 0)}
    sums_to_window(events)


def test_idle_intervals_cut_at_span_edges_and_clip_to_the_window():
    events = window(ev("c3dgs.view", 0, 1200), ev("c3dgs.accessors", 50, 150), ev("c3dgs.preprocess", 150, 400),
                    ev("c3dgs.binning", 400, 990), kernel(1, 300, 450, launch_at=160),
                    kernel(2, 980, 1100, launch_at=450))
    assert figures(events) == {
        "c3dgs.view": (0, 50, 1), "c3dgs.accessors": (0, 100, 1), "c3dgs.preprocess": (150, 150, 1),
        "c3dgs.binning": (20, 530, 1), spans.UNATTRIBUTED: (0, 0, 0),
    }
    sums_to_window(events)


def test_a_kernel_with_no_runtime_call_goes_by_its_link_or_its_start():
    events = window(ev("c3dgs.view", 0, 1000), ev("c3dgs.blend", 100, 200, id=40),
                    ev("aten::mul", 210, 220, id=41), ev("c3dgs.binning", 200, 300),
                    ev("k", 250, 260, dev=CUDA, id=9, linked=40), ev("k", 260, 270, dev=CUDA, id=10, linked=41),
                    ev("k", 400, 410, dev=CUDA, id=11))
    assert figures(events) == {"c3dgs.view": (10, 790, 1), "c3dgs.blend": (10, 100, 1),
                               "c3dgs.binning": (10, 80, 1), spans.UNATTRIBUTED: (0, 0, 0)}


def test_no_program_spans_everything_unattributed_and_gaps_named_as_summarize():
    events = window(ev("bench.train_step", 100, 900), ev("aten::index", 400, 700), ev("aten::zeros", 750, 800),
                    kernel(1, 150, 300, launch_at=120), kernel(2, 720, 760, launch_at=710))
    got = spans.attribute(events)
    assert figures(events) == {spans.UNATTRIBUTED: (190, 810, 0)}
    assert got["idle_gaps"] == trace.summarize(events)["idle_gaps"]
    sums_to_window(events)


def test_gaps_named_by_the_innermost_program_span():
    events = window(ev("bench.train_step", 0, 1000), ev("c3dgs.train_step", 10, 990),
                    ev("c3dgs.accessors", 100, 600), ev("aten::index", 200, 500), kernel(1, 600, 1000, launch_at=590))
    assert spans.attribute(events)["idle_gaps"][0] == ["aten::index in c3dgs.accessors", pytest.approx(600e-6)]
    assert trace.summarize(events)["idle_gaps"][0] == ["aten::index in bench.train_step", pytest.approx(600e-6)]


def test_layer_ms_reads_its_loop_and_span():
    got = {"c3dgs.blend": dict(busy_s=0.003, idle_s=0.001, count=4), "c3dgs.backward": dict(busy_s=0.1, idle_s=0.0,
                                                                                            count=2)}
    assert spans.layer_ms(got, "blend_ms.view", "view", 4) == pytest.approx(1.0)
    assert spans.layer_ms(got, "autograd_ms.train", "train", 2) == pytest.approx(50.0)
    assert spans.layer_ms(got, "blend_ms.train", "view", 4) is None
    assert spans.layer_ms(got, "table_grads_ms.train", "train", 2) is None


@pytest.mark.parametrize("name,layers", [
    ("train.garden-5m", {m for m, (_, loop) in spans.METRICS.items() if loop == "train"} - {"table_grads_ms.train"}),
    ("finetune.garden-5m-c3dgs", {m for m, (_, loop) in spans.METRICS.items() if loop == "train"}),
    ("view.garden-5m-c3dgs", {m for m, (_, loop) in spans.METRICS.items() if loop == "view"}),
])
def test_traced_run_of_each_loop(name, layers):
    """A traced run at a CPU size: every step's root once, the cell's
    layers read, the sum check, and summarize restored."""
    summarize = trace.summarize
    r = spans.traced(name, 2 ** 31 + 777, "cpu", spec=small_spec(name))
    assert trace.summarize is summarize
    assert r["correct"] and r["attempted"] == 2
    root = "c3dgs.view" if name.startswith("view") else "c3dgs.train_step"
    assert r["spans"][root]["count"] == r["attempted"]
    assert set(r["layers"]) == layers and all(v > 0 for v in r["layers"].values())
    total = sum(v["busy_s"] + v["idle_s"] for v in r["spans"].values())
    assert total == pytest.approx(r["device"]["window_s"], rel=1e-9)
