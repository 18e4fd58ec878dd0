"""The port's DMA probes (c3dgs_tpu_torch/tools/dma_probe.py, P1-P3)
against the Pallas probes of tools/dma_probe.py on the CPU.

tools/ is no package, so the JAX tool is loaded by path. Its
`pl.pallas_call` is wrapped to pass interpret=True and to record each
built callable; the probes then run as the tool runs them, and the
recorded callables are called again on seeded inputs of the same shapes.
The port's plain versions must match: P1 and P2 bitwise, P3 within rtol
1e-6 (the chunk sums' summation order differs). The kernels themselves run
only on the card (tests/test_torch_gpu.py, chip_smoke.py).
"""
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from c3dgs_tpu_torch.tools import dma_probe as tprobe
import torch_cpu  # noqa: F401,E402  (one torch thread per test worker)

TOOL = Path(__file__).resolve().parents[1] / "tools" / "dma_probe.py"


@pytest.fixture(scope="module")
def jax_probes():
    """Run the JAX tool's three probes in interpret mode; returns its
    results and the pallas callables it built, in order: probe1, probe2,
    probe3 without and with the transpose."""
    spec = importlib.util.spec_from_file_location("jax_dma_probe", TOOL)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    built = []
    real = mod.pl.pallas_call

    def interpret_call(*args, **kwargs):
        fn = real(*args, interpret=True, **kwargs)
        built.append(fn)
        return fn

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mod.pl, "pallas_call", interpret_call)
        results = [mod.probe1(), mod.probe2(), mod.probe3()]
    assert len(built) == 4
    return results, built


def seeded(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def positive(shape, seed):
    """Seeded values in [0.5, 1.5): P3's sums then have no cancellation, so
    a relative bar of 1e-6 measures the summation order alone."""
    return np.random.default_rng(seed).uniform(0.5, 1.5, size=shape).astype(np.float32)


def test_jax_tool_runs_in_interpret_mode(jax_probes):
    results, _ = jax_probes
    assert results[:2] == ["ok", "ok"]
    assert "transpose cost" in results[2]


@pytest.mark.parametrize("seed", [0, 1])
def test_probe1_plain_matches_jax_kernel(jax_probes, seed):
    x = seeded((tprobe.P1_CAP, 16), seed)
    want = np.asarray(jax_probes[1][0](jnp.asarray(x)))
    got = tprobe.scale_chunks(torch.as_tensor(x))  # the CPU route: probe1_plain
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", [0, 1])
def test_probe2_plain_matches_jax_kernel(jax_probes, seed):
    x = seeded((tprobe.P2_TILES, 8, 512), seed)
    want = np.asarray(jax_probes[1][1](jnp.asarray(x)))
    got = tprobe.add_blocks(torch.as_tensor(x))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("do_t", [False, True])
def test_probe3_plain_matches_jax_kernel(jax_probes, do_t):
    """The (1, 128) output is the last chunk's sum, on the tool's all-ones
    input (256.0) and on a seeded positive one."""
    fn = jax_probes[1][2 + int(do_t)]
    shape = (16, tprobe.P3_CHUNKS * tprobe.CHUNK)
    for x in (np.ones(shape, np.float32), positive(shape, 3)):
        want = np.asarray(fn(jnp.asarray(x)))
        got, sums = tprobe.chunk_sums(torch.as_tensor(x), do_t)
        assert got.shape == want.shape == (1, 128) and sums.shape == (tprobe.P3_CHUNKS,)
        np.testing.assert_allclose(got.numpy(), want, rtol=tprobe.P3_RTOL, atol=0)
        assert float(got[0, 0]) == float(sums[-1])
    ones_out, _ = tprobe.probe3_plain(torch.ones(shape), do_t)
    assert bool((ones_out == 256.0).all())


def test_probe3_chunk_sums_are_per_chunk():
    """Every chunk's sum, not only the last one's, against a float64 sum."""
    x = positive((16, 8 * 128), 5)
    _, sums = tprobe.chunk_sums(torch.as_tensor(x), do_t=True)
    blocks = x.astype(np.float64).reshape(16, 8, 128)
    ref = (blocks[0] + blocks[5] * blocks[3]).sum(1)
    np.testing.assert_allclose(sums.numpy(), ref, rtol=tprobe.P3_RTOL)


def test_probe_entry_points_on_cpu(capsys):
    assert tprobe.probe1(device="cpu") == "ok"
    assert tprobe.probe2(torch.as_tensor(seeded((4, 8, 512), 2)), device="cpu") == "ok"
    assert "transpose cost" in tprobe.probe3(torch.as_tensor(seeded((16, 64 * 128), 4)), device="cpu", reps=2)
    assert tprobe.main(device="cpu") == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert [ln.split(" -> ")[0] for ln in lines] == [name for name, _ in tprobe.PROBES]
    assert lines[0].endswith("-> ok") and lines[1].endswith("-> ok")


@pytest.mark.parametrize(
    "call",
    [
        lambda: tprobe.scale_chunks(torch.zeros(100, 16)),
        lambda: tprobe.add_blocks(torch.zeros(2, 8, 256)),
        lambda: tprobe.chunk_sums(torch.zeros(16, 100), False),
        lambda: tprobe.scale_chunks(torch.zeros(128, 16, dtype=torch.float64)),
    ],
    ids=["p1-rows", "p2-block", "p3-cols", "p1-dtype"],
)
def test_probe_wrappers_reject_bad_shapes(call):
    with pytest.raises(ValueError):
        call()
