"""Nothing the benchmark runs may load JAX or the JAX package, and the
reference loads nothing of the program. Names are compared by their
top-level part (before the first dot), whole: c3dgs_tpu_torch is the
program, c3dgs_tpu the JAX package."""
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import harness

ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.parametrize("names,found", [
    (["c3dgs_tpu_torch", "c3dgs_tpu_torch.render.binning", "torch", "benchmark.harness"], []),
    (["c3dgs_tpu", "c3dgs_tpu.render"], ["c3dgs_tpu"]),
    (["c3dgs_tpu.models.gaussians"], ["c3dgs_tpu"]),
    (["jax", "jax.numpy"], ["jax"]),
    (["jaxlib.xla_client"], ["jaxlib"]),
    (["flax.linen"], ["flax"]),
    (["jaxtyping", "flax_extra", "c3dgs_tpu_torchx"], []),
])
def test_forbidden_modules(names, found):
    assert harness.forbidden_modules(names) == found


def _loaded(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys; print(' '.join(sys.modules))"], cwd=ROOT,
                         capture_output=True, text=True, check=True, timeout=300)
    return {n.split(".")[0] for n in out.stdout.split()}


def test_harness_and_program_load_no_jax():
    mods = _loaded("import benchmark.harness, benchmark.program, benchmark.control, benchmark.loops.train, benchmark.loops.view")
    assert "c3dgs_tpu_torch" in mods
    assert not mods & set(harness.FORBIDDEN)


def test_reference_loads_nothing_of_the_program():
    mods = _loaded("import benchmark.reference.splat, benchmark.checks, benchmark.work, benchmark.scene")
    assert not mods & (set(harness.FORBIDDEN) | {"c3dgs_tpu_torch"})


def test_sources_name_no_jax():
    for path in (ROOT / "benchmark").rglob("*.py"):
        if path.parent.name == "tests":
            continue
        for line in path.read_text().splitlines():
            words = line.replace(",", " ").split()
            if words[:1] in (["import"], ["from"]):
                assert words[1].split(".")[0] not in harness.FORBIDDEN, (path, line)
