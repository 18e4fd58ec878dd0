"""The port at the tile shapes the reference runs besides the default
32x16, against c3dgs_tpu on the CPU.

Both packages read C3DGS_TILE_X/Y once, at import, so each shape runs in
one child process (tests/torch_tile_shape_cases.py) with the two
variables set; a module-scoped fixture starts the three children
together and each case below asserts one of their results. At 16x16, the
shape of the system this repo ports: K1-K4's plain versions against the
JAX kernels in interpret mode on identical inputs (forward rows at atol
2e-5 / rtol 1e-4, tests/test_render.py:113; gradient rows at normalized
5e-4 exact, 5e-2 fast_grad, tests/test_render.py:150; freeze slots, stop
rows and tags exact) on make_scene (n=200) and the wall scene that
freezes, the wrappers' CPU route, a render per kernel family (image at
the image bar, every input's gradient against jax.grad at 5e-4) and one
train_step per family against JAX's. At 16x8 and 32x32, the two ends of
the kernels' thread counts (64 and 512 threads per tile), the kernel
cases only. Here in the parent: which shapes the CUDA kernels take, and
that the wrappers refuse any other on the card only.
"""
import json
import os
import subprocess
import sys
from types import SimpleNamespace

import pytest
import torch

import torch_tile_shape_cases as cases
from c3dgs_tpu_torch import kernels
from c3dgs_tpu_torch.render import tiles, tiles_packed
from c3dgs_tpu_torch.render.types import kernel_shape_problem
import torch_cpu  # noqa: F401,E402  (one torch thread per test worker)

SHAPES = {"16x16": "jax", "16x8": "jax-kernels", "32x32": "jax-kernels"}
CHILD_TIMEOUT_S = 600


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """Each shape's case results (name -> "ok" or the traceback), from its
    child process; all three children run at once."""
    out_dir = tmp_path_factory.mktemp("tile_shapes")
    procs = {}
    for shape, mode in SHAPES.items():
        tx, ty = shape.split("x")
        env = dict(os.environ, C3DGS_TILE_X=tx, C3DGS_TILE_Y=ty, JAX_PLATFORMS="cpu")
        out = out_dir / f"{shape}.json"
        procs[shape] = (subprocess.Popen([sys.executable, cases.__file__, mode, str(out)], env=env,
                                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), out)
    got = {}
    try:
        for shape, (proc, out) in procs.items():
            log, _ = proc.communicate(timeout=CHILD_TIMEOUT_S)
            ok = proc.returncode == 0 and out.exists()
            got[shape] = json.loads(out.read_text()) if ok else {"error": f"exit {proc.returncode}\n{log[-4000:]}"}
    finally:
        for proc, _ in procs.values():
            proc.kill()  # no-op for a child that has exited
    return got


@pytest.mark.parametrize(
    "shape,case",
    [pytest.param(shape, name, id=f"{shape}-{name}") for shape, mode in SHAPES.items()
     for name in cases.case_names(mode)],
)
def test_port_matches_jax_at_tile_shape(results, shape, case):
    got = results[shape]
    assert "error" not in got, got.get("error")
    assert got["tile"] == [int(v) for v in shape.split("x")]
    assert got[case] == "ok", got[case]


@pytest.mark.parametrize("tx,ty", [(32, 16), (16, 16), (16, 8), (32, 32), (8, 8), (24, 8), (64, 32)])
def test_kernel_shapes_taken(tx, ty):
    assert kernel_shape_problem(tx, ty) == ""


@pytest.mark.parametrize(
    "tx,ty,why",
    [(20, 16, "multiple of 8"), (16, 6, "multiple of 4"), (24, 4, "odd number"), (64, 64, "1024 threads")],
)
def test_kernel_shapes_refused(tx, ty, why):
    assert why in kernel_shape_problem(tx, ty)


def test_wrappers_refuse_an_unsupported_shape_on_the_card_only(monkeypatch):
    """On the card a shape outside the kernels' set raises, with its
    reason, before any launch; CPU tensors take the plain version at any
    shape. (A CUDA device object stands in for a card tensor: only its
    device is read.)"""
    card = SimpleNamespace(device=torch.device("cuda", 0))
    assert tiles._on_card(card)  # 32x16: launch
    monkeypatch.setattr(tiles, "TILE_X", 20)
    with pytest.raises(NotImplementedError, match="20x16: the width must be a multiple of 8"):
        tiles._on_card(card)
    assert not tiles._on_card(torch.zeros(1))
    assert tiles_packed._on_card is tiles._on_card  # the packed wrappers ask the same question


def test_one_library_per_tile_shape(monkeypatch):
    """K1-K4 build one library per shape, the shape in the name and in
    the nvcc defines; the probe source has no tile shape."""
    default = kernels.library_path("tiles_packed_fwd.cu").name
    assert default.startswith("libtiles_packed_fwd-32x16-")
    assert kernels.shape_flags("tiles_bwd.cu") == ("-DC3DGS_TILE_X=32", "-DC3DGS_TILE_Y=16")
    monkeypatch.setattr(kernels, "TILE_X", 16)
    other = kernels.library_path("tiles_packed_fwd.cu").name
    assert other.startswith("libtiles_packed_fwd-16x16-") and other[-15:] != default[-15:]
    assert kernels.shape_flags("dma_probe.cu") == () and "16x16" not in kernels.library_path("dma_probe.cu").name
