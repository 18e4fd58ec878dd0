"""The port at a tile shape other than 32x16, in a child process.

Both packages read the tile shape once, at import (C3DGS_TILE_X/Y), so a
test of another shape runs here, in a process whose environment the
caller set, and reads the JSON this writes: each case's name mapped to
"ok" or to the failure's traceback.

    C3DGS_TILE_X=16 C3DGS_TILE_Y=16 python tests/torch_tile_shape_cases.py jax out.json
    C3DGS_TILE_X=16 C3DGS_TILE_Y=8 python tests/torch_tile_shape_cases.py jax-kernels out.json
    C3DGS_TILE_X=16 C3DGS_TILE_Y=16 python tests/torch_tile_shape_cases.py card out.json

`jax` (tests/test_torch_tile_shapes.py, on the CPU): the plain versions of
K1-K4 against the JAX kernels in interpret mode on the same staged
inputs, the wrappers' CPU route, a render's image and gradients against
jax.grad in each kernel family, one train_step per family against
JAX's. `jax-kernels`: the kernel cases only. `card` (tests/test_torch_gpu.py,
on a card; imports no JAX): K1-K4 against their plain versions, K2 and K4
run twice and held bitwise. The tolerances are the reference's:
images and forward rows at atol 2e-5 / rtol 1e-4 (tests/test_render.py:113),
gradients at normalized 5e-4 in exact mode and 5e-2 in fast_grad mode
(tests/test_render.py:150), freeze slots, `stop` rows and tags exact.
"""
import json
import os
import sys
import traceback
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]

import numpy as np  # noqa: E402
import torch  # noqa: E402

from c3dgs_tpu_torch.render import tiles, tiles_packed  # noqa: E402
from c3dgs_tpu_torch.render.types import TILE_X, TILE_Y  # noqa: E402

KERNEL_SCENES = ("make_scene", "wall")
CARD_SCENES = ("make_scene", "occluder", "wall", "boundary", "long_tile")


def case_names(mode: str) -> list:
    """The cases of a mode, known without running them (the tests
    parametrize over these)."""
    kernel = [f"{k}[{s}{m}]" for s in KERNEL_SCENES
              for k, m in (("k1", ""), ("k2", "-exact"), ("k2", "-fast"), ("k3", ""), ("k4", "-exact"), ("k4", "-fast"))]
    if mode == "jax-kernels":
        return kernel
    if mode == "jax":
        return kernel + ["wrappers_take_the_plain_versions"] + [
            f"{what}[{family}]" for family in ("packed", "per_tile") for what in ("render", "train_step")]
    return [f"{k}[{s}]" for s in CARD_SCENES for k in ("k1_k2", "k3_k4")]


def _scene(name):
    from test_torch_gpu import SCENES, make_scene

    return make_scene(200) if name == "make_scene" else SCENES[name]()


# ------------------------------------------------------------ JAX, CPU
def jax_kernel_cases():
    """K1-K4's plain versions (through the wrappers, on CPU tensors)
    against the JAX kernels in interpret mode, on identical inputs."""
    import jax.numpy as jnp
    from c3dgs_tpu.render import rasterizer as jrast
    import test_torch_tiles as tt
    from test_torch_backward import FAST_TOL, GRAD_TOL, assert_normalized, cotangent
    from test_torch_render import K1_TOL, _t, k1_args, staged

    def k1(name):
        sc, kw = _scene(name)
        js, fields, tile_lo, meta, b = staged(sc, kw)
        out_j = np.asarray(jrast._blend_forward_call_packed(js.num_tiles, fields.shape[1], fields, tile_lo, meta))
        out_t = tiles_packed.forward(*k1_args(fields, tile_lo, meta, b)).numpy()
        assert out_t.shape == out_j.shape == (js.num_tiles, 8, TILE_X * TILE_Y)
        np.testing.assert_allclose(out_t[:, :5], out_j[:, :5], **K1_TOL)
        np.testing.assert_array_equal(out_t[:, 5:], out_j[:, 5:])
        if name == "wall":
            assert (out_t[:, 5, 0] < int(meta[3])).sum() >= 1  # the freeze really happens

    def k2(name, fast_grad):
        sc, kw = _scene(name)
        js, fields, tile_lo, meta, b = staged(sc, kw)
        totals = jrast._blend_forward_call_packed(js.num_tiles, fields.shape[1], fields, tile_lo, meta)
        g = cotangent(js.num_tiles)
        gj = np.asarray(jrast._blend_backward_call_packed(js.num_tiles, fields.shape[1], fast_grad, fields, tile_lo,
                                                          meta, totals, jnp.asarray(g)))
        gt = tiles_packed.backward(*k1_args(fields, tile_lo, meta, b), _t(totals), torch.as_tensor(g)).numpy()
        assert gt.shape == gj.shape == (16, fields.shape[1])
        for r in range(9):
            assert_normalized(gt[r], gj[r], FAST_TOL if fast_grad else GRAD_TOL, f"row {r}")
        assert np.abs(gj[:9]).max() > 0 and not gt[10:].any()
        walked = gt[9] > 0
        np.testing.assert_array_equal(gt[9, walked], np.asarray(fields)[10, walked])

    def k3(name):
        sc, kw = _scene(name)
        js, fields, _, b = tt.staged(sc, kw)
        out_j = np.asarray(tt.jax_forward(js, fields, b))
        out_t = tiles.forward(*tt.k3_args(js, fields, b), js.tiles_x).numpy()
        assert out_t.shape == out_j.shape == (js.num_tiles, 8, TILE_X * TILE_Y)
        np.testing.assert_allclose(out_t[:, :5], out_j[:, :5], **K1_TOL)
        np.testing.assert_array_equal(out_t[:, 5:], out_j[:, 5:])

    def k4(name, fast_grad):
        sc, kw = _scene(name)
        js, fields, _, b = tt.staged(sc, kw)
        totals = tt.jax_forward(js, fields, b)
        g = cotangent(js.num_tiles)
        grad_cap = js.resolve_grad_cap(sc["means"].shape[0])
        gj = tt.jax_backward(js, fields, b, totals, g, grad_cap, fast_grad)
        gt = tiles.backward(*tt.k3_args(js, fields, b), _t(np.asarray(b.grad_base)), _t(totals), torch.as_tensor(g),
                            js.tiles_x, grad_cap).numpy()
        written = int(b.grad_total)
        for r in range(9):
            assert_normalized(gt[r, :written], gj[r, :written], FAST_TOL if fast_grad else GRAD_TOL, f"row {r}")
        np.testing.assert_array_equal(gt[9, :written], gj[9, :written])
        assert np.abs(gj[:9, :written]).max() > 0 and not gt[:, written:].any() and not gt[10:].any()

    cases = {}
    for name in KERNEL_SCENES:
        cases[f"k1[{name}]"] = lambda name=name: k1(name)
        cases[f"k3[{name}]"] = lambda name=name: k3(name)
        for fast in (False, True):
            mode = "fast" if fast else "exact"
            cases[f"k2[{name}-{mode}]"] = lambda name=name, fast=fast: k2(name, fast)
            cases[f"k4[{name}-{mode}]"] = lambda name=name, fast=fast: k4(name, fast)
    return cases


def jax_cases():
    """The kernel cases, then the wrappers' CPU route, a render per family
    (image and gradients) and a train_step per family against JAX."""
    from test_torch_backward import GRAD_TOL, NAMES, assert_normalized, jax_grads, port_grads
    from test_torch_gpu import k1_inputs, k3_inputs, make_scene
    from test_torch_render import IMG_TOL, render_both
    from test_torch_train import train_step_parity

    def wrappers_take_the_plain_versions():
        sc, kw = _scene("wall")
        before = {k: tiles_packed.kernels.REGISTRY[k].launches for k in tiles_packed.kernels.REGISTRY}
        args = k1_inputs(sc, kw, "cpu")
        out = tiles_packed.forward(*args)
        assert torch.equal(out, tiles_packed.forward_plain(*args))
        g = torch.zeros_like(out)
        g[:, :4] = 1.0
        assert torch.equal(tiles_packed.backward(*args, out, g), tiles_packed.backward_plain(*args, out, g))
        pt, grad_base, st = k3_inputs(sc, kw, "cpu")
        blocks = tiles.forward(*pt, st.tiles_x)
        assert torch.equal(blocks, tiles.forward_plain(*pt, st.tiles_x))
        cap = st.resolve_grad_cap(len(sc["means"]))
        assert torch.equal(tiles.backward(*pt, grad_base, blocks, g[: blocks.shape[0]], st.tiles_x, cap),
                           tiles.backward_plain(*pt, grad_base, blocks, g[: blocks.shape[0]], st.tiles_x, cap))
        after = {k: tiles_packed.kernels.REGISTRY[k].launches for k in tiles_packed.kernels.REGISTRY}
        assert after == before  # CPU tensors launch nothing

    def render(packed):
        sc, kw = make_scene(150)
        oj, ot, _, _ = render_both(sc, kw, packed=packed)
        assert ot["render"].shape == (3, kw["height"], kw["width"])
        np.testing.assert_allclose(ot["render"].numpy(), np.asarray(oj["render"]), **IMG_TOL)
        np.testing.assert_allclose(ot["final_T"].numpy(), np.asarray(oj["final_T"]), atol=2e-5)
        for k in ("num_instances", "overflow", "grad_total", "grad_overflow", "culled"):
            np.testing.assert_array_equal(ot[k].numpy(), np.asarray(oj[k]), err_msg=k)
        wimg = np.random.default_rng(7).normal(size=(3, kw["height"], kw["width"])).astype(np.float32)
        gj = jax_grads(sc, kw, wimg, fast_grad=False, packed=packed)
        gt, _ = port_grads(sc, kw, wimg, fast_grad=False, packed=packed)
        for name, a, b in zip(NAMES, gj, gt):
            assert b is not None and np.isfinite(b).all(), name
            assert_normalized(b, a, GRAD_TOL, name)

    cases = jax_kernel_cases()
    cases["wrappers_take_the_plain_versions"] = wrappers_take_the_plain_versions
    for packed in (True, False):
        family = "packed" if packed else "per_tile"
        cases[f"render[{family}]"] = lambda packed=packed: render(packed)
        cases[f"train_step[{family}]"] = lambda packed=packed: train_step_parity(quantization=True, steps=1,
                                                                                  packed=packed)
    return cases


# ----------------------------------------------------------- the card
def card_cases():
    """K1-K4 on the card against their plain versions at this shape, on
    the small scenes and the long-tile scene; K2 and K4 twice, bitwise."""
    from test_torch_gpu import GRAD_TOL, K1_TOL, assert_normalized, k2_inputs, k4_inputs

    def k1_k2(scene):
        args, totals, g = k2_inputs(scene, "cuda")
        before = (tiles_packed.FORWARD_KERNEL.launches, tiles_packed.BACKWARD_KERNEL.launches)
        out_k = tiles_packed.forward(*args)
        got = tiles_packed.backward(*args, totals, g)
        again = tiles_packed.backward(*args, totals, g)
        torch.cuda.synchronize()
        assert (tiles_packed.FORWARD_KERNEL.launches, tiles_packed.BACKWARD_KERNEL.launches) == (
            before[0] + 1, before[1] + 2)
        out_p = tiles_packed.forward_plain(*args)
        torch.testing.assert_close(out_k[:, :5], out_p[:, :5], **K1_TOL)
        assert torch.equal(out_k[:, 5:], out_p[:, 5:])
        assert torch.equal(got, again), "K2 is not bitwise repeatable"
        ref = tiles_packed.backward_plain(*args, totals, g)
        for r in range(9):
            assert_normalized(got[r], ref[r], GRAD_TOL, f"K2 row {r}")
        assert torch.equal(got[9:], ref[9:])

    def k3_k4(scene):
        args, grad_base, totals, g, tiles_x, grad_cap = k4_inputs(scene, "cuda")
        before = (tiles.FORWARD_KERNEL.launches, tiles.BACKWARD_KERNEL.launches)
        out_k = tiles.forward(*args, tiles_x)
        got = tiles.backward(*args, grad_base, totals, g, tiles_x, grad_cap)
        again = tiles.backward(*args, grad_base, totals, g, tiles_x, grad_cap)
        torch.cuda.synchronize()
        assert (tiles.FORWARD_KERNEL.launches, tiles.BACKWARD_KERNEL.launches) == (before[0] + 1, before[1] + 2)
        out_p = tiles.forward_plain(*args, tiles_x)
        torch.testing.assert_close(out_k[:, :5], out_p[:, :5], **K1_TOL)
        assert torch.equal(out_k[:, 5:], out_p[:, 5:])
        assert torch.equal(got, again), "K4 is not bitwise repeatable"
        ref = tiles.backward_plain(*args, grad_base, totals, g, tiles_x, grad_cap)
        for r in range(9):
            assert_normalized(got[r], ref[r], GRAD_TOL, f"K4 row {r}")
        assert torch.equal(got[9:], ref[9:])

    cases = {}
    for scene in CARD_SCENES:
        cases[f"k1_k2[{scene}]"] = lambda scene=scene: k1_k2(scene)
        cases[f"k3_k4[{scene}]"] = lambda scene=scene: k3_k4(scene)
    return cases


MODES = {"jax": jax_cases, "jax-kernels": jax_kernel_cases, "card": card_cases}


def main(mode: str, out: str) -> None:
    if mode.startswith("jax"):
        os.environ["JAX_PLATFORMS"] = "cpu"
        import jax

        jax.config.update("jax_platforms", "cpu")
        import torch_cpu  # noqa: F401  (one torch thread)
    results = {"tile": [TILE_X, TILE_Y]}
    cases = MODES[mode]()
    assert sorted(cases) == sorted(case_names(mode)), "case_names() is out of date"
    for name, fn in cases.items():
        try:
            fn()
            results[name] = "ok"
        except Exception:  # noqa: BLE001  (each case's failure goes to the caller's test)
            results[name] = traceback.format_exc()
    Path(out).write_text(json.dumps(results))


if __name__ == "__main__":
    main(*sys.argv[1:3])
