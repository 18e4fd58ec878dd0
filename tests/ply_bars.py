"""The bar for two trained .ply files that should hold the same scene: the
port's train CLI against train.py on the CPU (tests/test_torch_cli.py),
and the port on the card against the port on the CPU
(tests/test_torch_gpu.py).

Two runs whose gradients agree at the train bar still part by up to one
learning rate a step in a few entries: Adam's eps is 1e-15, so where a
gradient is ~0 a last-ulp difference flips its normalized step between
-lr and +lr (ROADMAP C). So:
- every entry lies within the steps times its field's learning rate;
- at most LOOSE_SHARE of all entries differ by more than TIGHT.

On tests/synth.py's 32-px folder the port and train.py part by more than
TIGHT in 0.085% of the entries after 2 default steps and in 0.17% after
the 6 steps of the epoch-boundary run. A run that skips the parameter
update parts in 16% of them, and one that trains on mirrored photos in
5.5%.
"""
import numpy as np

from c3dgs_tpu_torch.config import OptimizationParams

TIGHT = 1e-5
LOOSE_SHARE = 0.01
# the cameras' ring radius (4), nerf++ normalized (get_nerfpp_norm's 1.1),
# for both tests/synth.py's and tools/datasets.py's Blender folders
EXTENT = 4.0 * 1.1


def field_steps(opt: OptimizationParams, extent: float = EXTENT) -> dict:
    """The most one Adam step moves each stored field. f_dc also moves by
    one int8 step of the colors' fake-quant range; a stored log scale
    moves with scaling_factor (lr) and with the scale direction's
    components (lr each, over a component of 1/sqrt(3) at the isotropic
    init, once directly and once through the normalization)."""
    return {"x": opt.position_lr_init * extent, "y": opt.position_lr_init * extent,
            "z": opt.position_lr_init * extent, "f_dc": opt.feature_lr + 1.0 / 127, "f_rest": opt.feature_lr / 20,
            "opacity": opt.opacity_lr, "scale": opt.scaling_lr * (1 + 2 * 3 ** 0.5), "rot": opt.rotation_lr}


def assert_trained_plys_close(got: dict, ref: dict, steps: int, opt: OptimizationParams = None) -> None:
    """`got` and `ref` are io_ply.read_vertices dicts of the same header.
    The normals are equal; every other field meets the bar above."""
    assert list(got) == list(ref)
    bound = field_steps(opt or OptimizationParams())
    loose = total = 0
    for name in got:
        key = next((k for k in bound if name.startswith(k)), None)
        if key is None:  # nx, ny, nz
            np.testing.assert_array_equal(got[name], ref[name], err_msg=name)
            continue
        np.testing.assert_allclose(got[name], ref[name], atol=steps * bound[key], rtol=0, err_msg=name)
        d = np.abs(got[name].astype(np.float64) - ref[name])
        loose += int((d > TIGHT).sum())
        total += d.size
    assert loose <= LOOSE_SHARE * total, f"{loose} of {total} entries differ by more than {TIGHT}"
