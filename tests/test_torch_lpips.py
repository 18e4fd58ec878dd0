"""LPIPS of the port (c3dgs_tpu_torch.eval.lpips) against c3dgs_tpu's on
the CPU, on shared random weights (tests/test_lpips.py's recipes): no
pretrained weights are in the repository, so this holds the network math
(scaling layer, VGG16 / AlexNet taps, unit normalization, linear heads,
spatial mean) weight for weight, at rtol 1e-4 on 1x3x64x64 images; and
the behaviour without a weights file equal to JAX's.
"""
import numpy as np
import pytest
import torch

from c3dgs_tpu.eval import lpips as jlpips
from c3dgs_tpu_torch.eval import lpips as tlpips
from c3dgs_tpu_torch.tools import scenes
from test_lpips import _random_alex_weights, _random_weights
import torch_cpu  # noqa: F401,E402  (one torch thread per test worker)


@pytest.mark.parametrize("net_type", ["vgg", "alex"])
def test_lpips_matches_jax_on_random_weights(net_type, tmp_path):
    rng = np.random.default_rng(0)
    state = (_random_weights if net_type == "vgg" else _random_alex_weights)(rng)
    path = str(tmp_path / f"lpips_{net_type}.npz")
    np.savez(path, **state)
    x = rng.random(size=(1, 3, 64, 64)).astype(np.float32)
    y = np.clip(x + rng.normal(size=x.shape).astype(np.float32) * 0.1, 0, 1)
    jm = jlpips.LPIPS(weights_npz=path, net_type=net_type)
    tm = tlpips.LPIPS(weights_npz=path, net_type=net_type, device="cpu")
    ref = float(jm(x, y))
    assert ref > 1e-6  # non-degenerate fixture
    np.testing.assert_allclose(float(tm(torch.as_tensor(x), torch.as_tensor(y))), ref, rtol=1e-4)
    # CHW images, and identical images at exactly zero distance
    np.testing.assert_allclose(float(tm(x[0], y[0])), float(jm(x[0], y[0])), rtol=1e-4)
    assert float(tm(x[0], x[0])) == pytest.approx(0.0, abs=1e-9)


def test_lpips_without_weights_behaves_as_jax(tmp_path):
    missing = str(tmp_path / "missing.npz")
    assert tlpips.available(missing) == jlpips.available(missing) is False
    for mod in (tlpips, jlpips):
        with pytest.raises(FileNotFoundError):
            mod.LPIPS(weights_npz=missing)
        with pytest.raises(ValueError):
            mod.LPIPS(weights_npz=missing, net_type="squeeze")
    assert tlpips.UNAVAILABLE_REASON == jlpips.UNAVAILABLE_REASON
    assert tlpips.VGG_BLOCKS == jlpips.VGG_BLOCKS and tlpips.ALEX_CONVS == jlpips.ALEX_CONVS
    np.testing.assert_array_equal(tlpips.SHIFT, jlpips.SHIFT)
    np.testing.assert_array_equal(tlpips.SCALE, jlpips.SCALE)
    for net in ("vgg", "alex"):
        # neither package ships converted weights
        assert tlpips.available(net_type=net) == jlpips.available(net_type=net) is False
        assert tlpips.default_weights(net).endswith(f"c3dgs_tpu_torch/eval/weights/lpips_{net}.npz")
        hint = tlpips.unavailable_hint(net)
        assert tlpips.UNAVAILABLE_REASON in hint and tlpips.default_weights(net) in hint


def test_card_weights_recipe_is_the_jax_tests():
    """tools/scenes.py's weights, which the card's checks use, are
    tests/test_lpips.py's draws."""
    for net_type, recipe in (("vgg", _random_weights), ("alex", _random_alex_weights)):
        got, ref = scenes.lpips_random_weights(net_type, np.random.default_rng(5)), recipe(np.random.default_rng(5))
        assert list(got) == list(ref)
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
