"""Parity of the port's ops (c3dgs_tpu_torch.ops) with c3dgs_tpu.ops on the
CPU: seeded numpy inputs through both packages, atol 1e-6 (1e-5 for SH of
degree 3, whose 16 terms sum in another order)."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from c3dgs_tpu.ops import camera_math as jcam
from c3dgs_tpu.ops import losses as jlosses
from c3dgs_tpu.ops import misc as jmisc
from c3dgs_tpu.ops import quantize as jquant
from c3dgs_tpu.ops import quat as jquat
from c3dgs_tpu.ops import sh as jsh
from c3dgs_tpu_torch.ops import camera_math as tcam
from c3dgs_tpu_torch.ops import losses as tlosses
from c3dgs_tpu_torch.ops import misc as tmisc
from c3dgs_tpu_torch.ops import quantize as tquant
from c3dgs_tpu_torch.ops import quat as tquat
from c3dgs_tpu_torch.ops import sh as tsh
import torch_cpu  # noqa: F401,E402  (one torch thread per test worker)

ATOL = 1e-6


def close(t, j, atol=ATOL, rtol=0.0):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=atol, rtol=rtol)


def quats(rng, n=64):
    return rng.normal(size=(n, 4)).astype(np.float32)


@pytest.mark.parametrize("fn", ["normalize", "quat_to_rotmat", "build_scaling_rotation", "cov6"])
def test_quat_matches_jax(rng, fn):
    q = quats(rng)
    s = np.exp(rng.normal(size=(64, 3)) * 0.5 - 1.0).astype(np.float32)  # splat-sized
    if fn == "normalize":
        close(tquat.normalize(torch.as_tensor(q)), jquat.normalize(jnp.asarray(q)))
    elif fn == "quat_to_rotmat":
        qn = q / np.linalg.norm(q, axis=1, keepdims=True)
        close(tquat.quat_to_rotmat(torch.as_tensor(qn)), jquat.quat_to_rotmat(jnp.asarray(qn)))
    elif fn == "build_scaling_rotation":
        close(
            tquat.build_scaling_rotation(torch.as_tensor(s), torch.as_tensor(q)),
            jquat.build_scaling_rotation(jnp.asarray(s), jnp.asarray(q)),
            atol=ATOL, rtol=1e-6,
        )
    else:
        close(
            tquat.cov6_from_scaling_rotation(torch.as_tensor(s), torch.as_tensor(q)),
            jquat.cov6_from_scaling_rotation(jnp.asarray(s), jnp.asarray(q)),
            atol=ATOL, rtol=1e-6,
        )


def extrinsics(rng):
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    return np.concatenate([q, rng.normal(size=3)]).astype(np.float32)


@pytest.mark.parametrize("fn", ["extrinsic_to_mat", "projection_matrix", "camera_center", "intrinsic", "ndc_to_pix"])
def test_camera_math_matches_jax(rng, fn):
    ev = extrinsics(rng)
    if fn == "extrinsic_to_mat":
        close(tcam.extrinsic_to_mat(torch.as_tensor(ev)), jcam.extrinsic_to_mat(jnp.asarray(ev)))
    elif fn == "projection_matrix":
        fx, fy = np.float32(1.2), np.float32(0.9)
        close(
            tcam.projection_matrix(torch.tensor(fx), torch.tensor(fy)),
            jcam.projection_matrix(jnp.float32(fx), jnp.float32(fy)),
        )
    elif fn == "camera_center":
        close(
            tcam.camera_center_from_extrinsic(torch.as_tensor(ev)),
            jcam.camera_center_from_extrinsic(jnp.asarray(ev)),
            atol=ATOL, rtol=1e-6,
        )
    elif fn == "intrinsic":
        k = np.array([[1.2, 0, 640], [0, 0.9, 360], [0, 0, 1]])
        assert tcam.intrinsic_geometry(k) == jcam.intrinsic_geometry(k)
    else:
        v = rng.uniform(-1.5, 1.5, size=100).astype(np.float32)
        close(tcam.ndc_to_pix(torch.as_tensor(v), 1920), jcam.ndc_to_pix(jnp.asarray(v), 1920), atol=1e-4)


@pytest.mark.parametrize("deg", [0, 1, 2, 3])
def test_sh_matches_jax(rng, deg):
    sh = (rng.normal(size=(256, 16, 3)) * 0.5).astype(np.float32)
    d = rng.normal(size=(256, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    atol = 1e-5 if deg == 3 else ATOL
    close(tsh.eval_sh(deg, torch.as_tensor(sh), torch.as_tensor(d)),
          jsh.eval_sh(deg, jnp.asarray(sh), jnp.asarray(d)), atol=atol)
    for clamp in (True, False):
        out = tsh.sh_to_rgb(deg, torch.as_tensor(sh), torch.as_tensor(d), clamp_color=clamp)
        close(out, jsh.sh_to_rgb(deg, jnp.asarray(sh), jnp.asarray(d), clamp_color=clamp), atol=atol)
        assert (out.min() >= 0) == clamp or not clamp
    rgb = rng.random(size=(32, 3)).astype(np.float32)
    close(tsh.rgb_to_sh_dc(torch.as_tensor(rgb)), jsh.rgb_to_sh_dc(jnp.asarray(rgb)))
    close(tsh.sh_dc_to_rgb(torch.as_tensor(sh[:, 0])), jsh.sh_dc_to_rgb(jnp.asarray(sh[:, 0])))
    with pytest.raises(ValueError):
        tsh.eval_sh(4, torch.as_tensor(sh), torch.as_tensor(d))


def test_inverse_sigmoid_matches_jax(rng):
    x = rng.uniform(0.01, 0.99, size=100).astype(np.float32)
    close(tmisc.inverse_sigmoid(torch.as_tensor(x)), jmisc.inverse_sigmoid(jnp.asarray(x)), atol=2e-6)
    assert tmisc.inverse_sigmoid(0.1) == jmisc.inverse_sigmoid(0.1)


@pytest.mark.parametrize("n", [500, 5000])
def test_mean_knn_sq_dist_matches_jax(rng, n):
    """Exact chunked kNN; n=5000 spans two 4096-row chunks. The distances
    come out of |a|^2 + |b|^2 - 2 a.b, whose rounding cancels against
    terms of size max|x|^2: the bar is 1e-6 of that scale."""
    pts = (rng.normal(size=(n, 3)) * 2.0).astype(np.float32)
    t = tmisc.mean_knn_sq_dist(torch.as_tensor(pts))
    j = jmisc.mean_knn_sq_dist(jnp.asarray(pts))
    scale = float((pts**2).sum(1).max())
    close(t, j, atol=1e-6 * scale)
    # and against a float64 brute force at the same scale
    d = ((pts[:, None].astype(np.float64) - pts[None]) ** 2).sum(-1) if n <= 500 else None
    if d is not None:
        np.fill_diagonal(d, np.inf)
        ref = np.sort(d, axis=1)[:, :3].mean(1)
        np.testing.assert_allclose(t.numpy(), ref, atol=1e-6 * scale)


@pytest.mark.parametrize("initialized", [True, False])
def test_fake_quant_matches_jax(rng, initialized):
    x = (rng.normal(size=(1000, 3)) * 1.7).astype(np.float32)
    lo, hi = float(x.min()) * 0.8, float(x.max()) * 0.8  # some values clamp
    if initialized:
        j_obs = jquant.set_range(lo, hi)
        t_obs = tquant.set_range(lo, hi)
    else:
        j_obs = jquant.init_observer()
        t_obs = tquant.init_observer()
    for a, b in zip(t_obs, j_obs):
        close(a, b)
    close(tquant.fake_quant(torch.as_tensor(x), t_obs), jquant.fake_quant(jnp.asarray(x), j_obs))
    st, zt = tquant.qparams(t_obs)
    sj, zj = jquant.qparams(j_obs)
    close(st, sj)
    close(zt, zj)


def test_fake_quant_half_matches_jax(rng):
    x = (rng.normal(size=(1000, 3)) * 50).astype(np.float32)
    close(tquant.fake_quant_half(torch.as_tensor(x)), jquant.fake_quant_half(jnp.asarray(x)), atol=0)


@pytest.mark.parametrize("metric", ["psnr", "ssim"])
def test_image_metrics_match_jax(rng, metric):
    a = rng.random(size=(3, 40, 56)).astype(np.float32)
    b = np.clip(a + rng.normal(size=a.shape) * 0.05, 0, 1).astype(np.float32)
    t = getattr(tlosses, metric)(torch.as_tensor(a), torch.as_tensor(b))
    j = getattr(jlosses, metric)(jnp.asarray(a), jnp.asarray(b))
    close(t, j, atol=1e-5 if metric == "psnr" else 1e-6)
    if metric == "ssim":
        per = tlosses.ssim(torch.as_tensor(a)[None], torch.as_tensor(b)[None], size_average=False)
        assert per.shape == (1,) and math.isclose(float(per[0]), float(t), rel_tol=1e-6)
