"""The instance count of scale_train_probe's first frame, in either package.

    python tests/scale_init_counts.py port [--n_init N] [--n_gt N] [--knn auto|exact|window|exact-bf16] [--device cuda]
    python tests/scale_init_counts.py jax [--n_init N] [--n_gt N] [--knn auto|exact|window]

The scene is the probe's noisy init: the seed-11 stream gives the GT
scene's draws (n_gt points) first, then n_init points go through
from_point_cloud (capacity 1.25x, quantization on, SH degree 0), seen
from view 0 at 1920x1080. Counts only: preprocess and the binning's
emission prefix, whose sum is the num_instances a render reports; no
sort and no kernel. `--knn` picks from_point_cloud's scale init: `auto`
is the package's own choice (the Morton-window approximation above
EXACT_KNN_MAX_POINTS, the exact 3-NN up to it), `exact` and `window`
force one, and `exact-bf16` (port only) is the exact 3-NN with its
distance product taken on bf16-rounded coordinates and summed in f32,
which is what JAX's default-precision jnp.dot computes on a TPU. Prints
one JSON line.

`port` imports no JAX and runs where --device says (the card by
default); `jax` runs on the CPU. tests/test_torch_probes.py holds the two
equal at a small size.
"""
import argparse
import json
import math
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402

WIDTH, HEIGHT = 1920, 1080


def init_points(n_init: int, n_gt: int):
    """The probe's init points and colors, after its GT draws."""
    from c3dgs_tpu_torch.tools import scale_train_probe as probe

    rng = np.random.default_rng(11)
    probe.gt_arrays(rng, n_gt)
    return probe.init_arrays(rng, n_init)


def knn_threshold(knn: str, n: int, default: int) -> int:
    return {"auto": default, "exact": n, "exact-bf16": n, "window": 0}[knn]


def knn_bf16_product(xyz, k: int = 3, chunk: int = 4096):
    """c3dgs_tpu_torch.ops.misc.mean_knn_sq_dist with the (chunk, N)
    product of bf16-rounded coordinates (each product exact in f32, summed
    in f32); the squared norms stay f32."""
    import torch

    n = xyz.shape[0]
    sq = torch.sum(xyz * xyz, dim=1)
    xb = xyz.to(torch.bfloat16).to(torch.float32)
    out = torch.empty(n, dtype=xyz.dtype, device=xyz.device)
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        d = sq[lo:hi, None] + sq[None, :] - 2.0 * (xb[lo:hi] @ xb.T)
        idx = torch.arange(lo, hi, device=xyz.device)
        d[idx - lo, idx] = float("inf")
        out[lo:hi] = torch.clamp(torch.topk(d, k, dim=1, largest=False).values, min=0.0).mean(dim=1)
    return out


def count_port(n_init: int, n_gt: int, knn: str, device: str) -> dict:
    import torch

    from c3dgs_tpu_torch.models import gaussians as gmod
    from c3dgs_tpu_torch.ops import misc
    from c3dgs_tpu_torch.render import binning
    from c3dgs_tpu_torch.render.preprocess import preprocess
    from c3dgs_tpu_torch.render.types import RasterSettings
    from c3dgs_tpu_torch.tools.scale_train_probe import cam

    torch.backends.cuda.matmul.allow_tf32 = False  # the exact product in f32, as on the CPU
    pts, cols = init_points(n_init, n_gt)
    default, exact = misc.EXACT_KNN_MAX_POINTS, misc.mean_knn_sq_dist
    misc.EXACT_KNN_MAX_POINTS = knn_threshold(knn, n_init, default)
    if knn == "exact-bf16":
        misc.mean_knn_sq_dist = knn_bf16_product
    t0 = time.perf_counter()
    try:
        scene = gmod.from_point_cloud(pts, cols, capacity=int(n_init * 1.25) // 128 * 128, quantization=True,
                                      device=device)
    finally:
        misc.EXACT_KNN_MAX_POINTS, misc.mean_knn_sq_dist = default, exact
    init_s = time.perf_counter() - t0
    scene.active_sh_degree = 0
    settings = RasterSettings(width=WIDTH, height=HEIGHT, tanfovx=math.tan(0.5), tanfovy=math.tan(0.32),
                              sh_degree=0)
    with torch.no_grad():
        prep = preprocess(scene.get_xyz(), scene.get_covariance(1.0), scene.get_opacity()[:, 0],
                          torch.as_tensor(cam(0.0), device=scene.device), settings, shs=scene.get_features())
        n, tiles = prep.depth.shape[0], settings.num_tiles
        _, cum, clipped = binning._emission_prefix(prep, min(tiles, 1 << binning._payload_bits(n, tiles)))
        touched = prep.tiles_touched
        return {"package": "port", "device": str(scene.device), "n_init": n_init, "n_gt": n_gt, "knn": knn,
                "instances": int(cum[-1]), "clipped": int(clipped), "visible": int((touched > 0).sum()),
                "init_seconds": init_s}


def count_jax(n_init: int, n_gt: int, knn: str) -> dict:
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    from c3dgs_tpu.models import gaussians as gmod
    from c3dgs_tpu.ops import misc
    from c3dgs_tpu.render import binning
    from c3dgs_tpu.render.preprocess import preprocess
    from c3dgs_tpu.render.types import RasterSettings
    from c3dgs_tpu_torch.tools.scale_train_probe import cam

    pts, cols = init_points(n_init, n_gt)
    default = misc.EXACT_KNN_MAX_POINTS
    misc.EXACT_KNN_MAX_POINTS = knn_threshold(knn, n_init, default)
    t0 = time.perf_counter()
    try:
        scene = gmod.from_point_cloud(pts, cols, capacity=int(n_init * 1.25) // 128 * 128, quantization=True)
    finally:
        misc.EXACT_KNN_MAX_POINTS = default
    init_s = time.perf_counter() - t0
    scene = scene.replace(active_sh_degree=0)
    settings = RasterSettings(width=WIDTH, height=HEIGHT, tanfovx=math.tan(0.5), tanfovy=math.tan(0.32),
                              sh_degree=0)
    prep = preprocess(scene.get_xyz(), scene.get_covariance(1.0), scene.get_opacity()[:, 0], jnp.asarray(cam(0.0)),
                      settings, shs=scene.get_features())
    n, tiles = prep.depth.shape[0], settings.num_tiles
    _, cum, clipped = binning._emission_prefix(prep, min(tiles, 1 << binning._payload_bits(n, tiles)))
    visible = int((np.asarray(prep.tiles_touched) > 0).sum())
    return {"package": "jax", "device": "cpu", "n_init": n_init, "n_gt": n_gt, "knn": knn,
            "instances": int(cum[-1]), "clipped": int(clipped), "visible": visible, "init_seconds": init_s}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("package", choices=("port", "jax"))
    ap.add_argument("--n_init", type=int, default=1_000_000)
    ap.add_argument("--n_gt", type=int, default=600_000)
    ap.add_argument("--knn", choices=("auto", "exact", "window", "exact-bf16"), default="auto")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    if a.package == "port":
        out = count_port(a.n_init, a.n_gt, a.knn, a.device)
    elif a.knn == "exact-bf16":
        raise SystemExit("exact-bf16 is the port's emulation of the TPU product; JAX on the CPU computes it in f32")
    else:
        out = count_jax(a.n_init, a.n_gt, a.knn)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
