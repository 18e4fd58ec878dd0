"""The freeze's skip share on the bench frame (port of the JAX package's
tools/saturation_probe.py).

The packed kernels freeze a tile once every pixel's log-transmittance is
below log(1e-6) and no flush is pending: K1 stops the tile's walk at its
freeze slot (csrc/tiles_packed_fwd.cu) and K2 starts from min(ends,
freeze) (csrc/tiles_packed_bwd.cu), so the interior chunks past the freeze
are work neither kernel does. One packed forward (K1) of bench.py's
frame at a probe-exact bucket gives, from the per-tile freeze slots and
the binning's tile ranges:

  - chunks_exec (the chunks the frame's slots fill),
  - the chunks the freeze skips, exactly,
  - the interior (flush-free) chunks, the most a finer skip could save,
  - per-pixel saturation (final T) for context.

    python -m c3dgs_tpu_torch.tools.saturation_probe [--device cpu]

C3DGS_BENCH_N (default 300,000) and C3DGS_BENCH_OPACITY ("trained", the
default, or anything else for from_point_cloud's opacity) as the JAX tool
reads them. Prints the report (the JAX tool's keys, fractions unrounded,
plus `card`) and returns it.
"""
from __future__ import annotations

import argparse
import json
import math
import os
from typing import Optional

import numpy as np
import torch

from ..device import resolve_device
from ..render.binning import CHUNK, bin_gaussians, per_gaussian_table
from ..render.capacity import CapacityPolicy
from ..render.preprocess import Preprocessed, preprocess
from ..render.rasterizer import blend_gaussians_packed
from ..render.types import RasterSettings
from ..train import trainer
from .scenes import bench_recipe_scene

SETTINGS = RasterSettings(width=1920, height=1080, tanfovx=math.tan(0.6), tanfovy=math.tan(0.6), sh_degree=3)
EV = np.asarray([0, 0, 0, 1, 0, 0, 0], np.float32)


@torch.no_grad()
def packed_blocks(means, cov, opacity, ev, settings: RasterSettings, shs=None, colors=None):
    """One packed forward over the whole slot domain, as the JAX tool runs
    it: preprocess -> bin_gaussians -> K1 with meta [chunks_exec, 0, T,
    cap]. Returns numpy (out blocks (T, OUT_ROWS, PIX), starts, ends) and
    the ints (chunks_exec, instances)."""
    ev = torch.as_tensor(ev, dtype=torch.float32, device=means.device)
    prep = preprocess(means, cov, opacity, ev, settings, shs, colors)
    b = bin_gaussians(Preprocessed(*(t.detach() for t in prep)), settings)
    table = per_gaussian_table(prep, b.offset)
    cap, _ = settings.resolve_caps(means.shape[0])
    t = settings.num_tiles
    zero = torch.zeros_like(b.chunks_exec)
    meta = torch.stack([b.chunks_exec, zero, zero + t, zero + cap])
    out = blend_gaussians_packed(table, b.gid_sorted, b.tid_sorted, b.sent_sorted, b.j_sorted, b.tile_lo, meta,
                                 b.starts, b.ends, b.perm, b.emit_cum, settings.tiles_x, t, t, cap, cap,
                                 settings.fast_grad)
    return (out.cpu().numpy(), b.starts.cpu().numpy(), b.ends.cpu().numpy(), int(b.chunks_exec),
            int(b.num_instances))


def saturation_report(out, starts, ends, chunks_exec: int, instances: int, tiles: int, n: int) -> dict:
    """The JAX tool's report (tools/saturation_probe.py:104-149) of one
    packed forward: its keys and arithmetic, the fractions unrounded."""
    frz = out[:, 5, 0]  # freeze start slot per tile (cap if never frozen)
    final_t = out[:, 3, :]  # exp(lt) per pixel per tile
    # a tile's interior chunks lie strictly between the chunk holding
    # starts[t] and the one holding ends[t] (its sentinel): no flush inside
    c_of_start = starts // CHUNK
    c_of_end = ends // CHUNK
    interior = np.maximum(c_of_end - c_of_start - 1, 0)
    # skipped by the freeze: the interior chunks that start at or past it
    frz_chunk = np.where(frz < ends, (frz.astype(np.int64) + CHUNK - 1) // CHUNK, c_of_end)
    skipped = np.maximum(c_of_end - np.maximum(frz_chunk, c_of_start + 1), 0)
    skipped = np.minimum(skipped, interior)
    return {
        "workload": {"n_gaussians": n, "instances": int(instances), "tiles": int(tiles), "chunks_exec": chunks_exec},
        "per_tile_chunks": {
            "total_segment_chunks": int((c_of_end - c_of_start + 1).sum()),
            "interior_flush_free_chunks": int(interior.sum()),
        },
        "freeze": {
            "tiles_frozen": int((frz < ends).sum()),
            "chunks_skipped_by_freeze": int(skipped.sum()),
            "skip_fraction_of_exec": float(skipped.sum()) / max(chunks_exec, 1),
        },
        "saturation": {
            "tiles_fully_saturated_final": int((final_t.max(axis=1) < 1e-4).sum()),
            "pixels_saturated_fraction": float((final_t < 1e-4).mean()),
        },
    }


def main(argv: Optional[list] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", type=str, default=None, help="torch device (default cuda; a missing card is an error)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    n = int(os.environ.get("C3DGS_BENCH_N", 300_000))
    trained = os.environ.get("C3DGS_BENCH_OPACITY", "trained") == "trained"
    scene = bench_recipe_scene(n, seed=0, scale=0.15, trained=trained, device=dev)
    bg = torch.zeros(3, device=dev)
    with torch.no_grad():
        probe = trainer.render_scene(scene, EV, CapacityPolicy(initial=1 << 21).apply(SETTINGS), bg,
                                     device=dev)["num_instances"]
    settings = CapacityPolicy(initial=int(int(probe) * 1.12)).apply(SETTINGS)
    st = trainer.settings_with_degree(settings, scene.active_sh_degree)
    out, starts, ends, chunks_exec, instances = packed_blocks(
        scene.get_xyz(), scene.get_covariance(), scene.get_opacity()[:, 0], EV, st, shs=scene.get_features())
    report = saturation_report(out, starts, ends, chunks_exec, instances, st.num_tiles, n)
    report["card"] = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(json.dumps(report, indent=1))
    return report


if __name__ == "__main__":
    main()
