#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (c3dgs_tpu_torch) on one CUDA card.

    python3 chip_smoke.py        # from the repo root, on a machine with a card

Phases (any failed check raises, and the script exits non-zero):
  1. build every hand-written kernel from csrc/ (one nvcc per source, all
     started together); print nvcc time, ptxas registers / shared memory,
     and the card's name and power limit;
  2. a small scene (tests/test_render.py::make_scene recipe, 300 splats
     with SH at 64x48): the CUDA render against the port's oracle on the
     card and against the port's CPU path;
  3. K1 against its plain version on identical staged fields: at the full
     bench frame (bench.py's scene: 300k gaussians, SH degree 3,
     trained-opacity statistics, 1920x1080, capacity probed as bench.py
     does), on the two freeze scenes and on the long-tile scene at 64x48;
     the bench frame's slots walked per tile (mean, p99, max); K1's time,
     its plain version's time and the frame's bound;
  4. serve: render_and_eval over 8 orbit poses of the 300k scene through
     the capacity policy (inference=True), with every kernel count reset
     just before and read just after; per-view ms from CUDA events;
  5. where a bench-frame render spends its time: each stage of the
     render path timed with CUDA events, and the profiler's device time by
     kernel name;
  6. gradients on the card: the CUDA render's gradients (means, cov,
     opacity, extrinsic, colors or SH) on five small scenes against the
     port's oracle under autograd on the card and against the port's CPU
     path; a clamped frame's gradients against the CPU path; the SSIM
     gradient at 1080p against float64;
  7. K2 against its plain version at the bench frame (phase 3's staged
     fields and K1 blocks, the cotangent of bench.py's L1 loss against a
     zero image) and on the freeze, boundary and long-tile scenes; K2's
     time, its plain version's time, its bound, bitwise repeats, the slots
     walked per tile, the (slot, warp) pairs with any alpha > 0 that set
     its shuffle count, and the reduction's error per column against a
     float64 index_add in both fast_grad modes;
  8. fwd+bwd at the bench frame (bench.py's metric: one forward and the
     L1 loss's gradients with respect to the 7 scene parameters), its
     stage breakdown and the profiler's device busy share;
  9. train: the 300k scene with quantization and SH degree 3 through
     create_train_state, 10 train_steps, densify_step, grow_capacity,
     reset_opacity_step and 2 more steps, with every kernel count reset
     just before and read just after;
 10. K3 (the per-tile forward, packed=False) against its plain version at
     the bench frame (probe-exact per-tile buckets) and on the occluder,
     wall and boundary scenes; K3's time, its plain version's time and the
     frame's bound;
 11. K4 (the per-tile backward) against its plain version at the bench
     frame (bench.py's L1 cotangent) and on the same small scenes, a
     bitwise repeat, a clamped frame (grad capacity below grad_total) run
     twice, K4's time, plain time and bound, and the per-tile reduction's
     error per column against a float64 index_add;
 12. serve with packed=False: render_and_eval over the 8 orbit poses,
     images against phase 4's packed renders, counts reset just before
     and read just after;
 13. per-tile gradients on the card on phase 6's five small scenes against
     the oracle and the CPU path;
 14. fwd+bwd with packed=False at the bench frame, with phase 8's
     breakdown;
 15. train the 300k quantized scene 4 steps with packed=False, counts
     reset just before and read just after;
 16. the DMA probes P1-P3: the probe tool's entry point with every kernel
     count reset just before and read just after, each probe kernel
     against its plain version on the tool's and seeded inputs, their
     times against their byte bounds and the launch overhead, and P1
     against torch.mul and P2 against torch.add in 5 alternating rounds;
 17. compress the 300k scene as compress.py does, with the default
     CompressionParams and phase 4's 8 orbit views: the bench scene given
     random rotations and scale directions (its kNN init makes every
     splat alike in shape), phase 4's images as its photos, its own
     uncompressed renders as the reference: to_compressed (sensitivity through K2 per
     view, color and covariance VQ, each VQ run twice from its seed and
     held bitwise), 12 finetune steps through the indexed scene (K1 + K2;
     overflow 0, the caller's scene bit-identical, one step's codebook-row
     gradients bitwise over two runs), save_npz (Morton order, fixed-point
     xyz) and load_npz with their bytes, ratio and seconds, then
     render_and_eval of the loaded scene (PSNR against the uncompressed
     renders, the difference from the in-memory compressed renders, view
     ms against the uncompressed scene's in turns), counts reset just
     before each stage and read just after;
 18. the `kernels` JSON line (K1-K4, P1-P3), the card line, and the final
     status line.
It imports nothing of JAX and nothing of the c3dgs_tpu package.
"""
from __future__ import annotations

import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

import torch.nn.functional as F

from c3dgs_tpu_torch import kernels
from c3dgs_tpu_torch.compress import pipeline
from c3dgs_tpu_torch.config import CompressionParams, OptimizationParams
from c3dgs_tpu_torch.eval import metrics
from c3dgs_tpu_torch.models import gaussians, io_npz
from c3dgs_tpu_torch.ops import losses, quat
from c3dgs_tpu_torch.render import oracle, rasterizer, tiles, tiles_packed
from c3dgs_tpu_torch.render.binning import bin_gaussians, per_gaussian_table
from c3dgs_tpu_torch.render.capacity import CapacityPolicy, _bucket
from c3dgs_tpu_torch.render.preprocess import preprocess
from c3dgs_tpu_torch.render.types import RasterSettings, settings_from_intrinsic
from c3dgs_tpu_torch.tools import dma_probe, scenes
from c3dgs_tpu_torch.train import finetune, trainer

# H100 SXM peaks (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
SMS = 132
SFU_PER_SM_CLOCK = 16  # special-function (MUFU) results per SM per clock
LOG_EXIT_T = math.log(1e-6)
DEVICE = "cuda"
BENCH_N = 300_000  # bench.py's gaussian count
GRAD_TOL = 5e-4  # normalized gradient bar, tests/test_render.py:150
EV_ID = [0, 0, 0, 1, 0, 0, 0]  # identity camera at the origin


def log(msg: str = "") -> None:
    print(msg, flush=True)


def smi(query: str) -> str:
    r = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return r.stdout.strip().splitlines()[0]


def check_close(name, got, ref, atol, rtol=0.0):
    """Raise unless |got - ref| <= atol + rtol*|ref| everywhere; returns the
    max absolute error."""
    got, ref = got.double(), ref.double()
    err = (got - ref).abs()
    bad = err > atol + rtol * ref.abs()
    max_err = float(err.max()) if err.numel() else 0.0
    log(f"  {name}: max|err| {max_err:.3e} (atol {atol:g}, rtol {rtol:g})")
    if bool(bad.any()) or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: {int(bad.sum())} elements out of tolerance, max err {max_err:.3e}")
    return max_err


def cuda_ms(fn, reps: int, warmup: int = 2):
    """Per-call device times (ms) of fn from CUDA events, after warm-up."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return times


def host_ms(fn, reps: int = 3):
    """Host-clock times (ms) of fn() between two device syncs: the plain
    versions, whose Python loops the host bounds."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def roofline(bytes_moved: int, sfu_ops: int, flops: int, clock_mhz: float):
    """The least time (ms) the card could take for this work: the largest of
    the bytes over the memory rate, the special-function operations over
    the SFUs' rate at the card's clock, and the fp32 flops over the fp32
    peak. Logs the three; returns (bound, what bounds it)."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_sfu = sfu_ops / (SMS * SFU_PER_SM_CLOCK * clock_mhz * 1e6) * 1e3
    t_flops = flops / FP32_FLOPS * 1e3
    log(f"  bound: bytes {t_bytes:.4f} ms ({bytes_moved} B), special functions {t_sfu:.4f} ms "
        f"({sfu_ops} ops at {clock_mhz} MHz), fp32 {t_flops:.4f} ms ({flops} flops)")
    return max(t_bytes, t_sfu, t_flops), "bytes" if t_bytes >= max(t_sfu, t_flops) else "operations"


def old_bound(bytes_moved: int, stats: dict, sfu_per_alpha: int, flops: int, clock_mhz: float) -> float:
    """K3's or K4's bound with an exp counted for every walked pair, as it
    was computed before those kernels skipped exps: logged beside the new
    one."""
    t_sfu = (stats["pairs"] + sfu_per_alpha * stats["alpha_pairs"]) / (SMS * SFU_PER_SM_CLOCK * clock_mhz * 1e6)
    return max(bytes_moved / HBM_BYTES_PER_S, t_sfu, flops / FP32_FLOPS) * 1e3


# ------------------------------------------------------------------ scenes
def small_scene(n=300, seed=0):
    """tests/test_render.py::make_scene: means, scales, quats, opacity,
    colors and the SH of its SH variant."""
    rng = np.random.default_rng(seed)
    means = rng.normal(size=(n, 3)).astype(np.float32) * 0.8
    means[:, 2] += 4.0
    scales = np.exp(rng.normal(size=(n, 3)).astype(np.float32) * 0.5 - 2.5)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    opacity = (1 / (1 + np.exp(-rng.normal(size=n)))).astype(np.float32)
    colors = rng.random(size=(n, 3)).astype(np.float32)
    shs = rng.normal(size=(n, 16, 3)).astype(np.float32) * 0.3
    return means, scales, quats, opacity, colors, shs


def freeze_scenes():
    """The occluder of tests/test_render.py:159 (no tile reaches the
    freeze) and the full-view wall of tests/test_torch_gpu.py (it does)."""
    rng = np.random.default_rng(4)
    near = np.stack([rng.uniform(-0.9, -0.3, 60), rng.uniform(-0.5, 0.5, 60), 2.0 + rng.uniform(0, 0.1, 60)], 1)
    far = np.stack([rng.uniform(-0.9, -0.3, 500), rng.uniform(-0.5, 0.5, 500), 6.0 + rng.uniform(0, 1.0, 500)], 1)
    occ = (np.concatenate([near, far]), 60, 0.25, rng.random(size=(560, 3)))
    rng = np.random.default_rng(4)
    gx, gy = np.meshgrid(np.linspace(-1.4, 1.4, 10), np.linspace(-1.0, 1.0, 8))
    near = np.stack([gx.ravel(), gy.ravel(), 2.0 + rng.uniform(0, 0.1, gx.size)], 1)
    far = np.stack([rng.uniform(-1.3, 1.3, 800), rng.uniform(-0.9, 0.9, 800), 6.0 + rng.uniform(0, 1.0, 800)], 1)
    wall = (np.concatenate([near, far]), 80, 0.5, rng.random(size=(880, 3)))
    out = {}
    for name, (means, n_near, near_scale, colors) in (("occluder", occ), ("wall", wall)):
        n = len(means)
        scales = np.full((n, 3), 0.12, np.float32)
        scales[:n_near] = near_scale
        opacity = np.full(n, 0.6, np.float32)
        opacity[:n_near] = 0.995
        quats = np.tile(np.asarray([1, 0, 0, 0], np.float32), (n, 1))
        out[name] = (means.astype(np.float32), scales, quats, opacity, colors.astype(np.float32))
    return out


def long_tile_scene():
    """scenes.long_tile_scene (three tiles of 1,792-2,053 slots at 64x48,
    the top-left one frozen at slot 1408) as (means, cov, opacity, colors)."""
    means, scales, quats, opacity, colors = scenes.long_tile_scene()
    cov = quat.cov6_from_scaling_rotation(torch.as_tensor(scales), torch.as_tensor(quats)).numpy()
    return means, cov, opacity, colors


def bench_scene(device, n):
    """bench.py:34-77's scene (same RNG stream): 300k points, splats shrunk
    to a trained footprint, trained-opacity Beta(0.5, 0.35) statistics.
    SH degree 3 is active with small random higher bands from a second
    seed (bench.py leaves them zero), so the degree-3 evaluation runs."""
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(n, 3)).astype(np.float32) * 2.0
    pts[:, 2] += 6.0
    cols = rng.random(size=(n, 3)).astype(np.float32)
    t0 = time.perf_counter()
    scene = gaussians.from_point_cloud(pts, cols, capacity=n, quantization=False, device=device)
    torch.cuda.synchronize()
    knn_s = time.perf_counter() - t0
    op = np.clip(rng.beta(0.5, 0.35, size=(n, 1)), 0.005, 0.995)
    rest = np.random.default_rng(1).normal(size=tuple(scene.features_rest.shape)) * 0.05
    with torch.no_grad():
        scene.scaling_factor += math.log(0.15)
        scene.opacity.copy_(torch.as_tensor(np.log(op / (1.0 - op)), dtype=torch.float32))
        scene.features_rest.copy_(torch.as_tensor(rest, dtype=torch.float32))
    scene.active_sh_degree = 3
    return scene, knn_s


def orbit_extrinsic(yaw: float, radius: float = 6.0) -> np.ndarray:
    """World-to-camera 7-vector of a camera on a circle of `radius` around
    (0, 0, radius), looking at it; yaw 0 is the identity camera at the
    origin. R_w2c = Ry(-yaw), t = -R_w2c @ C."""
    cam_pos = np.array([-radius * math.sin(yaw), 0.0, radius - radius * math.cos(yaw)])
    c, s = math.cos(-yaw), math.sin(-yaw)
    r_w2c = np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])
    q = np.array([0.0, math.sin(-yaw / 2), 0.0, math.cos(-yaw / 2)])  # (qx, qy, qz, qw)
    return np.concatenate([q, -r_w2c @ cam_pos]).astype(np.float32)


# ------------------------------------------------------------------ phases
def phase_build():
    log("== phase 1: build")
    sources = sorted({k.source for k in kernels.REGISTRY.values()})
    results = kernels.build(sources)
    for src in sources:
        res = results[src]
        log(f"  {src}: nvcc {res.seconds:.1f} s -> {kernels.library_path(src).name}")
        for line in res.log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line or "Compiling entry" in line:
                log(f"    {line.strip()}")
    card = smi("name,power.limit")
    log(f"  card: {card}; max SM clock {smi('clocks.max.sm')}")
    return card


def phase_small():
    log("== phase 2: small scene (300 splats, SH 3, 64x48) on the card")
    means, scales, quats, opacity, _, shs = small_scene()
    settings = RasterSettings(width=64, height=48, tanfovx=math.tan(0.6), tanfovy=math.tan(0.45), sh_degree=3)
    bg = torch.tensor([0.2, 0.1, 0.4])
    ev = torch.tensor([0, 0, 0, 1, 0, 0, 0], dtype=torch.float32)
    cov = quat.cov6_from_scaling_rotation(torch.as_tensor(scales), torch.as_tensor(quats))
    host = [torch.as_tensor(means), cov, torch.as_tensor(opacity), ev]
    card = [x.to(DEVICE) for x in host]
    shs_t = torch.as_tensor(shs)
    before = tiles_packed.FORWARD_KERNEL.launches
    out_c = rasterizer.render(*card, settings, bg.to(DEVICE), shs=shs_t.to(DEVICE))
    torch.cuda.synchronize()
    assert tiles_packed.FORWARD_KERNEL.launches == before + 1, "the CUDA render did not launch K1"
    out_o = oracle.render_oracle(*card, settings, bg.to(DEVICE), shs=shs_t.to(DEVICE))
    out_h = rasterizer.render(*host, settings, bg, shs=shs_t)
    assert out_c["render"].shape == (3, 48, 64)
    check_close("image vs oracle (card)", out_c["render"], out_o["render"], 2e-5, 1e-4)
    check_close("final_T vs oracle (card)", out_c["final_T"], out_o["final_T"], 2e-5)
    check_close("image vs CPU path", out_c["render"].cpu(), out_h["render"], 2e-5, 1e-4)
    check_close("final_T vs CPU path", out_c["final_T"].cpu(), out_h["final_T"], 2e-5)
    for k in ("num_instances", "overflow", "grad_total", "culled"):
        assert int(out_c[k]) == int(out_h[k]), k


def k1_args(prep, b, settings, n):
    """K1's inputs as rasterizer.render stages them at the execution
    capacity: (fields, tile_lo, meta, starts, ends), and the (T,) mask of
    the tiles that flush."""
    cap, _ = settings.resolve_caps(n)
    nc = settings.resolve_grad_cap(n) // 128
    e = nc * 128
    chunks_c = torch.clamp(b.chunks_exec, max=nc)
    fields = rasterizer._build_fields_packed(
        per_gaussian_table(prep, b.offset), b.gid_sorted[:e], b.tid_sorted[:e],
        b.sent_sorted[:e], b.j_sorted[:e], settings.tiles_x, settings.num_tiles, cap,
    )
    zero = torch.zeros_like(chunks_c)
    meta = torch.stack([chunks_c, zero, zero + settings.num_tiles, zero + cap])
    complete = torch.arange(settings.num_tiles, device=fields.device) < b.tile_lo[chunks_c.long()]
    return (fields, b.tile_lo[: nc + 1], meta, b.starts, b.ends), complete


def staged_inputs(means, cov, opacity, ev, settings, shs=None, colors=None):
    """The render path's stages up to K1, run on one frame: K1's inputs."""
    prep = preprocess(means, cov, opacity, ev, settings, shs, colors)
    return k1_args(prep, bin_gaussians(prep, settings), settings, means.shape[0])[0]


def lt_margin(fields, start, boundary):
    """max over the tile's pixels of lt at slot `boundary` (float64 walk of
    slots [start, boundary)) minus log(1e-6): the freeze decision margin."""
    f = fields[:, start:boundary].double()
    pix = torch.arange(512, device=fields.device)
    px, py = (pix % 32).double()[:, None], (pix // 32).double()[:, None]
    dx, dy = f[0] - px, f[1] - py
    power = torch.clamp((f[2] * dx + f[3] * dy) * dx + (f[4] * dy) * dy, max=0.0)
    raw = f[5] * torch.exp(power)
    alpha = torch.where(raw >= 1 / 255, torch.clamp(raw, max=0.99), torch.zeros_like(raw))
    return float(torch.log1p(-alpha).sum(1).max()) - LOG_EXIT_T


def walk_lengths(name, starts, ends, frz, complete):
    """Log the distribution of slots walked per flushed tile
    (min(ends, freeze) - starts)."""
    n = (torch.minimum(frz.long(), ends.long()) - starts.long())[complete].double()
    p99 = float(torch.quantile(n, 0.99))
    log(f"  {name}: slots walked per tile over {n.numel()} tiles: mean {float(n.mean()):.1f}, p99 {p99:.0f}, "
        f"max {int(n.max())}; {int((n > 1000).sum())} tiles above 1,000")


def compare_k1(name, args, stats=None):
    """K1 vs forward_plain on identical inputs: rows 0-4 within 2e-5 abs +
    1e-4 rel on tiles whose freeze slots agree; every freeze-slot mismatch
    must sit within 1e-4 of the threshold (a rounding-order tie)."""
    fields, tile_lo, meta, starts, ends = args
    out_k = tiles_packed.forward(*args)
    torch.cuda.synchronize()
    out_p = tiles_packed.forward_plain(*args, stats=stats)
    torch.cuda.synchronize()
    nc, _, _, cap = meta.tolist()
    complete = ends < nc * 128
    frz_k, frz_p = out_k[:, 5, 0], out_p[:, 5, 0]
    same = complete & (frz_k == frz_p) & (out_k[:, 5] == out_k[:, 5, :1]).all(1)
    mismatched = torch.nonzero(complete & ~same).flatten().tolist()
    frozen = int((complete & (frz_p < cap)).sum())
    log(f"  {name}: {int(complete.sum())} flushed tiles, {frozen} frozen, {len(mismatched)} freeze-slot mismatches")
    for t in mismatched:
        b = int(min(frz_k[t], frz_p[t]))
        margin = lt_margin(fields, int(starts[t]), b)
        log(f"    tile {t}: kernel {int(frz_k[t])} plain {int(frz_p[t])}; lt margin at slot {b}: {margin:.3e}")
        if abs(margin) > 1e-4:
            raise AssertionError(f"{name}: tile {t} freeze slot differs at a margin of {margin:.3e}")
    err = check_close(f"{name} rows 0-4", out_k[same, :5], out_p[same, :5], 2e-5, 1e-4)
    assert bool((out_k[complete, 6:] == 0).all()), "rows 6-7 must be zero"
    return err, len(mismatched), out_k, out_p


def phase_k1(scene, card_clock_mhz):
    log("== phase 3: K1 against its plain version")
    freeze = freeze_scenes()
    small = RasterSettings(width=64, height=48, tanfovx=math.tan(0.6), tanfovy=math.tan(0.45))
    ev = torch.tensor([0, 0, 0, 1, 0, 0, 0], dtype=torch.float32, device=DEVICE)
    for name, (means, scales, quats, opacity, colors) in freeze.items():
        cov = quat.cov6_from_scaling_rotation(torch.as_tensor(scales), torch.as_tensor(quats))
        t = lambda x: torch.as_tensor(x, device=DEVICE)
        args = staged_inputs(t(means), cov.to(DEVICE), t(opacity), ev, small, colors=t(colors))
        compare_k1(f"{name} scene 64x48", args)
    means, cov, opacity, colors = long_tile_scene()
    t = lambda x: torch.as_tensor(x, device=DEVICE)
    compare_k1("long-tile scene 64x48", staged_inputs(t(means), t(cov), t(opacity), ev, small, colors=t(colors)))

    # the bench frame, with bench.py's probe-exact buckets
    settings = RasterSettings(width=1920, height=1080, tanfovx=math.tan(0.6), tanfovy=math.tan(0.6), sh_degree=3)
    bg = torch.zeros(3, device=DEVICE)
    with torch.no_grad():
        probe = trainer.render_scene(scene, ev, CapacityPolicy().apply(settings), bg, device=DEVICE)
        need, grad_need = int(probe["num_instances"]), int(probe["grad_total"])
        policy = CapacityPolicy(initial=need + settings.num_tiles, grad_initial=grad_need)
        settings = policy.apply(settings)
        chk = trainer.render_scene(scene, ev, settings, bg, device=DEVICE)
        assert int(chk["overflow"]) == 0 and int(chk["grad_overflow"]) == 0, "bench frame degraded"
        log(f"  bench frame: {need} instances -> slot bucket {settings.instance_capacity}; "
            f"grad_total {grad_need} -> execution bucket {settings.grad_capacity}; culled {int(chk['culled'])}")
        deg = trainer.settings_with_degree(settings, scene.active_sh_degree)
        prep = preprocess(scene.get_xyz(), scene.get_covariance(), scene.get_opacity()[:, 0], ev, deg,
                          scene.get_features())
        b = bin_gaussians(prep, deg)
        args, complete = k1_args(prep, b, deg, scene.capacity)
        stats = {}
        err, mism, out_k, _ = compare_k1("bench frame 1920x1080", args, stats)

        fields, tile_lo, meta, starts, ends = args
        out = torch.empty_like(out_k)
        ms = cuda_ms(lambda: tiles_packed.launch(fields, meta, starts, ends, out), reps=20)
        plain_ms = host_ms(lambda: tiles_packed.forward_plain(*args))

    # the least time for this frame's work: each staged field slot a tile
    # walks read once (9 f32 rows), starts/ends read, blocks written; every
    # walked (pixel, slot) pair's power in fp32, an exp for those the
    # kernel's skip keeps, and a log1p and an exp more for those with
    # alpha > 0, on the card's special-function units
    nc = int(meta[0])
    complete = ends < nc * 128
    frz = out_k[:, 5, 0].long()
    walked = int((torch.minimum(frz, ends.long()) - starts.long())[complete].sum())
    walk_lengths("bench frame", starts, ends, frz, complete)
    t = starts.shape[0]
    bytes_moved = 9 * 4 * walked + 2 * 4 * t + t * 8 * 512 * 4
    log(f"  work: {walked} walked slots, {stats['pairs']} (pixel, slot) pairs, {stats['exp_pairs']} needing "
        f"their exp, {stats['alpha_pairs']} with alpha > 0")
    bound, bound_by = roofline(bytes_moved, stats["exp_pairs"] + 2 * stats["alpha_pairs"],
                               12 * stats["pairs"] + 11 * stats["alpha_pairs"], card_clock_mhz)
    log(f"  K1 {statistics.median(ms):.4f} ms median of {len(ms)} (min {min(ms):.4f}); "
        f"plain {statistics.median(plain_ms):.1f} ms median of 3")
    return {
        "name": "tiles_packed_fwd",
        "route": "cuda",
        "source": "c3dgs_tpu_torch/csrc/tiles_packed_fwd.cu",
        "replaces": tiles_packed.FORWARD_KERNEL.replaces,
        "launches": None,  # filled from the serve and training runs
        "max_abs_err": err,
        "freeze_mismatches": mism,
        "ms": statistics.median(ms),
        "plain_ms": statistics.median(plain_ms),
        "bound_ms": bound,
        "bound_by": bound_by,
        "library_ms": None,  # no single PyTorch call composites tiles
    }, settings, SimpleNamespace(args=args, out=out_k, b=b, deg=deg, complete=complete, walked=walked)


def phase_serve(scene, settings):
    log("== phase 4: serve 8 orbit poses (render_and_eval, inference=True, capacity policy)")
    intrinsic = np.array([[1.2, 0, settings.width], [0, 1.2, settings.height], [0, 0, 1]])
    yaws = np.linspace(-0.35, 0.35, 8)
    views = [orbit_extrinsic(float(y)) for y in yaws]
    base = settings_from_intrinsic(intrinsic, inference=True)
    policy = CapacityPolicy()
    refs, per_view_ms, overflow = [], [], []
    for ev in views:  # first pass: warm-up, and the images later passes are scored against
        refs.append(metrics.render_full(scene, ev, base, np.zeros(3), policy, device=DEVICE)["render"].clone())
    for ev in views:
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        out = metrics.render_full(scene, ev, base, np.zeros(3), policy, device=DEVICE)
        b.record()
        b.synchronize()
        per_view_ms.append(a.elapsed_time(b))
        overflow.append((int(out["overflow"]), int(out["grad_overflow"]), int(out["num_instances"])))
        img = out["render"]
        assert img.shape == (3, settings.height, settings.width) and bool(torch.isfinite(img).all())
    assert all(o == 0 and g == 0 for o, g, _ in overflow), f"overflow in the serve loop: {overflow}"
    log(f"  per-view ms: {[round(m, 3) for m in per_view_ms]}; median {statistics.median(per_view_ms):.3f}")
    log(f"  instances per view: {[n for _, _, n in overflow]}; overflow 0, grad_overflow 0")

    cams = [
        SimpleNamespace(intrinsic=intrinsic, extrinsic_vector=ev, original_image=ref, image_name=f"orbit{i}")
        for i, (ev, ref) in enumerate(zip(views, refs))
    ]
    kernels.reset_counts()
    results = metrics.render_and_eval(scene, cams, device=DEVICE)
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in kernels.REGISTRY.values()}
    log(f"  render_and_eval: psnr {[v['psnr'] for v in results['per_view'].values()]}")
    log(f"  render_and_eval: ssim {[round(v['ssim'], 6) for v in results['per_view'].values()]}")
    log(f"  renders {results['num_renders']}; kernel launches {launches}")
    assert results["num_views"] == 8
    for name, v in results["per_view"].items():
        assert v["psnr"] > 60 and v["ssim"] > 0.9999, f"{name}: served image differs from its first render: {v}"
    assert launches["tiles_packed_fwd"] == results["num_renders"], "K1 launches != renders"
    assert launches["tiles_packed_bwd"] == 0, "serving took a gradient"
    return launches, per_view_ms, cams


def phase_breakdown(scene, settings):
    """Where one render of the bench frame spends its time: the render
    path's stages one by one with CUDA events (median of 5 after a
    warm-up), then the whole render_scene call, and the profiler's device
    time by kernel over one render_scene (informational: some hosts do
    not give the profiler device time)."""
    log("== phase 5: where a bench-frame render spends its time")
    ev = torch.tensor([0, 0, 0, 1, 0, 0, 0], dtype=torch.float32, device=DEVICE)
    bg = torch.zeros(3, device=DEVICE)
    deg = trainer.settings_with_degree(settings, scene.active_sh_degree)
    s = {}
    stages = {
        "accessors": lambda: s.update(
            acc=(scene.get_xyz(), scene.get_covariance(), scene.get_opacity()[:, 0], scene.get_features())
        ),
        "preprocess": lambda: s.update(prep=preprocess(*s["acc"][:3], ev, deg, s["acc"][3])),
        "binning": lambda: s.update(b=bin_gaussians(s["prep"], deg)),
        "table + staging": lambda: s.update(
            zip(("args", "complete"), k1_args(s["prep"], s["b"], deg, scene.capacity))
        ),
        "K1 (wrapper)": lambda: s.update(out=tiles_packed.forward(*s["args"])),
        "assemble": lambda: s.update(img=rasterizer.assemble_image(s["out"], deg, s["complete"], bg)),
    }
    times = {k: [] for k in stages}
    with torch.no_grad():
        for rep in range(6):
            for name, fn in stages.items():
                a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                a.record()
                fn()
                b.record()
                b.synchronize()
                if rep:  # rep 0 warms up
                    times[name].append(a.elapsed_time(b))
        whole = cuda_ms(lambda: trainer.render_scene(scene, ev, settings, bg, device=DEVICE), reps=5)
    med = {k: statistics.median(v) for k, v in times.items()}
    view_ms = statistics.median(whole)
    for name, ms in med.items():
        log(f"  {name:16s} {ms:9.4f} ms  ({100 * ms / view_ms:5.1f}% of the render)")
    log(f"  sum of stages    {sum(med.values()):9.4f} ms; whole render_scene {view_ms:.4f} ms (median of 5)")

    from torch.profiler import ProfilerActivity, profile

    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        trainer.render_scene(scene, ev, settings, bg, device=DEVICE)
        torch.cuda.synchronize()
    dev_time = lambda e: getattr(e, "self_device_time_total", 0.0)
    rows = sorted(
        (e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA and dev_time(e) > 0),
        key=dev_time, reverse=True,
    )
    busy_ms = sum(dev_time(e) for e in rows) / 1e3
    if not rows:
        log("  profiler: no device time recorded")
        return
    log(f"  profiler: {busy_ms:.4f} ms of kernel time in one render; busy share "
        f"{100 * busy_ms / view_ms:.1f}% of the unprofiled {view_ms:.4f} ms")
    for e in rows[:12]:
        log(f"    {dev_time(e) / 1e3:9.4f} ms  x{e.count:<4d} {e.key[:90]}")


# ------------------------------------------------------------ gradients
def grad_scenes():
    """The gradient phase's small scenes: tests/test_render.py::make_scene
    (150 splats with colors, and its SH variant) at 64x48, the occluder and
    wall freeze scenes, and the sentinel-at-chunk-boundary scene of
    tests/test_render.py:230 (600 splats at 256x192). name -> (means, cov,
    opacity, colors or SH, is_sh, settings kwargs)."""
    small = dict(width=64, height=48, tanfovx=math.tan(0.6), tanfovy=math.tan(0.45), sh_degree=3)
    cov6 = lambda s, q: quat.cov6_from_scaling_rotation(torch.as_tensor(s), torch.as_tensor(q)).numpy()
    means, scales, quats, opacity, colors, shs = small_scene(150)
    out = {
        "make_scene": (means, cov6(scales, quats), opacity, colors, False, small),
        "make_scene_sh": (means, cov6(scales, quats), opacity, shs, True, small),
    }
    for name, (means, scales, quats, opacity, colors) in freeze_scenes().items():
        out[name] = (means, cov6(scales, quats), opacity, colors, False, small)
    rng = np.random.default_rng(35)
    n = 600
    means = rng.normal(size=(n, 3)).astype(np.float32) * 1.2
    means[:, 2] += 4.0
    scales = np.exp(rng.normal(size=(n, 3)).astype(np.float32) * 0.6 - 3.6)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    opacity = (1 / (1 + np.exp(-rng.normal(size=n) - 0.5))).astype(np.float32)
    colors = rng.random(size=(n, 3)).astype(np.float32)
    out["boundary"] = (means, cov6(scales, quats), opacity, colors, False,
                       dict(width=256, height=192, tanfovx=math.tan(0.6), tanfovy=math.tan(0.47), sh_degree=0))
    return out


def render_grads(render_fn, sc, settings, device):
    """Gradients of a seeded linear loss of the image with respect to
    means, cov, opacity, the extrinsic and the colors or SH."""
    means, cov, opacity, feats, sh, _ = sc
    leaves = [torch.tensor(x, dtype=torch.float32, device=device, requires_grad=True)
              for x in (means, cov, opacity, EV_ID, feats)]
    kw = {"shs": leaves[4]} if sh else {"colors_precomp": leaves[4]}
    out = render_fn(*leaves[:4], settings, torch.tensor([0.2, 0.1, 0.4], device=device), **kw)
    w = np.random.default_rng(7).normal(size=(3, settings.height, settings.width)).astype(np.float32)
    (torch.as_tensor(w, device=device) * out["render"]).sum().backward()
    return [x.grad for x in leaves], out


def normalized_err(got, ref, floor=1e-3):
    """max|got - ref| / max(max|ref|, floor); the gradient bar's floor of
    tests/test_render.py:153 unless told otherwise."""
    got, ref = got.double().cpu(), ref.double().cpu()
    if not bool(torch.isfinite(got).all()):
        raise AssertionError("non-finite values")
    return float((got - ref).abs().max()) / max(float(ref.abs().max()), floor)


def check_grads(name, got, ref, tol=GRAD_TOL):
    names = ("means", "cov", "opacity", "extrinsic", "colors/SH")
    errs = [normalized_err(a, b) for a, b in zip(got, ref)]
    log(f"  {name}: normalized max err " + ", ".join(f"{n} {e:.2e}" for n, e in zip(names, errs)))
    bad = [n for n, e in zip(names, errs) if e > tol]
    if bad:
        raise AssertionError(f"{name}: gradients of {bad} exceed {tol:g}")


def _conv_forward_flags_only(img, window):
    """The SSIM convolution as the serving slice had it: cuDNN off around
    the forward only, so autograd's backward runs under the global flags."""
    c = img.shape[1]
    kernel = window.to(img.dtype).expand(c, 1, *window.shape).contiguous()
    with torch.backends.cudnn.flags(enabled=False):
        return F.conv2d(img, kernel, padding=window.shape[-1] // 2, groups=c)


def ssim_grad(a, b, device, dtype):
    x = torch.tensor(a, device=device, dtype=dtype, requires_grad=True)
    losses.ssim(x, torch.tensor(b, device=device, dtype=dtype)).backward()
    return x.grad


def small_scene_grads(packed: bool):
    """The card's render gradients on grad_scenes() against the oracle on
    the card and the CPU path; the kernel family's forward and backward
    each launch once per scene."""
    fwd, bwd = (tiles_packed.FORWARD_KERNEL, tiles_packed.BACKWARD_KERNEL) if packed else \
        (tiles.FORWARD_KERNEL, tiles.BACKWARD_KERNEL)
    for name, sc in grad_scenes().items():
        settings = RasterSettings(**sc[5], fast_grad=False, packed=packed)
        before = (fwd.launches, bwd.launches)
        g_card, _ = render_grads(rasterizer.render, sc, settings, DEVICE)
        torch.cuda.synchronize()
        assert (fwd.launches, bwd.launches) == (before[0] + 1, before[1] + 1), \
            f"the CUDA render did not launch {fwd.name} and {bwd.name} once each"
        g_cpu, _ = render_grads(rasterizer.render, sc, settings, "cpu")
        g_oracle, _ = render_grads(oracle.render_oracle, sc, settings, DEVICE)
        check_grads(f"{name} vs oracle (card)", g_card, g_oracle)
        check_grads(f"{name} vs CPU path", g_card, g_cpu)


def phase_grads():
    log("== phase 6: gradients on the card (small scenes) and the SSIM gradient")
    small_scene_grads(packed=True)
    # the clamped frame of tests/test_render.py:510-528
    sc = grad_scenes()["make_scene"]
    full = RasterSettings(**sc[5], instance_capacity=1 << 13)
    _, out = render_grads(rasterizer.render, sc, full, "cpu")
    clamp = dataclasses.replace(full, grad_capacity=max(int(out["grad_total"]) - 512, 128))
    g_card, out_c = render_grads(rasterizer.render, sc, clamp, DEVICE)
    g_cpu, _ = render_grads(rasterizer.render, sc, clamp, "cpu")
    assert int(out_c["grad_overflow"]) > 0, "the clamped frame did not clamp"
    check_grads(f"clamped frame (grad_overflow {int(out_c['grad_overflow'])}) vs CPU path", g_card, g_cpu)

    rng = np.random.default_rng(0)
    a = rng.random(size=(3, 1080, 1920)).astype(np.float32)
    b = np.clip(a + rng.normal(size=a.shape) * 0.05, 0, 1).astype(np.float32)
    ref = ssim_grad(a, b, "cpu", torch.float64)  # max|grad| ~6e-7: no floor
    err = normalized_err(ssim_grad(a, b, DEVICE, torch.float32), ref, floor=0.0)
    err_cpu = normalized_err(ssim_grad(a, b, "cpu", torch.float32), ref, floor=0.0)
    repaired = losses._depthwise_conv_same
    losses._depthwise_conv_same = _conv_forward_flags_only
    try:
        err_before = normalized_err(ssim_grad(a, b, DEVICE, torch.float32), ref, floor=0.0)
    finally:
        losses._depthwise_conv_same = repaired
    log(f"  SSIM gradient at 1080p vs float64 (normalized max err): card {err:.3e}, CPU fp32 {err_cpu:.3e}; "
        f"with cuDNN's backward under the global flags (cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}) "
        f"{err_before:.3e}")
    if err > 2e-5:
        raise AssertionError(f"SSIM gradient on the card is not fp32: {err:.3e}")


# ------------------------------------------------------------------- K2
def l1_cotangent(out_blocks, deg, complete):
    """The cotangent of bench.py's loss, L1 against a zero image, with
    respect to K1's blocks (through assemble_image)."""
    blocks = out_blocks.detach().clone().requires_grad_(True)
    img, _ = rasterizer.assemble_image(blocks, deg, complete, torch.zeros(3, device=blocks.device))
    (g,) = torch.autograd.grad(losses.l1_loss(img, torch.zeros_like(img)), blocks)
    return g.contiguous()


def compare_k2(name, args, totals, g, stats=None):
    """K2 vs backward_plain on identical inputs: rows 0-8 at normalized
    5e-4 per row, rows 9-15 exact. Returns (max abs err, K2 rows)."""
    got = tiles_packed.backward(*args, totals, g)
    torch.cuda.synchronize()
    ref = tiles_packed.backward_plain(*args, totals, g, stats=stats)
    torch.cuda.synchronize()
    errs = [normalized_err(got[r], ref[r]) for r in range(9)]
    abs_err = float((got[:9] - ref[:9]).abs().max())
    nonzero = int((got[:9] != 0).any(0).sum())
    log(f"  {name}: {nonzero} slots with nonzero rows; max abs err {abs_err:.3e}; normalized per row "
        + " ".join(f"{e:.1e}" for e in errs))
    if max(errs) > GRAD_TOL or not torch.equal(got[9:], ref[9:]):
        raise AssertionError(f"{name}: K2 disagrees with its plain version")
    return abs_err, got


def phase_k2(ctx, clock_mhz):
    log("== phase 7: K2 against its plain version")
    small = RasterSettings(width=64, height=48, tanfovx=math.tan(0.6), tanfovy=math.tan(0.45))
    scenes = grad_scenes()
    ev = torch.tensor(EV_ID, dtype=torch.float32, device=DEVICE)
    scenes["long-tile"] = (*long_tile_scene(), False, None)
    for name in ("occluder", "wall", "boundary", "long-tile"):
        means, cov, opacity, colors, _, kw = scenes[name]
        st = RasterSettings(**kw) if name == "boundary" else small
        t = lambda x: torch.as_tensor(x, device=DEVICE)
        args = staged_inputs(t(means), t(cov), t(opacity), ev, st, colors=t(colors))
        totals = tiles_packed.forward(*args)
        g = np.zeros(tuple(totals.shape), np.float32)
        g[:, :4] = np.random.default_rng(0).normal(size=g[:, :4].shape)
        _, got = compare_k2(f"{name} scene {st.width}x{st.height}", args, totals, torch.as_tensor(g, device=DEVICE))
        if name == "long-tile":
            if not torch.equal(got, tiles_packed.backward(*args, totals, torch.as_tensor(g, device=DEVICE))):
                raise AssertionError("K2 is not bitwise repeatable on the long-tile scene")
            log("  K2 run twice on the long-tile scene: bitwise equal")

    fields, tile_lo, meta, starts, ends = args = ctx.args
    totals = ctx.out
    g = l1_cotangent(totals, ctx.deg, ctx.complete)
    stats = {}
    err, got = compare_k2("bench frame 1920x1080 (L1 cotangent)", args, totals, g, stats)
    again = tiles_packed.backward(*args, totals, g)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError("K2 is not bitwise repeatable")
    log("  K2 run twice at the bench frame: bitwise equal")

    buf = torch.zeros_like(got)
    ms = cuda_ms(lambda: tiles_packed.launch_backward(fields, meta, starts, ends, totals, g, buf), reps=20)
    plain_ms = host_ms(lambda: tiles_packed.backward_plain(*args, totals, g))

    # the reduction after K2: d_table per column against a float64
    # index_add over the emitted positions, both fast_grad modes
    b = ctx.b
    rows = got.shape[1]
    total = int(b.emit_cum[-1])
    perm = b.perm[:rows].long()
    pos = torch.arange(rows, device=DEVICE)
    keep = (pos < total) & (perm < rows)
    owner = torch.searchsorted(b.emit_cum.long(), pos, right=True)
    d_pre = got[:9].T.double()[torch.clamp(perm, max=rows - 1)]
    ref = torch.zeros((b.emit_cum.shape[0], 9), dtype=torch.float64, device=DEVICE)
    ref.index_add_(0, owner[keep], d_pre[keep])
    red_err = {}
    for compensated in (False, True):
        d = rasterizer._reduce_instance_grads_packed(got, b.perm, b.emit_cum, compensated)
        col = (d[:, :9].double() - ref).abs().max(0).values
        red_err["exact" if compensated else "fast"] = col.tolist()
        log(f"  d_table vs float64 index_add, {'exact (compensated)' if compensated else 'fast_grad'}: "
            "max abs err per column " + " ".join(f"{v:.2e}" for v in col.tolist())
            + f"; column max |value| " + " ".join(f"{v:.2e}" for v in ref.abs().max(0).values.tolist()))
    red_ms = cuda_ms(lambda: rasterizer._reduce_instance_grads_packed(got, b.perm, b.emit_cum, False), reps=10)

    # the least time for K2's work at this frame: each walked slot's 10
    # staged rows read once, 7 block rows per pixel read, the 16 gradient
    # rows of the execution capacity written; every walked (pixel, slot)
    # pair's power in fp32, an exp for those the kernel's skip keeps, and a
    # log1p, an exp and a reciprocal per pair with alpha > 0, on the
    # special-function units
    t = starts.shape[0]
    bytes_moved = 10 * 4 * ctx.walked + 7 * 4 * t * 512 + 16 * 4 * rows + 2 * 4 * t
    log(f"  work: {ctx.walked} walked slots, {stats['pairs']} (pixel, slot) pairs, {stats['exp_pairs']} needing "
        f"their exp, {stats['alpha_pairs']} with alpha > 0")
    walk_lengths("bench frame", starts, ends, totals[:, 5, 0], ctx.complete)
    log(f"  (slot, pixel group) pairs with any alpha > 0: {stats['row_pairs']} of 32-pixel rows (K2's first warps: "
        f"{45 * stats['row_pairs']} shuffles at 45 each), {stats['warp_pairs']} of 16x4 regions (the "
        f"redesign's warps: {12 * stats['warp_pairs']} shuffles at 12 each)")
    bound, bound_by = roofline(bytes_moved, stats["exp_pairs"] + 3 * stats["alpha_pairs"],
                               12 * stats["pairs"] + 40 * stats["alpha_pairs"], clock_mhz)
    log(f"  K2 {statistics.median(ms):.4f} ms median of {len(ms)} (min {min(ms):.4f}); "
        f"plain {statistics.median(plain_ms):.1f} ms median of 3; reduction (fast_grad) "
        f"{statistics.median(red_ms):.4f} ms median of {len(red_ms)}")
    return {
        "name": "tiles_packed_bwd",
        "route": "cuda",
        "source": "c3dgs_tpu_torch/csrc/tiles_packed_bwd.cu",
        "replaces": tiles_packed.BACKWARD_KERNEL.replaces,
        "launches": None,  # filled from the training run
        "max_abs_err": err,
        "ms": statistics.median(ms),
        "plain_ms": statistics.median(plain_ms),
        "bound_ms": bound,
        "bound_by": bound_by,
        "library_ms": None,  # no single PyTorch call computes the blend's gradient
    }, statistics.median(red_ms)


# -------------------------------------------------------------- fwd+bwd
def device_busy_ms(fn):
    """Kernel time the profiler saw during fn() (0.0 if it saw none)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    dev_time = lambda e: getattr(e, "self_device_time_total", 0.0)
    rows = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA and dev_time(e) > 0]
    return sum(dev_time(e) for e in rows) / 1e3, sorted(rows, key=dev_time, reverse=True)


def phase_fwd_bwd(scene, settings, bwd_ms, red_ms, phase=8):
    """bench.py's metric on the card: one forward and the gradients of the
    L1 loss against a zero image with respect to the 7 scene parameters,
    through the kernel family `settings.packed` selects; bwd_ms and red_ms
    are its backward kernel's and its reduction's times at this frame."""
    fwd_k, bwd_k = (tiles_packed.FORWARD_KERNEL, tiles_packed.BACKWARD_KERNEL) if settings.packed else \
        (tiles.FORWARD_KERNEL, tiles.BACKWARD_KERNEL)
    log(f"== phase {phase}: fwd+bwd at the bench frame (bench.py's metric), packed={settings.packed}")
    ev = torch.tensor(EV_ID, dtype=torch.float32, device=DEVICE)
    bg = torch.zeros(3, device=DEVICE)
    params = list(trainer.scene_params(scene).values())
    zeros = torch.zeros((3, settings.height, settings.width), device=DEVICE)
    ev_t = [torch.cuda.Event(enable_timing=True) for _ in range(3)]

    def step(events=None):
        if events:
            events[0].record()
        out = trainer.render_scene(scene, ev, settings, bg, device=DEVICE)
        loss = losses.l1_loss(out["render"], zeros)
        if events:
            events[1].record()
        grads = torch.autograd.grad(loss, params)
        if events:
            events[2].record()
        return out, grads

    kernels.reset_counts()
    out, grads = step()
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in kernels.REGISTRY.values() if k.launches}
    assert int(out["overflow"]) == 0 and int(out["grad_overflow"]) == 0, "bench frame degraded"
    assert all(bool(torch.isfinite(x).all()) for x in grads), "non-finite gradients"
    assert launches == {fwd_k.name: 1, bwd_k.name: 1}, launches
    log(f"  one step: overflow 0, grad_overflow 0, finite gradients; kernel launches {launches}")
    _, again = step()
    if not all(torch.equal(a, b) for a, b in zip(grads, again)):
        raise AssertionError("the fwd+bwd gradients are not bitwise repeatable")
    log("  a second step gives bitwise-equal gradients for all 7 parameters")
    ms = cuda_ms(step, reps=10)
    fwd, bwd = [], []
    for _ in range(5):
        step(ev_t)
        ev_t[2].synchronize()
        fwd.append(ev_t[0].elapsed_time(ev_t[1]))
        bwd.append(ev_t[1].elapsed_time(ev_t[2]))
    step_ms = statistics.median(ms)
    f, b = statistics.median(fwd), statistics.median(bwd)
    rest = b - bwd_ms - red_ms
    log(f"  fwd+bwd {step_ms:.4f} ms median of {len(ms)} (min {min(ms):.4f})")
    for name, v in (("forward (render + loss)", f), ("backward, whole", b), (f"  {bwd_k.name}", bwd_ms),
                    ("  reduction", red_ms), ("  rest of autograd", rest)):
        log(f"  {name:26s} {v:9.4f} ms  ({100 * v / step_ms:5.1f}% of the step)")
    busy, rows = device_busy_ms(step)
    if not rows:
        log("  profiler: no device time recorded")
    else:
        log(f"  profiler: {busy:.4f} ms of kernel time in one step; busy share {100 * busy / step_ms:.1f}% "
            f"of the unprofiled {step_ms:.4f} ms")
        for e in rows[:12]:
            log(f"    {getattr(e, 'self_device_time_total', 0.0) / 1e3:9.4f} ms  x{e.count:<4d} {e.key[:90]}")
    return step_ms


# ---------------------------------------------------------------- train
def probe_policy(scene, base, ev, bg):
    """A capacity policy seeded with bench.py's probe-exact buckets for the
    scene as it is now."""
    with torch.no_grad():
        probe = trainer.render_scene(scene, ev, CapacityPolicy().apply(base), bg, device=DEVICE)
    return CapacityPolicy(initial=int(probe["num_instances"]) + base.num_tiles,
                          grad_initial=int(probe["grad_total"]))


def phase_train(scene, base):
    log("== phase 9: train the 300k scene (quantization on, SH degree 3)")
    ev = torch.tensor(EV_ID, dtype=torch.float32, device=DEVICE)
    bg = torch.zeros(3, device=DEVICE)
    n = scene.capacity
    # spare rows for densification, then quantization-aware training
    tscene = scene.pad_to_capacity(n + 32_768)
    tscene.quantization = True
    tscene.update_observers()
    with torch.no_grad():
        tscene.opacity += 1.0
        target = trainer.render_scene(tscene, ev, base, bg, device=DEVICE)["render"].clone()
        tscene.opacity -= 1.0
    policy = probe_policy(tscene, base, ev, bg)
    log(f"  probe-exact buckets: slots {policy.capacity}, execution {policy.grad_capacity}")
    opt = OptimizationParams()
    kernels.reset_counts()
    state = trainer.create_train_state(tscene, opt, spatial_lr_scale=1.0, device=DEVICE)
    hist, step_ms = [], []
    probes = 0

    def run(k):
        # the buckets follow the scene as it trains: the capacity policy
        # grows them (with its 1.3 headroom) after a step that needed more
        nonlocal state
        for _ in range(k):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            state, m = trainer.train_step(state, ev, target, policy.apply(base), bg, opt, 1.0, device=DEVICE)
            b.record()
            b.synchronize()
            step_ms.append(a.elapsed_time(b))
            hist.append((float(m["loss"]), int(m["overflow"]), int(m["grad_overflow"]), int(m["num_instances"]),
                         policy.capacity, policy.grad_capacity))
            policy.update(hist[-1][3], hist[-1][1], int(m["grad_total"]), hist[-1][2])

    run(10)
    log(f"  losses: {[round(h[0], 6) for h in hist]}")
    accum = state.stats.xyz_gradient_accum / torch.clamp(state.stats.denom, min=1.0)
    free = int((~state.scene.active).sum())
    k = min(free // 3, int((accum > 0).sum()) // 4)
    thr = float(torch.topk(accum, k).values[-1])
    assert thr > 0, "no splat has a densify gradient"
    n_before = int(state.scene.num_active)
    state, dropped = trainer.densify_step(state, 4.0, dataclasses.replace(opt, densify_grad_threshold=thr),
                                          device=DEVICE)
    log(f"  densify_step (threshold {thr:.3e}, the {k}-th largest mean gradient; extent 4.0): active "
        f"{n_before} -> {int(state.scene.num_active)}, rows written into the {free} free rows "
        f"{int(state.scene.active[n:].sum())}, dropped {int(dropped)}")
    new_cap = _bucket(state.scene.capacity + 1)
    state = trainer.grow_capacity(state, new_cap, device=DEVICE)
    state = trainer.reset_opacity_step(state, device=DEVICE)
    policy = probe_policy(state.scene, base, ev, bg)
    probes += 1
    log(f"  grow_capacity -> {state.scene.capacity}; reset_opacity_step; probe-exact buckets: slots "
        f"{policy.capacity}, execution {policy.grad_capacity}")
    run(2)
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in kernels.REGISTRY.values()}
    log(f"  losses after: {[round(h[0], 6) for h in hist[10:]]}")
    log(f"  per step (instances, slot bucket, execution bucket): {[(h[3], h[4], h[5]) for h in hist]}")
    log(f"  kernel launches over {len(hist)} train_steps and {probes} bucket probe: {launches}")
    log(f"  ms per train_step: {[round(m, 3) for m in step_ms]}; median of steps 2-10 "
        f"{statistics.median(step_ms[1:10]):.3f}")
    assert all(math.isfinite(h[0]) for h in hist), "non-finite loss"
    assert hist[9][0] < hist[0][0], "the loss did not fall over 10 steps"
    assert all(h[1] == 0 and h[2] == 0 for h in hist), f"overflow in training: {hist}"
    assert launches["tiles_packed_bwd"] == len(hist), launches
    assert launches["tiles_packed_fwd"] == len(hist) + probes, launches
    return launches, statistics.median(step_ms[1:10])


# ------------------------------------------------------- per-tile: K3
def per_tile_args(prep, b, settings):
    """K3's inputs as rasterizer.render stages them with packed=False:
    (fields, tile_ids, starts, ends, nchunks), and grad_base."""
    fields = rasterizer._build_fields(per_gaussian_table(prep, b.offset), b.gid_sorted, b.j_sorted)
    tile_ids = torch.arange(settings.num_tiles, dtype=torch.int32, device=fields.device)
    return (fields, tile_ids, b.starts, b.ends, b.nchunks), b.grad_base


def per_tile_small_scenes():
    """The occluder, wall and boundary scenes of grad_scenes(), staged for
    the per-tile kernels: name -> (K3's args, grad_base, settings, the
    grad capacity)."""
    out = {}
    ev = torch.tensor(EV_ID, dtype=torch.float32, device=DEVICE)
    scenes = grad_scenes()
    for name in ("occluder", "wall", "boundary"):
        means, cov, opacity, colors, _, kw = scenes[name]
        st = RasterSettings(**kw, packed=False)
        t = lambda x: torch.as_tensor(x, device=DEVICE)
        prep = preprocess(t(means), t(cov), t(opacity), ev, st, None, t(colors))
        out[name] = (*per_tile_args(prep, bin_gaussians(prep, st), st), st, st.resolve_grad_cap(len(means)))
    return out


def compare_k3(name, args, tiles_x, stats=None):
    """K3 vs forward_plain on identical inputs: rows 0-4 within 2e-5 abs +
    1e-4 rel, `stop` (row 5) and rows 6-7 exactly equal."""
    out_k = tiles.forward(*args, tiles_x)
    torch.cuda.synchronize()
    out_p = tiles.forward_plain(*args, tiles_x, stats=stats)
    torch.cuda.synchronize()
    nch = args[4].float()
    stopped = int((out_p[:, 5, 0] < nch).sum())
    mism = int((out_k[:, 5] != out_p[:, 5]).any(1).sum())
    log(f"  {name}: {nch.shape[0]} tiles, {int((nch > 0).sum())} with instances, {stopped} stopped early by "
        f"the saturation exit; {mism} stop mismatches")
    if not torch.equal(out_k[:, 5:], out_p[:, 5:]):
        raise AssertionError(f"{name}: K3's stop row or rows 6-7 differ from its plain version")
    err = check_close(f"{name} rows 0-4", out_k[:, :5], out_p[:, :5], 2e-5, 1e-4)
    return err, out_k


def phase_k3(scene, settings, clock_mhz):
    log("== phase 10: K3 (per-tile forward) against its plain version")
    for name, (args, _, st, _) in per_tile_small_scenes().items():
        compare_k3(f"{name} scene {st.width}x{st.height}", args, st.tiles_x)

    # the bench frame with probe-exact per-tile buckets: phase 3's slot
    # bucket, and a grad bucket sized from the per-tile grad_total
    ev = torch.tensor(EV_ID, dtype=torch.float32, device=DEVICE)
    bg = torch.zeros(3, device=DEVICE)
    base = dataclasses.replace(settings, packed=False, grad_capacity=0)
    with torch.no_grad():
        probe = trainer.render_scene(scene, ev, base, bg, device=DEVICE)
        need, grad_need = int(probe["num_instances"]), int(probe["grad_total"])
        settings = CapacityPolicy(initial=need + base.num_tiles, grad_initial=grad_need).apply(base)
        chk = trainer.render_scene(scene, ev, settings, bg, device=DEVICE)
        assert int(chk["overflow"]) == 0 and int(chk["grad_overflow"]) == 0, "per-tile bench frame degraded"
        log(f"  bench frame, packed=False: {need} instances -> slot bucket {settings.instance_capacity}; "
            f"per-tile grad_total {grad_need} -> grad bucket {settings.grad_capacity}")
        deg = trainer.settings_with_degree(settings, scene.active_sh_degree)
        prep = preprocess(scene.get_xyz(), scene.get_covariance(), scene.get_opacity()[:, 0], ev, deg,
                          scene.get_features())
        b = bin_gaussians(prep, deg)
        args, grad_base = per_tile_args(prep, b, deg)
        stats = {}
        err, out_k = compare_k3("bench frame 1920x1080", args, deg.tiles_x, stats)
        out = torch.empty_like(out_k)
        ms = cuda_ms(lambda: tiles.launch(*args, deg.tiles_x, out), reps=20)
        plain_ms = host_ms(lambda: tiles.forward_plain(*args, deg.tiles_x))

    # the least time for this frame's work: each instance of a window
    # walked before `stop` read once (9 f32 rows), the four (T,) int
    # arrays read, the blocks written; every walked (pixel, instance) pair
    # one exp, and those with alpha > 0 a log1p and an exp more, on the
    # special-function units
    _, _, starts, ends, nch = args
    stop = out_k[:, 5, 0].long()
    walked = int(torch.minimum((ends - starts).long(), stop * 128).sum())
    t = starts.shape[0]
    bytes_moved = 9 * 4 * walked + 4 * 4 * t + t * 8 * 512 * 4
    log(f"  work: {walked} walked instances in {int(torch.minimum(stop, nch.long()).sum())} windows, "
        f"{stats['pairs']} (pixel, instance) pairs, {stats['exp_pairs']} needing their exp "
        f"({stats['exp_pairs'] / stats['pairs']:.1%}), {stats['alpha_pairs']} with alpha > 0")
    flops = 12 * stats["pairs"] + 11 * stats["alpha_pairs"]
    bound, bound_by = roofline(bytes_moved, stats["exp_pairs"] + 2 * stats["alpha_pairs"], flops, clock_mhz)
    log(f"  K3 bound {bound:.4f} ms ({bound_by}); {old_bound(bytes_moved, stats, 2, flops, clock_mhz):.4f} ms "
        "when every pair's exp was counted")
    log(f"  K3 {statistics.median(ms):.4f} ms median of {len(ms)} (min {min(ms):.4f}); "
        f"plain {statistics.median(plain_ms):.1f} ms median of 3")
    return {
        "name": "tiles_fwd",
        "route": "cuda",
        "source": "c3dgs_tpu_torch/csrc/tiles_fwd.cu",
        "replaces": tiles.FORWARD_KERNEL.replaces,
        "launches": None,  # filled from the per-tile serve and training runs
        "max_abs_err": err,
        "ms": statistics.median(ms),
        "plain_ms": statistics.median(plain_ms),
        "bound_ms": bound,
        "bound_by": bound_by,
        "library_ms": None,  # no single PyTorch call composites tiles
    }, settings, SimpleNamespace(args=args, grad_base=grad_base, out=out_k, b=b, deg=deg, walked=walked)


# ------------------------------------------------------- per-tile: K4
def compare_k4(name, args, grad_base, totals, g, tiles_x, grad_cap, stats=None):
    """K4 vs backward_plain on identical inputs: rows 0-8 at normalized
    5e-4 per row, rows 9-15 exact. Returns (max abs err, K4 rows)."""
    got = tiles.backward(*args, grad_base, totals, g, tiles_x, grad_cap)
    torch.cuda.synchronize()
    ref = tiles.backward_plain(*args, grad_base, totals, g, tiles_x, grad_cap, stats=stats)
    torch.cuda.synchronize()
    errs = [normalized_err(got[r], ref[r]) for r in range(9)]
    abs_err = float((got[:9] - ref[:9]).abs().max())
    nonzero = int((got[:9] != 0).any(0).sum())
    log(f"  {name}: {nonzero} columns with nonzero rows; max abs err {abs_err:.3e}; normalized per row "
        + " ".join(f"{e:.1e}" for e in errs))
    if max(errs) > GRAD_TOL or not torch.equal(got[9:], ref[9:]):
        raise AssertionError(f"{name}: K4 disagrees with its plain version")
    return abs_err, got


def phase_k4(scene, ctx, clock_mhz):
    log("== phase 11: K4 (per-tile backward) against its plain version")
    for name, (args, grad_base, st, grad_cap) in per_tile_small_scenes().items():
        totals = tiles.forward(*args, st.tiles_x)
        g = np.zeros(tuple(totals.shape), np.float32)
        g[:, :4] = np.random.default_rng(0).normal(size=g[:, :4].shape)
        compare_k4(f"{name} scene {st.width}x{st.height}", args, grad_base, totals, torch.as_tensor(g, device=DEVICE),
                   st.tiles_x, grad_cap)

    args, grad_base, totals, deg, b = ctx.args, ctx.grad_base, ctx.out, ctx.deg, ctx.b
    tx = deg.tiles_x
    grad_cap = deg.resolve_grad_cap(scene.capacity)
    g = l1_cotangent(totals, deg, None)
    stats = {}
    err, got = compare_k4("bench frame 1920x1080 (L1 cotangent)", args, grad_base, totals, g, tx, grad_cap, stats)
    again = tiles.backward(*args, grad_base, totals, g, tx, grad_cap)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError("K4 is not bitwise repeatable")
    log("  K4 run twice at the bench frame: bitwise equal")

    # a clamped frame: 64 chunks fewer than the windows need, so windows
    # of the last tiles clamp into the last chunk and only the TPU grid's
    # last writer may fill it
    grad_total = int(b.grad_total)
    clamp_cap = grad_total - 64 * 128
    ref = tiles.backward_plain(*args, grad_base, totals, g, tx, clamp_cap)
    for run in (1, 2):
        got_c = tiles.backward(*args, grad_base, totals, g, tx, clamp_cap)
        torch.cuda.synchronize()
        errs = [normalized_err(got_c[r], ref[r]) for r in range(9)]
        same = torch.equal(got_c[9:], ref[9:])
        if run == 2 and not torch.equal(got_c, first):
            raise AssertionError("K4 on the clamped frame is not bitwise repeatable")
        first = got_c
        log(f"  clamped frame (grad_cap {clamp_cap} < grad_total {grad_total}), run {run}: tag rows "
            f"{'bitwise equal' if same else 'DIFFERENT'} to the plain version's; normalized per row "
            + " ".join(f"{e:.1e}" for e in errs))
        if not same or max(errs) > GRAD_TOL:
            raise AssertionError("K4 on the clamped frame disagrees with its plain version")
    log("  K4 run twice on the clamped frame: bitwise equal")

    buf = torch.zeros_like(got)
    ms = cuda_ms(lambda: tiles.launch_backward(*args, grad_base, totals, g, tx, buf), reps=20)
    plain_ms = host_ms(lambda: tiles.backward_plain(*args, grad_base, totals, g, tx, grad_cap))

    # the per-tile reduction: d_table per column against a float64
    # index_add over the rows keyed by a pre-sort slot, both modes
    cap = args[0].shape[1]
    key = got[9].long()
    keep = (key >= 0) & (key < cap)
    owner = torch.searchsorted(b.emit_cum.long(), key[keep], right=True)
    ref64 = torch.zeros((b.emit_cum.shape[0], 9), dtype=torch.float64, device=DEVICE)
    ref64.index_add_(0, owner, got[:9, keep].T.double())
    for compensated in (False, True):
        d = rasterizer._reduce_instance_grads(got, b.emit_cum, cap, 0, b.grad_total, True, compensated)
        col = (d[:, :9].double() - ref64).abs().max(0).values
        log(f"  d_table vs float64 index_add, {'exact (compensated)' if compensated else 'fast_grad'}: "
            "max abs err per column " + " ".join(f"{v:.2e}" for v in col.tolist())
            + "; column max |value| " + " ".join(f"{v:.2e}" for v in ref64.abs().max(0).values.tolist()))
    red_ms = cuda_ms(lambda: rasterizer._reduce_instance_grads(got, b.emit_cum, cap, 0, b.grad_total, True),
                     reps=10)

    # the least time for K4's work at this frame: each walked instance's
    # 10 staged rows read once, 7 block rows per pixel read, the 16 rows of
    # the grad buffer written, the five (T,) int arrays read; one exp per
    # walked (pixel, instance) pair, and a log1p, an exp and a reciprocal
    # per pair with alpha > 0, on the special-function units
    t = args[2].shape[0]
    bytes_moved = 10 * 4 * ctx.walked + 7 * 4 * t * 512 + 16 * 4 * grad_cap + 5 * 4 * t
    log(f"  work: {ctx.walked} walked instances, {stats['pairs']} (pixel, instance) pairs, "
        f"{stats['exp_pairs']} needing their exp, {stats['alpha_pairs']} with alpha > 0; "
        f"grad buffer {grad_cap} columns")
    flops = 12 * stats["pairs"] + 40 * stats["alpha_pairs"]
    bound, bound_by = roofline(bytes_moved, stats["exp_pairs"] + 3 * stats["alpha_pairs"], flops, clock_mhz)
    log(f"  K4 bound {bound:.4f} ms ({bound_by}); {old_bound(bytes_moved, stats, 3, flops, clock_mhz):.4f} ms "
        "when every pair's exp was counted")
    log(f"  K4 {statistics.median(ms):.4f} ms median of {len(ms)} (min {min(ms):.4f}); "
        f"plain {statistics.median(plain_ms):.1f} ms median of 3; reduction (fast_grad) "
        f"{statistics.median(red_ms):.4f} ms median of {len(red_ms)}")
    return {
        "name": "tiles_bwd",
        "route": "cuda",
        "source": "c3dgs_tpu_torch/csrc/tiles_bwd.cu",
        "replaces": tiles.BACKWARD_KERNEL.replaces,
        "launches": None,  # filled from the per-tile training run
        "max_abs_err": err,
        "ms": statistics.median(ms),
        "plain_ms": statistics.median(plain_ms),
        "bound_ms": bound,
        "bound_by": bound_by,
        "library_ms": None,  # no single PyTorch call computes the blend's gradient
    }, statistics.median(red_ms)


# ---------------------------------------------------- per-tile: paths
def phase_serve_per_tile(scene, cams):
    log("== phase 12: serve the 8 orbit poses with packed=False (render_and_eval, inference=True)")
    base = settings_from_intrinsic(cams[0].intrinsic, inference=True, packed=False)
    policy = CapacityPolicy()
    for cam in cams:  # warm-up: the policy's buckets settle
        metrics.render_full(scene, cam.extrinsic_vector, base, np.zeros(3), policy, device=DEVICE)
    errs, per_view_ms = [], []
    for cam in cams:
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        out = metrics.render_full(scene, cam.extrinsic_vector, base, np.zeros(3), policy, device=DEVICE)
        b.record()
        b.synchronize()
        per_view_ms.append(a.elapsed_time(b))
        assert int(out["overflow"]) == 0 and int(out["grad_overflow"]) == 0, \
            f"{cam.image_name}: overflow {int(out['overflow'])}, grad_overflow {int(out['grad_overflow'])}"
        errs.append(check_close(f"{cam.image_name} per-tile vs packed image", out["render"], cam.original_image,
                                2e-5, 1e-4))
    log(f"  8 views: overflow 0, grad_overflow 0; max |per-tile - packed| {max(errs):.3e}")
    log(f"  per-view ms: {[round(m, 3) for m in per_view_ms]}; median {statistics.median(per_view_ms):.3f}")
    kernels.reset_counts()
    results = metrics.render_and_eval(scene, cams, device=DEVICE, packed=False)
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in kernels.REGISTRY.values()}
    log(f"  render_and_eval: psnr {[v['psnr'] for v in results['per_view'].values()]}")
    log(f"  renders {results['num_renders']}; kernel launches {launches}")
    assert results["num_views"] == 8
    for name, v in results["per_view"].items():
        assert v["psnr"] > 60 and v["ssim"] > 0.9999, f"{name}: per-tile image differs from the packed one: {v}"
    assert launches["tiles_fwd"] == results["num_renders"], "K3 launches != renders"
    assert launches["tiles_packed_fwd"] == 0 and launches["tiles_bwd"] == 0, launches
    return launches


def phase_grads_per_tile():
    log("== phase 13: per-tile gradients on the card (packed=False, small scenes)")
    small_scene_grads(packed=False)


def phase_train_per_tile(scene, base, steps=4):
    log(f"== phase 15: train the 300k scene with packed=False ({steps} steps, quantization on, SH degree 3)")
    ev = torch.tensor(EV_ID, dtype=torch.float32, device=DEVICE)
    bg = torch.zeros(3, device=DEVICE)
    tscene = scene.pad_to_capacity(scene.capacity + 1024)
    tscene.quantization = True
    tscene.update_observers()
    with torch.no_grad():
        tscene.opacity += 1.0
        target = trainer.render_scene(tscene, ev, base, bg, device=DEVICE)["render"].clone()
        tscene.opacity -= 1.0
    policy = probe_policy(tscene, base, ev, bg)
    log(f"  probe-exact buckets: slots {policy.capacity}, per-tile grad {policy.grad_capacity}")
    opt = OptimizationParams()
    kernels.reset_counts()
    state = trainer.create_train_state(tscene, opt, spatial_lr_scale=1.0, device=DEVICE)
    hist, step_ms = [], []
    for _ in range(steps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        state, m = trainer.train_step(state, ev, target, policy.apply(base), bg, opt, 1.0, device=DEVICE)
        b.record()
        b.synchronize()
        step_ms.append(a.elapsed_time(b))
        hist.append((float(m["loss"]), int(m["overflow"]), int(m["grad_overflow"])))
        policy.update(int(m["num_instances"]), hist[-1][1], int(m["grad_total"]), hist[-1][2])
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in kernels.REGISTRY.values()}
    log(f"  losses: {[round(h[0], 6) for h in hist]}")
    log(f"  kernel launches over {steps} train_steps: {launches}")
    log(f"  ms per train_step: {[round(m, 3) for m in step_ms]}; median of steps 2-{steps} "
        f"{statistics.median(step_ms[1:]):.3f}")
    assert all(math.isfinite(h[0]) for h in hist), "non-finite loss"
    assert hist[-1][0] < hist[0][0], "the loss did not fall"
    assert all(h[1] == 0 and h[2] == 0 for h in hist), f"overflow in training: {hist}"
    assert launches["tiles_bwd"] == steps and launches["tiles_fwd"] == steps, launches
    assert launches["tiles_packed_fwd"] == 0 and launches["tiles_packed_bwd"] == 0, launches
    return launches


# --------------------------------------------------------- DMA probes
def phase_probes():
    """P1-P3 through the probe tool's entry point, with the kernel counts
    reset just before and read just after; then each kernel against its
    plain version on the tool's inputs and on seeded ones, its time from
    CUDA events (median of 20) against its byte bound, its plain version's
    and, where one PyTorch call computes the same function, that call's."""
    log("== phase 16: the DMA probes (python -m c3dgs_tpu_torch.tools.dma_probe)")
    probe_kernels = (dma_probe.PROBE1_KERNEL, dma_probe.PROBE2_KERNEL, dma_probe.PROBE3_KERNEL)
    kernels.reset_counts()
    rc = dma_probe.main()
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in kernels.REGISTRY.values() if k.launches}
    log(f"  entry point returned {rc}; kernel launches {launches}")
    assert rc == 0 and set(launches) == {k.name for k in probe_kernels}, launches

    rng = np.random.default_rng(0)
    arange = lambda shape: torch.arange(math.prod(shape), dtype=torch.float32, device=DEVICE).reshape(shape)
    seeded = lambda shape: torch.as_tensor(rng.uniform(0.5, 1.5, size=shape), dtype=torch.float32, device=DEVICE)
    inputs = {
        "dma_probe1": [arange((dma_probe.P1_CAP, 16)), seeded((dma_probe.P1_CAP, 16))],
        "dma_probe2": [arange((dma_probe.P2_TILES, 8, 512)), seeded((dma_probe.P2_TILES, 8, 512))],
        "dma_probe3": [torch.ones((16, dma_probe.P3_CHUNKS * 128), device=DEVICE),
                       seeded((16, dma_probe.P3_CHUNKS * 128))],
    }
    errs = {}
    for x in inputs["dma_probe1"]:
        got, ref = dma_probe.scale_chunks(x).cpu(), dma_probe.probe1_plain(x.cpu())
        assert torch.equal(got, ref), "P1 differs from its plain version"
        errs["dma_probe1"] = 0.0
    for x in inputs["dma_probe2"]:
        got, ref = dma_probe.add_blocks(x).cpu(), dma_probe.probe2_plain(x.cpu())
        assert torch.equal(got, ref), "P2 differs from its plain version"
        errs["dma_probe2"] = 0.0
    err3 = 0.0
    for i, x in enumerate(inputs["dma_probe3"]):
        for do_t in (False, True):
            out, sums = dma_probe.chunk_sums(x, do_t)
            ref_out, ref_sums = dma_probe.probe3_plain(x.cpu(), do_t)
            for what, got, ref in (("output", out.cpu(), ref_out), ("chunk sums", sums.cpu(), ref_sums)):
                err3 = max(err3, check_close(f"P3 transpose={do_t} input {i} {what}", got, ref, 0.0,
                                             dma_probe.P3_RTOL))
            if i == 0:
                assert bool((out == 256.0).all()), "P3 on the tool's all-ones input must give 256.0"
    errs["dma_probe3"] = err3
    log("  P1 and P2 bitwise equal to their plain versions on the tool's and seeded inputs; "
        "P3 256.0 on the tool's input")

    x1, x2, x3 = inputs["dma_probe1"][0], inputs["dma_probe2"][0], inputs["dma_probe3"][0]
    o1, o2 = torch.empty_like(x1), torch.empty_like(x2)
    sums, o3 = torch.empty(dma_probe.P3_CHUNKS, device=DEVICE), torch.empty((1, 128), device=DEVICE)
    stream = torch.cuda.current_stream().cuda_stream
    launch1 = lambda: dma_probe.PROBE1_KERNEL.launch(x1.data_ptr(), o1.data_ptr(), x1.shape[0] // 128, stream)
    launch2 = lambda: dma_probe.PROBE2_KERNEL.launch(x2.data_ptr(), o2.data_ptr(), x2.shape[0], stream)
    timed = {
        "dma_probe1": (launch1, lambda: dma_probe.probe1_plain(x1), lambda: torch.mul(x1, 2.0),
                       2 * x1.numel() * 4),
        "dma_probe2": (launch2, lambda: dma_probe.probe2_plain(x2), lambda: torch.add(x2, 1.0),
                       2 * x2.numel() * 4),
        "dma_probe3": (lambda: dma_probe.launch3(x3, False, sums, o3), lambda: dma_probe.probe3_plain(x3, False),
                       None, x3.numel() * 4 + sums.numel() * 4 + o3.numel() * 4),
    }
    # launch overhead: back-to-back launches of P1, the lightest kernel
    reps = 200
    launch1()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        launch1()
    b.record()
    b.synchronize()
    overhead = a.elapsed_time(b) / reps
    log(f"  launch overhead: {overhead * 1e3:.2f} us per P1 launch over {reps} back-to-back launches")
    out = []
    dev = torch.device(DEVICE)
    for k in probe_kernels:
        launch, plain, library, nbytes = timed[k.name]
        ms = dma_probe.median_ms(launch, dev)
        plain_ms = dma_probe.median_ms(plain, dev)
        library_ms = dma_probe.median_ms(library, dev) if library else None
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        log(f"  {k.name}: {ms:.4f} ms median of 20; bound {bound:.6f} ms ({nbytes} B); plain {plain_ms:.4f} ms"
            + (f"; library {library_ms:.4f} ms" if library else ""))
        out.append({
            "name": k.name,
            "route": "cuda",
            "source": "c3dgs_tpu_torch/csrc/dma_probe.cu",
            "replaces": k.replaces,
            "launches": launches[k.name],
            "max_abs_err": errs[k.name],
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bound,
            "bound_by": "bytes",
            "library_ms": library_ms,  # P1: torch.mul, P2: torch.add; P3 has no single call
            "launch_overhead_ms": overhead,
        })
    # P1 against torch.mul and P2 against torch.add in turns: 5 rounds, each
    # the kernel's then the library call's median of 20
    for i, library_name in enumerate(("torch.mul", "torch.add")):
        launch, _, library, _ = timed[probe_kernels[i].name]
        rounds = [(dma_probe.median_ms(launch, dev), dma_probe.median_ms(library, dev)) for _ in range(5)]
        lost = sum(a > b for a, b in rounds)
        log(f"  {probe_kernels[i].name} vs {library_name} in turns (ms): "
            + ", ".join(f"{a:.4f} / {b:.4f}" for a, b in rounds) + f"; the kernel slower in {lost} of 5")
        out[i]["rounds"] = rounds
    ms_t = dma_probe.median_ms(lambda: dma_probe.launch3(x3, True, sums, o3), dev)
    out[2]["ms_transpose"] = ms_t
    log(f"  P3 with the shared-memory transpose: {ms_t:.4f} ms; cost "
        f"{(ms_t - out[2]['ms']) / dma_probe.P3_CHUNKS * 1e6:.1f} ns per chunk")
    return out



# -------------------------------------------------------- compression
NPZ_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke"


def view_ms(scene, cams, policy):
    """Per-view ms (CUDA events) of render_full over the cameras."""
    out = []
    for cam in cams:
        settings = settings_from_intrinsic(cam.intrinsic, inference=True)
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        metrics.render_full(scene, cam.extrinsic_vector, settings, np.zeros(3), policy, device=DEVICE)
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b))
    return out


def phase_compress(scene, cams, serve_ms, finetune_steps=12):
    """Compress the bench scene as compress.py does (to_compressed ->
    finetune -> save_npz -> load_npz -> render_and_eval) with the default
    CompressionParams; the finetune's depth is cut from 5,000 steps. The
    8 orbit views of phase 4 are the cameras, their uncompressed renders
    the images. Each stage runs with the kernel counts reset just before
    and read just after; returns the summed launches."""
    log(f"== phase 17: compress the 300k scene (to_compressed, finetune {finetune_steps} steps, save_npz, "
        "load_npz, render_and_eval)")
    comp = CompressionParams()
    # the bench scene with shapes as a trained scene has them: its kNN init
    # leaves every splat isotropic with the identity rotation, so every
    # normalized covariance is the same and the covariance VQ would need
    # one codebook row. Random rotations and scale directions from a third
    # seed; quantization on, as compress.py loads a trained scene. Phase
    # 4's renders of the bench scene stand in for the photos (sensitivity
    # and finetune), which the reshaped scene matches only roughly, as a
    # trained scene matches its photos: against its own renders every
    # photometric gradient would be zero. The reshaped scene's renders are
    # the uncompressed reference the served npz is scored against.
    src = scene.clone()
    rng = np.random.default_rng(2)
    with torch.no_grad():
        src.rotation.copy_(torch.as_tensor(rng.normal(size=tuple(src.rotation.shape)), dtype=torch.float32))
        src.scaling.copy_(torch.as_tensor(np.abs(rng.normal(size=tuple(src.scaling.shape))) + 0.05,
                                          dtype=torch.float32))
    src.quantization = True
    src.update_observers()
    policy = CapacityPolicy()
    ref_cams = [
        SimpleNamespace(intrinsic=c.intrinsic, extrinsic_vector=c.extrinsic_vector, image_name=c.image_name,
                        original_image=metrics.render_full(src, c.extrinsic_vector, settings_from_intrinsic(
                            c.intrinsic, inference=True), np.zeros(3), policy, device=DEVICE)["render"].clone())
        for c in cams
    ]
    photo_psnr = [float(losses.psnr(r.original_image, c.original_image)[0, 0]) for r, c in zip(ref_cams, cams)]
    log(f"  the reshaped scene's renders against the photos (phase 4's images): PSNR "
        f"{[round(p, 3) for p in photo_psnr]}")
    total = {k.name: 0 for k in kernels.REGISTRY.values()}

    def add(stage):
        torch.cuda.synchronize()
        got = {k.name: k.launches for k in kernels.REGISTRY.values()}
        for k, v in got.items():
            total[k] += v
        log(f"  {stage}: kernel launches {got}")
        return got

    # sensitivity through K2, then the two VQ stages; each vq_features call
    # is recorded so it can be run again from its seed
    vq_calls = []
    real_vq = pipeline.vq_features

    def recorded_vq(*a, **kw):
        out = real_vq(*a, **kw)
        vq_calls.append((a, kw, out))
        return out

    timings = {}
    kernels.reset_counts()
    pipeline.vq_features = recorded_vq
    try:
        compressed = pipeline.to_compressed(src, cams, comp, timings=timings, device=DEVICE)
    finally:
        pipeline.vq_features = real_vq
    got = add("to_compressed")
    compressed.check_state()
    n = compressed.capacity
    log(f"  sensitivity {timings['sensitivity_calculation']:.3f} s, clustering {timings['clustering']:.3f} s")
    log(f"  pruned {1 - n / src.capacity:.4%} of {src.capacity} splats; {n} left")
    for what, idx, size in (("color", compressed.feature_indices, comp.color_codebook_size),
                            ("covariance", compressed.gaussian_indices, comp.gaussian_codebook_size)):
        kept = int((idx >= size).sum())
        used = int(torch.unique(idx[idx < size]).numel())
        log(f"  {what}: {kept / n:.4%} of the splats kept dense, {used} of {size} codebook rows used")
    assert got["tiles_packed_bwd"] >= len(cams), "sensitivity did not backpropagate each view through K2"
    assert got["tiles_packed_fwd"] == got["tiles_packed_bwd"], got
    assert len(vq_calls) == 2, "expected the color and the covariance VQ"
    for what, (a, kw, (cb, idx)) in zip(("color", "covariance"), vq_calls):
        cb2, idx2 = real_vq(*a, **kw)
        assert torch.equal(cb, cb2) and torch.equal(idx, idx2), f"{what} VQ differs between two runs of one seed"
        log(f"  {what} VQ run twice from one seed: codebook {tuple(cb.shape)} and indices bitwise equal")

    # the QAT finetune through the indexed scene (K1 + K2); the caller's
    # scene must keep its bits
    before = {k: v.clone() for k, v in compressed.state_dict().items()}
    hist = []
    kernels.reset_counts()
    tuned = finetune.finetune(compressed, cams, OptimizationParams(), finetune_steps, log_every=0, history=hist,
                              device=DEVICE)
    got = add("finetune")
    log(f"  losses: {[round(h['loss'], 6) for h in hist]}")
    log(f"  ms per step: {[round(h['ms'], 3) for h in hist]}; median of steps 2-{finetune_steps} "
        f"{statistics.median(h['ms'] for h in hist[1:]):.3f}")
    assert all(math.isfinite(h["loss"]) for h in hist), "non-finite finetune loss"
    assert all(h["overflow"] == 0 and h["grad_overflow"] == 0 for h in hist), f"overflow in the finetune: {hist}"
    assert got["tiles_packed_bwd"] == finetune_steps and got["tiles_packed_fwd"] == finetune_steps + 1, got
    assert all(torch.equal(before[k], v) for k, v in compressed.state_dict().items()), \
        "finetune changed the caller's scene"
    log("  the caller's compressed scene is bit-identical after the finetune")
    ev = torch.as_tensor(cams[0].extrinsic_vector, device=DEVICE)
    settings = probe_policy(tuned, settings_from_intrinsic(cams[0].intrinsic), ev, torch.zeros(3, device=DEVICE)) \
        .apply(settings_from_intrinsic(cams[0].intrinsic))
    grads = [trainer.loss_and_grads(tuned, ev, cams[0].original_image, settings, torch.zeros(3, device=DEVICE),
                                    OptimizationParams())[2] for _ in range(2)]
    for k in ("features_dc", "features_rest", "scaling", "rotation"):
        assert torch.equal(grads[0][k], grads[1][k]), f"the {k} codebook-row gradient differs between two runs"
    log(f"  one step's codebook-row gradients (features_dc {tuple(grads[0]['features_dc'].shape)}, "
        f"scaling {tuple(grads[0]['scaling'].shape)}, ...) bitwise equal over two runs")

    # the npz as compress.py writes it (Morton order, fixed-point xyz), and
    # the uncompressed scene's npz for the ratio
    NPZ_DIR.mkdir(parents=True, exist_ok=True)
    path = NPZ_DIR / "compressed.npz"
    t0 = time.perf_counter()
    saved = io_npz.save_npz(tuned, path, sort_morton=True, xyz_u16=True)
    encode_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    loaded = io_npz.load_npz(path, device=DEVICE)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    io_npz.save_npz(src, NPZ_DIR / "uncompressed.npz")
    size, base_size = path.stat().st_size, (NPZ_DIR / "uncompressed.npz").stat().st_size
    log(f"  npz {size} B ({size / saved.capacity:.2f} B per splat), the uncompressed scene's npz {base_size} B: "
        f"ratio {base_size / size:.3f}; encode {encode_s:.3f} s, decode {decode_s:.3f} s")
    assert loaded.capacity == saved.capacity and loaded.is_color_indexed and loaded.is_gaussian_indexed

    # serve the loaded scene through K1
    kernels.reset_counts()
    results = metrics.render_and_eval(loaded, ref_cams, device=DEVICE)
    got = add("render_and_eval of the loaded npz")
    psnrs = [v["psnr"] for v in results["per_view"].values()]
    log(f"  PSNR against the uncompressed renders: {[round(p, 3) for p in psnrs]}; mean {results['psnr']:.4f}; "
        f"SSIM mean {results['ssim']:.6f}")
    assert results["num_views"] == len(cams) and all(math.isfinite(p) for p in psnrs)
    assert got["tiles_packed_fwd"] == results["num_renders"] and got["tiles_packed_bwd"] == 0, got
    policy = CapacityPolicy()
    diffs = []
    for cam in ref_cams:
        settings = settings_from_intrinsic(cam.intrinsic, inference=True)
        a = metrics.render_full(loaded, cam.extrinsic_vector, settings, np.zeros(3), policy, device=DEVICE)
        b = metrics.render_full(tuned, cam.extrinsic_vector, settings, np.zeros(3), policy, device=DEVICE)
        assert int(a["overflow"]) == 0 and bool(torch.isfinite(a["render"]).all())
        diffs.append((float((a["render"] - b["render"]).abs().max()), float(losses.psnr(a["render"], b["render"])[0, 0])))
    log(f"  loaded vs in-memory compressed renders (Morton order, fixed-point xyz, requantized): max|diff| "
        f"{[round(d, 6) for d, _ in diffs]}; PSNR {[round(p, 3) for _, p in diffs]}")
    # served view time, the loaded compressed scene against the uncompressed
    # one in turns, after a warm-up pass of each
    view_ms(loaded, ref_cams, policy)
    view_ms(src, ref_cams, policy)
    comp_ms, base_ms = [], []
    for _ in range(2):
        comp_ms += view_ms(loaded, ref_cams, policy)
        base_ms += view_ms(src, ref_cams, policy)
    log(f"  served view ms, compressed: {[round(m, 3) for m in comp_ms]}; median {statistics.median(comp_ms):.3f}")
    log(f"  served view ms, uncompressed: {[round(m, 3) for m in base_ms]}; median {statistics.median(base_ms):.3f} "
        f"(phase 4: median {statistics.median(serve_ms):.3f})")
    log(f"  K1 and K2 launches over the phase: {total}")
    return total


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the card only", file=sys.stderr)
        return 2
    assert "jax" not in sys.modules and "c3dgs_tpu" not in sys.modules
    t_start = time.perf_counter()
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    card = phase_build()
    clock_mhz = float(smi("clocks.max.sm").split()[0])
    phase_small()
    scene, knn_s = bench_scene(DEVICE, BENCH_N)
    log(f"  bench scene: {BENCH_N} splats, kNN scale init {knn_s:.2f} s on the card")
    k1, settings, ctx = phase_k1(scene, clock_mhz)
    launches, serve_ms, cams = phase_serve(scene, settings)
    k1["launches"] = launches[k1["name"]]
    phase_breakdown(scene, settings)
    phase_grads()
    k2, red_ms = phase_k2(ctx, clock_mhz)
    phase_fwd_bwd(scene, settings, k2["ms"], red_ms)
    base = RasterSettings(width=1920, height=1080, tanfovx=math.tan(0.6), tanfovy=math.tan(0.6), sh_degree=3)
    train_launches, _ = phase_train(scene, base)
    k1["launches"] += train_launches[k1["name"]]  # serving's 8 plus training's steps and probe
    k2["launches"] = train_launches[k2["name"]]
    # the per-tile family (packed=False)
    k3, settings_pt, ctx_pt = phase_k3(scene, settings, clock_mhz)
    k4, red_pt_ms = phase_k4(scene, ctx_pt, clock_mhz)
    k3["launches"] = phase_serve_per_tile(scene, cams)[k3["name"]]
    phase_grads_per_tile()
    phase_fwd_bwd(scene, settings_pt, k4["ms"], red_pt_ms, phase=14)
    train_pt = phase_train_per_tile(scene, dataclasses.replace(base, packed=False))
    k3["launches"] += train_pt[k3["name"]]  # per-tile serving's 8 plus training's steps
    k4["launches"] = train_pt[k4["name"]]
    probes = phase_probes()
    compress_launches = phase_compress(scene, cams, serve_ms)
    k1["launches"] += compress_launches[k1["name"]]  # sensitivity, finetune and serving the npz
    k2["launches"] += compress_launches[k2["name"]]  # sensitivity and finetune
    log(f"== done in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [k1, k2, k3, k4, *probes]}), flush=True)
    print(card, flush=True)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
