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
     path (the packed exact-mode backward launches the segment sum once);
     a clamped frame's gradients against the CPU path; the SSIM
     gradient at 1080p against float64;
  7. K2 against its plain version at the bench frame (phase 3's staged
     fields and K1 blocks, the cotangent of bench.py's L1 loss against a
     zero image) and on the freeze, boundary and long-tile scenes; K2's
     time, its plain version's time, its bound, bitwise repeats, the slots
     walked per tile, the (slot, warp) pairs with any alpha > 0 that set
     its shuffle count, and the reduction's error per column against a
     float64 index_add in both fast_grad modes; the exact mode's kernel
     (csrc/segment_sum.cu) against its plain version, twice bitwise, its
     time beside its byte bound, the plain version's and
     torch.Tensor.index_add_'s;
  8. fwd+bwd at the bench frame (bench.py's metric: one forward and the
     L1 loss's gradients with respect to the 7 scene parameters), its
     stage breakdown and the profiler's device busy share;
  9. train: the 300k scene with quantization and SH degree 3 through
     create_train_state, 10 train_steps, densify_step, grow_capacity,
     reset_opacity_step, 2 more steps and 2 in exact mode (fast_grad off,
     as the benchmark's training cells run: one segment-sum launch each),
     with every kernel count reset just before and read just after;
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
 18. from disk through the CLIs: tools/datasets.py writes a COLMAP folder
     of the bench scene (its 300,000 points and DC colors as points3D.bin,
     one PINHOLE 1920x1080 camera at phase 4's fov, 24 orbit poses with
     their K1 renders as the photos); cli.train (-r 1 --eval --epochs 8
     --eval_every 4: densify at epochs 2 and 3, opacity reset and SH
     warm-up every epoch), cli.compress (12 finetune steps, the other
     flags from cfg_args.json), cli.render and cli.metrics run in this
     process; each CLI's K1 and K2 launches, reset just before and read
     just after, equal the calls that launch them (train_step, the eval
     renders, sensitivity, finetune); the log, the saved .ply against the
     final state, results.json, times.json, the PNG dump and its scores
     checked, and the npz from disk served again; dataset write s, Scene
     load s (its points3D.bin parse through the host codec), s per
     epoch, ms per step (its image decode and its metric reads), eval ms per view, the compress CLI's times, bytes, ratio and
     PSNR, and render ms per view printed;
 19. poses, joint training and the small CLIs, each part's K1 and K2
     launches, reset just before and read just after, equal to the calls
     that make them: optimize_camera (150 Adam steps at lr 3e-3 from a
     phase 4 orbit pose + tests/test_camera_opt.py:28's perturbation,
     against the scene's own render at that pose) on the 300k scene and
     on phase 17's codebook-indexed scene, held to test_pose_recovery's
     bars (image error below 0.35x the start's, translation within 0.03)
     with overflow 0 on every step, ms per step and the busy share;
     cli.train_camera on phase 18's trained .ply and on its npz (2
     cameras, 100 steps at the CLI's 1600x900: the pose-error lines and
     PNGs); cli.train_no_splatting on phase 18's folder (10 epochs step
     each camera once; --perturb_poses 0.005 --anchor_weight 0.5
     --compress: the poses, each capacity bucket clipping at most once,
     the .ply against the final state, the npz served), ms per joint
     step; cli.run_indexed (12 finetune steps) and cli.npz2ply on phase
     18's model; densify_initial on the folder's 300,000 points, and on a
     20,000-point subset from one scene, card against CPU (kNN indices
     equal, rows at 1e-6); LPIPS (VGG and AlexNet, seeded random weights)
     at 1920x1080 card against CPU at rtol 1e-4, ms per call;
 20. multi-device on the one card (c3dgs_tpu_torch.parallel): 8 ranks
     spawned on cuda:0 with the gloo backend (NCCL refuses two ranks on
     one device), each loading the scenes the parent wrote as npz; the
     reference gate of __graft_entry__.py::dryrun_multichip (50,000
     splats at 512x256: the xyz gradient of vdot(w, image) sharded at
     dp2xtiles4, dp1xtiles8 and dp4xtiles2 against single-device, bar
     1e-4 relative, route_dropped 0; one hybrid step's loss against
     train_step's), then the 300k bench frame (the dp1xtiles8 image
     within atol 1e-5 of render_full, the 7 exact L1 gradients and a
     dp2xtiles4 hybrid step's gradients within 1e-4 relative of
     single-device, the replicas bitwise equal after the step); every
     rank's K1/K2 launches held to its calls; ranks 3 and 4 hold their
     tile-range K1/K2 against the plain versions;
 21. other tile shapes, each in a child process of this script with
     C3DGS_TILE_X/Y set (python3 chip_smoke.py --tile-phase 16x16 <cfg>):
     at 16x16, the shape of the system this repo ports, K1-K4 built for
     it and held against their plain versions on the small, freeze and
     long-tile scenes and at the 300k bench frame (probe-exact buckets at
     this shape; K2 and K4 twice, bitwise; times and bounds), 8 orbit
     views served in each family, fwd+bwd in each family, 4 packed and
     2 per-tile train_steps (the loss falls, the families' losses agree),
     each kernel's launches held to its calls; the image's difference
     from phase 4's 32x16 renders for information; at 16x8 and 32x32,
     K1-K4 against their plain versions on the small scenes, and their
     CUDA-event times and bounds on the long-tile scene (small-scene
     figures: no main path runs these shapes);
 22. the compression evidence tools, each in a child process of this
     script that runs `python -m c3dgs_tpu_torch.tools.<name>` as -m
     does (python3 chip_smoke.py --tool-phase <name> <cfg>), with its
     output in a temporary directory: bench_compression at its full
     protocol (100,000 splats, 150 finetune steps), scale_compress_probe
     at 1,200,000 splats and 12 views at 1920x1080 with 50 of its 1000
     finetune steps, convergence_run at the round-5 width (60,000 GT
     splats, 512x512, 288/32 views, the headline compression) with the
     first 8 of the 220-epoch schedule's epochs and 100 of 3000 finetune
     steps, robustness_runs --only A7 with the first 10 of 60 epochs (a
     train CLI --iterations that keeps the full run's densify and reset
     epochs); every child exits 0, launches K1 and K2, and
     overflows on no finetune step; every PSNR finite, npz bytes > 0,
     ratios > 1, the train logs' last epoch the one asked for, more
     trained splats than codebook entries; codebook
     colors computed block by block against the dense gather, at the
     image bar, on the probe's finetuned npz and on its 1.2M-splat scene
     made codebook-indexed (blocked there by default); ratios, PSNRs, active counts, stage seconds, peak
     memory, eigh's batches and seconds and the launches printed;
 23. the host codec and the last tools: the codec (csrc/codec.cpp, built
     with g++) loaded, its points3D.bin parse of phase 18's folder and its
     Morton order of the bench scene equal to the numpy versions, and
     phases 17 (the npz's Morton order) and 18 (the Scene load) counted
     calling it; then, each in a child process of this script as phase 22
     runs its tools: saturation_probe at bench.py's frame (300,000
     splats, 1920x1080: skipped <= interior <= segment chunks, frozen
     tiles <= tiles, the report from the plain K1's blocks equal to the
     tool's), clamp_probe (1,500,000 splats at 1920x1080: four rows, PSNR
     finite and falling, dropped = true instances - capacity + tiles
     exactly), scale_train_probe --steps 500 (600k-splat GT, 1M-point
     init at 1920x1080: one capacity growth to 2,499,840 rows at step
     300, the EMA PSNR finite and above step 0's, the clamp rows obeying
     the same identity) and dcn_probe (two torchrun nodes of 4 gloo ranks
     on cuda:0: each tiles group on one node, the JAX tool's 5e-5 / 1e-5
     / 0 bars); every tool's K1 / K2 launches, every dcn rank's, equal
     to the calls that make them; their figures printed beside the card's
     name and power limit;
 24. the bench entry points, each in a child process as phase 22 runs
     its tools: c3dgs_tpu_torch.tools.bench (bench.py's workload at full
     width: 300,000 splats at SH degree 0, 1920x1080, probe-exact buckets;
     C3DGS_BENCH_ITERS=10, BLOCKS=2), bench_render (dense and indexed,
     ITERS=10), profile_bench --packed 1 (K1 + K2) and --packed 0 (K3 +
     K4; 1 profiled step each), dispatch_probe and cumsum_probe (5 calls a
     formulation); each JSON line parsed with its keys, the bench's gate
     and bitwise-repeatable gradients, every formulation's error under
     1e-2 but the one-pass bf16 matmul's (printed) and torch.cumsum over
     dim 0's (a sequential fp32 scan, held bit for bit to numpy's), each
     tool's K1-K4 launches equal to the calls that make them;
 25. the `kernels` JSON line (K1-K4, P1-P3, then K1-K4 at 16x16 as
     `<name>@16x16`; K1/K2's launches include phase 22's, 23's and 24's
     children and ranks, K3/K4's phase 24's), the card line, and the final
     status line.
Each phase from 1 to 24 ends with a `== phase N: done (x.x s)` line.
It imports nothing of JAX and nothing of the c3dgs_tpu package.
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import io
import json
import math
import os
import importlib
import random
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

import torch.nn.functional as F

from c3dgs_tpu_torch import kernels, native
from c3dgs_tpu_torch.cli import compress as cli_compress
from c3dgs_tpu_torch.cli import metrics as cli_metrics
from c3dgs_tpu_torch.cli import npz2ply as cli_npz2ply
from c3dgs_tpu_torch.cli import render as cli_render
from c3dgs_tpu_torch.cli import run_indexed as cli_run_indexed
from c3dgs_tpu_torch.cli import train as cli_train
from c3dgs_tpu_torch.cli import train_camera as cli_train_camera
from c3dgs_tpu_torch.cli import train_no_splatting as cli_tns
from c3dgs_tpu_torch.compress import importance, pipeline
from c3dgs_tpu_torch.config import CompressionParams, OptimizationParams
from c3dgs_tpu_torch.data import cameras, colmap
from c3dgs_tpu_torch.eval import lpips, metrics
from c3dgs_tpu_torch.models import gaussians, io_npz, io_ply
from c3dgs_tpu_torch.ops import losses, morton, quat
from c3dgs_tpu_torch.render import oracle, rasterizer, segment_sum, tiles, tiles_packed
from c3dgs_tpu_torch.render.binning import bin_gaussians, per_gaussian_table
from c3dgs_tpu_torch.render.capacity import CapacityPolicy, _bucket
from c3dgs_tpu_torch.render.preprocess import preprocess
from c3dgs_tpu_torch.render.types import MAX_BINNING_CAP, TILE_X, TILE_Y, RasterSettings, settings_from_intrinsic
from c3dgs_tpu_torch.tools import datasets, dma_probe, scenes
from c3dgs_tpu_torch.tools.roofline import (FP32_FLOPS, HBM_BYTES_PER_S, SFU_PER_SM_CLOCK, SMS, bwd_work,
                                            device_busy_ms, fwd_work, roofline, segment_sum_work)
from c3dgs_tpu_torch.train import camera_opt, densify_initial, finetune, trainer

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
    t0 = time.perf_counter()
    scene = scenes.bench_recipe_scene(n, 0, 0.15, device=device)
    torch.cuda.synchronize()
    knn_s = time.perf_counter() - t0
    rest = np.random.default_rng(1).normal(size=tuple(scene.features_rest.shape)) * 0.05
    with torch.no_grad():
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
    pix = torch.arange(tiles.PIX, device=fields.device)
    px, py = (pix % TILE_X).double()[:, None], (pix // TILE_X).double()[:, None]
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


def timed_plain(fn, timing):
    """fn() (a plain version, after a device sync); its host-clock ms is
    appended to `timing` when that is a list."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    if timing is not None:
        timing.append((time.perf_counter() - t0) * 1e3)
    return out


def compare_k1(name, args, stats=None, timing=None):
    """K1 vs forward_plain on identical inputs: rows 0-4 within 2e-5 abs +
    1e-4 rel on tiles whose freeze slots agree; every freeze-slot mismatch
    must sit within 1e-4 of the threshold (a rounding-order tie). The
    plain call's ms goes to `timing` (a list) if given."""
    fields, tile_lo, meta, starts, ends = args
    out_k = tiles_packed.forward(*args)
    torch.cuda.synchronize()
    out_p = timed_plain(lambda: tiles_packed.forward_plain(*args, stats=stats), timing)
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


def bench_settings(scene):
    """The 1920x1080 bench frame's settings with bench.py's probe-exact
    buckets: the slot bucket of the frame's instances plus one sentinel per
    tile, the execution bucket of its grad_total."""
    settings = RasterSettings(width=1920, height=1080, tanfovx=math.tan(0.6), tanfovy=math.tan(0.6), sh_degree=3)
    ev = torch.tensor(EV_ID, dtype=torch.float32, device=DEVICE)
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
    return settings


def k1_small_scenes():
    """K1 against its plain version on the two freeze scenes and the
    long-tile scene at 64x48."""
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


def plain_times(fn, reps, compared):
    """The plain version's host ms: `reps` timed calls, or with reps 0 the
    one call the comparison made (`compared`)."""
    return host_ms(fn, reps=reps) if reps else compared


def phase_k1(scene, card_clock_mhz, plain_reps=3, label="phase 3"):
    log(f"== {label}: K1 against its plain version")
    k1_small_scenes()
    ev = torch.tensor([0, 0, 0, 1, 0, 0, 0], dtype=torch.float32, device=DEVICE)

    # the bench frame, with bench.py's probe-exact buckets
    settings = bench_settings(scene)
    with torch.no_grad():
        deg = trainer.settings_with_degree(settings, scene.active_sh_degree)
        prep = preprocess(scene.get_xyz(), scene.get_covariance(), scene.get_opacity()[:, 0], ev, deg,
                          scene.get_features())
        b = bin_gaussians(prep, deg)
        args, complete = k1_args(prep, b, deg, scene.capacity)
        stats, plain_first = {}, []
        err, mism, out_k, _ = compare_k1("bench frame 1920x1080", args, stats, plain_first)

        fields, tile_lo, meta, starts, ends = args
        out = torch.empty_like(out_k)
        ms = cuda_ms(lambda: tiles_packed.launch(fields, meta, starts, ends, out), reps=20)
        plain_ms = plain_times(lambda: tiles_packed.forward_plain(*args), plain_reps, plain_first)

    # the least time for this frame's work: each staged field slot a tile
    # walks read once, starts/ends read, blocks written (fwd_work)
    nc = int(meta[0])
    complete = ends < nc * 128
    frz = out_k[:, 5, 0].long()
    walked = int((torch.minimum(frz, ends.long()) - starts.long())[complete].sum())
    walk_lengths("bench frame", starts, ends, frz, complete)
    log(f"  work: {walked} walked slots, {stats['pairs']} (pixel, slot) pairs, {stats['exp_pairs']} needing "
        f"their exp, {stats['alpha_pairs']} with alpha > 0")
    bound, bound_by = roofline(*fwd_work(walked, starts.shape[0], 2, stats), card_clock_mhz)
    log(f"  K1 {statistics.median(ms):.4f} ms median of {len(ms)} (min {min(ms):.4f}); "
        f"plain {statistics.median(plain_ms):.1f} ms median of {len(plain_ms)}")
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


def phase_serve(scene, settings, label="phase 4"):
    log(f"== {label}: serve 8 orbit poses (render_and_eval, inference=True, capacity policy)")
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

    def render():
        with torch.no_grad():
            trainer.render_scene(scene, ev, settings, bg, device=DEVICE)

    busy_ms, rows = device_busy_ms(render)
    if not rows:
        log("  profiler: no device time recorded")
        return
    log(f"  profiler: {busy_ms:.4f} ms of kernel time in one render; busy share "
        f"{100 * busy_ms / view_ms:.1f}% of the unprofiled {view_ms:.4f} ms")
    for name, ms, count in rows[:12]:
        log(f"    {ms:9.4f} ms  x{count:<4d} {name[:90]}")


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
        before = (fwd.launches, bwd.launches, segment_sum.KERNEL.launches)
        g_card, _ = render_grads(rasterizer.render, sc, settings, DEVICE)
        torch.cuda.synchronize()
        assert (fwd.launches, bwd.launches) == (before[0] + 1, before[1] + 1), \
            f"the CUDA render did not launch {fwd.name} and {bwd.name} once each"
        assert segment_sum.KERNEL.launches == before[2] + packed, "the exact packed backward's segment sums"
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


def compare_k2(name, args, totals, g, stats=None, timing=None):
    """K2 vs backward_plain on identical inputs: rows 0-8 at normalized
    5e-4 per row, rows 9-15 exact. Returns (max abs err, K2 rows)."""
    got = tiles_packed.backward(*args, totals, g)
    torch.cuda.synchronize()
    ref = timed_plain(lambda: tiles_packed.backward_plain(*args, totals, g, stats=stats), timing)
    errs = [normalized_err(got[r], ref[r]) for r in range(9)]
    abs_err = float((got[:9] - ref[:9]).abs().max())
    nonzero = int((got[:9] != 0).any(0).sum())
    log(f"  {name}: {nonzero} slots with nonzero rows; max abs err {abs_err:.3e}; normalized per row "
        + " ".join(f"{e:.1e}" for e in errs))
    if max(errs) > GRAD_TOL or not torch.equal(got[9:], ref[9:]):
        raise AssertionError(f"{name}: K2 disagrees with its plain version")
    return abs_err, got


def k2_small_scenes():
    """K2 against its plain version on the occluder, wall, boundary and
    long-tile scenes, twice (bitwise) on the long-tile one."""
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


def phase_k2(ctx, clock_mhz, plain_reps=3, label="phase 7"):
    log(f"== {label}: K2 against its plain version")
    k2_small_scenes()
    fields, tile_lo, meta, starts, ends = args = ctx.args
    totals = ctx.out
    g = l1_cotangent(totals, ctx.deg, ctx.complete)
    stats, plain_first = {}, []
    err, got = compare_k2("bench frame 1920x1080 (L1 cotangent)", args, totals, g, stats, plain_first)
    again = tiles_packed.backward(*args, totals, g)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError("K2 is not bitwise repeatable")
    log("  K2 run twice at the bench frame: bitwise equal")

    buf = torch.zeros_like(got)
    ms = cuda_ms(lambda: tiles_packed.launch_backward(fields, meta, starts, ends, totals, g, buf), reps=20)
    plain_ms = plain_times(lambda: tiles_packed.backward_plain(*args, totals, g), plain_reps, plain_first)

    # the reduction after K2: d_table per column against a float64
    # index_add over every emission whose sorted slot lies in the execution
    # bucket (the emissions, culled ones included, outnumber its slots),
    # both fast_grad modes
    b = ctx.b
    rows = got.shape[1]
    total = int(b.emit_cum[-1])
    perm = b.perm.long()
    pos = torch.arange(perm.shape[0], device=DEVICE)
    keep = (pos < total) & (perm < rows)
    log(f"  {total} emissions over an execution bucket of {rows} slots; {int(keep[rows:].sum())} kept ones lie "
        f"past index {rows} of the permutation")
    owner = torch.searchsorted(b.emit_cum.long(), pos, right=True)
    d_pre = got[:9].T.double()[torch.clamp(perm, max=rows - 1)]
    ref = torch.zeros((b.emit_cum.shape[0], 9), dtype=torch.float64, device=DEVICE)
    ref.index_add_(0, owner[keep], d_pre[keep])
    for exact in (False, True):
        d = rasterizer._reduce_instance_grads_packed(got, b.perm, b.emit_cum, meta, exact)
        col = (d[:, :9].double() - ref).abs().max(0).values
        log(f"  d_table vs float64 index_add, {'exact (segment sums)' if exact else 'fast_grad'}: "
            "max abs err per column " + " ".join(f"{v:.2e}" for v in col.tolist())
            + f"; column max |value| " + " ".join(f"{v:.2e}" for v in ref.abs().max(0).values.tolist()))
    red_ms = cuda_ms(lambda: rasterizer._reduce_instance_grads_packed(got, b.perm, b.emit_cum, meta), reps=10)
    seg = segment_sum_row(got, meta, b, ref, owner[keep], d_pre[keep], total, clock_mhz)

    # the least time for K2's work at this frame (bwd_work): the 16
    # gradient rows of the execution capacity written, starts/ends read
    log(f"  work: {ctx.walked} walked slots, {stats['pairs']} (pixel, slot) pairs, {stats['exp_pairs']} needing "
        f"their exp, {stats['alpha_pairs']} with alpha > 0")
    walk_lengths("bench frame", starts, ends, totals[:, 5, 0], ctx.complete)
    region = "x".join(map(str, tiles.WARP_REGION[::-1]))
    log(f"  (slot, pixel group) pairs with any alpha > 0: {stats['row_pairs']} of {TILE_X}-pixel rows (K2's first "
        f"warps: {45 * stats['row_pairs']} shuffles at 45 each), {stats['warp_pairs']} of {region} regions (the "
        f"redesign's warps: {12 * stats['warp_pairs']} shuffles at 12 each)")
    bound, bound_by = roofline(*bwd_work(ctx.walked, starts.shape[0], rows, 2, stats), clock_mhz)
    log(f"  K2 {statistics.median(ms):.4f} ms median of {len(ms)} (min {min(ms):.4f}); "
        f"plain {statistics.median(plain_ms):.1f} ms median of {len(plain_ms)}; reduction (fast_grad) "
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
    }, seg, statistics.median(red_ms)


def segment_sum_row(grads, meta, b, ref, owner_kept, rows_kept, total, clock_mhz):
    """The exact reduction's kernels at the bench frame: against their plain
    version (float64 sums, each rounded once: 1 ulp apart at most, plus the
    float64 sums' order) and twice bitwise, the error per column against the
    float64 index_add `ref`; its time beside its byte bound, the plain
    version's and that of torch.Tensor.index_add_ (float64, on the kept rows
    already gathered), which the port never calls on the card. The row's
    launches are the exact training steps' (phase 9), not these."""
    perm, emit_cum = b.perm, b.emit_cum
    before = segment_sum.KERNEL.launches
    got = segment_sum.segment_sum(grads, perm, emit_cum, meta)
    again = segment_sum.segment_sum(grads, perm, emit_cum, meta)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError("the segment sum is not bitwise repeatable")
    plain = segment_sum.segment_sum_plain(grads, perm, emit_cum, meta)
    err = check_close("segment_sum vs its plain version", got, plain, atol=1e-13, rtol=2.0 ** -23)
    col = (got[:, :9].double() - ref).abs().max(0).values
    log("  segment_sum run twice: bitwise equal; vs float64 index_add: max abs err per column "
        + " ".join(f"{v:.2e}" for v in col.tolist()))
    buf = torch.empty_like(got)
    rec = torch.empty((grads.shape[1], segment_sum.REC), dtype=torch.float32, device=DEVICE)
    ms = cuda_ms(lambda: segment_sum.launch(grads, meta, perm, emit_cum, rec, buf), reps=20)
    plain_ms = cuda_ms(lambda: segment_sum.segment_sum_plain(grads, perm, emit_cum, meta), reps=5)
    sums = torch.zeros_like(ref)
    lib_ms = cuda_ms(lambda: sums.zero_().index_add_(0, owner_kept, rows_kept), reps=5)
    assert segment_sum.KERNEL.launches - before == 2 + 2 + 20  # the checked calls, cuda_ms' warm-up and reps
    n, kept = emit_cum.shape[0], owner_kept.shape[0]
    bound, bound_by = roofline(*segment_sum_work(n, min(total, perm.shape[0]), kept), clock_mhz)
    log(f"  segment_sum {statistics.median(ms):.4f} ms median of {len(ms)} (min {min(ms):.4f}) over {n} splats, "
        f"{kept} kept emissions; bound {bound:.4f} ms ({bound_by}; with a 32-byte sector per gathered float "
        f"{(32 * 9 * kept + 68 * n + 4 * total) / HBM_BYTES_PER_S * 1e3:.4f}); plain "
        f"{statistics.median(plain_ms):.4f} ms; index_add_ {statistics.median(lib_ms):.4f} ms")
    return {
        "name": segment_sum.KERNEL.name,
        "route": "cuda",
        "source": "c3dgs_tpu_torch/csrc/segment_sum.cu",
        "replaces": segment_sum.KERNEL.replaces,
        "launches": None,  # filled from the training run's exact steps
        "kernels_per_launch": 2,  # each launch runs pass 1 (records) and pass 2 (sums)
        "max_abs_err": err,
        "ms": statistics.median(ms),
        "plain_ms": statistics.median(plain_ms),
        "bound_ms": bound,
        "bound_by": bound_by,
        "library_ms": statistics.median(lib_ms),  # torch.Tensor.index_add_, float64
    }


# -------------------------------------------------------------- fwd+bwd
def phase_fwd_bwd(scene, settings, bwd_ms, red_ms, label="phase 8"):
    """bench.py's metric on the card: one forward and the gradients of the
    L1 loss against a zero image with respect to the 7 scene parameters,
    through the kernel family `settings.packed` selects; bwd_ms and red_ms
    are its backward kernel's and its reduction's times at this frame."""
    fwd_k, bwd_k = (tiles_packed.FORWARD_KERNEL, tiles_packed.BACKWARD_KERNEL) if settings.packed else \
        (tiles.FORWARD_KERNEL, tiles.BACKWARD_KERNEL)
    log(f"== {label}: fwd+bwd at the bench frame (bench.py's metric), packed={settings.packed}")
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
        for name, ms, count in rows[:12]:
            log(f"    {ms:9.4f} ms  x{count:<4d} {name[:90]}")
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

    def run(k, fast_grad=True):
        # the buckets follow the scene as it trains: the capacity policy
        # grows them (with its 1.3 headroom) after a step that needed more
        nonlocal state
        settings = dataclasses.replace(base, fast_grad=fast_grad)
        for _ in range(k):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            state, m = trainer.train_step(state, ev, target, policy.apply(settings), bg, opt, 1.0, device=DEVICE)
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
    assert segment_sum.KERNEL.launches == 0, "a fast_grad step launched the segment sum"
    run(2, fast_grad=False)
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in kernels.REGISTRY.values()}
    log(f"  losses after (the last 2 in exact mode): {[round(h[0], 6) for h in hist[10:]]}")
    log(f"  per step (instances, slot bucket, execution bucket): {[(h[3], h[4], h[5]) for h in hist]}")
    log(f"  kernel launches over {len(hist)} train_steps and {probes} bucket probe: {launches}")
    log(f"  ms per train_step: {[round(m, 3) for m in step_ms]}; median of steps 2-10 "
        f"{statistics.median(step_ms[1:10]):.3f}; the exact steps {step_ms[-2]:.3f}, {step_ms[-1]:.3f} (fast "
        f"{step_ms[-4]:.3f}, {step_ms[-3]:.3f})")
    assert all(math.isfinite(h[0]) for h in hist), "non-finite loss"
    assert hist[9][0] < hist[0][0], "the loss did not fall over 10 steps"
    assert all(h[1] == 0 and h[2] == 0 for h in hist), f"overflow in training: {hist}"
    assert launches["tiles_packed_bwd"] == len(hist), launches
    assert launches["tiles_packed_fwd"] == len(hist) + probes, launches
    assert launches[segment_sum.KERNEL.name] == 2, launches  # one per exact backward
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


def compare_k3(name, args, tiles_x, stats=None, timing=None):
    """K3 vs forward_plain on identical inputs: rows 0-4 within 2e-5 abs +
    1e-4 rel, `stop` (row 5) and rows 6-7 exactly equal."""
    out_k = tiles.forward(*args, tiles_x)
    torch.cuda.synchronize()
    out_p = timed_plain(lambda: tiles.forward_plain(*args, tiles_x, stats=stats), timing)
    nch = args[4].float()
    stopped = int((out_p[:, 5, 0] < nch).sum())
    mism = int((out_k[:, 5] != out_p[:, 5]).any(1).sum())
    log(f"  {name}: {nch.shape[0]} tiles, {int((nch > 0).sum())} with instances, {stopped} stopped early by "
        f"the saturation exit; {mism} stop mismatches")
    if not torch.equal(out_k[:, 5:], out_p[:, 5:]):
        raise AssertionError(f"{name}: K3's stop row or rows 6-7 differ from its plain version")
    err = check_close(f"{name} rows 0-4", out_k[:, :5], out_p[:, :5], 2e-5, 1e-4)
    return err, out_k


def k3_small_scenes():
    for name, (args, _, st, _) in per_tile_small_scenes().items():
        compare_k3(f"{name} scene {st.width}x{st.height}", args, st.tiles_x)


def phase_k3(scene, settings, clock_mhz, plain_reps=3, label="phase 10"):
    log(f"== {label}: K3 (per-tile forward) against its plain version")
    k3_small_scenes()

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
        stats, plain_first = {}, []
        err, out_k = compare_k3("bench frame 1920x1080", args, deg.tiles_x, stats, plain_first)
        out = torch.empty_like(out_k)
        ms = cuda_ms(lambda: tiles.launch(*args, deg.tiles_x, out), reps=20)
        plain_ms = plain_times(lambda: tiles.forward_plain(*args, deg.tiles_x), plain_reps, plain_first)

    # the least time for this frame's work (fwd_work): each instance of a
    # window walked before `stop` read once, the four (T,) int arrays read
    _, _, starts, ends, nch = args
    stop = out_k[:, 5, 0].long()
    walked = int(torch.minimum((ends - starts).long(), stop * 128).sum())
    bytes_moved, sfu, flops = fwd_work(walked, starts.shape[0], 4, stats)
    log(f"  work: {walked} walked instances in {int(torch.minimum(stop, nch.long()).sum())} windows, "
        f"{stats['pairs']} (pixel, instance) pairs, {stats['exp_pairs']} needing their exp "
        f"({stats['exp_pairs'] / stats['pairs']:.1%}), {stats['alpha_pairs']} with alpha > 0")
    bound, bound_by = roofline(bytes_moved, sfu, flops, clock_mhz)
    log(f"  K3 bound {bound:.4f} ms ({bound_by}); {old_bound(bytes_moved, stats, 2, flops, clock_mhz):.4f} ms "
        "when every pair's exp was counted")
    log(f"  K3 {statistics.median(ms):.4f} ms median of {len(ms)} (min {min(ms):.4f}); "
        f"plain {statistics.median(plain_ms):.1f} ms median of {len(plain_ms)}")
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
def compare_k4(name, args, grad_base, totals, g, tiles_x, grad_cap, stats=None, timing=None):
    """K4 vs backward_plain on identical inputs: rows 0-8 at normalized
    5e-4 per row, rows 9-15 exact. Returns (max abs err, K4 rows)."""
    got = tiles.backward(*args, grad_base, totals, g, tiles_x, grad_cap)
    torch.cuda.synchronize()
    ref = timed_plain(lambda: tiles.backward_plain(*args, grad_base, totals, g, tiles_x, grad_cap, stats=stats),
                      timing)
    errs = [normalized_err(got[r], ref[r]) for r in range(9)]
    abs_err = float((got[:9] - ref[:9]).abs().max())
    nonzero = int((got[:9] != 0).any(0).sum())
    log(f"  {name}: {nonzero} columns with nonzero rows; max abs err {abs_err:.3e}; normalized per row "
        + " ".join(f"{e:.1e}" for e in errs))
    if max(errs) > GRAD_TOL or not torch.equal(got[9:], ref[9:]):
        raise AssertionError(f"{name}: K4 disagrees with its plain version")
    return abs_err, got


def k4_small_scenes():
    for name, (args, grad_base, st, grad_cap) in per_tile_small_scenes().items():
        totals = tiles.forward(*args, st.tiles_x)
        g = np.zeros(tuple(totals.shape), np.float32)
        g[:, :4] = np.random.default_rng(0).normal(size=g[:, :4].shape)
        compare_k4(f"{name} scene {st.width}x{st.height}", args, grad_base, totals, torch.as_tensor(g, device=DEVICE),
                   st.tiles_x, grad_cap)


def phase_k4(scene, ctx, clock_mhz, plain_reps=3, label="phase 11"):
    log(f"== {label}: K4 (per-tile backward) against its plain version")
    k4_small_scenes()
    args, grad_base, totals, deg, b = ctx.args, ctx.grad_base, ctx.out, ctx.deg, ctx.b
    tx = deg.tiles_x
    grad_cap = deg.resolve_grad_cap(scene.capacity)
    g = l1_cotangent(totals, deg, None)
    stats, plain_first = {}, []
    err, got = compare_k4("bench frame 1920x1080 (L1 cotangent)", args, grad_base, totals, g, tx, grad_cap, stats,
                          plain_first)
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
    plain_ms = plain_times(lambda: tiles.backward_plain(*args, grad_base, totals, g, tx, grad_cap), plain_reps, plain_first)

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

    # the least time for K4's work at this frame (bwd_work): the 16 rows
    # of the grad buffer written, the five (T,) int arrays read
    bytes_moved, sfu, flops = bwd_work(ctx.walked, args[2].shape[0], grad_cap, 5, stats)
    log(f"  work: {ctx.walked} walked instances, {stats['pairs']} (pixel, instance) pairs, "
        f"{stats['exp_pairs']} needing their exp, {stats['alpha_pairs']} with alpha > 0; "
        f"grad buffer {grad_cap} columns")
    bound, bound_by = roofline(bytes_moved, sfu, flops, clock_mhz)
    log(f"  K4 bound {bound:.4f} ms ({bound_by}); {old_bound(bytes_moved, stats, 3, flops, clock_mhz):.4f} ms "
        "when every pair's exp was counted")
    log(f"  K4 {statistics.median(ms):.4f} ms median of {len(ms)} (min {min(ms):.4f}); "
        f"plain {statistics.median(plain_ms):.1f} ms median of {len(plain_ms)}; reduction (fast_grad) "
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
def phase_serve_per_tile(scene, cams, label="phase 12"):
    log(f"== {label}: serve the 8 orbit poses with packed=False (render_and_eval, inference=True)")
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


def phase_train_steps(scene, base, steps=4, label="phase 15"):
    """`steps` train_steps of the 300k scene, quantized, through the kernel
    family `base.packed` selects; returns the launches and the losses."""
    fwd, bwd, other = ("tiles_packed_fwd", "tiles_packed_bwd", ("tiles_fwd", "tiles_bwd")) if base.packed else \
        ("tiles_fwd", "tiles_bwd", ("tiles_packed_fwd", "tiles_packed_bwd"))
    log(f"== {label}: train the 300k scene with packed={base.packed} ({steps} steps, quantization on, SH degree 3)")
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
    log(f"  probe-exact buckets: slots {policy.capacity}, {'execution' if base.packed else 'per-tile grad'} "
        f"{policy.grad_capacity}")
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
    assert launches[bwd] == steps and launches[fwd] == steps, launches
    assert launches[other[0]] == 0 and launches[other[1]] == 0, launches
    return launches, [h[0] for h in hist]


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
    and read just after; returns the summed launches and the loaded npz's
    (codebook-indexed) scene."""
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
    morton_calls = native.calls["morton_order_f32"]
    saved = io_npz.save_npz(tuned, path, sort_morton=True, xyz_u16=True)
    encode_s = time.perf_counter() - t0
    CODEC_CALLS["phase 17 npz (morton_order_f32)"] = native.calls["morton_order_f32"] - morton_calls
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
    return total, loaded


# ------------------------------------------------------- from disk
CLI_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_cli"


class Recorder:
    """Wraps module functions for one phase: counts each one's calls, keeps
    their host-clock spans (entry and exit, after a device sync where asked)
    and, for render_full, sums the renders each call took; put back by
    restore()."""

    def __init__(self):
        self.spans, self.outputs, self.renders, self._undo = {}, {}, 0, []

    def wrap(self, owner, name, sync=False, keep=False):
        real = getattr(owner, name)
        spans = self.spans.setdefault(name, [])
        outputs = self.outputs.setdefault(name, [])

        def wrapped(*a, **kw):
            t0 = time.perf_counter()
            out = real(*a, **kw)
            if sync:
                torch.cuda.synchronize()
            spans.append((t0, time.perf_counter()))
            if keep:
                outputs.append(out)
            if name == "render_full":
                self.renders += out["renders"]
            return out

        setattr(owner, name, wrapped)
        self._undo.append((owner, name, real))

    def calls(self, name):
        return len(self.spans.get(name, []))

    def restore(self):
        for owner, name, real in reversed(self._undo):
            setattr(owner, name, real)


def launches():
    torch.cuda.synchronize()
    return {k.name: k.launches for k in kernels.REGISTRY.values()}


def phase_cli(scene, n_views=24, epochs=8, finetune_steps=12, width=1920, height=1080):
    """The user path from a dataset on disk through the port's CLIs, at the
    bench frame: a COLMAP folder of the bench scene's points and K1 renders
    (tools/datasets.py) -> cli.train -> cli.compress -> cli.render ->
    cli.metrics, each CLI's kernel launches held to the calls that make
    them. Training passes --opacity_reset_interval 30000: with --epochs 8
    and the default iterations, train.py's schedule resets opacity after
    every epoch and arms its 20 px screen-size prune at epoch 2, which cut
    the kNN-initialized bench scene to 17,451 near-transparent rows; at
    30000 neither fires in 8 epochs, and densify (epochs 2 and 3) works on
    a scene that keeps its splats. tests/test_torch_cli.py holds the reset
    and the prune to train.py's on a small folder. Returns the summed
    launches."""
    log(f"== phase 18: from disk through the CLIs ({n_views} views at {width}x{height}, train {epochs} epochs, compress "
        f"with {finetune_steps} finetune steps, render, metrics)")
    shutil.rmtree(CLI_DIR, ignore_errors=True)
    ds, out = str(CLI_DIR / "dataset"), str(CLI_DIR / "model")
    views = [orbit_extrinsic(float(y)) for y in np.linspace(-0.35, 0.35, n_views)]
    t0 = time.perf_counter()
    names = datasets.write_colmap_dataset(ds, scene, views, width, height, 1.2, 1.2, device=DEVICE)
    log(f"  dataset write {time.perf_counter() - t0:.3f} s: {len(names)} PNGs, points3D.bin of {scene.capacity} "
        f"points with their DC colors, one PINHOLE camera")
    total = {k.name: 0 for k in kernels.REGISTRY.values()}

    # -- train
    rec = Recorder()
    rec.wrap(cli_train, "Scene", sync=True)
    rec.wrap(native, "read_points3d_binary")
    rec.wrap(cli_train.trainer, "train_step", keep=True)
    rec.wrap(cameras.Camera, "load_image")
    rec.wrap(cli_train.metrics, "render_full", sync=True)
    kernels.reset_counts()
    parse_calls = native.calls["colmap_points3d_parse"]
    try:
        random.seed(0)
        state = cli_train.main(["-s", ds, "-m", out, "-r", "1", "--eval", "--epochs", str(epochs),
                                "--eval_every", "4", "--opacity_reset_interval", "30000", "--data_device", DEVICE])
    finally:
        rec.restore()
    CODEC_CALLS["phase 18 Scene load (colmap_points3d_parse)"] = native.calls["colmap_points3d_parse"] - parse_calls
    got = launches()
    entries = [json.loads(line) for line in open(Path(out) / "train_log.jsonl")]
    steps = rec.calls("train_step")
    (s0, s1), = rec.spans["Scene"]
    (p0, p1), = rec.spans["read_points3d_binary"]
    log(f"  Scene load (COLMAP read, kNN init at 4x capacity) {s1 - s0:.3f} s; of it the host codec's points3D.bin "
        f"parse of {scene.capacity} points {p1 - p0:.3f} s")
    for e in entries:
        log(f"  {json.dumps(e)}")
    n_test = 3
    eval_views = rec.calls("render_full")
    assert len(entries) == epochs and all(math.isfinite(e["ema_loss"]) for e in entries), entries
    assert entries[-1]["it"] == steps and eval_views == n_test * sum("test_psnr" in e for e in entries), \
        (steps, eval_views)
    assert got["tiles_packed_bwd"] == steps and got["tiles_packed_fwd"] == steps + rec.renders, (got, steps, rec.renders)
    log(f"  kernel launches {got}: K2 = {steps} steps, K1 = {steps} steps + {rec.renders} eval renders "
        f"({eval_views} views)")
    for k in total:
        total[k] += got[k]
    actives = [e["active"] for e in entries]
    assert len(set(actives[1:4])) > 1, f"active did not change at a densify epoch: {actives}"
    log(f"  ema_loss {entries[0]['ema_loss']} -> {entries[-1]['ema_loss']}; active {actives}")
    assert entries[-1]["ema_loss"] < entries[0]["ema_loss"], "the training loss did not fall"
    assert actives[-1] >= scene.capacity // 2, f"training kept {actives[-1]} of {scene.capacity} splats"
    last = entries[-1]["it"] - entries[-2]["it"]
    ovf = [(int(m["overflow"]), int(m["grad_overflow"])) for _, m in rec.outputs["train_step"]]
    log(f"  (overflow, grad_overflow) per step: {ovf}")
    assert all(o == (0, 0) for o in ovf[-last:]), f"overflow in the last epoch's {last} steps"
    # per step: the gap from one step's entry to the next one's within an
    # epoch (image decode, the step, its metric reads); decode and the
    # reads, which wait for the device, separately
    first_of_epoch = {e["it"] for e in entries}  # 0-based index of each later epoch's first step
    starts = [a for a, _ in rec.spans["train_step"]]
    ends = [b for _, b in rec.spans["train_step"]]
    decodes = rec.spans["load_image"]  # the steps' images and, between epochs, the eval's

    def decode_before(t):  # ms of the image decode that ended last before t
        a, b = max((span for span in decodes if span[1] <= t), key=lambda span: span[1])
        return (b - a) * 1e3

    step_ms, enqueue_ms, read_ms, decode_ms = [], [], [], []
    for i in range(1, steps - 1):
        if i + 1 in first_of_epoch:  # the next step is in the next epoch
            continue
        step_ms.append((starts[i + 1] - starts[i]) * 1e3)
        enqueue_ms.append((ends[i] - starts[i]) * 1e3)
        decode_ms.append(decode_before(starts[i + 1]))
        read_ms.append((starts[i + 1] - ends[i]) * 1e3 - decode_ms[-1])
    epoch_s = [round(b - a, 1) for a, b in zip([0.0] + [e["seconds"] for e in entries[:-1]], [e["seconds"] for e in entries])]
    ev_ms = [(b - a) * 1e3 for a, b in rec.spans["render_full"]]
    log(f"  s per epoch (train_log.jsonl): {epoch_s}")
    log(f"  ms per step, host clock, steps 2+ within an epoch: {[round(m, 1) for m in step_ms]}; median "
        f"{statistics.median(step_ms):.3f}; of it the train_step call {statistics.median(enqueue_ms):.3f}, the "
        f"image decode {statistics.median(decode_ms):.3f}, the metric reads after it {statistics.median(read_ms):.3f}")
    log(f"  --eval_every ms per view (render_full, synced): {[round(m, 1) for m in ev_ms]}; median "
        f"{statistics.median(ev_ms):.3f}")
    ply = Path(out) / "point_cloud" / f"iteration_{steps}" / "point_cloud.ply"
    loaded = io_ply.load_gaussians_ply(str(ply), device=DEVICE)
    final = state.scene.compact()
    check_close("the saved .ply's xyz against the final state's active rows", loaded.xyz, final.xyz, 0.0)
    check_close("its opacity logits", loaded.opacity, final.opacity, 0.0)
    assert loaded.capacity == int(state.scene.num_active), (loaded.capacity, int(state.scene.num_active))
    with torch.no_grad():
        check_close("its features", loaded.get_features(), final.get_features(), 0.0)
        check_close("its scales", loaded.get_scaling(), final.get_scaling(), 1e-6, 1e-5)
    log(f"  {ply.name}: {ply.stat().st_size} B, {loaded.capacity} rows; last epoch {last} steps")

    # -- compress
    rec = Recorder()
    rec.wrap(importance, "_importance_step")
    rec.wrap(finetune.trainer, "train_step")
    rec.wrap(cli_compress.metrics, "render_full")
    kernels.reset_counts()
    try:
        compressed = cli_compress.main(["-m", out, "--finetune_iterations", str(finetune_steps)])
    finally:
        rec.restore()
    got = launches()
    eval_renders = rec.renders
    vq = Path(out) / "vq"
    results = json.load(open(vq / "results.json"))
    times = json.load(open(vq / "times.json"))
    sens, ft = rec.calls("_importance_step"), rec.calls("train_step")
    log(f"  times.json {json.dumps(times)}")
    log(f"  results.json {json.dumps(results)}")
    assert ft == finetune_steps and sens >= n_test, (ft, sens)
    assert got["tiles_packed_bwd"] == sens + ft and got["tiles_packed_fwd"] == sens + ft + 1 + eval_renders, \
        (got, sens, ft, eval_renders)
    for k in ("psnr", "ssim", "uncompressed_psnr", "psnr_drop", "compression_ratio"):
        assert math.isfinite(results[k]), (k, results)
    assert all(math.isfinite(v) for v in times.values()), times
    log(f"  kernel launches {got}: K2 = {sens} sensitivity renders + {ft} finetune steps, K1 = those + the "
        f"finetune's probe + {eval_renders} eval renders")
    log(f"  npz {results['size_bytes']} B against the trained .ply's {results['ply_size_bytes']} B: ratio "
        f"{results['compression_ratio']:.3f}; PSNR {results['psnr']:.4f} (uncompressed {results['uncompressed_psnr']:.4f}, "
        f"drop {results['psnr_drop']:.4f})")
    for k in total:
        total[k] += got[k]

    # -- render, then metrics
    rec = Recorder()
    rec.wrap(cli_render.metrics, "render_full", sync=True)
    kernels.reset_counts()
    try:
        served = cli_render.main(["-m", out])
    finally:
        rec.restore()
    got = launches()
    n_views = sum(r["num_views"] for r in served.values())
    renders = sum(r["num_renders"] for r in served.values())
    view_ms = [(b - a) * 1e3 for a, b in rec.spans["render_full"]]
    assert n_views == len(names) and got["tiles_packed_fwd"] == renders and got["tiles_packed_bwd"] == 0, (got, served)
    for split in served:
        dump = Path(out) / split / f"ours_{steps}"
        pngs = sorted(p.name for p in (dump / "renders").iterdir())
        assert pngs == sorted(p.name for p in (dump / "gt").iterdir()) and len(pngs) == served[split]["num_views"]
    log(f"  render CLI: {n_views} views, {renders} renders, K1 launches {got['tiles_packed_fwd']}; ms per view "
        f"(render_full, synced) median {statistics.median(view_ms):.3f}, all {[round(m, 1) for m in view_ms]}")
    for k in total:
        total[k] += got[k]
    cli_metrics.main(["-m", out, "--data_device", DEVICE])
    scored = json.load(open(Path(out) / "results.json"))
    log(f"  metrics CLI results.json {json.dumps(scored)}")
    for split in served:
        assert math.isfinite(scored[f"{split}/ours_{steps}"]["PSNR"]), scored
    assert json.load(open(Path(out) / "per_view.json")), "per_view.json is empty"

    # -- the npz served as tests/test_e2e.py::test_compress_cli_roundtrip does
    npz = io_npz.load_npz(vq / "point_cloud.npz", override_quantization=True, device=DEVICE)
    test_cams = cli_render.Scene(source_path=ds, model_path="", scene=npz, resolution=1, eval_split=True,
                                 shuffle=False, device=DEVICE).get_test_cameras()
    served_npz = metrics.render_and_eval(npz, test_cams, device=DEVICE)
    log(f"  the npz loaded from disk against the test photos: PSNR {served_npz['psnr']:.4f} (compress CLI "
        f"{results['psnr']:.4f})")
    # the npz from disk against the scene the compress CLI returned, pixel by
    # pixel: they differ by the load's requantization only (observers
    # re-pinned to the dequantized ranges), held to the bars of phase 17's
    # round trip (51.8-54.7 dB, max|diff| <= 0.0945 there). A view's mean
    # pixel is ~0.5, so an empty or transparent scene from disk, which
    # renders the black background, scores ~6 dB.
    assert abs(served_npz["psnr"] - results["psnr"]) < 0.05, (served_npz["psnr"], results["psnr"])
    assert npz.capacity == compressed.capacity, (npz.capacity, compressed.capacity)
    policy, diffs = CapacityPolicy(), []
    for cam in test_cams:
        settings = settings_from_intrinsic(cam.intrinsic, inference=True)
        a = metrics.render_full(npz, cam.extrinsic_vector, settings, np.zeros(3), policy, device=DEVICE)
        b = metrics.render_full(compressed, cam.extrinsic_vector, settings, np.zeros(3), policy, device=DEVICE)
        assert int(a["overflow"]) == 0 and bool(torch.isfinite(a["render"]).all())
        diffs.append((float((a["render"] - b["render"]).abs().max()), float(losses.psnr(a["render"], b["render"])[0, 0]),
                      float(b["render"].mean())))
    log(f"  the npz from disk vs the compress CLI's scene in memory, per test view: max|diff| "
        f"{[round(d, 6) for d, _, _ in diffs]}; PSNR {[round(p, 3) for _, p, _ in diffs]}; mean pixel "
        f"{[round(m, 4) for _, _, m in diffs]}")
    assert all(d <= 0.1 and p >= 50.0 for d, p, _ in diffs), diffs
    log(f"  card: {smi('name,power.limit')}")
    return total

# -------------------------------------------- poses, joint training, small CLIs
POSE_DELTA = np.array([0.01, -0.01, 0.005, 0, 0.05, -0.04, 0.02], np.float32)  # tests/test_camera_opt.py:28
POSE_ITERATIONS = 150  # test_pose_recovery's count and lr
POSE_LR = 3e-3


def counted(fn, expect, what):
    """Run fn() with every kernel count reset just before and read just
    after; raise unless K1's and K2's launches equal `expect`, a callable
    of fn's result giving (K1, K2) from the calls that launch them.
    Returns (fn's result, the launches)."""
    kernels.reset_counts()
    out = fn()
    got = launches()
    want = expect(out)
    assert (got["tiles_packed_fwd"], got["tiles_packed_bwd"]) == want, (what, got, want)
    log(f"  {what}: kernel launches {got} (K1, K2 expected {want})")
    return out, got


def recover_pose(name, scene, cam):
    """optimize_camera from cam's pose + POSE_DELTA against the scene's own
    K1 render at cam's pose, through buckets twice the probe's (the pose
    moves the frame's instances); every step's overflow read. Returns the
    launches."""
    ev_true = np.asarray(cam.extrinsic_vector, np.float32)
    base = settings_from_intrinsic(cam.intrinsic)
    bg = torch.zeros(3, device=DEVICE)
    with torch.no_grad():
        probe = trainer.render_scene(scene, ev_true, CapacityPolicy().apply(base), bg, device=DEVICE)
        settings = CapacityPolicy(initial=2 * int(probe["num_instances"]),
                                  grad_initial=2 * int(probe["grad_total"])).apply(base)
        gt = trainer.render_scene(scene, ev_true, settings, bg, device=DEVICE)["render"].clone()

    def image_error(ev):
        with torch.no_grad():
            return float((trainer.render_scene(scene, ev, settings, bg, device=DEVICE)["render"] - gt).abs().mean())

    ev0 = ev_true + POSE_DELTA
    before = {k: v.clone() for k, v in scene.state_dict().items()}
    events, hist = [], []
    real = camera_opt.camera_step

    def timed_step(*a, **kw):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        out = real(*a, **kw)
        e.record()
        events.append((s, e))
        hist.append(out[2])  # each step's metrics, read after the run
        return out

    camera_opt.camera_step = timed_step
    t0 = time.perf_counter()
    try:
        (ev, loss), got = counted(
            lambda: camera_opt.optimize_camera(scene, ev0, gt, settings, iterations=POSE_ITERATIONS, lr=POSE_LR,
                                               device=DEVICE),
            lambda _: (POSE_ITERATIONS, POSE_ITERATIONS), f"{name}: optimize_camera, {POSE_ITERATIONS} steps")
    finally:
        camera_opt.camera_step = real
    wall_s = time.perf_counter() - t0
    step_ms = [s.elapsed_time(e) for s, e in events]
    hist = [{k: float(v) if k == "loss" else int(v) for k, v in m.items()} for m in hist]
    ev = ev.cpu().numpy()
    e0, e1 = image_error(ev0), image_error(ev)
    trans = float(np.abs(ev[4:] - ev_true[4:]).max())
    log(f"  {name}: {scene.capacity} splats{' (codebook-indexed)' if scene.is_color_indexed else ''}, "
        f"{settings.width}x{settings.height}, SH degree {scene.active_sh_degree}; instances at the true pose "
        f"{int(probe['num_instances'])}, buckets {settings.instance_capacity} / {settings.grad_capacity}")
    log(f"  losses every 25 steps: {[round(h['loss'], 6) for h in hist[::25]]}; final {loss:.6f}")
    log(f"  mean |image - target|: start {e0:.6f}, recovered {e1:.6f} ({e1 / e0:.4f} of the start; bar 0.35)")
    log(f"  pose error max: start {float(np.abs(ev0 - ev_true).max()):.4f}, recovered "
        f"{float(np.abs(ev - ev_true).max()):.6f}; translation {trans:.6f} (bar 0.03)")
    log(f"  ms per pose step (CUDA events): median "
        f"{statistics.median(step_ms[1:]):.3f}, min {min(step_ms):.3f}, max {max(step_ms[1:]):.3f}; "
        f"{POSE_ITERATIONS} steps in {wall_s:.3f} s of host clock")
    assert all(h["overflow"] == 0 and h["grad_overflow"] == 0 for h in hist), f"{name}: overflow in a pose step"
    assert all(math.isfinite(h["loss"]) for h in hist), f"{name}: non-finite pose loss"
    assert e1 < 0.35 * e0, f"{name}: image error {e1} not below 0.35x the start's {e0}"
    assert trans < 0.03, f"{name}: translation error {trans}"
    assert all(p.grad is None for p in scene.parameters()), f"{name}: the frozen scene got a .grad"
    assert all(torch.equal(before[k], v) for k, v in scene.state_dict().items()), f"{name}: the scene changed"
    # the device's busy share of one pose step
    ev_b = torch.as_tensor(ev0, device=DEVICE).clone()
    state = trainer.adam_init({"ev": ev_b})
    gt_d = gt.clone()
    busy, rows = device_busy_ms(lambda: camera_opt.camera_step(scene, ev_b, state, gt_d, settings, bg, POSE_LR))
    med = statistics.median(step_ms[1:])
    log(f"  profiler: {busy:.4f} ms of kernel time in one pose step; busy share {100 * busy / med:.1f}% of the "
        f"unprofiled median {med:.3f} ms" if rows else "  profiler: no device time recorded")
    return got


def written_ply_matches(ply, scene):
    loaded = io_ply.load_gaussians_ply(str(ply), device=DEVICE)
    final = scene.compact()
    check_close(f"{ply.name}'s xyz against the scene's active rows", loaded.xyz, final.xyz, 0.0)
    check_close("its opacity logits", loaded.opacity, final.opacity, 0.0)
    with torch.no_grad():
        check_close("its features", loaded.get_features(), final.get_features(), 0.0)
        check_close("its scales", loaded.get_scaling(), final.get_scaling(), 1e-6, 1e-5)
    assert loaded.capacity == final.capacity, (loaded.capacity, final.capacity)


def quiet(fn):
    """fn() with its standard output captured; returns (result, text)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn()
    return out, buf.getvalue()


def densify_check(points3d, subset=20_000):
    """densify_initial on a COLMAP folder's points on the card (insertions,
    capacity, seconds), and on an evenly strided subset on the card and on
    the CPU: kNN indices equal, the rows at 1e-6."""
    pts, rgb, _ = colmap.read_points3D_binary(str(points3d))
    pts, cols = pts.astype(np.float32), rgb.astype(np.float32) / 255.0
    cloud = gaussians.from_point_cloud(pts, cols, capacity=len(pts), quantization=False, device=DEVICE)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    thick = densify_initial.densify_initial(cloud)
    torch.cuda.synchronize()
    log(f"  densify_initial on {len(pts)} points: +{int(thick.num_active) - len(pts)} splats, capacity "
        f"{cloud.capacity} -> {thick.capacity}, {time.perf_counter() - t0:.3f} s")
    step = max(len(pts) // subset, 1)
    sub, sub_cols = pts[::step][:subset], cols[::step][:subset]
    knn = {dev: densify_initial._knn_indices(sub, 3, device=dev) for dev in (DEVICE, "cpu")}
    assert np.array_equal(knn[DEVICE], knn["cpu"]), f"kNN differs on {int((knn[DEVICE] != knn['cpu']).any(1).sum())} rows"
    # one input scene for both devices: from_point_cloud's kNN scale init
    # itself parts between them (its sq_i + sq_j - 2 x.y cancels)
    base = gaussians.from_point_cloud(sub, sub_cols, capacity=len(sub), quantization=False, device="cpu")
    outs = {dev: densify_initial.densify_initial(base.clone().to(dev)) for dev in (DEVICE, "cpu")}
    assert torch.equal(outs[DEVICE].active.cpu(), outs["cpu"].active), "densify_initial's rows differ"
    for k in ("xyz", "opacity", "scaling_factor", "features_dc", "scaling", "rotation"):
        check_close(f"densify_initial on {len(sub)} points, card vs CPU: {k}", getattr(outs[DEVICE], k).detach().cpu(),
                    getattr(outs["cpu"], k).detach(), 1e-6)
    log(f"  {len(sub)}-point subset: kNN indices equal on the card and the CPU; "
        f"+{int(outs['cpu'].num_active) - len(sub)} splats on both")


def lpips_check(a, b):
    """LPIPS (VGG and AlexNet, seeded random weights) of two images on the
    card against the CPU at rtol 1e-4, and its ms per call."""
    for net_type in ("vgg", "alex"):
        path = NPZ_DIR / f"lpips_{net_type}_random.npz"
        np.savez(path, **scenes.lpips_random_weights(net_type, np.random.default_rng(0)))
        card_fn = lpips.LPIPS(str(path), net_type, device=DEVICE)
        card = float(card_fn(a, b))
        ref = float(lpips.LPIPS(str(path), net_type, device="cpu")(a.cpu(), b.cpu()))
        ms = cuda_ms(lambda: card_fn(a, b), reps=5)
        log(f"  LPIPS ({net_type}, random weights) at {a.shape[2]}x{a.shape[1]}: card {card:.8f}, CPU {ref:.8f}, "
            f"relative difference {abs(card - ref) / ref:.3e} (rtol 1e-4); {statistics.median(ms):.3f} ms a call "
            "(CUDA events, median of 5)")
        assert math.isfinite(card) and ref > 0 and abs(card - ref) <= 1e-4 * ref, (net_type, card, ref)


def phase_pose(scene, cams, compressed, width=1920, height=1080):
    """The fork's pose paths at the bench frame: pose recovery on the 300k
    scene and on phase 17's codebook-indexed scene, the pose and joint
    CLIs on phase 18's folder, run_indexed and npz2ply on its model,
    densify_initial on its 300,000 points, and LPIPS on the card against
    the CPU. Each part's K1 and K2 launches are held to the calls that
    make them. Returns the summed launches."""
    from PIL import Image

    log(f"== phase 19: poses, joint training and the small CLIs ({POSE_ITERATIONS} pose steps at lr {POSE_LR}; "
        "phase 18's folder)")
    total = {k.name: 0 for k in kernels.REGISTRY.values()}

    def add(got):
        for k in total:
            total[k] += got[k]

    cam = cams[2]
    add(recover_pose(f"the 300k scene at {cam.image_name}", scene, cam))
    add(recover_pose(f"phase 17's npz as loaded at {cam.image_name}", compressed, cam))

    ds, model = CLI_DIR / "dataset", CLI_DIR / "model"
    iteration = max(int(p.name.split("_")[-1]) for p in (model / "point_cloud").iterdir())
    npz_model = CLI_DIR / "model_npz"
    (npz_model / "point_cloud" / f"iteration_{iteration}").mkdir(parents=True, exist_ok=True)
    shutil.copyfile(model / "vq" / "point_cloud.npz", npz_model / "point_cloud" / f"iteration_{iteration}" /
                    "point_cloud.npz")

    # -- cli.train_camera against the trained .ply, then the npz
    for what, m in (("the trained .ply", model), ("the compressed npz", npz_model)):
        dump = CLI_DIR / f"pose_dump_{m.name}"
        rec = Recorder()
        rec.wrap(cli_train_camera.camera_opt, "camera_step")
        rec.wrap(cli_train_camera.trainer, "render_scene")
        try:
            (results, text), got = counted(
                lambda: quiet(lambda: cli_train_camera.main(
                    ["-s", str(ds), "-m", str(m), "--num_cameras", "2", "--iterations", "100", "--dump_dir", str(dump),
                     "--data_device", DEVICE])),
                lambda _: (rec.calls("render_scene"), rec.calls("camera_step")), f"cli.train_camera on {what}")
        finally:
            rec.restore()
        lines = [line for line in text.splitlines() if "pose error" in line]
        for line in lines:
            log(f"  {line}")
        assert len(lines) == len(results) == 2 and rec.calls("camera_step") == 200, (lines, rec.calls("camera_step"))
        assert all(math.isfinite(r["loss"]) for r in results), results
        pngs = sorted(p.name for p in dump.iterdir())
        assert pngs == sorted(f"{r['image_name']}_opt.png" for r in results), pngs
        # train_camera.py has no resolution flag: its Scene takes the
        # default ladder, which brings 1920 px wide photos in at 1600 px
        size = cameras.resolve_resolution(width, height, -1)
        assert Image.open(dump / pngs[0]).size == size
        log(f"  {pngs} written at {size[0]}x{size[1]} (the CLI's default resolution ladder); steps {rec.calls('camera_step')}, renders {rec.calls('render_scene')}")
        add(got)

    # -- cli.train_no_splatting: 10 epochs step every camera once
    joint_dir = CLI_DIR / "joint"
    rec = Recorder()
    rec.wrap(cli_tns.J, "joint_step", sync=True, keep=True)
    rec.wrap(importance, "_importance_step")
    try:
        js, got = counted(
            lambda: cli_tns.main(["-s", str(ds), "-m", str(joint_dir), "-r", "1", "--epochs", "10", "--perturb_poses",
                                  "0.005", "--anchor_weight", "0.5", "--compress", "--data_device", DEVICE]),
            lambda _: (rec.calls("joint_step") + rec.calls("_importance_step"),) * 2,
            "cli.train_no_splatting (K1 = K2 = joint steps + sensitivity views)")
    finally:
        rec.restore()
    add(got)
    n_cams = js.evs.shape[0]
    poses = np.load(joint_dir / "optimized_poses.npy")
    starts = js.anchors.cpu().numpy()
    ovf = [(int(m["overflow"]), int(m["grad_overflow"])) for _, m in rec.outputs["joint_step"]]
    joint_ms = [(b - a) * 1e3 for a, b in rec.spans["joint_step"]]
    log(f"  {rec.calls('joint_step')} joint steps over {n_cams} cameras; per-camera steps "
        f"{js.ev_t.cpu().numpy().astype(int).tolist()}; losses {[round(float(m['loss']), 5) for _, m in rec.outputs['joint_step']]}")
    log(f"  ms per joint step (the call to a device sync): median {statistics.median(joint_ms[1:]):.3f}, all "
        f"{[round(v, 1) for v in joint_ms]}")
    log(f"  pose change per camera, max |pose - start|: {np.abs(poses - starts).max(1).round(7).tolist()}")
    assert poses.shape == (n_cams, 7) and np.isfinite(poses).all(), poses.shape
    assert np.allclose(np.linalg.norm(poses[:, :4], axis=1), 1.0, atol=1e-5), "non-unit quaternions"
    assert rec.calls("joint_step") == n_cams and bool((js.ev_t == 1).all()), "not every camera was stepped once"
    assert (np.abs(poses - starts).max(1) > 0).all(), "a stepped pose did not move"
    # the CLI's capacity policy starts at 2^20 slots, as train_no_splatting
    # .py's does, and grows each bucket after a step that clipped it (a soft
    # degradation of that step): each bucket may clip once, on its first
    # frame, and never again
    log(f"  (overflow, grad_overflow) per step: {ovf}")
    assert sum(o > 0 for o, _ in ovf) <= 1 and sum(g > 0 for _, g in ovf) <= 1, f"a bucket clipped twice: {ovf}"
    ply = joint_dir / "point_cloud" / f"iteration_{n_cams}" / "point_cloud.ply"
    written_ply_matches(ply, js.train.scene)
    vq = io_npz.load_npz(joint_dir / "point_cloud_vq.npz", override_quantization=True, device=DEVICE)
    assert vq.is_color_indexed and vq.is_gaussian_indexed
    c0 = cli_tns.Scene(source_path=str(ds), model_path="", scene=vq, resolution=1, shuffle=False,
                       device=DEVICE).get_train_cameras()[0]
    out, got = counted(
        lambda: metrics.render_full(vq, c0.extrinsic_vector, settings_from_intrinsic(c0.intrinsic, inference=True),
                                    np.zeros(3), device=DEVICE),
        lambda o: (o["renders"], 0), "point_cloud_vq.npz served")
    add(got)
    assert int(out["overflow"]) == 0 and bool(torch.isfinite(out["render"]).all())
    log(f"  point_cloud_vq.npz: {(joint_dir / 'point_cloud_vq.npz').stat().st_size} B, {vq.capacity} rows; served "
        f"view PSNR against its photo {float(losses.psnr(out['render'], torch.as_tensor(c0.original_image, device=DEVICE))[0, 0]):.4f}")

    # -- cli.run_indexed, then cli.npz2ply
    preview = CLI_DIR / "indexed_preview.png"
    rec = Recorder()
    rec.wrap(importance, "_importance_step")
    rec.wrap(finetune.trainer, "train_step")
    try:
        (comp, view), got = counted(
            lambda: cli_run_indexed.main(["-s", str(ds), "-m", str(model), "--finetune_iterations", "12", "--out",
                                          str(preview), "--data_device", DEVICE]),
            lambda _: (rec.calls("_importance_step") + rec.calls("train_step") + 2,
                       rec.calls("_importance_step") + rec.calls("train_step")),
            "cli.run_indexed (K1 = sensitivity + finetune + its probe + the view)")
    finally:
        rec.restore()
    add(got)
    size = cameras.resolve_resolution(width, height, -1)  # run_indexed.py's Scene: the default ladder too
    assert rec.calls("train_step") == 12 and Image.open(preview).size == size
    assert bool(torch.isfinite(view["render"]).all()) and comp.is_color_indexed
    log(f"  {preview.name}: {size[0]}x{size[1]}, finite; {comp.capacity} rows, overflow {int(view['overflow'])}")
    ply = CLI_DIR / "npz2ply.ply"
    deindexed, got = counted(lambda: cli_npz2ply.main([str(model / "vq" / "point_cloud.npz"), str(ply),
                                                       "--data_device", DEVICE]),
                             lambda _: (0, 0), "cli.npz2ply")
    written_ply_matches(ply, deindexed)

    densify_check(ds / "sparse" / "0" / "points3D.bin")
    lpips_check(cams[0].original_image, cams[1].original_image)
    log(f"  K1 and K2 launches over the phase: {total}")
    log(f"  card: {smi('name,power.limit')}")
    return total


# ---------------------------------------------- multi-device (phase 20)
MP_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_mp"
MP_WORLD = 8
MP_TIMEOUT_S = 300  # every collective of a rank; a hung one fails the run
MP_GEOMETRIES = ((2, 4), (1, 8), (4, 2))  # __graft_entry__.py:132-134
DRYRUN_N = 50_000  # __graft_entry__.py:70
SCENE_FIELDS = ("xyz", "opacity", "scaling_factor", "active", "features_dc", "features_rest", "scaling", "rotation")


def dryrun_scene():
    """__graft_entry__.py::dryrun_multichip's scene: 50,000 splats, 80% of
    them in a tight off-centre cluster, the rest spread wide, scales
    halved (the same numpy draws)."""
    n = DRYRUN_N
    rng = np.random.default_rng(3)
    tight = rng.normal(size=(n * 4 // 5, 3)).astype(np.float32) * 0.25
    tight[:, 0] += 1.0
    wide = rng.normal(size=(n - tight.shape[0], 3)).astype(np.float32) * 2.0
    pts = np.concatenate([tight, wide])
    pts[:, 2] += 4.0
    cols = rng.random(size=(n, 3)).astype(np.float32)
    scene = gaussians.from_point_cloud(pts, cols, capacity=n, quantization=False, device=DEVICE)
    with torch.no_grad():
        scene.scaling_factor += math.log(0.5)
    return scene


def save_scene(scene, path: Path) -> dict:
    """The scene's leaves to an npz the ranks load; returns what
    scene_from_numpy needs besides them."""
    np.savez(path, **{k: getattr(scene, k).detach().cpu().numpy() for k in SCENE_FIELDS
                      if getattr(scene, k) is not None})
    return dict(path=str(path), max_sh_degree=scene.max_sh_degree, active_sh_degree=scene.active_sh_degree,
                quantization=scene.quantization, use_factor_scaling=scene.use_factor_scaling)


def load_scene(spec: dict):
    with np.load(spec["path"]) as z:
        leaves = {k: z[k] if k in z.files else None for k in SCENE_FIELDS}
    return gaussians.scene_from_numpy(leaves, device=DEVICE,
                                      **{k: v for k, v in spec.items() if k != "path"})


def rel_err(got, ref) -> float:
    return float((got - ref).abs().max()) / max(float(ref.abs().max()), 1e-12)


def mp_rank(rank: int, cfg: dict) -> None:
    """One rank of phase 20: gloo on the card the parent uses, the result
    as JSON under MP_DIR (an exception ends the rank, and the parent's
    spawn raises it)."""
    import datetime

    import torch.distributed as dist

    torch.set_num_threads(1)
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(cfg["store"], cfg["world"]), rank=rank,
                            world_size=cfg["world"], timeout=datetime.timedelta(seconds=MP_TIMEOUT_S))
    try:
        out = mp_work(rank, cfg)
        (MP_DIR / f"rank{rank}.json").write_text(json.dumps(out))
    finally:
        dist.destroy_process_group()


def mp_work(rank: int, cfg: dict) -> dict:
    """Phase 20 on this rank: (a) the reference gate of
    __graft_entry__.py::dryrun_multichip, (b) the bench frame through
    render_tile_sharded and the hybrid step, every K1/K2 launch held to the
    calls that make it; then, outside the counted path, this rank's
    tile-range K1 and K2 timed (and, on cfg["compare_ranks"], held against
    their plain versions)."""
    from c3dgs_tpu_torch.parallel import make_hybrid_train_step, make_mesh, render_tile_sharded, sharded
    from c3dgs_tpu_torch.render.binning import bin_gaussians_routed
    from c3dgs_tpu_torch.render.preprocess import Preprocessed

    t_start = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    opt = OptimizationParams()
    res = {"rank": rank}
    calls = [0, 0]  # the K1 and K2 launches the calls below make

    def made(k1, k2):
        calls[0] += k1
        calls[1] += k2

    kernels.reset_counts()
    meshes = {g: make_mesh(*g) for g in MP_GEOMETRIES}
    res["coords"] = {f"dp{g[0]}xtiles{g[1]}": (m.dp.index, m.tiles.index) for g, m in meshes.items()}

    # (a) the reference gate: 512x256, SH 0, the xyz gradient of vdot(w,
    # image) in exact mode, sharded at 2^18 slots against single-device
    s50 = load_scene(cfg["dryrun"])
    base = RasterSettings(width=512, height=256, tanfovx=math.tan(0.6), tanfovy=math.tan(0.45), sh_degree=0,
                          instance_capacity=1 << 17)
    exact = dataclasses.replace(base, fast_grad=False)
    exact_par = dataclasses.replace(exact, instance_capacity=1 << 18)
    ev = torch.tensor(EV_ID, dtype=torch.float32, device=DEVICE)
    bg = torch.zeros(3, device=DEVICE)
    w = torch.as_tensor(np.random.default_rng(5).normal(size=(3, 256, 512)).astype(np.float32), device=DEVICE)
    (g1,) = torch.autograd.grad(torch.sum(w * trainer.render_scene(s50, ev, exact, bg, device=DEVICE)["render"]),
                                s50.xyz)
    made(1, 1)
    res["gate"] = {}
    for g, mesh in meshes.items():
        img, diag = render_tile_sharded(s50, ev, exact_par, bg, mesh, return_diag=True)
        (gs,) = torch.autograd.grad(torch.sum(w * img), s50.xyz)
        made(1, 1)
        res["gate"][f"dp{g[0]}xtiles{g[1]}"] = (rel_err(gs, g1), int(diag["shard_route_dropped"]))
    # one hybrid step at dp2 x tiles4, 2^17, against a single-device train_step
    gts = np.zeros((2, 3, 256, 512), np.float32)
    state = trainer.create_train_state(load_scene(cfg["dryrun"]), opt, 1.0, device=DEVICE)
    state, m = make_hybrid_train_step(meshes[(2, 4)], base, opt, 1.0)(state, np.stack([EV_ID] * 2), gts, bg)
    state1 = trainer.create_train_state(load_scene(cfg["dryrun"]), opt, 1.0, device=DEVICE)
    _, m1 = trainer.train_step(state1, ev, gts[0], base, bg, opt, 1.0, device=DEVICE)
    made(2, 2)
    res["gate_step"] = (float(m["loss"]), float(m1["loss"]), int(m["shard_route_dropped"]))

    # (b) the bench frame: 300k splats, SH 3, 1920x1080, probe-exact buckets
    scene = load_scene(cfg["bench"])
    st = RasterSettings(**cfg["bench_settings"])
    ex = dataclasses.replace(st, fast_grad=False)
    mesh18, mesh24 = meshes[(1, 8)], meshes[(2, 4)]
    deg = trainer.settings_with_degree(st, scene.active_sh_degree)
    with torch.no_grad():
        prep = sharded._sharded_preprocess(scene.get_xyz(), scene.get_covariance(), scene.get_opacity()[:, 0],
                                           scene.get_features(), ev, deg, mesh18.tiles)
        rb = bin_gaussians_routed(Preprocessed(*(t.detach() for t in prep)), deg, mesh18.tiles)
    res["layout"] = dict(t0=rb.t0, t1=rb.t1, instances=int((~rb.sent_sorted).sum()),
                         cap_local=rb.gid_sorted.shape[0], chunks_exec=int(rb.chunks_exec),
                         route_dropped=int(rb.route_dropped))
    policy = CapacityPolicy(initial=st.instance_capacity, grad_initial=st.grad_capacity)
    with torch.no_grad():
        single = metrics.render_full(scene, ev, st, bg, policy=policy, device=DEVICE)
        img, diag = render_tile_sharded(scene, ev, st, bg, mesh18, return_diag=True)
    made(single["renders"] + 1, 0)
    res["bench_image"] = (float((img - single["render"]).abs().max()), int(diag["shard_route_dropped"]),
                          int(single["overflow"]))
    params = trainer.scene_params(scene)
    zeros = torch.zeros((3, st.height, st.width), device=DEVICE)
    g_sh = torch.autograd.grad(losses.l1_loss(render_tile_sharded(scene, ev, ex, bg, mesh18), zeros),
                               list(params.values()))
    g_1 = torch.autograd.grad(losses.l1_loss(trainer.render_scene(scene, ev, ex, bg, device=DEVICE)["render"],
                                             zeros), list(params.values()))
    made(2, 2)
    res["bench_grads"] = {k: rel_err(a, b) for k, a, b in zip(params, g_sh, g_1)}
    # the hybrid step on two orbit cameras; each camera's target is the
    # other camera's render
    evs = np.stack([orbit_extrinsic(-0.15), orbit_extrinsic(0.15)])
    with torch.no_grad():
        gts = torch.stack([trainer.render_scene(scene, e, st, bg, device=DEVICE)["render"] for e in evs[::-1]])
    made(2, 0)
    _, g_h, dropped_h = sharded.hybrid_loss_and_grads(mesh24, ex, opt, scene, evs, gts, bg)
    total = sum(losses.photometric_loss(trainer.render_scene(scene, e, ex, bg, device=DEVICE)["render"], gt,
                                        opt.lambda_dssim) for e, gt in zip(evs, gts)) / 2
    g_2 = torch.autograd.grad(total, list(params.values()))
    made(3, 3)
    res["hybrid_grads"] = ({k: rel_err(g_h[k], b) for k, b in zip(params, g_2)}, int(dropped_h))
    with torch.no_grad():
        render_ms = host_ms(lambda: render_tile_sharded(scene, ev, st, bg, mesh18), reps=3)
    made(3, 0)
    state = trainer.create_train_state(scene, opt, 1.0, device=DEVICE)
    step = make_hybrid_train_step(mesh24, ex, opt, 1.0)
    step_ms = host_ms(lambda: step(state, evs, gts, bg), reps=1)
    made(1, 1)
    digest = hashlib.sha256()
    for p in trainer.scene_params(state.scene).values():
        digest.update(p.detach().cpu().numpy().tobytes())
    res["replica"] = digest.hexdigest()
    got = launches()
    res["launches"] = (got["tiles_packed_fwd"], got["tiles_packed_bwd"])
    res["calls"] = tuple(calls)
    res["render_ms"], res["step_ms"] = render_ms, step_ms

    # outside the counted path: this rank's tile-range K1 and K2 at the
    # bench frame (8 ranks share the card: correctness-run times only)
    cap = deg.resolve_caps(scene.capacity)[0]
    with torch.no_grad():
        fields = rasterizer._build_fields_packed(
            per_gaussian_table(prep, rb.offset), rb.gid_sorted, rb.tid_sorted, rb.sent_sorted, rb.j_sorted,
            deg.tiles_x, deg.num_tiles, cap)
    meta = torch.stack([rb.chunks_exec, *(torch.full_like(rb.chunks_exec, v) for v in (rb.t0, rb.t1, cap))])
    args = (fields, rb.tile_lo, meta, rb.starts, rb.ends)
    totals = tiles_packed.forward(*args)
    g = torch.zeros_like(totals)
    g[:, :4] = torch.as_tensor(np.random.default_rng(rank).normal(size=(totals.shape[0], 4, tiles.PIX)),
                               dtype=torch.float32, device=DEVICE)
    buf = torch.zeros((16, fields.shape[1]), device=DEVICE)
    out = torch.empty_like(totals)
    res["k1_ms"] = cuda_ms(lambda: tiles_packed.launch(fields, meta, rb.starts, rb.ends, out), reps=10)
    res["k2_ms"] = cuda_ms(lambda: tiles_packed.launch_backward(fields, meta, rb.starts, rb.ends, totals, g, buf),
                           reps=10)
    if rank in cfg["compare_ranks"]:
        with contextlib.redirect_stdout(io.StringIO()):
            k1_err = compare_k1("tile-range K1", args)[0]
            k2_err = compare_k2("tile-range K2", args, totals, g)[0]
        res["compare"] = (k1_err, k2_err)
    res["peak_mb"] = torch.cuda.max_memory_allocated() / 2**20
    res["seconds"] = time.perf_counter() - t_start
    return res


def phase_multi(scene, bench_settings, world=MP_WORLD):
    """Phase 20: the multi-device path (c3dgs_tpu_torch.parallel) on the
    one card, `world` gloo ranks sharing it. Returns the K1 and K2
    launches of every rank's path."""
    log(f"== phase 20: multi-device on one card: {world} gloo ranks on cuda:0 (NCCL refuses two ranks on one "
        "device), the reference gate (__graft_entry__.py::dryrun_multichip) and the 300k bench frame")
    import torch.multiprocessing as mp

    t0 = time.perf_counter()
    shutil.rmtree(MP_DIR, ignore_errors=True)
    MP_DIR.mkdir(parents=True)
    torch.cuda.empty_cache()  # the ranks share the card with this process
    cfg = dict(
        world=world,
        store=str(MP_DIR / "store"),
        dryrun=save_scene(dryrun_scene(), MP_DIR / "dryrun.npz"),
        bench=save_scene(scene, MP_DIR / "bench.npz"),
        bench_settings=dataclasses.asdict(bench_settings),
        compare_ranks=(3, 4),
    )
    log(f"  the ranks load the scenes the parent wrote as numpy arrays ({MP_DIR.name}/dryrun.npz, bench.npz); "
        f"kernels built by phase 1; setup {time.perf_counter() - t0:.1f} s")
    t1 = time.perf_counter()
    mp.start_processes(mp_rank, args=(cfg,), nprocs=world, join=True, start_method="spawn")
    wall = time.perf_counter() - t1
    ranks = [json.loads((MP_DIR / f"rank{r}.json").read_text()) for r in range(world)]

    for name in ranks[0]["gate"]:
        errs = [r["gate"][name][0] for r in ranks]
        dropped = ranks[0]["gate"][name][1]
        log(f"  gate {name}: xyz gradient relative max {max(errs):.3e} over the ranks; route_dropped {dropped}")
        assert max(errs) < 1e-4 and dropped == 0, f"the gate at {name}: {errs}, dropped {dropped}"
    loss, loss1, dropped = ranks[0]["gate_step"]
    log(f"  gate hybrid step dp2xtiles4: loss {loss:.6f}, single-device train_step {loss1:.6f}; dropped {dropped}")
    assert all(r["gate_step"] == ranks[0]["gate_step"] for r in ranks)
    assert abs(loss - loss1) < 5e-4 * max(1.0, abs(loss1)) and dropped == 0
    for r in ranks:
        lay = r["layout"]
        log(f"  rank {r['rank']} (dp, tiles) {r['coords']}: owns tiles {lay['t0']}..{lay['t1'] - 1} at "
            f"dp1xtiles8, {lay['instances']} local instances, cap_local {lay['cap_local']}, chunks_exec "
            f"{lay['chunks_exec']}; tile-range K1 {statistics.median(r['k1_ms']):.4f} ms, K2 "
            f"{statistics.median(r['k2_ms']):.4f} ms (medians of 10); peak {r['peak_mb']:.0f} MiB; "
            f"{r['seconds']:.1f} s")
        assert lay["route_dropped"] == 0
    err, dropped, overflow = ranks[0]["bench_image"]
    log(f"  bench frame dp1xtiles8 vs render_full: max|err| {max(r['bench_image'][0] for r in ranks):.3e}; "
        f"route_dropped {dropped}, single-device overflow {overflow}")
    assert all(r["bench_image"][0] <= 1e-5 for r in ranks) and dropped == 0 and overflow == 0
    bench_g = {k: max(r["bench_grads"][k] for r in ranks) for k in ranks[0]["bench_grads"]}
    log("  bench L1 gradients dp1xtiles8 vs single-device (exact), relative max: "
        + " ".join(f"{k} {v:.2e}" for k, v in bench_g.items()))
    assert max(bench_g.values()) < 1e-4
    hyb = {k: max(r["hybrid_grads"][0][k] for r in ranks) for k in ranks[0]["hybrid_grads"][0]}
    log("  hybrid step dp2xtiles4 gradients vs the single-device 2-camera mean (exact), relative max: "
        + " ".join(f"{k} {v:.2e}" for k, v in hyb.items()))
    assert max(hyb.values()) < 1e-4 and all(r["hybrid_grads"][1] == 0 for r in ranks)
    digests = {r["replica"] for r in ranks}
    log(f"  replicas after the hybrid step: {len(digests)} distinct sha256 over {world} ranks")
    assert len(digests) == 1, "the replicas differ after the hybrid step"
    for r in ranks:
        assert tuple(r["launches"]) == tuple(r["calls"]), (r["rank"], r["launches"], r["calls"])
    k1 = sum(r["launches"][0] for r in ranks)
    k2 = sum(r["launches"][1] for r in ranks)
    log(f"  K1, K2 launches held to each rank's calls: {[tuple(r['launches']) for r in ranks]}; total {k1}, {k2}")
    for r in ranks:
        if "compare" in r:
            log(f"  rank {r['rank']} tile-range K1 vs plain max abs err {r['compare'][0]:.3e}, K2 {r['compare'][1]:.3e}")
    med = lambda key: statistics.median(statistics.median(r[key]) for r in ranks)
    log(f"  ({world} ranks time-share one card and gloo stages through the host: correctness-run times, no "
        f"scaling) tile-range K1 median over ranks {med('k1_ms'):.4f} ms, K2 {med('k2_ms'):.4f} ms; sharded "
        f"render wall {med('render_ms'):.1f} ms, hybrid step wall {med('step_ms'):.1f} ms")
    log(f"  phase 20: {wall:.1f} s for the ranks; card: {smi('name,power.limit')}")
    return {"tiles_packed_fwd": k1, "tiles_packed_bwd": k2}


# ---------------------------------------- another tile shape (phase 21)
TILE_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_tiles"
TILE_SOURCES = ("tiles_packed_fwd.cu", "tiles_packed_bwd.cu", "tiles_fwd.cu", "tiles_bwd.cu")
# 16x16 at full width (the shape of the system this repo ports, config.h:16-17);
# 16x8 and 32x32, the kernels' 64- and 512-thread ends, on the small scenes
TILE_SHAPES = (("16x16", True), ("16x8", False), ("32x32", False))


def phase_tiles(scene, cams):
    """Phase 21: K1-K4 built for other tile shapes, each shape in a child
    process of this script (the shape is read at import) that loads the
    scene this one wrote. Raises if a child fails; returns the 16x16
    child's kernel records and the other shapes' small-scene records."""
    log("== phase 21: K1-K4 at other tile shapes, one child process per shape (C3DGS_TILE_X/Y set before import)")
    shutil.rmtree(TILE_DIR, ignore_errors=True)
    TILE_DIR.mkdir(parents=True)
    bench = save_scene(scene, TILE_DIR / "bench.npz")
    np.save(TILE_DIR / f"views_{TILE_X}x{TILE_Y}.npy", torch.stack([c.original_image for c in cams]).cpu().numpy())
    torch.cuda.empty_cache()  # the child shares the card with this process
    records, small_rows = [], []
    for shape, full in TILE_SHAPES:
        tx, ty = shape.split("x")
        cfg = dict(bench=bench, full=full, refs=str(TILE_DIR / f"views_{TILE_X}x{TILE_Y}.npy"),
                   out=str(TILE_DIR / f"{shape}.json"))
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--tile-phase", shape, json.dumps(cfg)],
                              env=dict(os.environ, C3DGS_TILE_X=tx, C3DGS_TILE_Y=ty), timeout=900)
        if proc.returncode != 0:
            raise RuntimeError(f"phase 21 at {shape}: the child exited {proc.returncode}")
        res = json.loads(Path(cfg["out"]).read_text())
        assert res["tile"] == [int(tx), int(ty)], res["tile"]
        log(f"  {shape}: every check passed in the child, {time.perf_counter() - t0:.1f} s")
        if full:
            records = res["kernels"]
        else:
            small_rows += res["small_scene"]
    log(f"  phase 21 card: {smi('name,power.limit')}")
    return records, small_rows


def tile_child(shape: str, cfg: dict) -> int:
    """Phase 21 at one tile shape, in the child process whose C3DGS_TILE_X/Y
    the parent set: build K1-K4 for it, hold each against its plain
    version (small scenes; with cfg["full"] also the bench frame with its
    bound and times, serving, fwd+bwd and training in both families)."""
    assert [TILE_X, TILE_Y] == [int(v) for v in shape.split("x")], (TILE_X, TILE_Y)
    label = f"phase 21 at {shape}"
    region = "x".join(map(str, tiles.WARP_REGION[::-1]))
    log(f"== {label}: build K1-K4 for {TILE_X}x{TILE_Y} tiles ({tiles.PIX} pixels, {tiles.PIX // 2} threads a "
        f"tile), {tiles.PIX // 64} warps of {region} pixels")
    results = kernels.build(TILE_SOURCES)
    for src in TILE_SOURCES:
        log(f"  {src}: nvcc {results[src].seconds:.1f} s -> {kernels.library_path(src).name}")
        for line in results[src].log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"    {line.strip()}")
    out = {"tile": [TILE_X, TILE_Y]}
    clock_mhz = float(smi("clocks.max.sm").split()[0])
    if not cfg["full"]:
        log(f"== {label}: K1-K4 against their plain versions on the small scenes")
        k1_small_scenes()
        k2_small_scenes()
        k3_small_scenes()
        k4_small_scenes()
        log(f"== {label}: K1-K4 times and bounds on the long-tile scene")
        out["small_scene"] = small_scene_rows(shape, clock_mhz)
        Path(cfg["out"]).write_text(json.dumps(out))
        return 0

    scene = load_scene(cfg["bench"])
    k1, settings, ctx = phase_k1(scene, clock_mhz, plain_reps=0, label=label)
    log(f"  {TILE_X}x{TILE_Y}: {settings.num_tiles} tiles, {int((~ctx.b.sent_sorted).sum())} instances at the bench "
        "frame")
    k2, _, red_ms = phase_k2(ctx, clock_mhz, plain_reps=0, label=label)
    k3, settings_pt, ctx_pt = phase_k3(scene, settings, clock_mhz, plain_reps=0, label=label)
    k4, red_pt_ms = phase_k4(scene, ctx_pt, clock_mhz, plain_reps=0, label=label)
    del ctx, ctx_pt
    launches, serve_ms, cams = phase_serve(scene, settings, label=label)
    k1["launches"] = launches[k1["name"]]
    ref = np.load(cfg["refs"])
    diff = [float(np.abs(c.original_image.cpu().numpy() - r).max()) for c, r in zip(cams, ref)]
    log(f"  (information) max |image at {shape} - image at {cfg['refs'].split('views_')[1][:-4]}| over the 8 views: "
        f"{max(diff):.3e}; per view {[f'{d:.2e}' for d in diff]}")
    k3["launches"] = phase_serve_per_tile(scene, cams, label=label)[k3["name"]]
    phase_fwd_bwd(scene, settings, k2["ms"], red_ms, label=label)
    phase_fwd_bwd(scene, settings_pt, k4["ms"], red_pt_ms, label=label)
    base = RasterSettings(width=1920, height=1080, tanfovx=math.tan(0.6), tanfovy=math.tan(0.6), sh_degree=3)
    packed, loss_p = phase_train_steps(scene, base, steps=4, label=label)
    per_tile, loss_t = phase_train_steps(scene, dataclasses.replace(base, packed=False), steps=2, label=label)
    rel = [abs(a - b) / abs(b) for a, b in zip(loss_p, loss_t)]
    log(f"  packed vs per-tile loss at steps 1-2: {loss_p[:2]} vs {loss_t}; relative {rel[0]:.2e}, {rel[1]:.2e}")
    assert rel[0] < 1e-5 and rel[1] < 1e-3, f"the two families' losses part: {rel}"
    k1["launches"] += packed[k1["name"]]  # serving's renders plus the packed train_steps
    k2["launches"] = packed[k2["name"]]
    k3["launches"] += per_tile[k3["name"]]
    k4["launches"] = per_tile[k4["name"]]
    for k in (k1, k2, k3, k4):
        k["name"] = f"{k['name']}@{shape}"
    out["kernels"] = [k1, k2, k3, k4]
    print(json.dumps({"kernels": out["kernels"]}), flush=True)
    Path(cfg["out"]).write_text(json.dumps(out))
    return 0


def small_scene_rows(shape: str, clock_mhz: float) -> list:
    """K1-K4 at this child's tile shape on the long-tile scene at 64x48
    (the heaviest small scene): CUDA-event medians of 20 and the bounds
    from roofline's counts, with the same byte and operation tallies as
    phases 3, 7, 10 and 11. Small-scene figures: no main path runs these
    shapes, so launches stay 0."""
    means, cov, opacity, colors = long_tile_scene()
    t = lambda x: torch.as_tensor(x, device=DEVICE)
    ev = torch.tensor(EV_ID, dtype=torch.float32, device=DEVICE)
    rows = []

    def row(name, kernel, err, ms, plain_ms, bound):
        rows.append({"name": f"{name}@{shape}", "route": "cuda", "source": f"c3dgs_tpu_torch/csrc/{name}.cu",
                     "replaces": kernel.replaces, "launches": 0, "max_abs_err": err, "ms": statistics.median(ms),
                     "plain_ms": plain_ms[0], "bound_ms": bound[0], "bound_by": bound[1], "library_ms": None,
                     "scene": "long-tile 64x48"})
        log(f"  {name}@{shape} on the long-tile scene: {statistics.median(ms):.4f} ms median of {len(ms)} "
            f"(min {min(ms):.4f}); bound {bound[0]:.6f} ms ({bound[1]}); plain {plain_ms[0]:.1f} ms (one run)")

    with torch.no_grad():
        st = RasterSettings(width=64, height=48, tanfovx=math.tan(0.6), tanfovy=math.tan(0.45))
        prep = preprocess(t(means), t(cov), t(opacity), ev, st, None, t(colors))
        args, complete = k1_args(prep, bin_gaussians(prep, st), st, len(means))
        stats, plain = {}, []
        err, _, out_k, _ = compare_k1(f"long-tile scene at {shape}", args, stats, plain)
        fields, tile_lo, meta, starts, ends = args
        out = torch.empty_like(out_k)
        ms = cuda_ms(lambda: tiles_packed.launch(fields, meta, starts, ends, out), reps=20)
        frz = out_k[:, 5, 0].long()
        walked = int((torch.minimum(frz, ends.long()) - starts.long())[complete].sum())
        nt = starts.shape[0]
        bound = roofline(*fwd_work(walked, nt, 2, stats), clock_mhz)
        row("tiles_packed_fwd", tiles_packed.FORWARD_KERNEL, err, ms, plain, bound)

        g = np.zeros(tuple(out_k.shape), np.float32)
        g[:, :4] = np.random.default_rng(0).normal(size=g[:, :4].shape)
        g = t(g)
        stats, plain = {}, []
        err, got = compare_k2(f"long-tile scene at {shape}", args, out_k, g, stats, plain)
        buf = torch.zeros_like(got)
        ms = cuda_ms(lambda: tiles_packed.launch_backward(fields, meta, starts, ends, out_k, g, buf), reps=20)
        bound = roofline(*bwd_work(walked, nt, got.shape[1], 2, stats), clock_mhz)
        row("tiles_packed_bwd", tiles_packed.BACKWARD_KERNEL, err, ms, plain, bound)

        st = dataclasses.replace(st, packed=False)
        prep = preprocess(t(means), t(cov), t(opacity), ev, st, None, t(colors))
        args, grad_base = per_tile_args(prep, bin_gaussians(prep, st), st)
        stats, plain = {}, []
        err, out_k = compare_k3(f"long-tile scene at {shape}, per-tile", args, st.tiles_x, stats, plain)
        out = torch.empty_like(out_k)
        ms = cuda_ms(lambda: tiles.launch(*args, st.tiles_x, out), reps=20)
        _, _, starts, ends, nch = args
        walked = int(torch.minimum((ends - starts).long(), out_k[:, 5, 0].long() * 128).sum())
        nt = starts.shape[0]
        bound = roofline(*fwd_work(walked, nt, 4, stats), clock_mhz)
        row("tiles_fwd", tiles.FORWARD_KERNEL, err, ms, plain, bound)

        grad_cap = st.resolve_grad_cap(len(means))
        g = np.zeros(tuple(out_k.shape), np.float32)
        g[:, :4] = np.random.default_rng(0).normal(size=g[:, :4].shape)
        g = t(g)
        stats, plain = {}, []
        err, got = compare_k4(f"long-tile scene at {shape}, per-tile", args, grad_base, out_k, g, st.tiles_x,
                              grad_cap, stats, plain)
        buf = torch.zeros_like(got)
        ms = cuda_ms(lambda: tiles.launch_backward(*args, grad_base, out_k, g, st.tiles_x, buf), reps=20)
        bound = roofline(*bwd_work(walked, nt, grad_cap, 5, stats), clock_mhz)
        row("tiles_bwd", tiles.BACKWARD_KERNEL, err, ms, plain, bound)
    return rows


# ------------------------------------------------------------ phase 22
# (tool, its arguments, its environment, the finetune steps it runs, and
# for a cut training (the full run's epochs, the train CLI's --iterations)):
# each tool at its own width, depth cut as PERF.md §4 lists. A cut training
# runs the first epochs of the full run's schedule: the iteration budget
# puts densify, opacity resets and SH warm-up on the full run's epochs
# (cli/train.py::epoch_schedule), so the 8-epoch scene keeps its ~20k
# splats and convergence_run's 2048-entry codebooks see more rows than
# entries. convergence_run's finetune is cut in its compress argv.
TOOL_RUNS = (
    ("bench_compression", [], {"CR_N": "100000", "CR_FT": "150"}, 150, None),
    ("scale_compress_probe", ["--finetune_iters", "50"], {}, 50, None),
    ("convergence_run", ["--epochs", "8"], {}, 100, (220, 1090)),
    ("robustness_runs", ["--only", "A7", "--epochs", "10"], {}, 0, (60, 5000)),
)
TOOL_OUT = {"bench_compression": "--out_dir", "scale_compress_probe": "--out_dir", "convergence_run": "--out_root",
            "robustness_runs": "--out_root"}


def tool_child(name: str, cfg: dict) -> int:
    """Phase 22 in a child process: what `python -m
    c3dgs_tpu_torch.tools.<name> <argv>` runs (the module's main() on
    sys.argv), with every finetune step's metrics and each eigh call's
    matrices and seconds recorded, and the depth cut: cfg["iterations"]
    appended to every train CLI call, cfg["finetune_iterations"] put in
    convergence_run's compress argv. The kernel counts, the steps'
    overflows and the peak memory go to cfg["out"]."""
    steps, eighs = [], []
    real_finetune, real_eigh, real_train = finetune.finetune, quat._eigh, cli_train.main

    def recorded_finetune(*a, history=None, **kw):
        hist = []
        out = real_finetune(*a, history=hist, **kw)
        steps.extend(hist)
        if history is not None:
            history.extend(hist)
        return out

    def timed_eigh(m):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real_eigh(m)
        torch.cuda.synchronize()
        eighs.append((m.reshape(-1, 3, 3).shape[0], time.perf_counter() - t0))
        return out

    finetune.finetune, quat._eigh = recorded_finetune, timed_eigh
    module = f"c3dgs_tpu_torch.tools.{name}"
    tool = importlib.import_module(module)
    k1_inputs, rec = [], Recorder()
    if name == "saturation_probe":
        real_forward = tiles_packed.forward

        def captured_forward(*args):
            k1_inputs[:] = args
            return real_forward(*args)

        tiles_packed.forward = captured_forward
    if name == "scale_train_probe":
        rec.wrap(tool, "render_full")
    if cfg.get("iterations"):
        cli_train.main = lambda argv: real_train([*argv, "--iterations", str(cfg["iterations"])])
    if cfg.get("finetune_iterations"):
        real_argv = tool.compress_argv

        def cut_argv(fast):
            argv = real_argv(fast)
            argv[argv.index("--finetune_iterations") + 1] = str(cfg["finetune_iterations"])
            return argv

        tool.compress_argv = cut_argv
    sys.argv = [module, *cfg["argv"]]
    t0 = time.perf_counter()
    result = tool.main()
    torch.cuda.synchronize()
    seconds, counts = time.perf_counter() - t0, launches()
    extra = {}
    if name in PROBE_TOOLS:
        extra = {"result": result, "gt_renders": rec.renders}
    elif name in BENCH_TOOLS:
        extra = {"result": result}
    if name == "saturation_probe":
        # outside the counted run: the tool's K1 call against the plain K1
        from c3dgs_tpu_torch.tools.saturation_probe import saturation_report

        err, mismatched, _, out_p = compare_k1("saturation probe K1", k1_inputs)
        w = result["workload"]
        extra.update(k1_max_abs_err=err, freeze_mismatches=mismatched, plain_report=saturation_report(
            out_p.cpu().numpy(), k1_inputs[3].cpu().numpy(), k1_inputs[4].cpu().numpy(), w["chunks_exec"],
            w["instances"], w["tiles"], w["n_gaussians"]))
    Path(cfg["out"]).write_text(json.dumps({
        **extra,
        "seconds": seconds,
        "launches": counts,
        "finetune_steps": len(steps),
        "max_overflow": max((s["overflow"] for s in steps), default=0),
        "max_grad_overflow": max((s["grad_overflow"] for s in steps), default=0),
        "finetune_ms": statistics.median(s["ms"] for s in steps) if steps else None,
        "finetune_instances": [steps[0]["num_instances"], steps[-1]["num_instances"]] if steps else None,
        "eigh": {"calls": len(eighs), "matrices": sum(n for n, _ in eighs), "seconds": sum(s for _, s in eighs),
                 "batches": sum(-(-n // quat.EIGH_BATCH) for n, _ in eighs)},
        "peak_gb": torch.cuda.max_memory_allocated() / 2**30,
    }))
    return 0


def argv_n(argv: list, flag: str, default):
    return argv[argv.index(flag) + 1] if flag in argv else default


def finite(*values) -> bool:
    return all(v is not None and math.isfinite(v) for v in values)


def check_tool(name: str, out: Path, rec: dict, expect_steps: int, log_text: str) -> None:
    """Phase 22's checks of one tool's run; raises on the first failure,
    logs the figures."""
    k1, k2 = rec["launches"]["tiles_packed_fwd"], rec["launches"]["tiles_packed_bwd"]
    log(f"  {name}: {rec['seconds']:.1f} s in the child; K1 {k1} launches, K2 {k2}; peak {rec['peak_gb']:.2f} GiB; "
        f"{rec['finetune_steps']} finetune steps at {rec['finetune_ms']} ms median, instances first/last "
        f"{rec['finetune_instances']}, max overflow {rec['max_overflow']}, max grad_overflow "
        f"{rec['max_grad_overflow']}")
    assert k1 > 0 and k2 > 0, f"{name}: the run launched no K1 or no K2"
    assert rec["finetune_steps"] == expect_steps, (name, rec["finetune_steps"], expect_steps)
    assert rec["max_overflow"] == 0 and rec["max_grad_overflow"] == 0, f"{name}: a finetune step overflowed"
    if name == "bench_compression":
        r = json.loads((out / "bench_compression.json").read_text())
        log(f"  bench_compression: ratio {r['ratio']:.4f}x ({r['ply_bytes']} B .ply, {r['size_bytes']} B .npz), "
            f"PSNR vs uncompressed {r['psnr']:.4f} dB (views {[round(p, 3) for p in r['psnrs']]}), "
            f"{r['splats_kept']} of {r['n_splats']} splats kept; line {json.dumps({k: r[k] for k in list(r)[:6]})}")
        assert finite(r["psnr"], *r["psnrs"]) and r["size_bytes"] > 0 and r["ratio"] > 1, r
    elif name == "scale_compress_probe":
        r = json.loads((out / "SCALE_COMPRESS.json").read_text())
        gt = [line for line in log_text.splitlines() if line.startswith("# GT renders")]
        log(f"  scale_compress_probe: {r['n_splats']} splats -> {r['active_after_prune']} active; fidelity "
            f"{r['fidelity_vs_uncompressed_psnr']:.4f} dB, SSIM {r['ssim']:.4f}, base PSNR {r['uncompressed_psnr']}; "
            f"{r['size_bytes']} B npz, ratio vs .ply {r['compression_ratio_vs_ply']:.4f}x; peak "
            f"{r['peak_hbm_gb']} GiB; times {json.dumps(r['times'])}; {gt[0] if gt else ''}")
        e = rec["eigh"]
        log(f"  eigh inside clustering: {e['calls']} calls, {e['matrices']} matrices in {e['batches']} batches of "
            f"<= {quat.EIGH_BATCH}, {e['seconds']:.3f} s")
        assert finite(r["psnr"], r["fidelity_vs_uncompressed_psnr"]) and r["size_bytes"] > 0, r
        assert r["compression_ratio_vs_ply"] > 1, r
    elif name == "convergence_run":
        r = json.loads((out / "convergence.json").read_text())
        res, log_rows = r["results"], [json.loads(x) for x in open(out / "model" / "train_log.jsonl")]
        log(f"  convergence_run: held-out curve " + ", ".join(f"{e['epoch']}: {e['test_psnr']:.3f}"
                                                               for e in r["held_out_curve"])
            + f"; final train EMA {log_rows[-1]['ema_psnr']:.3f} dB, {log_rows[-1]['active']} active, "
            f"{r['seconds_per_epoch']:.2f} s per epoch")
        log(f"  convergence_run compression: {res['psnr']:.4f} dB compressed, {res['uncompressed_psnr']:.4f} "
            f"uncompressed, drop {res['psnr_drop']:.4f} dB, SSIM {res['ssim']:.4f}; {res['ply_size_bytes']} B .ply, "
            f"{res['size_bytes']} B npz, ratio {res['compression_ratio']:.4f}x; times {json.dumps(r['times'])}")
        log(f"  convergence_run log: {log_text.count('[capacity]')} [capacity] lines, "
            f"{log_text.count('[densify] dropped')} [densify] dropped lines")
        assert log_rows[-1]["epoch"] == r["protocol"]["epochs"] - 1, log_rows[-1]
        books = max(int(argv_n(r["protocol"]["compress_argv"], f, 0))
                    for f in ("--color_codebook_size", "--gaussian_codebook_size"))
        assert log_rows[-1]["active"] > books, f"a degenerate VQ: {log_rows[-1]['active']} splats, {books} entries"
        assert finite(res["psnr"], res["uncompressed_psnr"], *(e["test_psnr"] for e in r["held_out_curve"])), r
        assert res["size_bytes"] > 0 and res["compression_ratio"] > 1, res
    else:
        r = json.loads((out / "ROBUSTNESS.json").read_text())
        log_rows = [json.loads(x) for x in open(out / "A7" / "model" / "train_log.jsonl")]
        for run in r["runs"]:
            log(f"  robustness_runs {run['scene']}{run['seed']}: final test {run['final_test_psnr']:.4f} dB, "
                f"train EMA {run['final_train_ema']:.4f}, diverged {run['diverged']}; curve "
                + ", ".join(f"{e['epoch']}: {e['test_psnr']:.3f}" for e in run["eval_curve"]))
        assert log_rows[-1]["epoch"] == r["protocol"]["epochs"] - 1, log_rows[-1]
        assert finite(*(run["final_test_psnr"] for run in r["runs"])), r


def blocked_colors_check(npz: Path, n: int) -> None:
    """Codebook colors evaluated block by block against the dense gather,
    at the image bar (atol 2e-5, rtol 1e-4), on probe view 0 at 1920x1080:
    the finetuned scene from disk (blocked_colors True against False), and
    the n-splat probe scene made codebook-indexed (identity indices), where
    render_scene engages the blocked path itself (at >=
    BLOCKED_COLORS_MIN splats), against blocked_colors=False."""
    from c3dgs_tpu_torch.tools import scale_compress_probe as probe

    settings, _ = probe.probe_settings(1920, 1080)
    ev = probe.ring_extrinsics(12)[0]
    bg = torch.zeros(3, device=DEVICE)
    t0 = time.perf_counter()
    full = probe.make_scene(n, device=DEVICE).to_indexed()
    log(f"  probe scene rebuilt in {time.perf_counter() - t0:.1f} s: {full.capacity} splats, indexed")
    for name, scene, blocked in (("finetuned npz", io_npz.load_npz(str(npz), device=DEVICE), True),
                                 (f"{n}-splat scene, identity indices", full, None)):
        auto = scene.capacity >= trainer.BLOCKED_COLORS_MIN
        assert blocked or auto, "the blocked path would not engage"
        policy = CapacityPolicy()
        with torch.no_grad():
            probe.render_capped(scene, ev, settings, policy, bg, device=DEVICE)
            st = policy.apply(settings)
            got = trainer.render_scene(scene, ev, st, bg, blocked_colors=blocked, device=DEVICE)
            ref = trainer.render_scene(scene, ev, st, bg, blocked_colors=False, device=DEVICE)
        assert int(got["overflow"]) == 0 and int(ref["overflow"]) == 0
        log(f"  {name}: {scene.capacity} splats (blocked {'by default' if auto else 'when asked'}), "
            f"{int(ref['num_instances'])} instances")
        check_close(f"{name}: blocked vs dense colors, view 0 at 1920x1080", got["render"], ref["render"], 2e-5,
                    1e-4)


def run_tool(phase: str, name: str, out: Path, cfg: dict, env=None, timeout=900):
    """`python3 chip_smoke.py --tool-phase <name> <cfg>` with its output in
    out/stdout.log: (the child's record, its log, wall seconds). Raises
    with the log's end if the child fails."""
    log_path = out / "stdout.log"
    t0 = time.perf_counter()
    with open(log_path, "w") as f:
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--tool-phase", name, json.dumps(cfg)],
                              env=dict(os.environ, **(env or {})), stdout=f, stderr=subprocess.STDOUT,
                              timeout=timeout)
    text = log_path.read_text()
    if proc.returncode != 0:
        log(text[-4000:])
        raise RuntimeError(f"{phase}: {name} exited {proc.returncode}")
    return json.loads(Path(cfg["out"]).read_text()), text, time.perf_counter() - t0


def phase_tools() -> dict:
    """Phase 22: the four compression evidence tools on the card, each in a
    child process with its output in a temporary directory; returns their
    summed kernel launches."""
    log("== phase 22: the compression evidence tools (bench_compression, scale_compress_probe, convergence_run, "
        "robustness_runs), one child process each")
    torch.cuda.empty_cache()  # the children share the card with this process
    total = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tools_") as tmp:
        for name, argv, env, ft_steps, schedule in TOOL_RUNS:
            out = Path(tmp) / name
            out.mkdir()
            cfg = dict(argv=[*argv, TOOL_OUT[name], str(out), "--device", DEVICE], out=str(out / "record.json"))
            if schedule:
                full, cfg["iterations"] = schedule
                cut = int(argv_n(argv, "--epochs", full))
                assert cli_train.epoch_schedule(OptimizationParams(epochs=cut, iterations=cfg["iterations"])) == \
                    cli_train.epoch_schedule(OptimizationParams(epochs=full)), (name, schedule)
            if name == "convergence_run":
                cfg["finetune_iterations"] = ft_steps
            rec, text, seconds = run_tool("phase 22", name, out, cfg, env)
            cuts = " ".join(f"{k}={v}" for k, v in (*env.items(), *((k, cfg[k]) for k in
                                                                  ("iterations", "finetune_iterations") if k in cfg)))
            log(f"  {name} {' '.join(argv)} {cuts}: exit 0 in {seconds:.1f} s")
            check_tool(name, out, rec, ft_steps, text)
            for k, v in rec["launches"].items():
                total[k] = total.get(k, 0) + v
            if name == "scale_compress_probe":
                blocked_colors_check(out / "scale_compress.npz", int(argv_n(argv, "--n", 1_200_000)))
    log(f"  phase 22 launches: K1 {total['tiles_packed_fwd']}, K2 {total['tiles_packed_bwd']}; card "
        f"{smi('name,power.limit')}")
    return total


# ------------------------------------------------------------ phase 23
# (tool, its arguments): the last tools at their own widths; only
# scale_train_probe's depth is cut (2000 -> 500 steps: the first densify at
# step 300 with its capacity growth, the SH degree at 125 / 250 / 375; the
# opacity reset at 900 falls outside)
PROBE_TOOLS = ("saturation_probe", "clamp_probe", "scale_train_probe", "dcn_probe")
PROBE_CUT = {"scale_train_probe": ["--steps", "500"]}
GROWN_CAPACITY = 2 * (int(1_000_000 * 1.25) // 128 * 128)  # the 1M init's rows after its one growth
CODEC_CALLS = {}  # host-codec calls on the main paths, written by phases 17 and 18


def clamp_identity(rows, true_inst: int, tiles: int, dropped_key: str) -> None:
    """Each clamped render drops the instances and one sentinel per tile
    past its capacity: true instances - capacity + tiles, exactly."""
    for r in rows:
        cap = int(true_inst * r["capacity_fraction"]) // 128 * 128
        assert r[dropped_key] == true_inst - cap + tiles, (r, true_inst, cap, tiles)


def check_probe(name: str, out: Path, rec: dict) -> dict:
    """Phase 23's checks of one tool's run; raises on the first failure,
    logs the figures and returns the K1 / K2 launches of its main path."""
    k1, k2 = rec["launches"]["tiles_packed_fwd"], rec["launches"]["tiles_packed_bwd"]

    def tiles_of(res: str) -> int:
        w, h = (int(v) for v in res.split("x"))
        return RasterSettings(width=w, height=h, tanfovx=1.0, tanfovy=1.0).num_tiles

    if name == "saturation_probe":
        r = rec["result"]
        w, p, f, sat = r["workload"], r["per_tile_chunks"], r["freeze"], r["saturation"]
        log(f"  saturation_probe: {w['n_gaussians']} splats, {w['instances']} instances in {w['tiles']} tiles, "
            f"chunks_exec {w['chunks_exec']}; segment chunks {p['total_segment_chunks']}, interior (flush-free) "
            f"{p['interior_flush_free_chunks']}; tiles frozen {f['tiles_frozen']}, chunks skipped by the freeze "
            f"{f['chunks_skipped_by_freeze']} (skip share of chunks_exec {f['skip_fraction_of_exec']}); tiles "
            f"saturated at the end {sat['tiles_fully_saturated_final']}, pixels saturated "
            f"{sat['pixels_saturated_fraction']}")
        log(f"  saturation_probe K1 vs plain: max abs err {rec['k1_max_abs_err']:.3e}, "
            f"{rec['freeze_mismatches']} freeze-slot ties")
        assert f["chunks_skipped_by_freeze"] <= p["interior_flush_free_chunks"] <= p["total_segment_chunks"], r
        assert f["tiles_frozen"] <= w["tiles"], r
        assert rec["plain_report"] == {k: v for k, v in r.items() if k != "card"}, \
            "the report from the plain K1's blocks differs"
        expect = (2, 0)  # the probe render and the packed forward
    elif name == "clamp_probe":
        r = json.loads((out / "CLAMP_PROBE.json").read_text())
        rows = r["curve"]
        log(f"  clamp_probe: {r['n_gaussians']} splats, {r['true_instances']} true instances at {r['resolution']}; "
            + ", ".join(f"{c['capacity_fraction']:.0%}: {c['instances_dropped']} dropped, "
                        f"{c['psnr_vs_exact_dB']:.4f} dB" for c in rows))
        psnrs = [c["psnr_vs_exact_dB"] for c in rows]
        assert len(rows) == 4 and finite(*psnrs) and all(a > b for a, b in zip(psnrs, psnrs[1:])), rows
        clamp_identity(rows, r["true_instances"], tiles_of(r["resolution"]), "instances_dropped")
        expect = (6, 0)  # the probe render, the exact one, four clamped
    elif name == "scale_train_probe":
        r = json.loads((out / "SCALE_TRAIN.json").read_text())
        steps = r["steps"]
        log_rows = [json.loads(x) for x in open(out / "scale_train_log.jsonl")]
        log(f"  scale_train_probe ({steps} steps): final {r['final_active']} active in {r['final_capacity']} rows, "
            f"{r['capacity_growths']} growth(s), EMA PSNR {log_rows[0]['ema_psnr']:.4f} -> {r['final_ema_psnr']:.4f} "
            f"dB, {r['seconds_total']:.1f} s ({r['seconds_total'] / steps * 1e3:.1f} ms a step with densify and "
            f"logging), peak {rec['peak_gb']:.2f} GiB; {rec['gt_renders']} GT renders; {r['clamped_steps']} of "
            f"{steps} steps trained clamped (the slot domain holds {MAX_BINNING_CAP}), largest overflow "
            f"{r['max_overflow']} instances")
        log("  scale_train_probe log: " + "; ".join(
            f"{x['step']}: {x['ema_psnr']:.3f} dB, {x['active']} active, {x['capacity']} rows, {x['instances']} inst"
            for x in log_rows))
        log(f"  scale_train_probe clamp on view 0 ({r['true_instances_view0']} true instances): " + ", ".join(
            f"{c['capacity_fraction']:.0%}: {c['dropped']} dropped, {c['psnr_vs_exact']:.4f} dB"
            for c in r["clamp_experiment"]))
        assert finite(r["final_ema_psnr"]) and r["final_ema_psnr"] > log_rows[0]["ema_psnr"], r
        # the training leaves the clamped regime: its last frame fits the slot domain
        assert r["clamped_steps"] < steps and log_rows[-1]["instances"] < MAX_BINNING_CAP - tiles_of(r["resolution"]), r
        clamp_identity(r["clamp_experiment"], r["true_instances_view0"], tiles_of(r["resolution"]), "dropped")
        if steps == 500:
            assert r["capacity_growths"] == 1 and r["final_capacity"] == GROWN_CAPACITY, r
        expect = (steps + rec["gt_renders"] + 6, steps)  # a K1 and a K2 a step; GT renders; the clamp's six
    else:
        r = json.loads((out / "MULTIPROC.json").read_text())
        log(f"  dcn_probe: {r['devices_global']} ranks on {r['processes']} nodes, mesh {r['mesh']}, {r['collectives']}; "
            f"loss {r['loss']:.9f} vs single-device {r['ref_loss']:.9f}; max parameter difference "
            f"{r['max_param_update_diff_vs_single_device']:.3e} ({json.dumps(r['per_param_diffs'])}); route_dropped "
            f"{r['shard_route_dropped']}")
        for x in r["ranks"]:
            log(f"    rank {x['rank']} node {x['node']} (dp {x['dp_index']}, tile {x['tile_index']}): tiles group on "
                f"nodes {x['tiles_group_nodes']}, dp group on {x['dp_group_nodes']}; K1/K2 {x['launches']} for "
                f"calls {x['calls']}" + (f"; {x['diagnosis']}" if "diagnosis" in x else ""))
        assert not r["failures"], r["failures"]
        assert r["max_param_update_diff_vs_single_device"] < 5e-5 and abs(r["loss"] - r["ref_loss"]) < 1e-5
        assert r["shard_route_dropped"] == 0 and len(r["ranks"]) == 8
        for x in r["ranks"]:
            assert len(set(x["tiles_group_nodes"])) == 1 and sorted(x["dp_group_nodes"]) == [0, 1], x
            assert x["launches"] == x["calls"], x
        k1 += sum(x["launches"][0] for x in r["ranks"])
        k2 += sum(x["launches"][1] for x in r["ranks"])
        expect = tuple(sum(x["calls"][i] for x in r["ranks"]) for i in range(2))
    assert (k1, k2) == expect, f"{name}: K1/K2 launches {(k1, k2)}, its calls {expect}"
    log(f"  {name}: K1 {k1}, K2 {k2} launches, equal to its calls; card {smi('name,power.limit')}")
    return {"tiles_packed_fwd": k1, "tiles_packed_bwd": k2}


def codec_check(xyz: np.ndarray) -> None:
    """The host codec on the card's machine: built and loaded, its arrays
    equal to the numpy versions on phase 18's points3D.bin and on the bench
    scene's Morton order, and called on phase 17's and phase 18's paths."""
    t0 = time.perf_counter()
    native.get_lib()
    build_s = time.perf_counter() - t0
    path = CLI_DIR / "dataset" / "sparse" / "0" / "points3D.bin"
    t0 = time.perf_counter()
    got = native.read_points3d_binary(path)
    t1 = time.perf_counter()
    want = colmap.read_points3D_binary(path)
    t2 = time.perf_counter()
    for a, b in zip(got, want, strict=True):
        assert np.array_equal(a, b), "the codec's points3D.bin parse differs from the numpy parser"
    t3 = time.perf_counter()
    order = native.morton_order(xyz)
    t4 = time.perf_counter()
    assert np.array_equal(order, morton.morton_order(xyz)), "the codec's Morton order differs from numpy's"
    t5 = time.perf_counter()
    log(f"  host codec: built and loaded in {build_s:.3f} s ({native.library_path().name}); points3D.bin of "
        f"{len(got[0])} points {t1 - t0:.4f} s (numpy {t2 - t1:.4f} s), equal; Morton order of {len(xyz)} points "
        f"{t4 - t3:.4f} s (numpy {t5 - t4:.4f} s), equal; calls on the main paths {json.dumps(CODEC_CALLS)}")
    assert len(CODEC_CALLS) == 2 and all(n >= 1 for n in CODEC_CALLS.values()), CODEC_CALLS


def phase_probe_tools(xyz) -> dict:
    """Phase 23: the host codec (given the bench scene's xyz) and the last
    tools, each in a child process with its output in a temporary
    directory (scale_train_probe cut to 500 steps); returns their summed
    kernel launches, every rank's for dcn_probe."""
    log("== phase 23: the host codec and the last tools (saturation_probe, clamp_probe, scale_train_probe, "
        "dcn_probe), one child process each")
    t_phase = time.perf_counter()
    codec_check(xyz)
    torch.cuda.empty_cache()  # the children share the card with this process
    total = {"tiles_packed_fwd": 0, "tiles_packed_bwd": 0}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_probes_") as tmp:
        for name in PROBE_TOOLS:
            out = Path(tmp) / name
            out.mkdir()
            argv = PROBE_CUT.get(name, [])
            where = [] if name == "saturation_probe" else ["--out_dir", str(out)]
            cfg = dict(argv=[*argv, *where, "--device", DEVICE], out=str(out / "record.json"))
            rec, _, seconds = run_tool("phase 23", name, out, cfg)
            log(f"  {name} {' '.join(argv)}: exit 0 in {seconds:.1f} s")
            for k, v in check_probe(name, out, rec).items():
                total[k] += v
    log(f"  phase 23: {time.perf_counter() - t_phase:.1f} s; launches K1 {total['tiles_packed_fwd']}, K2 "
        f"{total['tiles_packed_bwd']}; card {smi('name,power.limit')}")
    return total


# ------------------------------------------------------------ phase 24
# (tool, its arguments, its environment): the bench entry points at full
# width; bench's and bench_render's iterations cut (30 -> 10 steps a short
# block, 3 -> 2 blocks; 50 -> 10 renders), profile_bench's steps 3 -> 1 and
# its rows 25 -> 12, cumsum_probe's calls 30 -> 5
BENCH_TOOLS = ("bench", "bench_render", "profile_bench", "dispatch_probe", "cumsum_probe")
BENCH_RUNS = (
    ("bench", [], {"C3DGS_BENCH_ITERS": "10", "C3DGS_BENCH_BLOCKS": "2"}),
    ("bench_render", [], {"C3DGS_BENCH_ITERS": "10"}),
    ("profile_bench", ["--packed", "1", "--steps", "1", "--top", "12"], {}),
    ("profile_bench", ["--packed", "0", "--steps", "1", "--top", "12"], {}),
    ("dispatch_probe", [], {}),
    ("cumsum_probe", ["--calls", "5"], {}),
)
BENCH_KEYS = ["metric", "value", "unit", "vs_baseline", "dispatch_ms", "opacity_mode", "floor_ms", "vs_floor"]
RENDER_KEYS = ["metric", "value", "unit", "vs_baseline", "dispatch_ms"]
# max abs error against float64 of every formulation but the one-pass bf16
# matmul (printed only) and torch.cumsum over dim 0, a sequential fp32 scan
# on the card (1.745e-2 on the probe's rows), held bit for bit to numpy's
CUMSUM_TOL = 1e-2


def json_lines(text: str) -> list:
    """The JSON objects a tool printed, one a line."""
    return [json.loads(line) for line in text.splitlines() if line.startswith("{")]


def check_bench_tool(name: str, argv: list, rec: dict, text: str) -> dict:
    """Phase 24's checks of one bench tool's run; raises on the first
    failure, logs its JSON lines and returns its kernel launches."""
    r, lines = rec["result"], json_lines(text)
    for line in lines:
        log(f"  {name} {' '.join(argv)}: {json.dumps(line)}")
    if name == "bench":
        (line,) = lines
        assert list(line) == BENCH_KEYS and list(line["floor_ms"]) == ["pair_math", "row_ops", "sorts", "total"], line
        assert line["metric"] == f"rasterize_fwd_bwd_ms_per_frame_1920x1080_{BENCH_N}g" and line["unit"] == "ms"
        assert finite(line["value"], line["dispatch_ms"], *line["floor_ms"].values()) and line["value"] > 0, line
        assert f"# instances={r['instances']} -> capacity bucket" in text, "no probe line"
        assert r["bitwise_repeatable"], "the bench's gradients are not bitwise repeatable"
        log(f"  bench: {r['instances']} instances, grad_total {r['grad_total']}, buckets {r['buckets']}, "
            f"{r['steps']} steps, overflow 0, gradients bitwise repeatable")
    elif name == "bench_render":
        assert [line["metric"] for line in lines] == [
            f"render_fwd_ms_per_frame_1920x1080_{BENCH_N}g_{m}" for m in ("dense", "indexed")], lines
        assert all(list(line) == RENDER_KEYS and finite(line["value"], line["dispatch_ms"]) for line in lines), lines
        assert not r["blocked_colors"], "a 300k-splat indexed scene evaluates its colors densely"
    elif name == "profile_bench":
        (line,) = lines
        assert list(line) == ["packed", "steps", "device_total_ms", "top"] and line["top"], line
        assert line["device_total_ms"] > 0 and line["packed"] == int(argv[1]), line
    elif name == "dispatch_probe":
        (line,) = lines
        assert list(line) == ["one_step_ms", "two_step_ms_per_frame", "dispatch_amortized_ms"], line
        assert finite(*line.values()), line
        log(f"  dispatch_probe: instances of the two cameras {r['instances']}")
    else:
        (line,) = lines
        assert list(line) == ["cumsum", "transposed", "twolevel", "matmul", "matmul_hp", "matmul_bf16"], line
        for f, v in line.items():
            assert finite(v["ms"], v["max_abs_err"]), (f, v)
            if f == "cumsum":  # the outer-dimension scan adds one row at a time: fp32's own error
                assert v["equals_sequential_fp32"], (f, v)
            elif f != "matmul_bf16":
                assert v["max_abs_err"] < CUMSUM_TOL, (f, v)
        log(f"  cumsum_probe: torch.cumsum(x, 0) equals the sequential fp32 scan bit for bit (its error "
            f"{r['sequential_fp32_err']:.3e}); the others under {CUMSUM_TOL:g} but the one-pass bf16 matmul "
            f"({line['matmul_bf16']['max_abs_err']:.3e})")
    got = {k: v for k, v in rec["launches"].items() if v}
    assert got == r.get("calls", {}), f"{name}: launches {got}, its calls {r.get('calls')}"
    log(f"  {name}: launches {json.dumps(got)}, equal to its calls; card {r['card']}")
    return got


def phase_bench_tools() -> dict:
    """Phase 24: the bench entry points, each in a child process with the
    depth BENCH_RUNS cuts; returns their summed kernel launches."""
    log("== phase 24: the bench entry points (bench, bench_render, profile_bench --packed 1 and 0, dispatch_probe, "
        "cumsum_probe), one child process each")
    torch.cuda.empty_cache()  # the children share the card with this process
    total = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_bench_") as tmp:
        for i, (name, argv, env) in enumerate(BENCH_RUNS):
            out = Path(tmp) / f"{i}_{name}"
            out.mkdir()
            cfg = dict(argv=[*argv, "--device", DEVICE], out=str(out / "record.json"))
            rec, text, seconds = run_tool("phase 24", name, out, cfg, env)
            cuts = " ".join(f"{k}={v}" for k, v in env.items())
            log(f"  {name} {' '.join(argv)} {cuts}: exit 0 in {seconds:.1f} s")
            for k, v in check_bench_tool(name, argv, rec, text).items():
                total[k] = total.get(k, 0) + v
    log(f"  phase 24 launches: {json.dumps(total)}; card {smi('name,power.limit')}")
    return total


def timed(n: int, fn, *args, **kw):
    """fn(*args, **kw), then `== phase n: done (seconds)`."""
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    log(f"== phase {n}: done ({time.perf_counter() - t0:.1f} s)")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the card only", file=sys.stderr)
        return 2
    assert "jax" not in sys.modules and "c3dgs_tpu" not in sys.modules
    if sys.argv[1:2] == ["--tile-phase"]:
        return tile_child(sys.argv[2], json.loads(sys.argv[3]))
    if sys.argv[1:2] == ["--tool-phase"]:
        return tool_child(sys.argv[2], json.loads(sys.argv[3]))
    t_start = time.perf_counter()
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    card = timed(1, phase_build)
    clock_mhz = float(smi("clocks.max.sm").split()[0])
    timed(2, phase_small)
    t0 = time.perf_counter()
    scene, knn_s = bench_scene(DEVICE, BENCH_N)
    log(f"  bench scene: {BENCH_N} splats, kNN scale init {knn_s:.2f} s on the card")
    k1, settings, ctx = phase_k1(scene, clock_mhz)
    log(f"== phase 3: done ({time.perf_counter() - t0:.1f} s)")
    launches, serve_ms, cams = timed(4, phase_serve, scene, settings)
    k1["launches"] = launches[k1["name"]]
    timed(5, phase_breakdown, scene, settings)
    timed(6, phase_grads)
    k2, seg, red_ms = timed(7, phase_k2, ctx, clock_mhz)
    timed(8, phase_fwd_bwd, scene, settings, k2["ms"], red_ms)
    base = RasterSettings(width=1920, height=1080, tanfovx=math.tan(0.6), tanfovy=math.tan(0.6), sh_degree=3)
    train_launches, _ = timed(9, phase_train, scene, base)
    k1["launches"] += train_launches[k1["name"]]  # serving's 8 plus training's steps and probe
    k2["launches"] = train_launches[k2["name"]]
    seg["launches"] = train_launches[seg["name"]]  # the exact steps' backwards
    # the per-tile family (packed=False)
    k3, settings_pt, ctx_pt = timed(10, phase_k3, scene, settings, clock_mhz)
    k4, red_pt_ms = timed(11, phase_k4, scene, ctx_pt, clock_mhz)
    k3["launches"] = timed(12, phase_serve_per_tile, scene, cams)[k3["name"]]
    timed(13, phase_grads_per_tile)
    timed(14, phase_fwd_bwd, scene, settings_pt, k4["ms"], red_pt_ms, label="phase 14")
    train_pt, _ = timed(15, phase_train_steps, scene, dataclasses.replace(base, packed=False))
    k3["launches"] += train_pt[k3["name"]]  # per-tile serving's 8 plus training's steps
    k4["launches"] = train_pt[k4["name"]]
    probes = timed(16, phase_probes)
    compress_launches, compressed = timed(17, phase_compress, scene, cams, serve_ms)
    k1["launches"] += compress_launches[k1["name"]]  # sensitivity, finetune and serving the npz
    k2["launches"] += compress_launches[k2["name"]]  # sensitivity and finetune
    cli_launches = timed(18, phase_cli, scene)
    k1["launches"] += cli_launches[k1["name"]]  # the CLIs' steps, evals, sensitivity, finetune, renders
    k2["launches"] += cli_launches[k2["name"]]  # the CLIs' steps, sensitivity and finetune
    pose_launches = timed(19, phase_pose, scene, cams, compressed)
    k1["launches"] += pose_launches[k1["name"]]  # pose and joint steps, sensitivity, finetune, renders
    k2["launches"] += pose_launches[k2["name"]]  # pose and joint steps, sensitivity and finetune
    multi = timed(20, phase_multi, scene, settings)
    k1["launches"] += multi[k1["name"]]  # every rank's sharded and reference renders and steps
    k2["launches"] += multi[k2["name"]]
    other_shape, small_rows = timed(21, phase_tiles, scene, cams)
    xyz = scene.xyz.detach().cpu().numpy()
    del scene, cams, compressed, ctx, ctx_pt
    tools = timed(22, phase_tools)
    k1["launches"] += tools[k1["name"]]  # the tools' GT renders, train steps, evals, sensitivity, finetune
    k2["launches"] += tools[k2["name"]]  # their train steps, sensitivity and finetune
    last = timed(23, phase_probe_tools, xyz)
    k1["launches"] += last[k1["name"]]  # the probes' renders, train steps, every dcn rank's step and reference
    k2["launches"] += last[k2["name"]]  # the train steps, every dcn rank's step and reference
    benches = timed(24, phase_bench_tools)
    for k in (k1, k2, k3, k4):  # the benches' probes, steps and renders; profile_bench --packed 0's K3 / K4
        k["launches"] += benches.get(k["name"], 0)
    log("== phase 25: the kernels line, the card and the status")
    log("small-scene kernel figures at 16x8 and 32x32 (no main path): " + json.dumps(small_rows))
    log(f"== done in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [k1, k2, k3, k4, seg, *probes, *other_shape]}), flush=True)
    print(card, flush=True)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
