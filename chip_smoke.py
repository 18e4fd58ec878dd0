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
     does) and on the two freeze scenes at 64x48; K1's time, its plain
     version's time and the frame's bound;
  4. serve: render_and_eval over 8 orbit poses of the 300k scene through
     the capacity policy (inference=True), with every kernel count reset
     just before and read just after; per-view ms from CUDA events;
  5. where a bench-frame render spends its time: each stage of the
     render path timed with CUDA events, and the profiler's device time by
     kernel name;
  6. the `kernels` JSON line, the card line, and the final status line.
It imports nothing of JAX and nothing of the c3dgs_tpu package.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

from c3dgs_tpu_torch import kernels
from c3dgs_tpu_torch.eval import metrics
from c3dgs_tpu_torch.models import gaussians
from c3dgs_tpu_torch.ops import quat
from c3dgs_tpu_torch.render import oracle, rasterizer, tiles_packed
from c3dgs_tpu_torch.render.binning import bin_gaussians, per_gaussian_table
from c3dgs_tpu_torch.render.capacity import CapacityPolicy
from c3dgs_tpu_torch.render.preprocess import preprocess
from c3dgs_tpu_torch.render.types import RasterSettings, settings_from_intrinsic
from c3dgs_tpu_torch.train import trainer

# H100 SXM peaks (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
SMS = 132
SFU_PER_SM_CLOCK = 16  # special-function (MUFU) results per SM per clock
LOG_EXIT_T = math.log(1e-6)
DEVICE = "cuda"
BENCH_N = 300_000  # bench.py's gaussian count


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


# ------------------------------------------------------------------ scenes
def small_scene(n=300, seed=0):
    """tests/test_render.py::make_scene with SH."""
    rng = np.random.default_rng(seed)
    means = rng.normal(size=(n, 3)).astype(np.float32) * 0.8
    means[:, 2] += 4.0
    scales = np.exp(rng.normal(size=(n, 3)).astype(np.float32) * 0.5 - 2.5)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    opacity = (1 / (1 + np.exp(-rng.normal(size=n)))).astype(np.float32)
    rng.random(size=(n, 3))  # the recipe's colors draw, unused with SH
    shs = rng.normal(size=(n, 16, 3)).astype(np.float32) * 0.3
    return means, scales, quats, opacity, shs


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
    means, scales, quats, opacity, shs = small_scene()
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
        args = staged_inputs(
            scene.get_xyz(), scene.get_covariance(), scene.get_opacity()[:, 0], ev, deg, shs=scene.get_features()
        )
        stats = {}
        err, mism, out_k, _ = compare_k1("bench frame 1920x1080", args, stats)

        fields, tile_lo, meta, starts, ends = args
        out = torch.empty_like(out_k)
        ms = cuda_ms(lambda: tiles_packed.launch(fields, meta, starts, ends, out), reps=20)
        plain_ms = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tiles_packed.forward_plain(*args)
            torch.cuda.synchronize()
            plain_ms.append((time.perf_counter() - t0) * 1e3)

    # the least time for this frame's work: each staged field slot a tile
    # walks read once (9 f32 rows), starts/ends read, blocks written; every
    # walked (pixel, slot) pair one exp, and those with alpha > 0 a log1p
    # and an exp more, on the card's special-function units
    nc = int(meta[0])
    complete = ends < nc * 128
    frz = out_k[:, 5, 0].long()
    walked = int((torch.minimum(frz, ends.long()) - starts.long())[complete].sum())
    t = starts.shape[0]
    bytes_moved = 9 * 4 * walked + 2 * 4 * t + t * 8 * 512 * 4
    sfu_ops = stats["pairs"] + 2 * stats["alpha_pairs"]
    flops = 12 * stats["pairs"] + 11 * stats["alpha_pairs"]
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_sfu = sfu_ops / (SMS * SFU_PER_SM_CLOCK * card_clock_mhz * 1e6) * 1e3
    t_flops = flops / FP32_FLOPS * 1e3
    bound = max(t_bytes, t_sfu, t_flops)
    log(f"  work: {walked} walked slots, {stats['pairs']} (pixel, slot) pairs, {stats['alpha_pairs']} with alpha > 0")
    log(f"  bound: bytes {t_bytes:.4f} ms ({bytes_moved} B), special functions {t_sfu:.4f} ms "
        f"({sfu_ops} ops at {card_clock_mhz} MHz), fp32 {t_flops:.4f} ms ({flops} flops)")
    log(f"  K1 {statistics.median(ms):.4f} ms median of {len(ms)} (min {min(ms):.4f}); "
        f"plain {statistics.median(plain_ms):.1f} ms median of 3")
    return {
        "name": "tiles_packed_fwd",
        "route": "cuda",
        "source": "c3dgs_tpu_torch/csrc/tiles_packed_fwd.cu",
        "replaces": tiles_packed.FORWARD_KERNEL.replaces,
        "launches": None,  # filled from the serve run
        "max_abs_err": err,
        "freeze_mismatches": mism,
        "ms": statistics.median(ms),
        "plain_ms": statistics.median(plain_ms),
        "bound_ms": bound,
        "bound_by": "bytes" if t_bytes >= max(t_sfu, t_flops) else "operations",
        "library_ms": None,  # no single PyTorch call composites tiles
    }, settings


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
    for name, n in launches.items():
        assert n > 0, f"kernel {name} was never launched on the main path"
    assert launches["tiles_packed_fwd"] == results["num_renders"], "K1 launches != renders"
    return launches, per_view_ms


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
    k1, settings = phase_k1(scene, clock_mhz)
    launches, _ = phase_serve(scene, settings)
    k1["launches"] = launches[k1["name"]]
    phase_breakdown(scene, settings)
    log(f"== done in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [k1]}), flush=True)
    print(card, flush=True)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
