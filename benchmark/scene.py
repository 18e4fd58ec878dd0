"""The benchmark's inputs, made on the device from the seed: the scene's
parameters (and, for a compressed configuration, its codebook tables and
indices), the cameras and the training targets.

A frozen copy of the bench recipe (`tools/scenes.bench_arrays` in the
port, which draws with numpy on the host) rewritten for the card: points
N(0, spread^2) about `center`, uniform colors, opacities
Beta(a, b) clipped, splat scales from the exact mean squared distance to
the 3 nearest neighbours times `scale_mult`, isotropic with identity
rotations; higher SH bands N(0, sh_rest_std^2) from a second stream.
Every draw comes from a `torch.Generator` on `device`, one per stream, so
the same seed gives the same tensors. Nothing here imports the program.
"""
from __future__ import annotations

import math
from typing import Dict, List

import torch

SH_C0 = 0.28209479177387814


def generator(device, seed: int, stream: int) -> torch.Generator:
    """Stream `stream` (< 16) of `seed` (any non-negative int below 2^59)."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) << 4) | stream)
    return g


def _uniform(shape, g, device):
    return torch.rand(shape, generator=g, device=device, dtype=torch.float32)


def _normal(shape, g, device):
    return torch.randn(shape, generator=g, device=device, dtype=torch.float32)


def sample_gamma(shape: float, n: int, g, device) -> torch.Tensor:
    """Gamma(shape, 1) draws: Marsaglia and Tsang's method at shape + 1,
    times U^(1/shape) (shape < 1). Each round draws whole-size tensors and
    fills the rows not yet accepted, so the result depends on the seed alone."""
    d = shape + 1.0 - 1.0 / 3.0
    c = 1.0 / math.sqrt(9.0 * d)
    out = torch.zeros(n, dtype=torch.float32, device=device)
    todo = torch.ones(n, dtype=torch.bool, device=device)
    for _ in range(64):
        x = _normal((n,), g, device)
        u = _uniform((n,), g, device)
        v = (1.0 + c * x) ** 3
        ok = (v > 0) & (torch.log(u.clamp_min(1e-30)) < 0.5 * x * x + d - d * v + d * torch.log(v.clamp_min(1e-30)))
        take = todo & ok
        out = torch.where(take, d * v, out)
        todo = todo & ~ok
        if not bool(todo.any()):
            break
    else:
        raise RuntimeError("gamma sampler did not converge")
    boost = _uniform((n,), g, device).clamp_min(1e-30) ** (1.0 / shape)
    return out * boost


def sample_beta(a: float, b: float, n: int, g, device) -> torch.Tensor:
    x = sample_gamma(a, n, g, device)
    y = sample_gamma(b, n, g, device)
    return x / (x + y)


def knn_mean_sq_dist(pts: torch.Tensor, k: int = 3, chunk: int = 1 << 22, fill_cap: int = 64,
                     brute_rows: int = 32) -> torch.Tensor:
    """Exact mean squared distance to the k nearest other points, on the
    device, by a grid search: at a cell size h every point whose k-th
    neighbour found among the 27 cells about its own lies within h is
    exact (the 27 cells hold the ball of radius h); the rest go on to the
    next level at 2h, whose 27 cells hold the last level's. The first h is
    1.5 times the mean spacing of the densest part of the cloud: the cube
    root of the volume per point of the ball about the median that holds
    1% of the points. Within a level, points are taken in groups by the
    fullest of their 27 cells, so that each pays for its own cells; a
    point whose fullest cell holds more than `fill_cap` points (a sparse
    point beside a dense region, at a coarse level) is left to the end,
    where it is compared with every point, `brute_rows` at a time."""
    n, dev = pts.shape[0], pts.device
    best = torch.full((n, k), float("inf"), dtype=torch.float32, device=dev)
    center = pts.median(dim=0).values
    r = torch.linalg.vector_norm(pts - center, dim=1)
    core = max(n // 100, 1)
    r_core = torch.kthvalue(r, core).values.clamp_min(1e-6)
    h = 1.5 * float((4.0 / 3.0 * math.pi * r_core ** 3 / core) ** (1.0 / 3.0))
    lo = pts.min(dim=0).values
    pending = torch.arange(n, device=dev)
    deferred = []
    offsets = torch.stack(torch.meshgrid(*[torch.arange(-1, 2, device=dev)] * 3, indexing="ij"), -1).reshape(27, 3)
    inf = float("inf")
    for _ in range(40):
        if pending.shape[0] == 0:
            break
        cells = torch.floor((pts - lo) / h).to(torch.int64) + 1  # >= 1: offsets stay non-negative
        dims = cells.max(dim=0).values + 2
        key = (cells[:, 0] * dims[1] + cells[:, 1]) * dims[2] + cells[:, 2]
        skey, order = torch.sort(key)
        ukey, counts = torch.unique_consecutive(skey, return_counts=True)
        starts = torch.cumsum(counts, 0) - counts
        left = []
        for s in range(0, pending.shape[0], chunk):
            q = pending[s : s + chunk]
            qc = cells[q][:, None, :] + offsets[None]  # (m, 27, 3)
            nk = (qc[..., 0] * dims[1] + qc[..., 1]) * dims[2] + qc[..., 2]
            pos = torch.searchsorted(ukey, nk).clamp(max=ukey.shape[0] - 1)
            found = ukey[pos] == nk
            st = torch.where(found, starts[pos], torch.zeros_like(pos))
            cnt = torch.where(found, counts[pos], torch.zeros_like(pos))
            fullest = cnt.max(1).values
            by_fill = torch.argsort(fullest)
            fill_sorted = fullest[by_fill]
            edges = [0] + [1 << b for b in range(fill_cap.bit_length())] + [fill_cap + 1]
            cuts = torch.searchsorted(fill_sorted, torch.tensor(edges, device=dev)).tolist()
            for a, b in zip(cuts[:-1], cuts[1:]):
                if b <= a:
                    continue
                g = by_fill[a:b]
                qg, stg, cntg = q[g], st[g], cnt[g]
                pq = pts[qg][:, None, :]
                bq = torch.full((qg.shape[0], k), inf, dtype=torch.float32, device=dev)
                for j in range(int(fill_sorted[b - 1])):
                    cand = order[(stg + j).clamp(max=n - 1)]
                    d = ((pts[cand] - pq) ** 2).sum(-1)
                    d = torch.where((j < cntg) & (cand != qg[:, None]), d, torch.full_like(d, inf))
                    bq = torch.topk(torch.cat([bq, d], 1), k, dim=1, largest=False).values
                best[qg] = bq
                left.append(qg[bq[:, k - 1] > h * h])
            deferred.append(q[by_fill[cuts[-1]:]])
        pending = torch.cat(left) if left else pending[:0]
        h *= 2.0
    deferred = torch.cat(deferred + [pending])
    for s in range(0, deferred.shape[0], brute_rows):
        q = deferred[s : s + brute_rows]
        d = ((pts[None, :, :] - pts[q][:, None, :]) ** 2).sum(-1)
        d[torch.arange(q.shape[0], device=dev), q] = inf
        best[q] = torch.topk(d, k, dim=1, largest=False).values
    return best.mean(dim=1)


def orbit_extrinsic(yaw: torch.Tensor, radius: float, center_z: float) -> torch.Tensor:
    """World-to-camera 7-vectors (qx, qy, qz, qw, tx, ty, tz) of cameras on
    a circle of `radius` about (0, 0, center_z) in the xz-plane, looking at
    it; yaw 0 sits at (0, 0, center_z - radius) looking along +z.
    R_w2c = Ry(-yaw), t = -R_w2c @ C (chip_smoke.py's orbit_extrinsic)."""
    yaw = yaw.to(torch.float64)
    cx = -radius * torch.sin(yaw)
    cz = center_z - radius * torch.cos(yaw)
    c, s = torch.cos(-yaw), torch.sin(-yaw)
    tx = -(c * cx + s * cz)
    tz = -(-s * cx + c * cz)
    zero = torch.zeros_like(yaw)
    ev = torch.stack([zero, torch.sin(-yaw / 2), zero, torch.cos(-yaw / 2), tx, zero, tz], -1)
    return ev.to(torch.float32)


def camera_geometry(cam: dict) -> dict:
    """Width, height, tan(fov/2) of both axes (square pixels) and the
    fork's 3x3 intrinsic (full FoV in radians at [0,0]/[1,1], W and H at
    [0,2]/[1,2])."""
    w, h = int(cam["width"]), int(cam["height"])
    tanx = math.tan(float(cam["half_fovx"]))
    tany = tanx * h / w
    intrinsic = [[2.0 * math.atan(tanx), 0.0, float(w)], [0.0, 2.0 * math.atan(tany), float(h)], [0.0, 0.0, 1.0]]
    return dict(width=w, height=h, tanfovx=tanx, tanfovy=tany, intrinsic=intrinsic)


def _points(n: int, sc: dict, cam: dict, g, device) -> torch.Tensor:
    """n points N(0, spread^2) about `center`, without those closer than
    `free_radius` to the camera orbit (the circle of `orbit_radius` about
    the center in the xz-plane): drawn in rounds, in order, so the seed
    alone decides them."""
    center = torch.tensor(sc["center"], dtype=torch.float32, device=device)
    free = float(sc["free_radius"])
    radius = float(cam["orbit_radius"])
    out, have, m = [], 0, n + n // 8
    while have < n:
        x = _normal((m, 3), g, device) * float(sc["spread"]) + center
        if free > 0:
            rel = x - center
            ring = torch.sqrt(rel[:, 0] ** 2 + rel[:, 2] ** 2) - radius
            x = x[ring * ring + rel[:, 1] ** 2 >= free * free]
        x = x[: n - have]
        out.append(x)
        have += x.shape[0]
    return torch.cat(out)


def make_scene(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The configuration's scene parameters, pre-activation, as the port's
    GaussianScene holds them: xyz (N,3), opacity (N,1) logits,
    scaling_factor (N,1) log, features_dc (F,1,3), features_rest (F,15,3),
    scaling (G,3), rotation (G,4); and, compressed, feature_indices and
    gaussian_indices (N,) int64 into the F- and G-row tables."""
    sc = cfg["scene"]
    n = int(sc["splats"])
    g_geo = generator(device, seed, 0)
    g_sh = generator(device, seed, 1)
    pts = _points(n, sc, cfg["camera"], g_geo, device)
    rgb = _uniform((n, 3), g_geo, device)
    a, b = sc["opacity_beta"]
    op = sample_beta(float(a), float(b), n, g_geo, device).clamp(*sc["opacity_clip"])
    dist2 = knn_mean_sq_dist(pts, int(sc["knn"])).clamp_min(1e-7)
    # from_point_cloud's isotropic kNN scale, as a unit direction and a
    # log-norm factor, then the recipe's multiplier on the factor
    log_scale = 0.5 * torch.log(dist2)
    lin = torch.exp(log_scale)[:, None].expand(n, 3)
    norm = torch.linalg.vector_norm(lin, dim=1, keepdim=True).clamp_min(1e-12)
    k = (int(sc["sh_degree"]) + 1) ** 2
    p = dict(
        xyz=pts,
        opacity=torch.log(op / (1.0 - op))[:, None],
        scaling_factor=torch.log(norm) + math.log(float(sc["scale_mult"])),
        features_dc=((rgb - 0.5) / SH_C0)[:, None, :],
        features_rest=_normal((n, k - 1, 3), g_sh, device) * float(sc["sh_rest_std"]),
        scaling=(lin / norm).contiguous(),
        rotation=torch.tensor([1.0, 0.0, 0.0, 0.0], device=device).expand(n, 4).contiguous(),
    )
    comp = cfg.get("compression")
    if comp:
        p.update(_compress_tables(p, comp, n, generator(device, seed, 2), device))
    return p


def _compress_tables(p: dict, comp: dict, n: int, g, device) -> dict:
    """c3dgs's table layout, drawn and not fitted: each table is its
    codebook's rows, then one row per kept splat, which points at its own
    row; every other splat points at a codebook row drawn uniformly. The
    color codebook is the features of splats drawn uniformly; the shape
    codebook is drawn anisotropic (unit directions of exp(N(0, 0.5^2))
    per axis) with uniform random rotations. The kept splats are drawn
    uniformly (the sensitivity ranking they stand for is not computed)."""
    out = {}
    for name, fields in (("color", ("features_dc", "features_rest")), ("shape", ("scaling", "rotation"))):
        cb = int(comp[f"{name}_codebook"])
        keep = int(round(float(comp[f"{name}_keep"]) * n))
        perm = torch.randperm(n, generator=g, device=device)
        kept = perm[:keep]
        idx = torch.randint(0, cb, (n,), generator=g, device=device)
        idx[kept] = cb + torch.arange(keep, device=device)
        if name == "color":
            src = torch.randint(0, n, (cb,), generator=g, device=device)
            cb_rows = [p[f][src] for f in fields]
            out["feature_indices"] = idx
        else:
            d = torch.exp(_normal((cb, 3), g, device) * 0.5)
            q = _normal((cb, 4), g, device)
            cb_rows = [d / torch.linalg.vector_norm(d, dim=1, keepdim=True),
                       q / torch.linalg.vector_norm(q, dim=1, keepdim=True)]
            out["gaussian_indices"] = idx
        for f, rows in zip(fields, cb_rows):
            out[f] = torch.cat([rows, p[f][kept]]).contiguous()
    return out


def make_cameras(cfg: dict, seed: int, device, targets: bool = True) -> Dict[str, object]:
    """The training cameras (every pose but each `test_every`-th of
    `poses` orbit poses at seeded yaws), their smooth seeded targets
    (None unless `targets`; the draws are made either way), the
    view path (`path_poses` poses evenly round the orbit from a seeded
    start) and the scene extent that scales the xyz learning rate (3DGS's
    getNerfppNorm: 1.1 times the largest camera distance from their mean)."""
    cam = cfg["camera"]
    g = generator(device, seed, 3)
    poses = int(cam["poses"])
    yaw = _uniform((poses,), g, device).double() * (2.0 * math.pi)
    every = int(cam["test_every"])
    train_idx = [i for i in range(poses) if i % every != 0]
    radius, cz = float(cam["orbit_radius"]), float(cfg["scene"]["center"][2])
    train_ev = orbit_extrinsic(yaw[train_idx], radius, cz)
    geo = camera_geometry(cam)
    gy, gx = cam["target_grid"]
    low = _uniform((len(train_idx), 3, int(gy), int(gx)), g, device)
    images = None
    if targets:
        images = torch.nn.functional.interpolate(low, size=(geo["height"], geo["width"]), mode="bilinear",
                                                 align_corners=True).contiguous()
    start = float(_uniform((1,), g, device)) * 2.0 * math.pi
    path_yaw = start + torch.arange(int(cam["path_poses"]), device=device, dtype=torch.float64) * (
        2.0 * math.pi / int(cam["path_poses"]))
    centers = torch.stack([-radius * torch.sin(yaw[train_idx]), torch.zeros_like(yaw[train_idx]),
                           cz - radius * torch.cos(yaw[train_idx])], -1)
    extent = 1.1 * float(torch.linalg.vector_norm(centers - centers.mean(0), dim=1).max())
    return dict(train_ev=train_ev, targets=images, path_ev=orbit_extrinsic(path_yaw, radius, cz),
                extent=extent, **geo)


def param_bytes(p: Dict[str, torch.Tensor]) -> int:
    return sum(v.numel() * v.element_size() for k, v in p.items() if v.is_floating_point())


PARAM_FIELDS: List[str] = ["xyz", "features_dc", "features_rest", "opacity", "scaling", "scaling_factor",
                           "rotation"]
