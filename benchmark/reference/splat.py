"""The plain reference: Gaussian-splat rendering, its loss, its gradients
and Adam, in plain PyTorch, after the published 3D Gaussian Splatting
rasterizer (Kerbl et al. 2023, diff-gaussian-rasterization's forward.cu /
backward.cu) and c3dgs's quantization-aware scene (Niedermayr et al.
2024): int8 fake-quant with EMA min/max observers, an fp16 round trip of
the positions, codebook-indexed colors and shapes.

It imports nothing of the program. It works every quantity out again from
the scene parameters, the camera and the target image: the observers'
ranges, covariances, the EWA projection, SH colors, the tile rects, the
depth order, the compositing, the loss, the gradients (by autograd) and
Adam's update. Compositing runs in blocks of tiles so that a 5M-splat
frame fits: the forward once without gradients, then, for a gradient,
each block again under autograd against its share of dL/dimage, the
per-splat screen-space gradients summed over the blocks and carried back
through the per-splat stage by one more autograd pass.

Semantics kept from the published rasterizer: a splat covers the pixels of
the tiles that its 3-sigma rect touches (getRect, here cut to the bbox of
the pixels where its alpha can reach 1/255, which changes no pixel);
pixels are at integer coordinates; alpha = min(0.99, o exp(power)), skipped
below 1/255 or at power > 0; a pixel stops at the splat that would take its
transmittance below 1e-4, which does not blend. Splats are ordered by their
float view depth.

Everything is float32 (`precision("float32")`). `precision("tf32")` is the control: the same
computation with TF32 allowed in the matrix products and convolutions.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

QMIN, QMAX = -128, 127
OBSERVER_AVERAGING = 0.01
MIN_ALPHA = 1.0 / 255.0
MAX_ALPHA = 0.99
STOP_T = 1e-4
# compositing in blocks of tiles: the tile (pixels across, down) and the most
# (pixel, instance) pairs a block holds; neither changes a pixel
TILE = (32, 16)
BLOCK_PAIRS = 1 << 25
ZNEAR, ZFAR = 0.01, 100.0
ADAM_B1, ADAM_B2 = 0.9, 0.999
ADAM_EPS = 1e-15  # 3DGS's optimizer (gaussian_model.py's Adam)
SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005, -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658, 0.3731763325901154, -0.4570457994644658,
         1.445305721320277, -0.5900435899266435)


@contextlib.contextmanager
def precision(mode: str):
    """"float32": matrix products and convolutions in IEEE float32;
    "tf32": TF32 allowed in both (the control)."""
    allow = {"float32": False, "tf32": True}[mode]
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = allow
    torch.backends.cudnn.allow_tf32 = allow
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


# ------------------------------------------------------------ quantization
def _normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp_min(1e-12)


def observed_fields(p: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {
        "features_dc": p["features_dc"],
        "features_rest": p["features_rest"],
        "opacity": torch.sigmoid(p["opacity"]),
        "scaling": _normalize(torch.relu(p["scaling"])),
        "scaling_factor": p["scaling_factor"],
        "rotation": p["rotation"],
    }


@torch.no_grad()
def observe(obs: Optional[dict], p: Dict[str, torch.Tensor]) -> dict:
    """One step of each EMA min/max observer (torch's
    MovingAverageMinMaxObserver, averaging constant 0.01): the first step
    sets the range, which always holds 0."""
    out = {}
    for name, x in observed_fields(p).items():
        lo = torch.clamp(x.min(), max=0.0)
        hi = torch.clamp(x.max(), min=0.0)
        if obs is not None:
            lo = obs[name][0] + OBSERVER_AVERAGING * (lo - obs[name][0])
            hi = obs[name][1] + OBSERVER_AVERAGING * (hi - obs[name][1])
        out[name] = (lo, hi)
    return out


def fake_quant(x: torch.Tensor, rng) -> torch.Tensor:
    """int8 affine quantize-dequantize at the observer's range; the
    gradient passes where the unclamped rounded value lies in [-128, 127]."""
    lo, hi = rng
    scale = torch.clamp((hi - lo) / float(QMAX - QMIN), min=1e-12)
    zp = torch.clamp(torch.round(QMIN - lo / scale), QMIN, QMAX)
    with torch.no_grad():
        q = torch.round(x / scale + zp)
        inside = (q >= QMIN) & (q <= QMAX)
        deq = (torch.clamp(q, QMIN, QMAX) - zp) * scale
    return torch.where(inside, x, x.detach()) + (deq - x).detach()


def half_round_trip(x: torch.Tensor) -> torch.Tensor:
    """float16 round trip with a straight-through gradient."""
    return x + (x.detach().half().float() - x.detach())


# --------------------------------------------------------------- accessors
def splat_attributes(p: Dict[str, torch.Tensor], obs: dict, idx: Dict[str, Optional[torch.Tensor]]):
    """Per-splat position, opacity, 3x3 covariance and SH coefficients (N,
    16, 3) of the scene as its fake-quantized accessors give them."""
    xyz = half_round_trip(p["xyz"])
    opacity = fake_quant(torch.sigmoid(p["opacity"]), obs["opacity"])[:, 0]
    sdir = fake_quant(_normalize(torch.relu(p["scaling"])), obs["scaling"])
    rot = _normalize(fake_quant(p["rotation"], obs["rotation"]))
    feats = torch.cat([fake_quant(p["features_dc"], obs["features_dc"]),
                       fake_quant(p["features_rest"], obs["features_rest"])], 1)
    if idx.get("gaussian_indices") is not None:
        sdir, rot = sdir[idx["gaussian_indices"]], rot[idx["gaussian_indices"]]
    if idx.get("feature_indices") is not None:
        feats = feats[idx["feature_indices"]]
    s = torch.exp(fake_quant(p["scaling_factor"], obs["scaling_factor"])) * sdir
    w, x, y, z = _normalize(rot).unbind(-1)
    r = torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], -2)
    m = r * s[:, None, :]
    cov = m @ m.transpose(1, 2)
    return xyz, opacity, cov, feats


def eval_sh3(sh: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """RGB of degree-3 SH (N, 16, 3) at unit directions d (N, 3): the
    published basis, + 0.5, clamped at 0."""
    x, y, z = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    xx, yy, zz, xy, yz, xz = x * x, y * y, z * z, x * y, y * z, x * z
    basis = [
        torch.full_like(x, SH_C0), -SH_C1 * y, SH_C1 * z, -SH_C1 * x,
        SH_C2[0] * xy, SH_C2[1] * yz, SH_C2[2] * (2 * zz - xx - yy), SH_C2[3] * xz, SH_C2[4] * (xx - yy),
        SH_C3[0] * y * (3 * xx - yy), SH_C3[1] * xy * z, SH_C3[2] * y * (4 * zz - xx - yy),
        SH_C3[3] * z * (2 * zz - 3 * xx - 3 * yy), SH_C3[4] * x * (4 * zz - xx - yy),
        SH_C3[5] * z * (xx - yy), SH_C3[6] * x * (xx - 3 * yy),
    ]
    b = torch.cat(basis, 1)  # (N, 16)
    return torch.clamp((b[:, :, None] * sh).sum(1) + 0.5, min=0.0)


# ------------------------------------------------------------------ camera
class Camera:
    """A pinhole camera from the world-to-camera 7-vector (qx, qy, qz, qw,
    tx, ty, tz) and the fork's 3x3 intrinsic (full FoV in radians, W, H)."""

    def __init__(self, ev, intrinsic, device):
        ev = torch.as_tensor(ev, dtype=torch.float32, device=device)
        qx, qy, qz, qw = ev[:4].unbind(0)
        self.r = torch.stack([
            torch.stack([1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qw * qz), 2 * (qx * qz + qw * qy)]),
            torch.stack([2 * (qx * qy + qw * qz), 1 - 2 * (qx * qx + qz * qz), 2 * (qy * qz - qw * qx)]),
            torch.stack([2 * (qx * qz - qw * qy), 2 * (qy * qz + qw * qx), 1 - 2 * (qx * qx + qy * qy)]),
        ])
        self.t = ev[4:7]
        self.center = -(self.r.T @ self.t)
        self.width, self.height = int(intrinsic[0][2]), int(intrinsic[1][2])
        self.tanx = math.tan(float(intrinsic[0][0]) * 0.5)
        self.tany = math.tan(float(intrinsic[1][1]) * 0.5)
        self.fx = self.width / (2.0 * self.tanx)
        self.fy = self.height / (2.0 * self.tany)


class Screen:
    """Per-splat screen-space quantities of the visible splats (V rows) and
    their indices `vis` into the scene; `rect` (V, 4) tiles x0, y0, x1, y1."""

    def __init__(self, vis, mean2d, depth, conic, opacity, color, rect):
        self.vis, self.mean2d, self.depth, self.conic = vis, mean2d, depth, conic
        self.opacity, self.color, self.rect = opacity, color, rect

    def leaves(self):
        return [self.mean2d, self.conic, self.opacity, self.color]


def project(xyz, opacity, cov, feats, cam: Camera) -> Screen:
    """Cull, EWA-project, colour and rect every splat (the published
    preprocessCUDA); returns the visible ones."""
    tx_, ty_ = TILE
    t3 = xyz @ cam.r.T + cam.t  # view space
    tz = t3[:, 2]
    tz_safe = torch.where(torch.abs(tz) < 1e-6, torch.full_like(tz, 1e-6), tz)
    limx, limy = 1.3 * cam.tanx, 1.3 * cam.tany
    txtz = torch.clamp(t3[:, 0] / tz_safe, -limx, limx) * tz_safe
    tytz = torch.clamp(t3[:, 1] / tz_safe, -limy, limy) * tz_safe
    zero = torch.zeros_like(tz)
    jac = torch.stack([
        torch.stack([cam.fx / tz_safe, zero, -cam.fx * txtz / (tz_safe * tz_safe)], -1),
        torch.stack([zero, cam.fy / tz_safe, -cam.fy * tytz / (tz_safe * tz_safe)], -1),
    ], -2)  # (N, 2, 3)
    tm = jac @ cam.r
    cov2 = tm @ cov @ tm.transpose(1, 2)
    a = cov2[:, 0, 0] + 0.3
    b = cov2[:, 0, 1]
    c = cov2[:, 1, 1] + 0.3
    det = a * c - b * b
    det_ok = det != 0
    inv = 1.0 / torch.where(det_ok, det, torch.ones_like(det))
    conic = torch.stack([c * inv, -b * inv, a * inv], -1)
    mid = 0.5 * (a + c)
    disc = torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    radius = torch.ceil(3.0 * torch.sqrt(torch.maximum(mid + disc, mid - disc)))
    # the projection: the full 4x4 transform, the divide by w (+ 1e-7)
    proj = torch.zeros((4, 4), dtype=torch.float32, device=xyz.device)
    proj[0, 0], proj[1, 1] = 1.0 / cam.tanx, 1.0 / cam.tany
    proj[2, 2], proj[2, 3] = ZFAR / (ZFAR - ZNEAR), -(ZFAR * ZNEAR) / (ZFAR - ZNEAR)
    proj[3, 2] = 1.0
    view = torch.eye(4, dtype=torch.float32, device=xyz.device)
    view[:3, :3], view[:3, 3] = cam.r, cam.t
    full = proj @ view
    hom = torch.cat([xyz, torch.ones_like(xyz[:, :1])], 1) @ full.T
    pw = 1.0 / (hom[:, 3] + 1e-7)
    mean2d = torch.stack([((hom[:, 0] * pw + 1.0) * cam.width - 1.0) * 0.5,
                          ((hom[:, 1] * pw + 1.0) * cam.height - 1.0) * 0.5], -1)
    with torch.no_grad():
        # the 3-sigma square of getRect, cut to the bbox of the pixels where
        # alpha can reach 1/255 (Mahalanobis distance sqrt(2 ln(255 o)))
        reach = torch.sqrt(2.0 * torch.log(torch.clamp(255.0 * opacity, min=1.0 + 1e-6)))
        cut = reach < 3.0
        hx = torch.where(cut, torch.ceil(reach * torch.sqrt(torch.clamp(a, min=0.0))), radius)
        hy = torch.where(cut, torch.ceil(reach * torch.sqrt(torch.clamp(c, min=0.0))), radius)
        ntx, nty = -(-cam.width // tx_), -(-cam.height // ty_)
        trunc = lambda v: torch.clamp(v, -2e9, 2e9).to(torch.int64)  # C's (int) cast
        m2 = mean2d.detach()
        x0 = torch.clamp(trunc((m2[:, 0] - hx) / tx_), 0, ntx)
        y0 = torch.clamp(trunc((m2[:, 1] - hy) / ty_), 0, nty)
        x1 = torch.clamp(trunc((m2[:, 0] + hx + tx_ - 1) / tx_), 0, ntx)
        y1 = torch.clamp(trunc((m2[:, 1] + hy + ty_ - 1) / ty_), 0, nty)
        visible = (tz > ZNEAR) & det_ok & ((x1 - x0) * (y1 - y0) > 0) & (opacity * 255.0 > 1.0)
        vis = torch.nonzero(visible)[:, 0]
    dirs = _normalize(xyz[vis] - cam.center)
    color = eval_sh3(feats[vis], dirs)
    rect = torch.stack([x0, y0, x1, y1], -1)[vis]
    return Screen(vis, mean2d[vis], tz[vis], conic[vis], opacity[vis], color, rect)


# --------------------------------------------------------------- compositing
class Bins:
    """(tile, splat) instances in tile order and, within a tile, by depth."""

    def __init__(self, scr: Screen, cam: Camera):
        dev = scr.mean2d.device
        self.tile = TILE
        self.tiles_x = -(-cam.width // TILE[0])
        self.tiles_y = -(-cam.height // TILE[1])
        self.num_tiles = self.tiles_x * self.tiles_y
        with torch.no_grad():
            x0, y0, x1, y1 = scr.rect.unbind(1)
            w = x1 - x0
            cnt = w * (y1 - y0)
            order = torch.sort(scr.depth.detach(), stable=True).indices
            cnt_o = cnt[order]
            sid = torch.repeat_interleave(order, cnt_o)
            first = torch.cumsum(cnt_o, 0) - cnt_o
            k = torch.arange(sid.shape[0], device=dev) - torch.repeat_interleave(first, cnt_o)
            ws = w[sid]
            tid = (y0[sid] + k // ws) * self.tiles_x + x0[sid] + k % ws
            tid_s, perm = torch.sort(tid, stable=True)
            self.sid = sid[perm]
            self.counts = torch.bincount(tid_s, minlength=self.num_tiles)
            self.starts = torch.cumsum(self.counts, 0) - self.counts
        self.instances = int(self.sid.shape[0])

    def blocks(self, budget: int):
        """Tiles in blocks of at most `budget` (pixel, slot) pairs, longest
        tiles first: (tile ids, padded length) per block."""
        pix = self.tile[0] * self.tile[1]
        counts = self.counts.tolist()
        order = sorted((t for t in range(self.num_tiles) if counts[t] > 0), key=lambda t: -counts[t])
        out, i = [], 0
        while i < len(order):
            length = counts[order[i]]
            nb = max(1, budget // (pix * length))
            out.append((order[i : i + nb], length))
            i += nb
        return out


def composite_block(scr_leaves, bins: Bins, tiles: List[int], length: int, bg, counts: Optional[dict] = None):
    """Color (nb, PIX, 3) of the block's tiles; `counts`, if given,
    accumulates the work the block needs (see `work_counts`)."""
    mean2d, conic, opacity, color = scr_leaves
    dev = mean2d.device
    tx_, ty_ = bins.tile
    tiles_t = torch.as_tensor(tiles, device=dev)
    ar = torch.arange(length, device=dev)
    valid = ar[None, :] < bins.counts[tiles_t][:, None]
    pos = (bins.starts[tiles_t][:, None] + ar[None, :]).clamp(max=max(bins.instances - 1, 0))
    sid = bins.sid[pos]  # (nb, L)
    m, co, o, col = mean2d[sid], conic[sid], opacity[sid], color[sid]
    pix = torch.arange(tx_ * ty_, device=dev)
    px = ((tiles_t % bins.tiles_x)[:, None] * tx_ + pix % tx_).to(torch.float32)  # (nb, PIX)
    py = ((tiles_t // bins.tiles_x)[:, None] * ty_ + pix // tx_).to(torch.float32)
    dx = m[:, None, :, 0] - px[:, :, None]  # (nb, PIX, L)
    dy = m[:, None, :, 1] - py[:, :, None]
    power = -0.5 * (co[:, None, :, 0] * dx * dx + co[:, None, :, 2] * dy * dy) - co[:, None, :, 1] * dx * dy
    raw = o[:, None, :] * torch.exp(power)
    keep = valid[:, None, :] & (power <= 0.0) & (raw >= MIN_ALPHA)
    alpha = torch.where(keep, torch.clamp(raw, max=MAX_ALPHA), torch.zeros_like(raw))
    t_in = torch.cumprod(1.0 - alpha, -1)
    t_ex = torch.cat([torch.ones_like(t_in[..., :1]), t_in[..., :-1]], -1)
    live = (t_in >= STOP_T).detach()
    w = alpha * t_ex * live
    rgb = torch.bmm(w, col)  # (nb, PIX, 3)
    t_final = torch.where(live, t_in, torch.ones_like(t_in)).amin(-1)
    if counts is not None:
        with torch.no_grad():
            before = t_ex >= STOP_T
            blend = keep & live
            counts["power_pairs"] += int((before & valid[:, None, :] & ((power >= -4.5) | keep)).sum())
            counts["blend_pairs"] += int(blend.sum())
            counts["needed_instances"] += int(blend.any(1).sum())
    return rgb + t_final[..., None] * bg


def tiles_to_image(rows: torch.Tensor, bins: Bins, cam: Camera) -> torch.Tensor:
    """(T, PIX, 3) -> (3, H, W)."""
    tx_, ty_ = bins.tile
    full = rows.reshape(bins.tiles_y, bins.tiles_x, ty_, tx_, 3).permute(4, 0, 2, 1, 3)
    return full.reshape(3, bins.tiles_y * ty_, bins.tiles_x * tx_)[:, : cam.height, : cam.width]


def image_to_tiles(img: torch.Tensor, bins: Bins) -> torch.Tensor:
    """(3, H, W) -> (T, PIX, 3), zero outside the image."""
    tx_, ty_ = bins.tile
    pad = F.pad(img, (0, bins.tiles_x * tx_ - img.shape[2], 0, bins.tiles_y * ty_ - img.shape[1]))
    return pad.reshape(3, bins.tiles_y, ty_, bins.tiles_x, tx_).permute(1, 3, 2, 4, 0).reshape(
        bins.num_tiles, tx_ * ty_, 3)


def render_tiles(scr: Screen, bins: Bins, bg, budget: int, counts: Optional[dict] = None) -> torch.Tensor:
    """The frame's (T, PIX, 3) tile colors, no gradients."""
    leaves = [t.detach() for t in scr.leaves()]
    rows = bg.expand(bins.num_tiles, bins.tile[0] * bins.tile[1], 3).clone()
    with torch.no_grad():
        for tiles, length in bins.blocks(budget):
            rows[torch.as_tensor(tiles, device=rows.device)] = composite_block(leaves, bins, tiles, length, bg,
                                                                                counts)
    return rows


# ----------------------------------------------------------------- the loss
def ssim(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """Mean SSIM of two (3, H, W) images: 11x11 gaussian window, sigma 1.5,
    zero padding, C1 = 0.01^2, C2 = 0.03^2."""
    xs = torch.arange(11, dtype=torch.float64) - 5
    g = torch.exp(-(xs ** 2) / (2 * 1.5 ** 2))
    g = g / g.sum()
    win = (g[:, None] * g[None, :]).to(torch.float32).to(img1.device).expand(3, 1, 11, 11).contiguous()
    conv = lambda x: F.conv2d(x[None], win, padding=5, groups=3)[0]
    mu1, mu2 = conv(img1), conv(img2)
    s11 = conv(img1 * img1) - mu1 * mu1
    s22 = conv(img2 * img2) - mu2 * mu2
    s12 = conv(img1 * img2) - mu1 * mu2
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    m = ((2 * mu1 * mu2 + c1) * (2 * s12 + c2)) / ((mu1 * mu1 + mu2 * mu2 + c1) * (s11 + s22 + c2))
    return m.mean()


def photometric_loss(img: torch.Tensor, gt: torch.Tensor, lambda_dssim: float) -> torch.Tensor:
    return (1.0 - lambda_dssim) * torch.abs(img - gt).mean() + lambda_dssim * (1.0 - ssim(img, gt))


# ------------------------------------------------------------------ a frame
class Scene:
    """The reference's scene: the parameters (leaf tensors), the index
    arrays of a compressed scene, and the observers."""

    def __init__(self, params: Dict[str, torch.Tensor], indices: Dict[str, Optional[torch.Tensor]],
                 budget: int = BLOCK_PAIRS):
        self.p = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
        self.idx = indices
        self.obs = None
        self.budget = int(budget)

    def screen(self, cam: Camera) -> Screen:
        xyz, op, cov, feats = splat_attributes(self.p, self.obs, self.idx)
        return project(xyz, op, cov, feats, cam)

    @torch.no_grad()
    def render(self, cam: Camera, bg, counts: Optional[dict] = None) -> torch.Tensor:
        scr = self.screen(cam)
        bins = Bins(scr, cam)
        if counts is not None:
            counts["visible"] += int(scr.vis.shape[0])
            counts["instances"] += bins.instances
        return tiles_to_image(render_tiles(scr, bins, bg, self.budget, counts), bins, cam)

    def loss_and_grads(self, cam: Camera, gt: torch.Tensor, bg, lambda_dssim: float):
        """The photometric loss of this view and its gradient to every
        parameter: (loss, {name: grad})."""
        scr = self.screen(cam)  # under autograd from the parameters
        bins = Bins(scr, cam)
        rows = render_tiles(scr, bins, bg, self.budget)
        img = tiles_to_image(rows, bins, cam).detach().requires_grad_(True)
        loss = photometric_loss(img, gt, lambda_dssim)
        (g_img,) = torch.autograd.grad(loss, [img])
        g_rows = image_to_tiles(g_img, bins)
        leaves = [t.detach().requires_grad_(True) for t in scr.leaves()]
        for tiles, length in bins.blocks(self.budget):
            with torch.enable_grad():
                out = composite_block(leaves, bins, tiles, length, bg)
            torch.autograd.backward(out, g_rows[torch.as_tensor(tiles, device=out.device)])
        outs = [(o, l.grad) for o, l in zip(scr.leaves(), leaves) if l.grad is not None]
        torch.autograd.backward([o for o, _ in outs], [g for _, g in outs])
        grads = {k: (v.grad if v.grad is not None else torch.zeros_like(v)) for k, v in self.p.items()}
        for v in self.p.values():
            v.grad = None
        return float(loss.detach()), grads


def adam_step(p: Dict[str, torch.Tensor], grads, state: dict, lrs: Dict[str, float], eps: float = ADAM_EPS) -> None:
    """One Adam step (Kingma and Ba; b1 0.9, b2 0.999) in place."""
    state["count"] = state.get("count", 0) + 1
    n = state["count"]
    bc1, bc2 = 1.0 - ADAM_B1 ** n, 1.0 - ADAM_B2 ** n
    with torch.no_grad():
        for k, v in p.items():
            g = grads[k]
            mu = state.setdefault("mu", {}).setdefault(k, torch.zeros_like(v))
            nu = state.setdefault("nu", {}).setdefault(k, torch.zeros_like(v))
            mu.mul_(ADAM_B1).add_((1.0 - ADAM_B1) * g)
            nu.mul_(ADAM_B2).add_((1.0 - ADAM_B2) * g * g)
            v.sub_(lrs[k] * (mu / bc1) / (torch.sqrt(nu / bc2) + eps))


def learning_rates(train: dict, step: int, extent: float) -> Dict[str, float]:
    """Per-field learning rates at `step`: xyz log-linear from
    position_lr_init to position_lr_final (times the scene extent) over
    position_lr_max_steps, the rest constant (3DGS's training_setup)."""
    t = min(max(step / float(train["position_lr_max_steps"]), 0.0), 1.0)
    lr0 = math.log(train["position_lr_init"] * extent)
    lr1 = math.log(train["position_lr_final"] * extent)
    return {
        "xyz": math.exp(lr0 * (1 - t) + lr1 * t),
        "features_dc": train["feature_lr"],
        "features_rest": train["feature_lr"] / 20.0,
        "opacity": train["opacity_lr"],
        "scaling": train["scaling_lr"],
        "scaling_factor": train["scaling_lr"],
        "rotation": train["rotation_lr"],
    }


def train_steps(scene: Scene, cams: List[Camera], targets: List[torch.Tensor], bg, train: dict, first_step: int,
                extent: float) -> dict:
    """The training steps of the program, followed: per step the observers'
    EMA, the loss and its gradients, Adam. Returns each step's loss, each
    field's first gradient and the parameters after the last step."""
    p0 = {k: v.detach().clone() for k, v in scene.p.items()}
    state, losses, first = {}, [], None
    for i, (cam, gt) in enumerate(zip(cams, targets)):
        scene.obs = observe(scene.obs, scene.p)
        loss, grads = scene.loss_and_grads(cam, gt, bg, train["lambda_dssim"])
        losses.append(loss)
        if first is None:
            first = grads
        adam_step(scene.p, grads, state, learning_rates(train, first_step + i, extent))
    return dict(losses=losses, first_grads=first, p0=p0, p=scene.p)


def work_counts() -> dict:
    """The work a frame needs, as the reference counts it:
    visible: splats that pass the culls;
    instances: the reference's (tile, splat) pairs;
    needed_instances: those in which the splat blends into some pixel;
    power_pairs: (pixel, splat) pairs of a pixel still live (T >= 1e-4
      before the splat) in the splat's rect where the pixel lies within the
      splat's 3-sigma ellipse or its alpha reaches 1/255;
    blend_pairs: the pairs that blend (alpha >= 1/255, the pixel live after)."""
    return dict(visible=0, instances=0, needed_instances=0, power_pairs=0, blend_pairs=0)
