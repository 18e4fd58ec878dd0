"""Fixed-capacity tile binning (port of c3dgs_tpu/render/binning.py): the
reference's duplicateWithKeys -> radix sort -> identifyTileRanges pipeline
(rasterizer_impl.cu:70-138, 275-316) as enumeration + sorts.

Every field equals the JAX Binning on the same Preprocessed (frozen slots
and per-slot gradient rows are indexed by sorted slot, so the order must
match exactly) but in two cases, where the JAX module departs from the
reference's float depth order and whole tile rects:
- instances of one tile whose depths share a quantized level (the key has
  31 - bit_length(T + 1) depth bits, 19 at 1920x1080) are ordered by
  their float depths, then by gaussian (`_sorted_rows`: a second, stable
  sort); the JAX module orders them by gaussian alone;
- the payload is the instance's emission slot (offset[gid] + j), in the
  same gaussian-major order as the JAX module's gid << j_bits | j but
  with no bits given to j: there j has 31 - bit_length(n + T) bits, 256
  tiles a gaussian at 5M gaussians, and the rest is dropped (`clipped`);
  here only `max_tiles_per_gaussian` clips.
The TPU workarounds of the JAX module become their plain torch
equivalents:
- the lexicographic (key, payload) sort is a stable sort of
  key << 32 | payload (both non-negative int32 values);
- `_rank_in_sorted` (#{boundaries <= q} by two packed sorts) is
  torch.searchsorted(..., right=True);
- quantize_depth runs the same f32 operation order and clamps in int64.
The tile-sharded `bin_gaussians_routed` runs on one rank of a mesh's
`tiles` axis (parallel/mesh.py) and routes instances with its all_to_all.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .preprocess import Preprocessed
from .types import TILE_X, TILE_Y, RasterSettings

CHUNK = 128  # slots per aligned chunk of the sorted instance array
NUM_FIELDS = 16  # staged instance field rows (9 used)
NUM_USED_FIELDS = 9  # x, y, conic(3), opacity, rgb(3)
PRESORT_ROW = 9  # per-tile staged field row carrying the pre-sort slot (exact in f32)
OFFSET_ROW = 10  # table column carrying each gaussian's first emission slot


def DEPTH_BITS(num_tiles: int) -> int:
    """Bits left for quantized depth in the packed 31-bit sort key."""
    tile_bits = max(int(num_tiles + 1).bit_length(), 1)
    return 31 - tile_bits


def quantize_depth(depth: torch.Tensor, alive: torch.Tensor, num_tiles: int) -> torch.Tensor:
    """Monotone depth quantization for the packed sort key (shared with the
    oracle so tile and oracle orderings agree exactly). int64 values in
    [0, 2^bits - 1]."""
    bits = DEPTH_BITS(num_tiles)
    levels = (1 << bits) - 1
    inf = torch.tensor(float("inf"), dtype=depth.dtype, device=depth.device)
    dmin = torch.min(torch.where(alive, depth, inf))
    dmax = torch.max(torch.where(alive, depth, -inf))
    dmin = torch.where(torch.isfinite(dmin), dmin, torch.zeros_like(dmin))
    span = torch.clamp(dmax - dmin, min=1e-12)
    q = torch.clamp((depth - dmin) / span * float(levels), 0.0, float(levels))
    # final clamp in the integer domain: f32(levels) rounds up to 2^bits
    return torch.clamp(q.to(torch.int64), max=levels)


# +inf's float bits: a sentinel row's depth, past every finite depth
FAR_BITS = 0x7F800000


def depth_bits(depth: torch.Tensor) -> torch.Tensor:
    """int64 bits of float32 depths, ordered as the (positive) depths are."""
    return depth.to(torch.float32).view(torch.int32).to(torch.int64)


def _sorted_rows(key: torch.Tensor, dbits: torch.Tensor, pj: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The order of rows by (key, float depth bits, payload): a stable sort
    by depth, then a stable one by key. The key's quantized depth is
    monotone in the float depth, so within a tile the order is the float
    depth's, ties by payload. Rows given in payload order (pj None) sort
    as int32 (both fields are below 2^31); otherwise the first sort takes
    (depth, payload) whole. Rows with no depth (culled, invalid) carry
    dbits 0 and keep their payload order."""
    first = dbits.to(torch.int32) if pj is None else (dbits << 32) | pj
    inner = torch.sort(first, stable=True).indices
    outer = torch.sort(key.to(torch.int32)[inner], stable=True).indices
    return inner[outer]


def _rank_in_sorted(boundaries: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """#{boundaries <= q} for every q; `boundaries` ascending."""
    return torch.searchsorted(boundaries, queries, right=True)


def _tile_hit(rows: torch.Tensor, tx: torch.Tensor, ty: torch.Tensor, settings: RasterSettings):
    """Exact ellipse-tile test: can this instance's alpha reach 1/255
    anywhere in tile (tx, ty)? The concave exponent's max over the pixel
    box is 0 if the mean lies inside, else on one of the 4 edges (clamped
    1-D argmax each). 1e-3 log-domain margin; non-PSD conics are kept.
    `rows` are the float columns of the instance table: x, y, conic a/b/c,
    opacity."""
    gx, gy, a, b, c, op = rows.unbind(1)

    psd = (a > 0.0) & (c > 0.0) & (a * c - b * b > 0.0)
    a_s = torch.where(psd, a, torch.ones_like(a))
    c_s = torch.where(psd, c, torch.ones_like(c))

    x0 = (tx * TILE_X).to(torch.float32)
    y0 = (ty * TILE_Y).to(torch.float32)
    x1 = torch.clamp(x0 + (TILE_X - 1), max=float(settings.width - 1))
    y1 = torch.clamp(y0 + (TILE_Y - 1), max=float(settings.height - 1))
    lx, hx = x0 - gx, x1 - gx
    ly, hy = y0 - gy, y1 - gy

    def power(dx, dy):
        return -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy

    def edge_x(e):  # dx fixed at e, dy free in [ly, hy]
        return power(e, torch.minimum(torch.maximum(-b * e / c_s, ly), hy))

    def edge_y(e):  # dy fixed at e, dx free in [lx, hx]
        return power(torch.minimum(torch.maximum(-b * e / a_s, lx), hx), e)

    maxp = torch.maximum(
        torch.maximum(edge_x(lx), edge_x(hx)), torch.maximum(edge_y(ly), edge_y(hy))
    )
    inside = (lx <= 0.0) & (hx >= 0.0) & (ly <= 0.0) & (hy >= 0.0)
    maxp = torch.where(inside, torch.zeros_like(maxp), maxp)
    thr = -torch.log(torch.clamp(255.0 * op, min=1e-30))
    return (maxp >= thr - 1e-3) | ~psd


class Binning(NamedTuple):
    """Sorted, tile-segmented instance bookkeeping (all int32 on device).

    The cap-long sorted instance array holds each tile's kept instances
    front to back, one sentinel slot per tile at its segment end, then the
    invalid/culled tail."""

    gid_sorted: torch.Tensor  # (cap,) source gaussian per slot (clamped to n-1)
    j_sorted: torch.Tensor  # (cap,) within-gaussian tile index
    starts: torch.Tensor  # (T,) first slot of each tile
    ends: torch.Tensor  # (T,) the tile's sentinel slot (one past its last)
    nchunks: torch.Tensor  # (T,) ceil(count / CHUNK)
    grad_base: torch.Tensor  # (T,) 128-aligned per-tile grad offset
    grad_total: torch.Tensor  # () total per-tile grad slots
    emit_cum: torch.Tensor  # (N,) inclusive prefix of per-gaussian emits
    offset: torch.Tensor  # (N,) first emission slot (emit_cum - emit)
    num_instances: torch.Tensor  # () true emitted instances
    overflow: torch.Tensor  # () instances dropped (capacity)
    grad_overflow: torch.Tensor  # () per-tile grad slots beyond grad capacity
    clipped: torch.Tensor  # () tiles dropped (max_tiles_per_gaussian)
    culled: torch.Tensor  # () instances dropped by the ellipse-tile test
    tid_sorted: torch.Tensor  # (cap,) tile per slot: sentinels keep their
    # real tile, invalid/culled slots carry num_tiles
    sent_sorted: torch.Tensor  # (cap,) bool sentinel (and invalid) slots
    tile_lo: torch.Tensor  # (cap//CHUNK + 1,) #tiles whose sentinel lies
    # before chunk c: tiles [tile_lo[c], tile_lo[c+1]) flush in chunk c
    chunks_exec: torch.Tensor  # () chunks covering every sentinel
    perm: Optional[torch.Tensor]  # (cap,) sorted slot -> gaussian-major
    # order, for the backward's grad reduction; None for inference, which
    # skips that sort (the JAX graph drops it the same way when nothing
    # takes gradients); a backward then reduces by pre-sort slot keys


def _emission_prefix(prep: Preprocessed, max_tiles: int):
    """Per-gaussian emission counts and their inclusive prefix (int64)."""
    tiles_touched = prep.tiles_touched.to(torch.int64)
    emit = torch.clamp(tiles_touched, max=max_tiles)
    clipped = torch.sum(tiles_touched - emit)
    return emit, torch.cumsum(emit, 0), clipped


def _instance_table(prep: Preprocessed, cum, emit, num_tiles: int):
    """Per-gaussian lookup table gathered once per instance: int columns
    [offset, rect_min_x, rect_min_y, rect_w, depth_q] and float columns
    [x, y, conic a/b/c, opacity]."""
    depth_q = quantize_depth(prep.depth, prep.radius > 0, num_tiles)
    ints = torch.stack(
        [
            cum - emit,
            prep.rect_min[:, 0].to(torch.int64),
            prep.rect_min[:, 1].to(torch.int64),
            torch.clamp(prep.rect_max[:, 0] - prep.rect_min[:, 0], min=1).to(torch.int64),
            depth_q,
        ],
        1,
    )
    floats = torch.cat(
        [prep.mean2d, prep.conic, prep.opacity[:, None]], 1
    ).to(torch.float32)
    return ints, floats


def _enumerate_slots(ints, floats, cum, total, slots, n: int, cap: int, settings: RasterSettings):
    """Instance enumeration over `slots`: each slot finds its gaussian by
    rank over the emission prefix, derives its tile, and runs the
    ellipse-tile cull. Returns the int64 (key, payload) sort columns, the
    culled count, each slot's gaussian (clamped to n - 1) and whether the
    ellipse-tile test kept it."""
    num_tiles = settings.num_tiles
    gid_k = _rank_in_sorted(cum, slots)
    gid_safe = torch.clamp(gid_k, max=n - 1)
    valid = slots < total
    irow = ints[gid_safe]
    j = slots - irow[:, 0]
    rw = irow[:, 3]
    ty = irow[:, 2] + torch.div(j, rw, rounding_mode="floor")
    tx = irow[:, 1] + torch.remainder(j, rw)
    keep = valid & _tile_hit(floats[gid_safe], tx, ty, settings)
    tile_k = torch.where(keep, ty * settings.tiles_x + tx, torch.full_like(tx, num_tiles))

    db = DEPTH_BITS(num_tiles)
    key = (tile_k << db) | torch.where(keep, irow[:, 4], torch.zeros_like(tile_k))
    # payload: the emission slot, gaussian-major; invalid slots carry
    # cap + T, past every sentinel's cap + t. Culled slots keep their real
    # payload (the gaussian-major perm orders every emission; their tile
    # key parks them past every sentinel)
    pj = torch.where(valid, slots, torch.full_like(slots, cap + num_tiles))
    return key, pj, torch.sum((valid & ~keep).to(torch.int64)), gid_safe, keep


def _gid_j(pj_s, gid_of_slot, offset, n: int, cap: int):
    """(gid, j, sentinel-or-invalid) of sorted payloads: real payloads are
    emission slots (< cap), the rest are sentinels and invalid rows, which
    carry gid n - 1 and j 0."""
    real = pj_s < cap
    slot = torch.where(real, pj_s, torch.zeros_like(pj_s))
    gid = torch.where(real, gid_of_slot(slot), torch.full_like(pj_s, n - 1))
    j = torch.where(real, slot - offset[gid], torch.zeros_like(pj_s))
    return gid, j, ~real


def bin_gaussians(prep: Preprocessed, settings: RasterSettings) -> Binning:
    """Per-tile depth-sorted instance bookkeeping over the full tile grid."""
    dev = prep.depth.device
    n = prep.depth.shape[0]
    cap, max_tiles = settings.resolve_caps(n)
    grad_cap = settings.resolve_grad_cap(n)
    num_tiles = settings.num_tiles
    i64 = dict(dtype=torch.int64, device=dev)

    emit, cum, clipped = _emission_prefix(prep, max_tiles)
    total = cum[-1]
    # T sentinel rows must fit inside the cap window; the excess is dropped
    overflow = torch.clamp(total - (cap - num_tiles), min=0)

    ints, floats = _instance_table(prep, cum, emit, num_tiles)
    slots = torch.arange(cap, **i64)
    key, pj, culled, gid_of_slot, keep = _enumerate_slots(ints, floats, cum, total, slots, n, cap, settings)
    db = DEPTH_BITS(num_tiles)
    levels = (1 << db) - 1
    t_ids = torch.arange(num_tiles, **i64)
    # one sentinel row per tile: (tile, max depth), payload cap + t — after
    # every real row of its tile in (key, depth, payload) order
    key_all = torch.cat([key, (t_ids << db) | levels])
    pj_all = torch.cat([pj, cap + t_ids])
    dbits = torch.where(keep, depth_bits(prep.depth)[gid_of_slot], torch.zeros_like(pj))
    dbits_all = torch.cat([dbits, torch.full((num_tiles,), FAR_BITS, **i64)])
    # rows in payload order but for the invalid slots before the
    # sentinels, whose keys differ from theirs
    order = _sorted_rows(key_all, dbits_all)[:cap]
    key_s = key_all[order]
    pj_s = pj_all[order]

    gid_s, j_s, is_sent = _gid_j(pj_s, lambda slot: gid_of_slot[slot], cum - emit, n, cap)
    tid_sorted = torch.clamp(key_s >> db, max=num_tiles)

    perm = None
    if settings.inference:
        # sentinel positions ascending ARE ends[0..T): a stable sort on
        # "not a sentinel" lists them first (then the remaining positions,
        # which an overflowing frame may reach — as in the JAX sort)
        order = torch.sort((~is_sent).to(torch.uint8), stable=True).indices
        ends = order[:num_tiles]
    else:
        # training: sentinel t sits at payload-sorted position K + t (K =
        # #real payloads); the start clamps to [0, cap - T] like
        # lax.dynamic_slice
        perm = torch.sort(pj_s, stable=True).indices
        k_real = torch.sum((~is_sent).to(torch.int64))
        k0 = torch.clamp(k_real, 0, cap - num_tiles)
        ends = perm[k0 + t_ids]
    starts = torch.cat([torch.zeros(1, **i64), ends[:-1] + 1])
    counts = ends - starts

    nchunks = torch.div(counts + CHUNK - 1, CHUNK, rounding_mode="floor")
    grad_base = (torch.cumsum(nchunks, 0) - nchunks) * CHUNK
    grad_total = torch.sum(nchunks) * CHUNK
    grad_overflow = torch.clamp(grad_total - grad_cap, min=0)

    # tile_lo[c] = #{ends < c*CHUNK}
    nc = cap // CHUNK
    chunk_starts = torch.arange(nc + 1, **i64) * CHUNK
    tile_lo = torch.searchsorted(torch.sort(ends + 1).values, chunk_starts, right=True)
    chunks_exec = torch.div(ends[num_tiles - 1] + 1 + CHUNK - 1, CHUNK, rounding_mode="floor")

    i32 = lambda v: v.to(torch.int32)
    return Binning(
        gid_sorted=i32(gid_s),
        j_sorted=i32(j_s),
        starts=i32(starts),
        ends=i32(ends),
        nchunks=i32(nchunks),
        grad_base=i32(grad_base),
        grad_total=i32(grad_total),
        emit_cum=i32(cum),
        offset=i32(cum - emit),
        num_instances=i32(total),
        overflow=i32(overflow),
        grad_overflow=i32(grad_overflow),
        clipped=i32(clipped),
        culled=i32(culled),
        tid_sorted=i32(tid_sorted),
        sent_sorted=is_sent,
        tile_lo=i32(tile_lo),
        chunks_exec=i32(chunks_exec),
        perm=None if perm is None else i32(perm),
    )


def per_gaussian_table(prep: Preprocessed, offset: torch.Tensor) -> torch.Tensor:
    """(N, NUM_FIELDS) per-gaussian field table: 0 x, 1 y, 2..4 PRE-SCALED
    conic (-0.5a, -b, -0.5c, so power = a'dx² + b'dxdy + c'dy²), 5
    opacity, 6..8 rgb, OFFSET_ROW the first emission slot (exact in f32);
    the rest zero."""
    n = prep.mean2d.shape[0]
    dt, dev = prep.mean2d.dtype, prep.mean2d.device
    scale = torch.tensor([-0.5, -1.0, -0.5], dtype=prep.conic.dtype, device=dev)
    return torch.cat(
        [
            prep.mean2d,
            prep.conic * scale,
            prep.opacity[:, None],
            prep.color,
            torch.zeros((n, OFFSET_ROW - NUM_USED_FIELDS), dtype=dt, device=dev),
            offset.detach().to(dt)[:, None],
            torch.zeros((n, NUM_FIELDS - OFFSET_ROW - 1), dtype=dt, device=dev),
        ],
        1,
    )


class RoutedBinning(NamedTuple):
    """One rank's sorted instance bookkeeping under tile sharding (port of
    c3dgs_tpu/render/binning.py:500-526; produced by bin_gaussians_routed).

    The local sorted array holds ONLY this rank's owned tiles' kept
    instances (routed in by an all_to_all), interleaved with one sentinel
    row per owned tile, then pad rows. Within a tile the (key, payload)
    order is the unsharded global sort's. Unlike the JAX record it also
    carries the owned tiles' slot ranges, which K1 and K2 walk."""

    gid_sorted: torch.Tensor  # (cap_local,) int32 source gaussian (clamped)
    j_sorted: torch.Tensor  # (cap_local,) int32 within-gaussian tile index
    tid_sorted: torch.Tensor  # (cap_local,) int32 tile (GLOBAL ids; sentinels
    # carry their real tile, pads num_tiles)
    sent_sorted: torch.Tensor  # (cap_local,) bool sentinel/pad rows
    tile_lo: torch.Tensor  # (cap_local//CHUNK + 1,) int32 GLOBAL-numbered
    # first-unflushed-tile per chunk boundary (t0 + #owned sentinels before)
    chunks_exec: torch.Tensor  # () int32 chunks covering all owned sentinels
    t0: int  # first owned tile
    t1: int  # one past the last owned tile (t0 + n_owned)
    emit_cum: torch.Tensor  # (N,) int32 inclusive per-gaussian emission prefix
    offset: torch.Tensor  # (N,) int32 first emission slot (global)
    num_instances: torch.Tensor  # () int32 true emitted instances (global)
    overflow: torch.Tensor  # () int32 instances past the global slot budget
    clipped: torch.Tensor  # () int32 tiles dropped (max_tiles_per_gaussian)
    route_dropped: torch.Tensor  # () int32 LOCAL instances dropped because a
    # (source, dest) routing budget overflowed: psum for the global count
    starts: torch.Tensor  # (t_local,) int32 first slot of each owned tile
    ends: torch.Tensor  # (t_local,) int32 its sentinel slot; padding
    # tiles (t0 + i >= t1) get the empty range [cap_local, cap_local)


def routed_local_cap(cap: int, shard_num: int, num_tiles: int):
    """(cap_pair, t_local, cap_local) static routing geometry.

    cap_pair is each (src, dst) all_to_all budget: 2x tile-skew headroom
    over the even split of a source slice across its possible destinations.
    A slice has cap/D slots and only min(D, T) reachable destinations (a
    tiles axis wider than the tile grid routes everything into T owners),
    so the even split is cap/D/min(D, T); overshoot beyond 2x is dropped
    and counted (RoutedBinning.route_dropped)."""
    cap_l = cap // shard_num
    dests = max(1, min(shard_num, num_tiles))
    cap_pair = -(-2 * cap_l // dests)  # ceil
    t_pad = -(-num_tiles // shard_num) * shard_num
    t_local = t_pad // shard_num
    cap_local = -(-(shard_num * cap_pair + t_local) // CHUNK) * CHUNK
    return cap_pair, t_local, cap_local


def bin_gaussians_routed(prep: Preprocessed, settings: RasterSettings, axis) -> RoutedBinning:
    """Tile-sharded binning on rank axis.index of the mesh axis `axis`
    (size D; parallel/mesh.py::Axis): enumeration and sorts run at ~cap/D
    slots per rank.

      1. enumerate the interleaved slots d + i*D (i < cap/D) -> (key, pj);
      2. local sort by (key, pj): the tile rides the key's high bits, so
         the sorted rows fall into D contiguous destination ranges (rank r
         owns tiles [r*t_local, (r+1)*t_local));
      3. all_to_all fixed (D, cap_pair, 2) blocks over `axis` (per-pair
         budget with 2x skew headroom; overshoot counted in route_dropped);
      4. local merge sort of the received rows + this rank's owned-tile
         sentinel rows by (key, float depth, pj) -> the rank's sorted
         array; tile ranges and tile_lo from the sentinel positions as in
         bin_gaussians.

    The final order within each tile equals the unsharded global sort's,
    so rendering matches bin_gaussians on every owned tile."""
    dev = prep.depth.device
    n = prep.depth.shape[0]
    cap, max_tiles = settings.resolve_caps(n)
    num_tiles = settings.num_tiles
    shard_num, d = axis.size, axis.index
    if cap % shard_num:
        raise ValueError(f"instance capacity {cap} must divide the tiles axis {shard_num} "
                         "(resolve_caps rounds to 128; use a power-of-two axis)")
    i64 = dict(dtype=torch.int64, device=dev)
    emit, cum, clipped = _emission_prefix(prep, max_tiles)
    total = cum[-1]
    overflow = torch.clamp(total - (cap - num_tiles), min=0)
    ints, floats = _instance_table(prep, cum, emit, num_tiles)

    cap_l = cap // shard_num
    # INTERLEAVED slot slice (ADVICE r3): emission slots follow gaussian
    # order, which is spatially coherent after the save-time Morton sort; a
    # contiguous cap/D block then concentrates on one or two owners and
    # overflows the per-(src, dst) budget. Striding by D makes every slice
    # a uniform sample of the emission order; the slots stay ascending.
    slots = d + torch.arange(cap_l, **i64) * shard_num
    key, pj, _, _, _ = _enumerate_slots(ints, floats, cum, total, slots, n, cap, settings)

    # 2. local sort: ascending tiles partition the rows by destination
    packed_l, _ = torch.sort((key << 32) | pj)
    db = DEPTH_BITS(num_tiles)
    tile_l = packed_l >> (32 + db)

    cap_pair, t_local, cap_local = routed_local_cap(cap, shard_num, num_tiles)
    # destination ranges: hi_r = #{tiles < (r+1)*t_local} (clamped to T so
    # the invalid tail, tile T, never routes)
    qs = torch.clamp(torch.arange(1, shard_num + 1, **i64) * t_local, max=num_tiles) - 1
    his = _rank_in_sorted(tile_l, qs)
    los = torch.cat([torch.zeros(1, **i64), his[:-1]])
    route_dropped = torch.sum(torch.clamp(his - los - cap_pair, min=0))

    # 3. fixed-size send blocks + all_to_all. Pad rows: key past every real
    # key (tile bits T), payload the invalid marker
    pad_key = (num_tiles << db) | ((1 << db) - 1)
    pad_pj = cap + num_tiles
    idx = los[:, None] + torch.arange(cap_pair, **i64)[None, :]
    send = packed_l[torch.clamp(idx, max=cap_l - 1)]
    send = torch.where(idx < his[:, None], send, torch.full_like(send, (pad_key << 32) | pad_pj))
    recv = axis.all_to_all(send).reshape(-1)  # rows from every source rank

    # 4. local merge: received rows + owned sentinels + chunk pad
    t0 = d * t_local
    own = t0 + torch.arange(t_local, **i64)
    sent_row = (((own << db) | ((1 << db) - 1)) << 32) | (cap + own)
    sent_row = torch.where(own < num_tiles, sent_row, torch.full_like(sent_row, (pad_key << 32) | pad_pj))
    n_tail = cap_local - shard_num * cap_pair - t_local
    tail = torch.full((n_tail,), (pad_key << 32) | pad_pj, **i64)
    rows = torch.cat([recv, sent_row, tail])
    key_r, pj_r = rows >> 32, rows & 0xFFFFFFFF
    # rows routed in from other ranks: their gaussian by rank over the
    # (replicated) emission prefix, their depth from it; every routed row
    # was kept (culled rows never route)
    gid_of = lambda slot: torch.clamp(_rank_in_sorted(cum, slot), max=n - 1)
    real = pj_r < cap
    dbits = torch.where(real, depth_bits(prep.depth)[gid_of(torch.where(real, pj_r, torch.zeros_like(pj_r)))],
                        torch.full_like(pj_r, FAR_BITS))
    order = _sorted_rows(key_r, dbits, pj_r)
    key_s = key_r[order]
    pj_s = pj_r[order]

    gid_s, j_s, is_sent = _gid_j(pj_s, gid_of, cum - emit, n, cap)
    tid_sorted = torch.clamp(key_s >> db, max=num_tiles)

    # owned-tile ends from sentinel positions: pads are sentinels too but
    # sort past every owned sentinel (the invariant of bin_gaussians)
    ends_l = torch.sort((~is_sent).to(torch.uint8), stable=True).indices[:t_local]
    n_owned = min(max(num_tiles - t0, 0), t_local)
    owned = torch.arange(t_local, **i64) < n_owned
    ends = torch.where(owned, ends_l, torch.full_like(ends_l, cap_local))
    last_end = ends_l[n_owned - 1] if n_owned > 0 else torch.full((), -1, **i64)
    chunks_exec = torch.div(last_end + 1 + CHUNK - 1, CHUNK, rounding_mode="floor")
    starts = torch.where(owned, torch.cat([torch.zeros(1, **i64), ends[:-1] + 1]), ends)

    nc = cap_local // CHUNK
    chunk_starts = torch.arange(nc + 1, **i64) * CHUNK
    tile_lo = t0 + _rank_in_sorted(ends + 1, chunk_starts)

    i32 = lambda v: v.to(torch.int32)
    return RoutedBinning(
        gid_sorted=i32(gid_s),
        j_sorted=i32(j_s),
        tid_sorted=i32(tid_sorted),
        sent_sorted=is_sent,
        tile_lo=i32(tile_lo),
        chunks_exec=i32(chunks_exec),
        t0=t0,
        t1=t0 + n_owned,
        emit_cum=i32(cum),
        offset=i32(cum - emit),
        num_instances=i32(total),
        overflow=i32(overflow),
        clipped=i32(clipped),
        route_dropped=i32(route_dropped),
        starts=i32(starts),
        ends=i32(ends),
    )
