// Shared by the four compositing kernels, K1 (tiles_packed_fwd.cu), K2
// (tiles_packed_bwd.cu), K3 (tiles_fwd.cu) and K4 (tiles_bwd.cu): their
// constants, their pixel layout, the bulk copy of a slot range into a ring
// stage, the float4 read of a staged slot group, the pieces of the
// per-(pixel, slot) alpha of c3dgs_tpu/render/tiles.py:71-81 and
// tiles_packed.py:129-146, and the backward kernels' per-pixel step and
// warp reduce-scatter. A packed stage is one aligned 128-slot chunk wide
// (CHUNK); a per-tile window starts at any slot, so a per-tile stage is 4
// slots wider (STAGE_W). kernels.library_path hashes this header into each
// including library's name, so an edit here rebuilds all four.
//
// The tile shape comes from C3DGS_TILE_X / C3DGS_TILE_Y (kernels.py passes
// render/types.py's constants; 32x16 when unset), one library per shape.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "bulk_copy.cuh"

#ifndef C3DGS_TILE_X
#define C3DGS_TILE_X 32
#endif
#ifndef C3DGS_TILE_Y
#define C3DGS_TILE_Y 16
#endif

namespace c3dgs {

constexpr int TILE_X = C3DGS_TILE_X;
constexpr int TILE_Y = C3DGS_TILE_Y;
constexpr int PIX = TILE_X * TILE_Y;
// the shapes render/types.py::kernel_shape_ok accepts
static_assert(TILE_X > 0 && TILE_X % 8 == 0, "the tile width must be a multiple of 8 (8x4 pixel blocks)");
static_assert(TILE_Y > 0 && TILE_Y % 4 == 0, "the tile height must be a multiple of 4 (8x4 pixel blocks)");
static_assert(PIX % 64 == 0, "a tile must hold an even number of 8x4 blocks (two per warp)");
static_assert(PIX <= 2048, "at most 1024 threads per tile (2 pixels each)");
constexpr int CHUNK = 128;  // the global slot chunk (packed), a window (per-tile)
constexpr int OUT_ROWS = 8;
constexpr float STOP_T = 1e-4f;
constexpr float MIN_ALPHA = 1.0f / 255.0f;
constexpr float MAX_ALPHA = 0.99f;
constexpr float LOG_EXIT_T = -13.815510557964274f;  // log(1e-6)
constexpr float LOG_STOP_T = -9.210340371976182f;  // log(1e-4)
// op <= 1 and power below this: op * exp(power) < exp(-5.55) < 1/255, so
// alpha is 0 in every version and the exp can be skipped
constexpr float SKIP_POWER = -5.55f;
constexpr unsigned FULL = 0xffffffffu;

// Pixels per thread, and threads per tile (one CTA per tile).
constexpr int PPT = 2;
constexpr int THREADS = PIX / PPT;
constexpr int WARPS = THREADS / 32;

// The per-tile kernels' stage width: a window's up to 128 instances start
// at any slot, and the 16-byte aligned span around them is up to 132
// floats wide.
constexpr int STAGE_W = CHUNK + 4;

// Residency for __launch_bounds__: the CTAs of this shape that make up the
// warps per SM a kernel was tuned for at 32x16 (at least one CTA).
constexpr int min_ctas(int warps_per_sm) { return warps_per_sm / WARPS > 0 ? warps_per_sm / WARPS : 1; }

// The pixel layout. The tile is a BLOCKS_X x BLOCKS_Y grid of 8x4 blocks;
// lane = 8 columns x 4 rows of a block, and each (warp, k) slice of 32
// pixels is one block, so the branches on alpha diverge less than along a
// pixel row. A warp owns two blocks: side by side (a 16x4 region) where
// the block columns pair up, else one above the other (8x8). The warps'
// regions form a REGIONS_X x REGIONS_Y grid, numbered down bands of BAND
// region rows, column by column within a band, band after band. At 32x16
// that is the 4x4-block Z order: warp w's bits 0, 1, 2 give the region's
// row bit 0, column, row bit 1 (w = 0: blocks 0-1 of block row 0, w = 1:
// of block row 1, w = 2: blocks 2-3 of block row 0, ...).
constexpr int BLOCKS_X = TILE_X / 8;
constexpr int BLOCKS_Y = TILE_Y / 4;
constexpr bool SIDE_BY_SIDE = BLOCKS_X % 2 == 0;
constexpr int REGIONS_X = SIDE_BY_SIDE ? BLOCKS_X / 2 : BLOCKS_X;
constexpr int REGIONS_Y = SIDE_BY_SIDE ? BLOCKS_Y : BLOCKS_Y / 2;
constexpr int BAND = REGIONS_Y % 2 == 0 ? 2 : 1;
static_assert(REGIONS_X * REGIONS_Y == WARPS, "one region per warp");

// Tile-local pixel index of pixel k (0 or 1) of thread `tid`.
__device__ __forceinline__ int pixel_index(int tid, int k) {
  const int w = tid >> 5, lane = tid & 31;
  const int rx = (w / BAND) % REGIONS_X;
  const int ry = (w / (BAND * REGIONS_X)) * BAND + w % BAND;
  const int bx = SIDE_BY_SIDE ? 2 * rx + k : rx;
  const int by = SIDE_BY_SIDE ? ry : 2 * ry + k;
  return (by * 4 + (lane >> 3)) * TILE_X + bx * 8 + (lane & 7);
}

// Global coordinates of tile-local pixel p of the tile with global id
// `tile_id` (the per-tile kernels' staged means are global).
__device__ __forceinline__ void pixel_coords(int tile_id, int tiles_x, int p, float* px, float* py) {
  *px = static_cast<float>((tile_id % tiles_x) * TILE_X + p % TILE_X);
  *py = static_cast<float>((tile_id / tiles_x) * TILE_Y + p / TILE_X);
}

// One batch of a ring: slots [lo, hi) of `rows` field rows into
// dst[f][...], dst[f] taking fields row f except the last, which takes row
// `last_row`. The copy covers the 16-byte aligned span [lo & ~3,
// roundup4(hi)), so slot s lands at dst[f][s - (lo & ~3)]; the caller
// keeps the span within W floats and hi <= the row stride (a multiple of
// 128). Called by one thread.
template <int W>
__device__ __forceinline__ void stage_slots(float (*dst)[W], uint64_t* bar, const float* fields, long long stride,
                                            int lo, int hi, int rows, int last_row) {
  const int a0 = lo & ~3;
  const int a1 = (hi + 3) & ~3;
  const uint32_t bytes = static_cast<uint32_t>(a1 - a0) * 4u;
  mbar_expect_tx(bar, bytes * static_cast<uint32_t>(rows));
  for (int f = 0; f < rows; ++f) {
    const int row = f == rows - 1 ? last_row : f;
    bulk_copy_g2s(dst[f], fields + row * stride + a0, bytes, bar);
  }
}

// Fields 0-8 (x, y, a', b', c', opacity, r, g, b) of the 4 staged slots
// 4g..4g+3 of a ring stage laid out [field][W]: one 16-byte shared load
// per field serves 4 slots.
template <int W>
struct SlotGroup {
  float x[4], y[4], a[4], b[4], c[4], op[4], r[4], g[4], bl[4];

  __device__ __forceinline__ SlotGroup(const float* stage, int group) {
    load(x, stage, 0, group);
    load(y, stage, 1, group);
    load(a, stage, 2, group);
    load(b, stage, 3, group);
    load(c, stage, 4, group);
    load(op, stage, 5, group);
    load(r, stage, 6, group);
    load(g, stage, 7, group);
    load(bl, stage, 8, group);
  }

  static __device__ __forceinline__ void load(float (&dst)[4], const float* stage, int field, int group) {
    const float4 v = *reinterpret_cast<const float4*>(stage + field * W + 4 * group);
    dst[0] = v.x;
    dst[1] = v.y;
    dst[2] = v.z;
    dst[3] = v.w;
  }
};

// power = min(a'dx^2 + b'dxdy + c'dy^2, 0) of slot j of the group at
// offset (dx, dy) from the pixel
template <int W>
__device__ __forceinline__ float slot_power(const SlotGroup<W>& s, int j, float dx, float dy) {
  return fminf((s.a[j] * dx + s.b[j] * dy) * dx + (s.c[j] * dy) * dy, 0.f);
}

// op <= 1 and power below SKIP_POWER: alpha is 0 in every version. The
// kernels test this before the exp as its own branch (`continue`), so the
// exp and everything after it are skipped and not merely predicated off.
template <int W>
__device__ __forceinline__ bool alpha_is_zero(const SlotGroup<W>& s, int j, float power) {
  return s.op[j] <= 1.f && power < SKIP_POWER;
}

// alpha = min(0.99, raw), 0 below 1/255, for raw = op * exp(power)
__device__ __forceinline__ float alpha_of(float raw) { return raw >= MIN_ALPHA ? fminf(MAX_ALPHA, raw) : 0.f; }

// ---------------------------------------------------------- backward (K2, K4)
constexpr int NSUM = 9;  // rgb x3, s0, mx, my, mxx, mxy, myy
constexpr int PART_LD = CHUNK + 1;  // the 9 storing lanes hit 9 banks
constexpr int PART_FLOATS = WARPS * NSUM * PART_LD;  // row warp*9 + value, one column per slot
constexpr int STATIC_SMEM_LIMIT = 48 * 1024;

// Bytes of dynamic shared memory a backward kernel whose ring takes
// `ring_bytes` launches with: 0 while the partials fit beside the ring in
// static shared memory (32x16 and smaller tiles), the partials' bytes past
// the 48 KB static limit (32x32: 74.3 KB of partials).
constexpr int partial_dynamic_bytes(int ring_bytes) {
  return ring_bytes + PART_FLOATS * 4 + 64 > STATIC_SMEM_LIMIT ? PART_FLOATS * 4 : 0;
}

// The backward kernels' per-slot partial sums, [WARPS * NSUM][PART_LD]:
// static shared memory, or the launch's dynamic shared memory.
template <bool DYNAMIC>
__device__ __forceinline__ auto partials() -> float (*)[PART_LD] {
  if constexpr (DYNAMIC) {
    extern __shared__ __align__(16) float dynamic_part[];
    return reinterpret_cast<float (*)[PART_LD]>(dynamic_part);
  } else {
    __shared__ float part[WARPS * NSUM][PART_LD];
    return part;
  }
}

// one step of the reduce-scatter: the lower half of each lane group keeps
// lo, the upper half hi, each adding its partner's copy
__device__ __forceinline__ float fold(float lo, float hi, bool upper, int mask) {
  const float keep = upper ? hi : lo;
  const float send = upper ? lo : hi;
  return keep + __shfl_xor_sync(FULL, send, mask);
}

// The warp's sums of v[0..8], scattered: the returned value is the sum of
// v[scatter_lane_value(lane >> 1)] over all 32 lanes (junk where that is
// -1). Lane bit 4 splits the values {0-4 | 5-8}, bit 3 {first 3 | last 2}
// of those, bit 2 {first 2 | last}, bit 1 {first | second}; bit 0 joins
// the pair. 12 shuffles in a fixed order.
__device__ __forceinline__ float reduce_scatter9(const float (&v)[NSUM], int lane) {
  const bool u4 = lane & 16, u3 = lane & 8, u2 = lane & 4, u1 = lane & 2;
  float a[5];
#pragma unroll
  for (int i = 0; i < 5; ++i) a[i] = fold(v[i], i + 5 < NSUM ? v[i + 5] : 0.f, u4, 16);
  float b[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) b[i] = fold(a[i], i + 3 < 5 ? a[i + 3] : 0.f, u3, 8);
  const float c0 = fold(b[0], b[2], u2, 4);
  const float c1 = fold(b[1], 0.f, u2, 4);
  const float d = fold(c0, c1, u1, 2);
  return d + __shfl_xor_sync(FULL, d, 1);
}

// value index held by lanes 2m and 2m+1 after reduce_scatter9, -1 for
// none: the table {0, 1, 2, -, 3, 4, -, -, 5, 6, 7, -, 8, -, -, -} as one
// nibble per m (15 for none)
__device__ __forceinline__ int scatter_lane_value(int m) {
  const int v = static_cast<int>((0xFFF8F765FF43F210ull >> (4 * m)) & 15ull);
  return v == 15 ? -1 : v;
}

// Per-pixel walk state of a backward kernel: the pixel's coordinates (in
// the frame of the staged means), dL/dC, dL/dT_final * T_final, lt and the
// strict suffix S.
struct Pixel {
  float px, py, gc0, gc1, gc2, gtt, lt, S;
};

// One pixel's step back over slot j, where its alpha > 0: lt and S move
// back, and the pixel's 9 values are added to v.
template <int W>
__device__ __forceinline__ void walk_back(Pixel& q, const SlotGroup<W>& sg, int j, float alpha, float raw,
                                          float dx, float dy, float (&v)[NSUM]) {
  const float tlog = log1pf(-alpha);
  const float pre = q.lt - tlog;
  q.lt = pre;
  const float w = pre + tlog >= LOG_STOP_T ? alpha * expf(pre) : 0.f;
  const float gwc = w * (q.gc0 * sg.r[j] + q.gc1 * sg.g[j] + q.gc2 * sg.bl[j]);
  float gp = gwc - (q.S + q.gtt) * (alpha / (1.f - alpha));
  if (raw > MAX_ALPHA) gp = 0.f;
  q.S += gwc;
  const float gdx = gp * dx, gdy = gp * dy;
  v[0] += q.gc0 * w;
  v[1] += q.gc1 * w;
  v[2] += q.gc2 * w;
  v[3] += gp;
  v[4] += gdx;
  v[5] += gdy;
  v[6] += gdx * dx;
  v[7] += gdx * dy;
  v[8] += gdy * dy;
}

}  // namespace c3dgs
