// Shared by K1 (tiles_packed_fwd.cu) and K2 (tiles_packed_bwd.cu): the
// packed kernels' constants, their pixel layout, the bulk copy of a batch
// into their ring, the float4 read of a staged slot group, and the pieces
// of the per-(pixel, slot) alpha of
// c3dgs_tpu/render/tiles_packed.py:129-146. kernels.library_path hashes
// this header into each including library's name, so an edit here
// rebuilds both.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "bulk_copy.cuh"

namespace c3dgs {

constexpr int TILE_X = 32;
constexpr int PIX = 512;  // 32 x 16 pixels
constexpr int CHUNK = 128;  // the global slot chunk, and a ring stage's width
constexpr int OUT_ROWS = 8;
constexpr float MIN_ALPHA = 1.0f / 255.0f;
constexpr float MAX_ALPHA = 0.99f;
// op <= 1 and power below this: op * exp(power) < exp(-5.55) < 1/255, so
// alpha is 0 in every version and the exp can be skipped
constexpr float SKIP_POWER = -5.55f;
constexpr unsigned FULL = 0xffffffffu;

// Pixels per thread, and threads per tile (one CTA per tile).
constexpr int PPT = 2;
constexpr int THREADS = PIX / PPT;

// Tile-local pixel index of pixel k (0 or 1) of thread `tid`. The tile is a
// 4x4 grid of 8x4 blocks; lane = 8 columns x 4 rows of a block, and pixel k
// of warp w is block 2w + k in Z order, so a warp owns a 16x4 region and
// each (warp, k) slice of 32 pixels is one 8x4 block: the branches on alpha
// diverge less than along a 32-pixel row.
__device__ __forceinline__ int pixel_index(int tid, int k) {
  const int b = (tid >> 5) * PPT + k, lane = tid & 31;
  const int bx = (b & 1) | ((b >> 1) & 2);
  const int by = ((b >> 1) & 1) | ((b >> 2) & 2);
  return (by * 4 + (lane >> 3)) * TILE_X + bx * 8 + (lane & 7);
}

// One batch of the ring: slots [lo, hi) of `rows` field rows into
// dst[f][...], dst[f] taking fields row f except the last, which takes row
// `last_row`. The copy covers the 16-byte aligned span [lo & ~3,
// roundup4(hi)), so slot s lands at dst[f][s - (lo & ~3)]; the caller
// keeps the span inside one 128-slot chunk (hi <= the row stride, a
// multiple of 128). Called by one thread.
__device__ __forceinline__ void stage_slots(float (*dst)[CHUNK], uint64_t* bar, const float* fields,
                                            long long stride, int lo, int hi, int rows, int last_row) {
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
// 4g..4g+3 of a ring stage laid out [field][CHUNK]: one 16-byte shared load
// per field serves 4 slots.
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
    const float4 v = *reinterpret_cast<const float4*>(stage + field * CHUNK + 4 * group);
    dst[0] = v.x;
    dst[1] = v.y;
    dst[2] = v.z;
    dst[3] = v.w;
  }
};

// power = min(a'dx^2 + b'dxdy + c'dy^2, 0) of slot j of the group at
// tile-local offset (dx, dy)
__device__ __forceinline__ float slot_power(const SlotGroup& s, int j, float dx, float dy) {
  return fminf((s.a[j] * dx + s.b[j] * dy) * dx + (s.c[j] * dy) * dy, 0.f);
}

// op <= 1 and power below SKIP_POWER: alpha is 0 in every version. The
// kernels test this before the exp as its own branch (`continue`), so the
// exp and everything after it are skipped and not merely predicated off.
__device__ __forceinline__ bool alpha_is_zero(const SlotGroup& s, int j, float power) {
  return s.op[j] <= 1.f && power < SKIP_POWER;
}

// alpha = min(0.99, raw), 0 below 1/255, for raw = op * exp(power)
__device__ __forceinline__ float alpha_of(float raw) { return raw >= MIN_ALPHA ? fminf(MAX_ALPHA, raw) : 0.f; }

}  // namespace c3dgs
