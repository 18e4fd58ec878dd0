// K2: packed backward of the alpha compositing, written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel c3dgs_tpu/render/tiles_packed.py:353
// (backward_kernel, launched by pallas_call at
// c3dgs_tpu/render/rasterizer.py:221). Same information in, the same
// per-slot gradient rows out: the staged fields of
// rasterizer._build_fields_packed, K1's (T, 8, 512) blocks (row 3
// exp(lt_final), row 4 lt_final, row 5 the freeze slot), the cotangent
// blocks (rows 0-2 dL/dC, row 3 dL/dT_final), starts/ends and meta. Out is
// the zero-initialized (16, exec_cap) f32 buffer, one column per sorted
// slot:
//   rows 0-1  dL/dx, dL/dy of the tile-local mean
//   rows 2-4  dL/d(a', b', c'): the moments mxx, mxy, myy
//   row  5    dL/dopacity = s0 / max(op, 1e-12)
//   rows 6-8  dL/drgb
//   row  9    the pre-sort slot (fields row 10) of every walked slot
//   rows 10-15 zero
// Slots at or past the tile's freeze slot are dead and keep zero rows.
// Tiles whose sentinel lies at or past meta[0]*128 never flushed; their K1
// blocks are unwritten memory, so the CTA returns before reading them and
// their rows stay zero (what the TPU gives them: zero cotangent, zero
// open-tile state).
//
// Numerics (the exact-mode `compute` of tiles_packed.py:851-1016), per
// pixel, walking the tile's slots back to front from lt = lt_final with the
// strict suffix S = 0:
//   alpha as in the forward (power clamped to <= 0; 0 below 1/255, capped
//   at 0.99); tlog = log1p(-alpha); pre = lt - tlog; lt = pre
//   live  = pre + tlog >= log(1e-4)      (the backward's log-domain test)
//   w     = live ? alpha * exp(pre) : 0
//   gwc   = w * (dL/dC . rgb)
//   g_pow = gwc - (S + dL/dT_final * T_final) * alpha / (1 - alpha),
//           0 where op*exp(power) > 0.99;   then S += gwc
// and per slot the sums over the tile's 512 pixels: dL/drgb = sum dL/dC*w,
// s0 = sum g_pow, mx, my = sum g_pow*dx, g_pow*dy, and the second moments;
// g_x = 2a'mx + b'my, g_y = 2c'my + b'mx. The TPU's fast_grad mode is a
// bf16-MXU precision trade; here both modes compute this in fp32 and
// fast_grad only drops the compensation of the reduction that follows.
//
// Design. One CTA per 32x16 tile, one thread per pixel (as K1). The CTA
// stages its slots from min(ends[t], freeze[t]) - 1 down to starts[t] into
// shared memory in batches of 64 (x, y, a', b', c', op, r, g, b, pre-sort
// slot) and each thread walks a batch back to front with S and lt in
// registers. The TPU walk's cross-chunk carries, its slim block regrouping
// and its chunk_map compaction are not needed: a tile is walked whole by
// one CTA, so the sentinel-on-lane-0 handoff of tiles_packed.py:984-992
// cannot arise. The per-slot sums are deterministic and free of atomics: a
// warp-shuffle tree per slot and value (a warp whose lanes all have
// alpha = 0 writes zeros and skips its shuffles), per-warp partials in
// shared memory (16 warps x 9 values x 64 slots, 36 KB), then one sum over
// the 16 warps in a fixed order. Two runs give bitwise-equal gradients.
//
// Bound on the card. chip_smoke.py's 1080p bench frame (300k splats, 4,080
// tiles; PR 1's chip run on an H100 80GB HBM3 at 700 W) walks 3.35e8
// (pixel, slot) pairs, 6.2e7 of them with alpha > 0: one exp per pair plus
// a log1p, an exp and a reciprocal per alpha > 0 pair, ~5.2e8
// special-function operations on 132 SMs x 16 a clock at 1980 MHz,
// ~0.13 ms. Bytes are ~0.13 GB (10 field rows of the walked slots, 7
// block rows per pixel, 16 gradient rows of the execution capacity),
// ~0.04 ms at 3.35 TB/s. So the kernel is bound by special-function
// operations; chip_smoke.py computes each run's bound from that run's own
// counts. This first version adds ~45 shuffles per slot and warp for the
// sums and makes no attempt at load balance across heavy tiles.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE_X = 32;
constexpr int PIX = 512;  // 32 x 16 pixels, one thread each
constexpr int WARPS = PIX / 32;
constexpr int CHUNK = 128;
constexpr int OUT_ROWS = 8;
constexpr int BATCH = 64;
constexpr int STAGED = 10;  // x, y, a', b', c', opacity, r, g, b, pre-sort slot
constexpr int OFFSET_ROW = 10;  // fields row holding the pre-sort slot
constexpr int NSUM = 9;  // rgb x3, s0, mx, my, mxx, mxy, myy
constexpr float MIN_ALPHA = 1.0f / 255.0f;
constexpr float MAX_ALPHA = 0.99f;
constexpr float LOG_STOP_T = -9.210340371976182f;  // log(1e-4)
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(FULL, v, o);
  return v;
}

__global__ void __launch_bounds__(PIX)
tiles_packed_bwd_kernel(const float* __restrict__ fields, long long stride,
                        const int* __restrict__ starts,
                        const int* __restrict__ ends,
                        const int* __restrict__ meta,
                        const float* __restrict__ totals,
                        const float* __restrict__ gout,
                        float* __restrict__ grads) {
  __shared__ float sf[STAGED][BATCH];
  __shared__ float part[WARPS][NSUM][BATCH];
  __shared__ float sums[NSUM][BATCH];
  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int lane = p & 31;
  const int warp = p >> 5;
  const int e = ends[t];  // the tile's sentinel slot
  if (e >= meta[0] * CHUNK) return;  // never flushed: blocks unwritten
  const int s = starts[t];
  const float* blk = totals + static_cast<long long>(t) * OUT_ROWS * PIX;
  const float* g = gout + static_cast<long long>(t) * OUT_ROWS * PIX;
  const int frz = static_cast<int>(blk[5 * PIX]);  // uniform over the tile
  const int walk_end = min(e, frz);
  const float px = static_cast<float>(p % TILE_X);
  const float py = static_cast<float>(p / TILE_X);
  const float gc0 = g[p], gc1 = g[PIX + p], gc2 = g[2 * PIX + p];
  const float gtt = g[3 * PIX + p] * blk[3 * PIX + p];
  float lt = blk[4 * PIX + p];
  float S = 0.f;

  for (int hi = walk_end; hi > s; hi -= BATCH) {
    const int lo = max(s, hi - BATCH);
    const int nb = hi - lo;
    __syncthreads();  // every thread is done with the previous batch
    for (int i = p; i < STAGED * BATCH; i += PIX) {
      const int f = i / BATCH, l = i % BATCH;
      const int row = f == STAGED - 1 ? OFFSET_ROW : f;
      if (l < nb) sf[f][l] = fields[row * stride + lo + l];
    }
    __syncthreads();
    for (int l = nb - 1; l >= 0; --l) {
      const float dx = sf[0][l] - px;
      const float dy = sf[1][l] - py;
      const float power =
          fminf((sf[2][l] * dx + sf[3][l] * dy) * dx + (sf[4][l] * dy) * dy, 0.f);
      const float raw = sf[5][l] * expf(power);
      const float alpha = raw >= MIN_ALPHA ? fminf(MAX_ALPHA, raw) : 0.f;
      float v[NSUM];
#pragma unroll
      for (int k = 0; k < NSUM; ++k) v[k] = 0.f;
      if (alpha > 0.f) {
        const float tlog = log1pf(-alpha);
        const float pre = lt - tlog;
        lt = pre;
        const float w = pre + tlog >= LOG_STOP_T ? alpha * expf(pre) : 0.f;
        const float gwc = w * (gc0 * sf[6][l] + gc1 * sf[7][l] + gc2 * sf[8][l]);
        float gp = gwc - (S + gtt) * (alpha / (1.f - alpha));
        if (raw > MAX_ALPHA) gp = 0.f;
        S += gwc;
        const float gdx = gp * dx, gdy = gp * dy;
        v[0] = gc0 * w;
        v[1] = gc1 * w;
        v[2] = gc2 * w;
        v[3] = gp;
        v[4] = gdx;
        v[5] = gdy;
        v[6] = gdx * dx;
        v[7] = gdx * dy;
        v[8] = gdy * dy;
      }
      if (__any_sync(FULL, alpha > 0.f)) {
#pragma unroll
        for (int k = 0; k < NSUM; ++k) v[k] = warp_sum(v[k]);
      }
      if (lane == 0) {
#pragma unroll
        for (int k = 0; k < NSUM; ++k) part[warp][k][l] = v[k];
      }
    }
    __syncthreads();
    for (int i = p; i < NSUM * BATCH; i += PIX) {
      const int k = i / BATCH, l = i % BATCH;
      if (l < nb) {
        float acc = 0.f;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) acc += part[w][k][l];
        sums[k][l] = acc;
      }
    }
    __syncthreads();
    if (p < nb) {
      const int l = p;
      const float mx = sums[4][l], my = sums[5][l];
      float* o = grads + lo + l;
      o[0 * stride] = 2.f * sf[2][l] * mx + sf[3][l] * my;
      o[1 * stride] = 2.f * sf[4][l] * my + sf[3][l] * mx;
      o[2 * stride] = sums[6][l];
      o[3 * stride] = sums[7][l];
      o[4 * stride] = sums[8][l];
      o[5 * stride] = sums[3][l] / fmaxf(sf[5][l], 1e-12f);
      o[6 * stride] = sums[0][l];
      o[7 * stride] = sums[1][l];
      o[8 * stride] = sums[2][l];
      o[9 * stride] = sf[9][l];
    }
  }
}

}  // namespace

extern "C" {

// fields: (16, stride) f32 staged sorted fields (rows 0-8 and 10 read);
// starts/ends: (num_tiles,) i32 tile slot ranges (ends = sentinel slots);
// meta: (4,) i32 on the device, [chunks_exec, tile_start, tile_end, cap];
// totals: K1's (num_tiles, 8, 512) f32 blocks; gout: their cotangent, same
// shape; grads: (16, stride) f32, zero-initialized by the caller. Launches
// on `stream`; returns cudaGetLastError() (0 when the launch was accepted).
int c3dgs_tiles_packed_bwd(const float* fields, long long stride,
                           const int* starts, const int* ends,
                           const int* meta, const float* totals,
                           const float* gout, float* grads, int num_tiles,
                           void* stream) {
  if (num_tiles > 0) {
    tiles_packed_bwd_kernel<<<num_tiles, PIX, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        fields, stride, starts, ends, meta, totals, gout, grads);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* c3dgs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
