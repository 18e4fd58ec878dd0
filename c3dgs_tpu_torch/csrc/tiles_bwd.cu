// K4: per-tile backward of the alpha compositing, written for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel c3dgs_tpu/render/tiles.py:320
// (backward_kernel, launched by pallas_call at
// c3dgs_tpu/render/rasterizer.py:451). Same information in, the same
// per-instance gradient rows out: the staged fields of
// rasterizer._build_fields, the binning's tile_ids / starts / ends /
// nchunks / grad_base, K3's (T, 8, 512) blocks (row 3 exp(lt_final), row 4
// lt_final, row 5 stop) and their cotangent (rows 0-2 dL/dC, row 3
// dL/dT_final). Out is the zero-initialized (16, grad_cap) f32 buffer;
// window w of tile t owns the 128 columns at grad_base[t] + w*128, clamped
// to grad_cap - 128:
//   rows 0-1  dL/dx, dL/dy of the global mean
//   rows 2-4  dL/d(a', b', c'): the moments mxx, mxy, myy
//   row  5    dL/dopacity = s0 / max(op, 1e-12)
//   rows 6-8  dL/drgb
//   row  9    the instance's pre-sort slot (fields row 9); the slot-domain
//             cap (the fields' row length) on tail lanes past ends[t]
//   rows 10-15 zero
// Windows at or past the forward's stop were never blended: they write the
// tag row only (tiles.py:553-566).
//
// Numerics (tiles.py:441-551, the exact mode), per pixel, walking the
// windows stop-1 down to 0 and each window's lanes back to front, from
// lt = lt_final and the strict suffix S = 0:
//   alpha as in the forward; tlog = log1p(-alpha); pre = lt - tlog; lt = pre
//   live  = pre + tlog >= log(1e-4)
//   w     = live ? alpha * exp(pre) : 0
//   gwc   = w * (dL/dC . rgb)
//   g_pow = gwc - (S + dL/dT_final * T_final) * alpha / (1 - alpha),
//           0 where op*exp(power) > 0.99;   then S += gwc
// and per lane the sums over the tile's 512 pixels: dL/drgb = sum dL/dC*w,
// s0 = sum g_pow, mx, my = sum g_pow*dx, g_pow*dy and the second moments;
// g_x = 2a'mx + b'my, g_y = 2c'my + b'mx. Walked back to front, lt after a
// window is its entering lt, lt_exit minus the window's sum (tiles.py:
// 450-458), and S carries every later lane of the tile. The TPU's
// fast_grad mode is a bf16-MXU precision trade; here both modes compute
// this in fp32 and fast_grad only drops the compensation of the reduction
// that follows.
//
// Clamped frames. When grad_total exceeds grad_cap, several windows land on
// the last chunk (grad_cap - 128). The TPU runs its grid in order, so the
// chunk holds what the last of them wrote: the last tile with any window
// (its windows end at grad_total), at the lowest of its windows that
// clamps. Blocks on the card run in any order, so every other clamped
// window skips its write and the result is the TPU's, on every run. A
// block decides this from grad_base and nchunks alone.
//
// Design. One CTA per 32x16 tile, one thread per pixel, as K2
// (tiles_packed_bwd.cu). Each window is staged in two halves of 64 lanes
// (x, y, a', b', c', op, r, g, b, pre-sort slot), the upper half first,
// and every thread walks a half back to front with S and lt in registers.
// The per-lane sums are deterministic and free of atomics: a warp-shuffle
// tree per lane and value (a warp whose lanes all have alpha = 0 writes
// zeros and skips its shuffles), per-warp partials in shared memory (16
// warps x 9 values x 64 lanes, 36 KB), then one sum over the 16 warps in a
// fixed order. Two runs give bitwise-equal gradients.
//
// Bound on the card: one exp per walked (pixel, real lane) pair, and a
// log1p, an exp and a reciprocal per pair with alpha > 0, on the
// special-function units; chip_smoke.py computes each run's bound from
// that run's own counts. This first version adds ~45 shuffles per lane and
// warp for the sums and makes no attempt at load balance across heavy
// tiles.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tiles_common.cuh"

namespace {

using namespace c3dgs;

constexpr int BATCH = 64;  // lanes staged at once: half a window
constexpr int STAGED = 10;  // x, y, a', b', c', opacity, r, g, b, pre-sort slot
constexpr int NSUM = 9;  // rgb x3, s0, mx, my, mxx, mxy, myy

__global__ void __launch_bounds__(PIX)
tiles_bwd_kernel(const float* __restrict__ fields, long long stride,
                 const int* __restrict__ tile_ids,
                 const int* __restrict__ starts,
                 const int* __restrict__ ends,
                 const int* __restrict__ nchunks,
                 const int* __restrict__ grad_base,
                 const float* __restrict__ totals,
                 const float* __restrict__ gout, int tiles_x,
                 float* __restrict__ grads, long long gstride, int num_tiles) {
  __shared__ float sf[STAGED][BATCH];
  __shared__ float part[WARPS][NSUM][BATCH];
  __shared__ float sums[NSUM][BATCH];
  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int lane = p & 31;
  const int warp = p >> 5;
  const int nw = nchunks[t];
  if (nw == 0) return;
  const int s = starts[t];
  const int count = ends[t] - s;
  const float cap = static_cast<float>(stride);  // the tail lanes' tag
  const float* blk = totals + static_cast<long long>(t) * OUT_ROWS * PIX;
  const float* g = gout + static_cast<long long>(t) * OUT_ROWS * PIX;
  const int stop = min(static_cast<int>(blk[5 * PIX]), nw);  // uniform over the tile

  // the clamped last chunk belongs to the TPU grid's last writer only
  const long long last = gstride - CHUNK;
  const long long gb = grad_base[t];
  const long long total =
      static_cast<long long>(grad_base[num_tiles - 1]) + static_cast<long long>(nchunks[num_tiles - 1]) * CHUNK;
  const bool last_tile = gb + static_cast<long long>(nw) * CHUNK == total;
  const long long w_last = last > gb ? (last - gb) / CHUNK : 0;
  auto offset = [&](int w) -> long long {  // -1: this window does not write
    const long long off = gb + static_cast<long long>(w) * CHUNK;
    if (off < last) return off;
    return (last_tile && w == w_last) ? last : -1;
  };

  // windows the forward never blended: the tag row only
  for (int w = stop; w < nw; ++w) {
    const long long off = offset(w);
    if (off >= 0 && p < CHUNK) {
      grads[PRESORT_ROW * gstride + off + p] =
          w * CHUNK + p < count ? fields[PRESORT_ROW * stride + s + w * CHUNK + p] : cap;
    }
  }

  float px, py;
  pixel_coords(tile_ids[t], tiles_x, p, &px, &py);
  const float gc0 = g[p], gc1 = g[PIX + p], gc2 = g[2 * PIX + p];
  const float gtt = g[3 * PIX + p] * blk[3 * PIX + p];
  float lt = blk[4 * PIX + p];
  float S = 0.f;

  for (int w = stop - 1; w >= 0; --w) {
    const long long off = offset(w);
    for (int half = 1; half >= 0; --half) {
      const int lo = w * CHUNK + half * BATCH;  // first lane's index in the tile
      const int nb = max(0, min(BATCH, count - lo));
      if (nb > 0) {
        __syncthreads();  // every thread is done with the previous half
        for (int i = p; i < STAGED * BATCH; i += PIX) {
          const int f = i / BATCH, l = i % BATCH;
          if (l < nb) sf[f][l] = fields[f * stride + s + lo + l];
        }
        __syncthreads();
        for (int l = nb - 1; l >= 0; --l) {
          const float dx = sf[0][l] - px;
          const float dy = sf[1][l] - py;
          float raw;
          const float alpha = alpha_of(dx, dy, sf[2][l], sf[3][l], sf[4][l], sf[5][l], &raw);
          float v[NSUM];
#pragma unroll
          for (int k = 0; k < NSUM; ++k) v[k] = 0.f;
          if (alpha > 0.f) {
            const float tlog = log1pf(-alpha);
            const float pre = lt - tlog;
            lt = pre;
            const float wgt = pre + tlog >= LOG_STOP_T ? alpha * expf(pre) : 0.f;
            const float gwc = wgt * (gc0 * sf[6][l] + gc1 * sf[7][l] + gc2 * sf[8][l]);
            float gp = gwc - (S + gtt) * (alpha / (1.f - alpha));
            if (raw > MAX_ALPHA) gp = 0.f;
            S += gwc;
            const float gdx = gp * dx, gdy = gp * dy;
            v[0] = gc0 * wgt;
            v[1] = gc1 * wgt;
            v[2] = gc2 * wgt;
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
            for (int q = 0; q < WARPS; ++q) acc += part[q][k][l];
            sums[k][l] = acc;
          }
        }
        __syncthreads();
      }
      if (off >= 0 && p < BATCH) {
        const int l = p;
        float* o = grads + off + half * BATCH + l;
        if (l < nb) {
          const float mx = sums[4][l], my = sums[5][l];
          o[0 * gstride] = 2.f * sf[2][l] * mx + sf[3][l] * my;
          o[1 * gstride] = 2.f * sf[4][l] * my + sf[3][l] * mx;
          o[2 * gstride] = sums[6][l];
          o[3 * gstride] = sums[7][l];
          o[4 * gstride] = sums[8][l];
          o[5 * gstride] = sums[3][l] / fmaxf(sf[5][l], 1e-12f);
          o[6 * gstride] = sums[0][l];
          o[7 * gstride] = sums[1][l];
          o[8 * gstride] = sums[2][l];
          o[9 * gstride] = sf[9][l];
        } else {  // a tail lane: zero rows (the buffer is zero) and the cap tag
          o[9 * gstride] = cap;
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// fields: (16, stride) f32 staged sorted fields (rows 0-9 read);
// tile_ids/starts/ends/nchunks/grad_base: (num_tiles,) i32; totals: K3's
// (num_tiles, 8, 512) f32 blocks; gout: their cotangent, same shape; grads:
// (16, gstride) f32, zero-initialized by the caller. Launches on `stream`;
// returns cudaGetLastError() (0 when the launch was accepted).
int c3dgs_tiles_bwd(const float* fields, long long stride, const int* tile_ids,
                    const int* starts, const int* ends, const int* nchunks,
                    const int* grad_base, const float* totals, const float* gout,
                    int tiles_x, float* grads, long long gstride, int num_tiles,
                    void* stream) {
  if (num_tiles > 0) {
    tiles_bwd_kernel<<<num_tiles, PIX, 0, static_cast<cudaStream_t>(stream)>>>(
        fields, stride, tile_ids, starts, ends, nchunks, grad_base, totals, gout,
        tiles_x, grads, gstride, num_tiles);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* c3dgs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
