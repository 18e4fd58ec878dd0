// K4: per-tile backward of the alpha compositing, written for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel c3dgs_tpu/render/tiles.py:320
// (backward_kernel, launched by pallas_call at
// c3dgs_tpu/render/rasterizer.py:451). Same information in, the same
// per-instance gradient rows out: the staged fields of
// rasterizer._build_fields, the binning's tile_ids / starts / ends /
// nchunks / grad_base, K3's (T, 8, PIX) blocks (row 3 exp(lt_final), row 4
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
// and per lane the sums over the tile's PIX pixels: dL/drgb = sum dL/dC*w,
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
// Bound on the card: one exp per walked (pixel, lane) pair the skip below
// keeps, and a log1p, an exp and a reciprocal per pair with alpha > 0, on
// the special-function units, or the fp32 arithmetic, whichever is longer;
// chip_smoke.py computes each run's bound from that run's own counts.
//
// Design for the card. The first version ran one thread per pixel (16 warps
// per tile), summed each lane's 9 values by 9 five-step shuffle trees in
// every warp with a live pixel (45 shuffles per (lane, 32-pixel row)), kept
// 16 partial rows per lane sum, staged 64-lane halves by plain loads behind
// 3 barriers each with no load in flight during the walk, and took every
// exp. Now, as K2 (tiles_packed_bwd.cu):
//   - 256 threads per tile, 2 pixels per thread (tiles_common.cuh: warp w
//     owns a 16x4 region, its pixel k the 8x4 block k of it). A thread
//     first adds its 2 pixels' 9 values in registers (pixel order).
//   - The warp's 9 sums by one butterfly reduce-scatter: 5 + 3 + 2 + 1
//     shuffles halve the values a lane holds at each step and a last one
//     joins lane pairs, 12 per (lane, warp) in place of 45, and only where
//     the warp's 64 pixels hold an alpha > 0. Value k ends on a fixed lane
//     (scatter_lane_value), and the 9 lanes holding values store them with
//     one store instruction; a (lane, warp) with no alpha > 0 stores zeros.
//   - After the window, one thread per lane adds the 8 warps' partials in
//     warp order and writes the lane's 10 rows, coalesced along the lanes.
//     The order is fixed everywhere: two runs give bitwise-equal rows, and
//     there are no atomics.
//   - Fields are read as float4s over 4 consecutive slots of a field row,
//     from a two-deep ring of windows filled by bulk async copies on
//     mbarriers: window w-1's 10 row copies are issued as window w starts.
//     A stage holds the 16-byte aligned span around its window (up to 132
//     floats); the walk skips the lanes outside the window.
//   - A pair whose power is below -5.55 with opacity <= 1 has alpha 0 in
//     every version; its exp is skipped, as its own branch (as in K1-K3).
//   - Residency chosen by measurement (chip_smoke.py's K4 time, PERF.md):
//     4 CTAs of 8 warps per SM (at most 64 registers; ptxas spills a few
//     bytes) ran faster than 3 (80 registers) or 2; 47.7 KB of static
//     shared memory each (the ring and the partials), below the 48 KB that
//     would need a dynamic allocation, and 4 x 47.7 KB fit the SM's 228 KB.
//
// Other tile shapes (C3DGS_TILE_X/Y): as K2's (tiles_packed_bwd.cu), with
// MIN_CTAS keeping 32 warps per SM (8 CTAs at 16x16, 7 of whose 29.1 KB
// fit an SM; 2 at 32x32, 85 KB each with the partials in dynamic shared
// memory). Below 128 threads a tile (16x8: 64) a thread writes two or more
// of a window's 128 lanes; the grad layout grad_base[t] + w*128 does not
// depend on PIX.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tiles_common.cuh"

namespace {

using namespace c3dgs;

constexpr int STAGED = 10;  // x, y, a', b', c', opacity, r, g, b, pre-sort slot
constexpr int PRESORT_ROW = 9;  // fields row holding the pre-sort slot
constexpr int MIN_CTAS = min_ctas(32);  // 4 CTAs of 8 warps at 32x16
constexpr int DYNAMIC_BYTES = partial_dynamic_bytes(2 * STAGED * STAGE_W * 4);

__global__ void __launch_bounds__(THREADS, MIN_CTAS)
tiles_bwd_kernel(const float* __restrict__ fields, long long stride,
                 const int* __restrict__ tile_ids,
                 const int* __restrict__ starts,
                 const int* __restrict__ ends,
                 const int* __restrict__ nchunks,
                 const int* __restrict__ grad_base,
                 const float* __restrict__ totals,
                 const float* __restrict__ gout, int tiles_x,
                 float* __restrict__ grads, long long gstride, int num_tiles) {
  __shared__ __align__(128) float sf[2][STAGED][STAGE_W];
  float(*part)[PART_LD] = partials<(DYNAMIC_BYTES > 0)>();  // row warp*9 + value
  __shared__ __align__(8) uint64_t bar[2];
  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
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
    if (off < 0) continue;
    for (int l = tid; l < CHUNK; l += THREADS) {  // once at THREADS >= 128
      grads[PRESORT_ROW * gstride + off + l] =
          w * CHUNK + l < count ? fields[PRESORT_ROW * stride + s + w * CHUNK + l] : cap;
    }
  }
  if (stop == 0) return;

  const int tile_id = tile_ids[t];
  Pixel q[PPT];
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int p = pixel_index(tid, k);
    float px, py;
    pixel_coords(tile_id, tiles_x, p, &px, &py);
    q[k] = Pixel{px, py, g[p], g[PIX + p], g[2 * PIX + p], g[3 * PIX + p] * blk[3 * PIX + p], blk[4 * PIX + p],
                 0.f};
  }
  const int my_value = (lane & 1) ? -1 : scatter_lane_value(lane >> 1);

  if (tid == 0) {
    mbar_init(&bar[0], 1);
    mbar_init(&bar[1], 1);
    mbar_fence_init();
  }
  __syncthreads();
  // the window [s + w*128, min(s + (w+1)*128, ends[t])) of the tile
  auto window_lo = [&](int w) { return s + w * CHUNK; };
  auto window_hi = [&](int w) { return s + min((w + 1) * CHUNK, count); };
  if (tid == 0) {
    stage_slots(sf[0], &bar[0], fields, stride, window_lo(stop - 1), window_hi(stop - 1), STAGED, PRESORT_ROW);
  }

  for (int i = 0, w = stop - 1; w >= 0; ++i, --w) {
    const int st = i & 1;
    const uint32_t parity = (i >> 1) & 1;
    __syncthreads();  // every thread is done with window w+1: its stage and partials
    if (tid == 0 && w > 0) {
      fence_proxy_async();
      stage_slots(sf[st ^ 1], &bar[st ^ 1], fields, stride, window_lo(w - 1), window_hi(w - 1), STAGED,
                  PRESORT_ROW);
    }
    mbar_wait(&bar[st], parity);

    const int base = window_lo(w), end = window_hi(w);
    const int a0 = base & ~3;
    for (int gi = (end - 1 - a0) >> 2; gi >= 0; --gi) {
      const SlotGroup<STAGE_W> sg(&sf[st][0][0], gi);
#pragma unroll
      for (int j = 3; j >= 0; --j) {
        const int slot = a0 + 4 * gi + j;
        if (slot < base || slot >= end) continue;  // uniform: outside the window
        float v[NSUM];
#pragma unroll
        for (int m = 0; m < NSUM; ++m) v[m] = 0.f;
        bool any = false;
#pragma unroll
        for (int k = 0; k < PPT; ++k) {
          const float dx = sg.x[j] - q[k].px, dy = sg.y[j] - q[k].py;
          const float power = slot_power(sg, j, dx, dy);
          if (alpha_is_zero(sg, j, power)) continue;
          const float raw = sg.op[j] * expf(power);
          const float alpha = alpha_of(raw);
          if (alpha > 0.f) {
            any = true;
            walk_back(q[k], sg, j, alpha, raw, dx, dy, v);
          }
        }
        const float r = __any_sync(FULL, any) ? reduce_scatter9(v, lane) : 0.f;
        if (my_value >= 0) part[warp * NSUM + my_value][slot - base] = r;
      }
    }
    __syncthreads();
    // one thread per lane of the window: the warps' partials in warp
    // order, then the lane's rows
    const long long off = offset(w);
    for (int l = tid; off >= 0 && l < CHUNK; l += THREADS) {  // once at THREADS >= 128
      float* o = grads + off + l;
      if (base + l < end) {
        float sum[NSUM];
#pragma unroll
        for (int m = 0; m < NSUM; ++m) {
          float acc = part[m][l];
#pragma unroll
          for (int wi = 1; wi < WARPS; ++wi) acc += part[wi * NSUM + m][l];
          sum[m] = acc;
        }
        const float* f = &sf[st][0][base + l - a0];
        const float fa = f[2 * STAGE_W], fb = f[3 * STAGE_W], fc = f[4 * STAGE_W];
        const float mx = sum[4], my = sum[5];
        o[0 * gstride] = 2.f * fa * mx + fb * my;
        o[1 * gstride] = 2.f * fc * my + fb * mx;
        o[2 * gstride] = sum[6];
        o[3 * gstride] = sum[7];
        o[4 * gstride] = sum[8];
        o[5 * gstride] = sum[3] / fmaxf(f[5 * STAGE_W], 1e-12f);
        o[6 * gstride] = sum[0];
        o[7 * gstride] = sum[1];
        o[8 * gstride] = sum[2];
        o[9 * gstride] = f[PRESORT_ROW * STAGE_W];
      } else {  // a tail lane: zero rows (the buffer is zero) and the cap tag
        o[9 * gstride] = cap;
      }
    }
  }
}

}  // namespace

extern "C" {

// fields: (16, stride) f32 staged sorted fields (rows 0-9 read), 16-byte
// aligned with stride a multiple of 128; tile_ids/starts/ends/nchunks/
// grad_base: (num_tiles,) i32; totals: K3's (num_tiles, 8, PIX) f32 blocks;
// gout: their cotangent, same shape; grads: (16, gstride) f32,
// zero-initialized by the caller. Launches on `stream`; returns
// cudaGetLastError() (0 when the launch was accepted).
int c3dgs_tiles_bwd(const float* fields, long long stride, const int* tile_ids,
                    const int* starts, const int* ends, const int* nchunks,
                    const int* grad_base, const float* totals, const float* gout,
                    int tiles_x, float* grads, long long gstride, int num_tiles,
                    void* stream) {
  if (DYNAMIC_BYTES > 0) {
    const cudaError_t err =
        cudaFuncSetAttribute(tiles_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, DYNAMIC_BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (num_tiles > 0) {
    tiles_bwd_kernel<<<num_tiles, THREADS, DYNAMIC_BYTES, static_cast<cudaStream_t>(stream)>>>(
        fields, stride, tile_ids, starts, ends, nchunks, grad_base, totals, gout,
        tiles_x, grads, gstride, num_tiles);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* c3dgs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
