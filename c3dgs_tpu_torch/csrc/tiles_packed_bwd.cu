// K2: packed backward of the alpha compositing, written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel c3dgs_tpu/render/tiles_packed.py:353
// (backward_kernel, launched by pallas_call at
// c3dgs_tpu/render/rasterizer.py:221). Same information in, the same
// per-slot gradient rows out: the staged fields of
// rasterizer._build_fields_packed, K1's (t_out, 8, PIX) blocks (row 3
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
// Tile range, as in K1: meta = [chunks_exec, tile_start, tile_end, cap] on
// the device; CTA i is global tile tile_start + i and reads block i of K1's
// blocks and of the cotangent (local numbering, as the TPU's
// t - tile_start); a CTA at or past tile_end (a padding tile) walks
// nothing and its rows stay zero.
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
// and per slot the sums over the tile's PIX pixels: dL/drgb = sum dL/dC*w,
// s0 = sum g_pow, mx, my = sum g_pow*dx, g_pow*dy, and the second moments;
// g_x = 2a'mx + b'my, g_y = 2c'my + b'mx. fp32 with accurate expf/log1pf
// and --fmad=false; the TPU's fast_grad mode is a bf16-MXU precision trade,
// and here fast_grad only drops the compensation of the reduction that
// follows. One CTA walks its tile whole, so the TPU walk's cross-chunk
// carries, slim block regrouping and chunk_map compaction are not needed.
//
// Bound on the card. chip_smoke.py's 1080p bench frame (300k splats; H100
// 80GB HBM3 at 700 W, max SM clock 1980 MHz) walks 3.35e8 (pixel, slot)
// pairs, 6.2e7 with alpha > 0: one exp per pair plus a log1p, an exp and a
// reciprocal per alpha > 0 pair, ~5.2e8 special-function operations,
// ~0.125 ms; ~0.13 GB, ~0.04 ms at 3.35 TB/s. chip_smoke.py computes each
// run's bound from that run's counts.
//
// Design for the card. The first version ran one thread per pixel (16 warps per
// tile) and summed each slot's 9 values by 9 five-step shuffle trees in
// every warp with a live lane: 45 shuffles per (slot, 32-pixel row), 2.1e8
// at the bench frame, ~0.8 ms of the SMs' shuffle rate in its 1.77 ms; each
// (slot, warp) also read 10 scalar fields from shared memory. Now:
//   - 256 threads per tile, 2 pixels per thread (tiles_common.cuh:
//     warp w owns a 16x4 region, its pixel k the 8x4 block k of it). A
//     thread first adds its 2 pixels' 9 values in registers (pixel order).
//   - The warp's 9 sums by one butterfly reduce-scatter: 5 + 3 + 2 + 1
//     shuffles halve the values a lane holds at each step and a last one
//     joins lane pairs, 12 per (slot, warp) in place of 45, and only where
//     the warp's 64 pixels hold an alpha > 0. Value k ends on a fixed lane
//     (scatter_lane_value), and the 9 lanes holding values store them with
//     one store instruction; a (slot, warp) with no alpha > 0 stores zeros.
//   - The 8 warps' partial sums are added per slot in warp order after the
//     batch, one thread per slot, which then writes the slot's 10 rows
//     (coalesced along the slots). The order is fixed everywhere: two runs
//     give bitwise-equal rows, and there are no atomics.
//   - Fields are read as float4s over 4 consecutive slots of a field row,
//     from a two-deep ring of batches (cut at the global 128-slot
//     boundaries) filled by bulk async copies on mbarriers: batch b+1's 10
//     row copies are issued when batch b starts.
//   - A slot whose power is below -5.55 with opacity <= 1 has alpha 0 in
//     every version; its exp is skipped (as in K1).
//   - The walk is bound by latency, not issue: each warp steps through its
//     slots one at a time, with the alpha > 0 work of each pixel behind its
//     own branch. So the CTA shape was chosen by measurement for residency
//     (chip_smoke.py times it; PERF.md): 3 CTAs per SM (at most 80
//     registers) of 8 warps; 47.4 KB of static shared memory each (the ring
//     and the partials), below the 48 KB that would need a dynamic
//     allocation. 4 pixels per thread held 16 warps per SM, 1 pixel per
//     thread needed 16 partial rows per slot; both were slower.
//
// Other tile shapes (C3DGS_TILE_X/Y; tiles_common.cuh): the numbers above
// are 32x16's (PIX 512, 256 threads, 8 warps). A tile of PIX pixels runs
// PIX/2 threads in PIX/64 warps; MIN_CTAS keeps 32x16's 24 warps per SM
// and so its 80-register budget (6 CTAs of 4 warps at 16x16, 12 of 2 at
// 16x8; one of 16 at 32x32, up to 128 registers). The partials take
// WARPS x 9 rows of 129 floats: 18.6 KB at 16x16 (28.8 KB a CTA with the
// ring), 9.3 KB at 16x8, and 74.3 KB at 32x32, past the 48 KB of static
// shared memory, so there they are the launch's dynamic shared memory
// (84.5 KB a CTA; partial_dynamic_bytes). The fold over the warps keeps
// its fixed warp order at every shape.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tiles_common.cuh"

namespace {

using namespace c3dgs;

constexpr int STAGED = 10;  // x, y, a', b', c', opacity, r, g, b, pre-sort slot
constexpr int OFFSET_ROW = 10;  // fields row holding the pre-sort slot
constexpr int MIN_CTAS = min_ctas(24);  // 3 CTAs of 8 warps at 32x16
constexpr int DYNAMIC_BYTES = partial_dynamic_bytes(2 * STAGED * CHUNK * 4);

__global__ void __launch_bounds__(THREADS, MIN_CTAS)
tiles_packed_bwd_kernel(const float* __restrict__ fields, long long stride,
                        const int* __restrict__ starts,
                        const int* __restrict__ ends,
                        const int* __restrict__ meta,
                        const float* __restrict__ totals,
                        const float* __restrict__ gout,
                        float* __restrict__ grads) {
  __shared__ __align__(128) float sf[2][STAGED][CHUNK];
  float(*part)[PART_LD] = partials<(DYNAMIC_BYTES > 0)>();  // row warp*9 + value
  __shared__ __align__(8) uint64_t bar[2];
  const int t = blockIdx.x;  // local block: global tile meta[1] + t
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  if (meta[1] + t >= meta[2]) return;  // a padding tile past the range
  const int e = ends[t];  // the tile's sentinel slot
  if (e >= meta[0] * CHUNK) return;  // never flushed: blocks unwritten
  const int s = starts[t];
  const float* blk = totals + static_cast<long long>(t) * OUT_ROWS * PIX;
  const float* g = gout + static_cast<long long>(t) * OUT_ROWS * PIX;
  const int frz = static_cast<int>(blk[5 * PIX]);  // uniform over the tile
  const int walk_end = min(e, frz);
  if (walk_end <= s) return;  // nothing walked: the rows stay zero

  Pixel q[PPT];
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int p = pixel_index(tid, k);
    q[k] = Pixel{static_cast<float>(p % TILE_X), static_cast<float>(p / TILE_X), g[p], g[PIX + p],
                 g[2 * PIX + p], g[3 * PIX + p] * blk[3 * PIX + p], blk[4 * PIX + p], 0.f};
  }
  const int my_value = (lane & 1) ? -1 : scatter_lane_value(lane >> 1);

  if (tid == 0) {
    mbar_init(&bar[0], 1);
    mbar_init(&bar[1], 1);
    mbar_fence_init();
  }
  __syncthreads();
  // batches: the tile's slots cut at the global 128-slot boundaries, walked
  // from the last (chunk c_hi) down to the first (chunk c_lo)
  const int c_lo = s / CHUNK, c_hi = (walk_end - 1) / CHUNK;
  if (tid == 0) {
    stage_slots(sf[0], &bar[0], fields, stride, max(s, c_hi * CHUNK), walk_end, STAGED, OFFSET_ROW);
  }

  for (int i = 0, c = c_hi; c >= c_lo; ++i, --c) {
    const int st = i & 1;
    const uint32_t parity = (i >> 1) & 1;
    const int lo = max(s, c * CHUNK), hi = min(walk_end, (c + 1) * CHUNK);
    __syncthreads();  // every thread is done with batch i-1: its stage and partials
    if (tid == 0 && c > c_lo) {
      fence_proxy_async();
      stage_slots(sf[st ^ 1], &bar[st ^ 1], fields, stride, max(s, (c - 1) * CHUNK), c * CHUNK, STAGED,
                  OFFSET_ROW);
    }
    mbar_wait(&bar[st], parity);

    const int a0 = lo & ~3;
    for (int gi = (hi - 1 - a0) >> 2; gi >= 0; --gi) {
      const SlotGroup<CHUNK> sg(&sf[st][0][0], gi);
#pragma unroll
      for (int j = 3; j >= 0; --j) {
        const int l = 4 * gi + j;  // index in the batch's stage
        const int slot = a0 + l;
        if (slot < lo || slot >= hi) continue;  // uniform: another tile's slot
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
        if (my_value >= 0) part[warp * NSUM + my_value][l] = r;
      }
    }
    __syncthreads();
    // one thread per slot of the batch: the warps' partials in warp order,
    // then the slot's rows
    for (int l = tid; l < CHUNK; l += THREADS) {
      const int slot = a0 + l;
      if (slot < lo || slot >= hi) continue;
      float sum[NSUM];
#pragma unroll
      for (int m = 0; m < NSUM; ++m) {
        float acc = part[m][l];
#pragma unroll
        for (int w = 1; w < WARPS; ++w) acc += part[w * NSUM + m][l];
        sum[m] = acc;
      }
      const float fa = sf[st][2][l], fb = sf[st][3][l], fc = sf[st][4][l];
      const float mx = sum[4], my = sum[5];
      float* o = grads + slot;
      o[0 * stride] = 2.f * fa * mx + fb * my;
      o[1 * stride] = 2.f * fc * my + fb * mx;
      o[2 * stride] = sum[6];
      o[3 * stride] = sum[7];
      o[4 * stride] = sum[8];
      o[5 * stride] = sum[3] / fmaxf(sf[st][5][l], 1e-12f);
      o[6 * stride] = sum[0];
      o[7 * stride] = sum[1];
      o[8 * stride] = sum[2];
      o[9 * stride] = sf[st][9][l];
    }
  }
}

}  // namespace

extern "C" {

// fields: (16, stride) f32 staged sorted fields (rows 0-8 and 10 read),
// 16-byte aligned with stride a multiple of 128; starts/ends: (num_tiles,)
// i32 slot ranges of the tiles tile_start, tile_start + 1, ... (ends =
// sentinel slots); meta: (4,) i32 on the device, [chunks_exec, tile_start,
// tile_end, cap]: CTA i is global tile tile_start + i, and CTAs at or past
// tile_end walk nothing; totals: K1's (num_tiles, 8, PIX) f32 blocks, in
// the same local numbering; gout: their cotangent, same shape; grads:
// (16, stride) f32, zero-initialized by the caller. Launches on `stream`;
// returns cudaGetLastError() (0 when the launch was accepted).
int c3dgs_tiles_packed_bwd(const float* fields, long long stride,
                           const int* starts, const int* ends,
                           const int* meta, const float* totals,
                           const float* gout, float* grads, int num_tiles,
                           void* stream) {
  if (DYNAMIC_BYTES > 0) {
    const cudaError_t err =
        cudaFuncSetAttribute(tiles_packed_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, DYNAMIC_BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (num_tiles > 0) {
    tiles_packed_bwd_kernel<<<num_tiles, THREADS, DYNAMIC_BYTES,
                              static_cast<cudaStream_t>(stream)>>>(
        fields, stride, starts, ends, meta, totals, gout, grads);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* c3dgs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
