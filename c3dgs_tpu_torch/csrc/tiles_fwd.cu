// K3: per-tile forward alpha compositing, written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel c3dgs_tpu/render/tiles.py:212
// (forward_kernel, launched by pallas_call at
// c3dgs_tpu/render/rasterizer.py:401). Same contract: the staged fields of
// rasterizer._build_fields (global means) and the binning's per-tile
// tile_ids / starts / ends / nchunks in, the same (T, 8, PIX) f32 blocks
// out:
//   rows 0-2  color without background
//   row  3    exp(lt_final)
//   row  4    lt_final (log transmittance; the backward's walk anchor)
//   row  5    stop: the first window the saturation exit skipped, or
//             nchunks[t] if none (as f32)
//   rows 6-7  zero
//
// Numerics (tiles.py:183-209, 272-298). Tile t walks its windows w =
// 0..nchunks[t]-1, each the up to 128 instances from starts[t] + w*128 (the
// lanes past ends[t] are masked, so they add nothing). Per pixel and lane:
//   power = min(a'dx^2 + b'dxdy + c'dy^2, 0)   (global pixel coordinates)
//   alpha = min(0.99, op*exp(power)), 0 below 1/255
//   T_in  = exp(s + lt), s the in-window exclusive sum of log1p(-alpha)
//   color += alpha*T_in*rgb while T_in*(1-alpha) >= 1e-4
// and after the window lt += s (every masked-in lane, live or not). As on
// the TPU, s runs from 0 in each window and lt is added to it, so the
// rounding of the entering transmittance follows the TPU kernel's form.
// After every window a block-wide test ends the walk once every pixel's lt
// is below log(1e-6): stop = w + 1, and windows at or past stop are not
// blended (the backward skips the same set). Each pixel's arithmetic is
// the first version's, in the same order (accurate expf/log1pf,
// --fmad=false); only pairs whose alpha is 0 skip their exp.
//
// Bound on the card: one exp per walked (pixel, lane) pair the skip below
// keeps, and a log1p and an exp more per pair with alpha > 0, on the
// special-function units (16 a clock on each of 132 SMs), or the fp32
// arithmetic of every pair, whichever is longer; the staged fields of the
// walked windows and the blocks written are far fewer bytes. chip_smoke.py
// computes each run's bound from that run's own counts.
//
// Design for the card (the first version ran one thread per pixel, staged
// each window by plain loads between two barriers with no load in flight
// during the walk, read 6 scalar fields from shared memory per (pixel,
// lane) and took every exp):
//   - 256 threads per tile, 2 pixels per thread (tiles_common.cuh: warp w
//     owns a 16x4 region, its pixel k the 8x4 block k of it). Each (warp,
//     k) slice of 32 pixels is compact, so the branches on alpha diverge
//     less than along a 32-pixel row.
//   - Fields are read as float4s over 4 consecutive slots of one field
//     row (SlotGroup): 9 16-byte shared loads serve 4 slots x 2 pixels.
//   - A two-deep ring of windows in shared memory, filled by bulk async
//     copies on mbarriers (bulk_copy.cuh): one thread issues window w+1's
//     9 row copies as window w starts, so the load overlaps w's walk. A
//     window starts at any slot, so a stage holds the 16-byte aligned span
//     around it (up to 132 floats) and the walk skips the lanes of the
//     first and last groups that lie outside it. The exit test after
//     window w-1 is the barrier that opens window w and frees the stage
//     window w+1 is copied into: one __syncthreads_or per window, as in the
//     first version. A tile that exits waits for its copy in flight first.
//   - A pair whose power is below -5.55 (exp(-5.55) < 1/255) and whose
//     opacity is at most 1 has alpha 0 in every version: its exp is
//     skipped, as its own branch (as a guarded assignment the compiler
//     predicated it, and the skip saved little in K1).
//   - Residency chosen by measurement (chip_smoke.py's K3 time, PERF.md):
//     4 CTAs of 8 warps per SM (at most 64 registers; ptxas spills a few
//     bytes) ran faster than 3 or 2; 9.5 KB of shared memory each.
//
// Other tile shapes (C3DGS_TILE_X/Y): as K1's (tiles_packed_fwd.cu):
// PIX/2 threads a tile, MIN_CTAS keeping 32 warps per SM.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tiles_common.cuh"

namespace {

using namespace c3dgs;

constexpr int USED = 9;  // x, y, a', b', c', opacity, r, g, b
constexpr int MIN_CTAS = min_ctas(32);  // 4 CTAs of 8 warps at 32x16

__global__ void __launch_bounds__(THREADS, MIN_CTAS)
tiles_fwd_kernel(const float* __restrict__ fields, long long stride,
                 const int* __restrict__ tile_ids,
                 const int* __restrict__ starts,
                 const int* __restrict__ ends,
                 const int* __restrict__ nchunks, int tiles_x,
                 float* __restrict__ out) {
  __shared__ __align__(128) float sf[2][USED][STAGE_W];
  __shared__ __align__(8) uint64_t bar[2];
  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int s = starts[t];
  const int count = ends[t] - s;
  const int nw = nchunks[t];
  const int tile_id = tile_ids[t];
  float px[PPT], py[PPT];
  float lt[PPT], cr[PPT], cg[PPT], cb[PPT];
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    pixel_coords(tile_id, tiles_x, pixel_index(tid, k), &px[k], &py[k]);
    lt[k] = cr[k] = cg[k] = cb[k] = 0.f;
  }

  if (tid == 0) {
    mbar_init(&bar[0], 1);
    mbar_init(&bar[1], 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0 && nw > 0) stage_slots(sf[0], &bar[0], fields, stride, s, s + min(CHUNK, count), USED, USED - 1);

  int stop = nw;
  for (int w = 0; w < nw; ++w) {
    const int st = w & 1;
    const uint32_t parity = (w >> 1) & 1;
    if (w > 0) {
      // the exit test after window w-1 (uniform across the block); !(lt <
      // x) keeps a NaN pixel live, as the TPU's max-reduction does. It also
      // proves every thread is done with window w-1's stage.
      bool live = false;
#pragma unroll
      for (int k = 0; k < PPT; ++k) live |= !(lt[k] < LOG_EXIT_T);
      if (!__syncthreads_or(live)) {
        stop = w;
        mbar_wait(&bar[st], parity);  // window w's copy is in flight
        break;
      }
    }
    if (tid == 0 && w + 1 < nw) {
      fence_proxy_async();
      stage_slots(sf[st ^ 1], &bar[st ^ 1], fields, stride, s + (w + 1) * CHUNK, s + min((w + 2) * CHUNK, count),
                  USED, USED - 1);
    }
    mbar_wait(&bar[st], parity);

    const int base = s + w * CHUNK;
    const int end = s + min((w + 1) * CHUNK, count);
    const int a0 = base & ~3;
    float sx[PPT];  // in-window exclusive sums of log1p(-alpha)
#pragma unroll
    for (int k = 0; k < PPT; ++k) sx[k] = 0.f;
    for (int g = 0; 4 * g < end - a0; ++g) {
      const SlotGroup<STAGE_W> sg(&sf[st][0][0], g);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int slot = a0 + 4 * g + j;
        if (slot < base || slot >= end) continue;  // uniform: outside the window
#pragma unroll
        for (int k = 0; k < PPT; ++k) {
          const float power = slot_power(sg, j, sg.x[j] - px[k], sg.y[j] - py[k]);
          if (alpha_is_zero(sg, j, power)) continue;
          const float alpha = alpha_of(sg.op[j] * expf(power));
          if (alpha > 0.f) {
            const float t_in = expf(sx[k] + lt[k]);
            if (t_in * (1.f - alpha) >= STOP_T) {
              const float wgt = alpha * t_in;
              cr[k] += wgt * sg.r[j];
              cg[k] += wgt * sg.g[j];
              cb[k] += wgt * sg.bl[j];
            }
            sx[k] += log1pf(-alpha);
          }
        }
      }
    }
#pragma unroll
    for (int k = 0; k < PPT; ++k) lt[k] += sx[k];
  }

  float* o = out + static_cast<long long>(t) * OUT_ROWS * PIX;
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    float* q = o + pixel_index(tid, k);
    q[0 * PIX] = cr[k];
    q[1 * PIX] = cg[k];
    q[2 * PIX] = cb[k];
    q[3 * PIX] = expf(lt[k]);
    q[4 * PIX] = lt[k];
    q[5 * PIX] = static_cast<float>(stop);
    q[6 * PIX] = 0.f;
    q[7 * PIX] = 0.f;
  }
}

}  // namespace

extern "C" {

// fields: (16, stride) f32 staged sorted fields (rows 0-8 read), 16-byte
// aligned with stride a multiple of 128; tile_ids/starts/ends/nchunks:
// (num_tiles,) i32 (ends = sentinel slots); out: (num_tiles, 8, PIX) f32.
// Launches on `stream`; returns cudaGetLastError() (0 when the launch was
// accepted).
int c3dgs_tiles_fwd(const float* fields, long long stride, const int* tile_ids,
                    const int* starts, const int* ends, const int* nchunks,
                    int tiles_x, float* out, int num_tiles, void* stream) {
  if (num_tiles > 0) {
    tiles_fwd_kernel<<<num_tiles, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        fields, stride, tile_ids, starts, ends, nchunks, tiles_x, out);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* c3dgs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
