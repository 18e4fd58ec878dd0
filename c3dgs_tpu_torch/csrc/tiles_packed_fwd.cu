// K1: packed forward alpha compositing, written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel c3dgs_tpu/render/tiles_packed.py:149
// (forward_kernel, launched by pallas_call at
// c3dgs_tpu/render/rasterizer.py:121). Same contract: the same staged
// fields in, the same (t_out, 8, PIX) f32 tile blocks out, block i for
// global tile meta[1] + i:
//   rows 0-2  color without background
//   row  3    exp(lt_final)
//   row  4    lt_final (log transmittance; the backward's walk anchor)
//   row  5    freeze start slot, or meta[3] (the slot-domain cap) if the
//             tile never froze
//   rows 6-7  zero
// Tiles whose sentinel lies at or past meta[0]*128 (the execution clamp)
// are left unwritten; assemble_image's `complete` mask replaces them.
//
// Tile range. meta = [chunks_exec, tile_start, tile_end, cap], read on the
// device. A single-device render passes [0, T) with T blocks. Under tile
// sharding (c3dgs_tpu_torch/parallel/sharded.py) the fields are one
// device's routed array, which holds only its owned tiles, and starts/ends
// hold those tiles' ranges in it: block i is global tile tile_start + i,
// and a block at or past tile_end (the last device's padding tiles when
// the device count does not divide T) writes nothing and walks nothing.
// Lanes of tiles outside the range never lie inside an owned tile's
// [starts[i], ends[i]), so they stay dead as on the TPU
// (tiles_packed.py:231), and the freeze is still decided at this array's
// own 128-slot boundaries.
//
// Numerics. The TPU kernel walks the global sorted instance array one
// aligned 128-slot chunk per grid step; here one CTA owns one 32x16 tile
// (4,080 CTAs at 1080p) and walks its slot range [starts[t], ends[t]) front
// to back in batches cut at the GLOBAL 128-slot boundaries, where the TPU
// decides the freeze: at an aligned boundary b inside the range whose chunk
// holds no sentinel of this tile (the TPU's ng == 0), a block-wide test
// freezes the tile when every pixel's lt is below log(1e-6) (a NaN stays
// live); b is then the freeze slot. Per pixel and slot
// (tiles_packed.py:129-146, 236-242):
//   power = min(a'dx^2 + b'dxdy + c'dy^2, 0)   (tile-local means)
//   alpha = min(0.99, op*exp(power)), 0 below 1/255
//   T_in  = exp(lt); contribution alpha*T_in*rgb while T_in*(1-alpha) >= 1e-4
//   lt   += log1p(-alpha)
// lt keeps advancing past the stop test (rows 3-4 export it); there is no
// per-pixel early exit. Each pixel's arithmetic is the one of the first version
// (accurate expf/log1pf, --fmad=false), so its rows are bitwise those.
//
// Bound on the card. chip_smoke.py's 1080p bench frame (300k splats;
// H100 80GB HBM3 at 700 W, max SM clock 1980 MHz) walks 653,388 slots:
// 3.35e8 (pixel, slot) pairs, each an exp, and 6.2e7 with alpha > 0 add a
// log1p and an exp: 4.6e8 special-function ops on 132 SMs x 16 a clock,
// 0.110 ms; 90 MB of fields and blocks, 0.027 ms. chip_smoke.py computes
// each run's bound from that run's counts.
//
// Design for the card (the first version ran one thread per pixel and read 9
// scalar fields from shared memory per (pixel, slot), 0.74 ms):
//   - 256 threads per tile, 2 pixels per thread (tiles_common.cuh:
//     warp w owns a 16x4 region, its pixel k the 8x4 block k of it). Each
//     (warp, k) slice of 32 pixels is compact, so the branches on alpha
//     diverge less than along a 32-pixel row.
//   - Fields are read as float4s over 4 consecutive slots of one field
//     row: 9 16-byte shared loads serve 4 slots x 2 pixels, where the
//     first version issued 9 scalar loads per pair.
//   - A two-deep ring of slot batches in shared memory, filled by bulk
//     async copies on mbarriers (bulk_copy.cuh; the copy of P1): one thread
//     issues batch b+1's 9 row copies when batch b starts, so the load
//     overlaps batch b's compute. The freeze test doubles as the barrier
//     that frees the older stage.
//   - A slot whose power is below -5.55 (exp(-5.55) < 1/255) and whose
//     opacity is at most 1 has alpha 0 in every version: its exp is
//     skipped. Nothing else changes for such a slot.
//   - Residency, chosen by measurement as K2's: 4 CTAs of 8 warps per SM
//     (at most 64 registers), 9.2 KB of shared memory each.
//
// Other tile shapes (C3DGS_TILE_X/Y; tiles_common.cuh): the numbers above
// are 32x16's (PIX 512, 256 threads, 8 warps). A tile of PIX pixels runs
// PIX/2 threads in PIX/64 warps, and MIN_CTAS keeps 32x16's 32 warps per
// SM and so its 64-register budget: 8 CTAs of 4 warps at 16x16, 16 of 2
// at 16x8, 2 of 16 at 32x32. The shared memory does not depend on PIX.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tiles_common.cuh"

namespace {

using namespace c3dgs;

constexpr int USED = 9;  // x, y, a', b', c', opacity, r, g, b
constexpr int MIN_CTAS = min_ctas(32);  // 4 CTAs of 8 warps at 32x16

__global__ void __launch_bounds__(THREADS, MIN_CTAS)
tiles_packed_fwd_kernel(const float* __restrict__ fields, long long stride,
                        const int* __restrict__ starts,
                        const int* __restrict__ ends,
                        const int* __restrict__ meta,
                        float* __restrict__ out) {
  __shared__ __align__(128) float sf[2][USED][CHUNK];
  __shared__ __align__(8) uint64_t bar[2];
  const int t = blockIdx.x;  // local block: global tile meta[1] + t
  const int tid = threadIdx.x;
  if (meta[1] + t >= meta[2]) return;  // a padding tile past the range
  const int e = ends[t];  // the tile's sentinel slot
  if (e >= meta[0] * CHUNK) return;  // never flushed on a clamped frame
  const int s = starts[t];
  float px[PPT], py[PPT];
  float lt[PPT], cr[PPT], cg[PPT], cb[PPT];
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int p = pixel_index(tid, k);
    px[k] = static_cast<float>(p % TILE_X);
    py[k] = static_cast<float>(p / TILE_X);
    lt[k] = cr[k] = cg[k] = cb[k] = 0.f;
  }
  float frz = static_cast<float>(meta[3]);

  if (tid == 0) {
    mbar_init(&bar[0], 1);
    mbar_init(&bar[1], 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0 && s < e) {
    stage_slots(sf[0], &bar[0], fields, stride, s, min(e, (s / CHUNK + 1) * CHUNK), USED, USED - 1);
  }

  int pos = s;
  for (int i = 0; pos < e; ++i) {
    const int st = i & 1;
    const uint32_t parity = (i >> 1) & 1;
    const int batch_end = min(e, (pos / CHUNK + 1) * CHUNK);
    if ((pos % CHUNK) == 0 && pos + CHUNK <= e) {
      // freeze test (uniform across the block); !(lt < x) keeps a NaN
      // pixel live, as the TPU's max-reduction does
      bool live = false;
#pragma unroll
      for (int k = 0; k < PPT; ++k) live |= !(lt[k] < LOG_EXIT_T);
      if (!__syncthreads_or(live)) {
        frz = static_cast<float>(pos);
        mbar_wait(&bar[st], parity);  // this batch's copy is in flight
        break;
      }
    } else {
      __syncthreads();
    }
    // every thread is done with batch i-1: its stage takes batch i+1
    if (tid == 0 && batch_end < e) {
      fence_proxy_async();
      stage_slots(sf[st ^ 1], &bar[st ^ 1], fields, stride, batch_end, min(e, batch_end + CHUNK), USED,
                  USED - 1);
    }
    mbar_wait(&bar[st], parity);

    const int a0 = pos & ~3;
    for (int g = 0; 4 * g < batch_end - a0; ++g) {
      const SlotGroup<CHUNK> sg(&sf[st][0][0], g);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int slot = a0 + 4 * g + j;
        if (slot < pos || slot >= batch_end) continue;  // uniform: another tile's slot
#pragma unroll
        for (int k = 0; k < PPT; ++k) {
          const float power = slot_power(sg, j, sg.x[j] - px[k], sg.y[j] - py[k]);
          if (alpha_is_zero(sg, j, power)) continue;
          const float alpha = alpha_of(sg.op[j] * expf(power));
          if (alpha > 0.f) {
            const float t_in = expf(lt[k]);
            if (t_in * (1.f - alpha) >= STOP_T) {
              const float w = alpha * t_in;
              cr[k] += w * sg.r[j];
              cg[k] += w * sg.g[j];
              cb[k] += w * sg.bl[j];
            }
            lt[k] += log1pf(-alpha);
          }
        }
      }
    }
    pos = batch_end;
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
    q[5 * PIX] = frz;
    q[6 * PIX] = 0.f;
    q[7 * PIX] = 0.f;
  }
}

}  // namespace

extern "C" {

// fields: (16, stride) f32 staged sorted fields (rows 0-8 read), 16-byte
// aligned with stride a multiple of 128; starts/ends: (num_tiles,) i32 slot
// ranges of the tiles tile_start, tile_start + 1, ... (ends = sentinel
// slots); meta: (4,) i32 on the device, [chunks_exec, tile_start,
// tile_end, cap]: block i is global tile tile_start + i, and blocks at or
// past tile_end are left unwritten; out: (num_tiles, 8, PIX) f32.
// Launches on `stream`; returns cudaGetLastError() (0 when the launch was
// accepted).
int c3dgs_tiles_packed_fwd(const float* fields, long long stride,
                           const int* starts, const int* ends,
                           const int* meta, float* out, int num_tiles,
                           void* stream) {
  if (num_tiles > 0) {
    tiles_packed_fwd_kernel<<<num_tiles, THREADS, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        fields, stride, starts, ends, meta, out);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* c3dgs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
