// K1: packed forward alpha compositing, written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel c3dgs_tpu/render/tiles_packed.py:149
// (forward_kernel, launched by pallas_call at
// c3dgs_tpu/render/rasterizer.py:121). Same contract: the same staged
// fields in, the same (T, 8, 512) f32 tile blocks out:
//   rows 0-2  color without background
//   row  3    exp(lt_final)
//   row  4    lt_final (log transmittance; the backward's walk anchor)
//   row  5    freeze start slot, or meta[3] (the slot-domain cap) if the
//             tile never froze
//   rows 6-7  zero
// Tiles whose sentinel lies at or past meta[0]*128 (the execution clamp)
// are left unwritten; assemble_image's `complete` mask replaces them.
//
// Design. The TPU kernel walks the global sorted instance array one
// aligned 128-slot chunk per grid step on one core, with in-chunk prefixes
// as masked triangular MXU matmuls and a carry for the tile left open at
// the chunk's end. Here one CTA owns one 32x16 tile (4,080 CTAs at 1080p),
// one thread per pixel. A CTA reads its tile's slot range [starts[t],
// ends[t]) and walks it front to back in batches staged into shared
// memory: x, y, a', b', c', opacity, r, g, b for up to 128 slots (4.6 KB).
// Batches are cut at the GLOBAL 128-slot boundaries, where the TPU kernel
// decides the freeze: at an aligned boundary b inside the range whose chunk
// holds no sentinel of this tile (the TPU's ng == 0), a block-wide test
// freezes the tile when every pixel's lt is below log(1e-6); b is then the
// freeze slot. Per pixel and slot (tiles_packed.py:129-146, 236-242):
//   power = min(a'dx^2 + b'dxdy + c'dy^2, 0)   (tile-local means)
//   alpha = min(0.99, op*exp(power)), 0 below 1/255
//   T_in  = exp(lt); contribution alpha*T_in*rgb while T_in*(1-alpha) >= 1e-4
//   lt   += log1p(-alpha)
// lt keeps advancing past the stop test (rows 3-4 export it); there is no
// per-pixel early exit. A slot with alpha == 0 changes nothing and is
// skipped after its first exp.
//
// Bound on the card. chip_smoke.py's 1080p bench frame (300k splats, 4,080
// tiles; H100 80GB HBM3 at 700 W, max SM clock 1980 MHz) walks 653,388
// slots: 23.5 MB of staged fields read and 66.8 MB of blocks written, 90 MB
// in all, 0.027 ms at 3.35 TB/s. It evaluates 3.35e8 (pixel, slot) pairs,
// each an exp, and 6.2e7 of them with alpha > 0 add a log1p and an exp:
// 4.6e8 special-function ops on 132 SMs x 16 a clock, 0.110 ms. So the
// kernel is bound by special-function operations, not bytes; chip_smoke.py
// computes each run's bound from that run's own counts. This first version
// keeps the accurate expf/log1pf (the plain version's rounding) and makes
// no attempt at load balance across heavy tiles.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE_X = 32;
constexpr int PIX = 512;  // 32 x 16 pixels, one thread each
constexpr int CHUNK = 128;
constexpr int OUT_ROWS = 8;
constexpr int USED = 9;  // x, y, a', b', c', opacity, r, g, b
constexpr float STOP_T = 1e-4f;
constexpr float MIN_ALPHA = 1.0f / 255.0f;
constexpr float MAX_ALPHA = 0.99f;
constexpr float LOG_EXIT_T = -13.815510557964274f;  // log(1e-6)

__global__ void __launch_bounds__(PIX)
tiles_packed_fwd_kernel(const float* __restrict__ fields, long long stride,
                        const int* __restrict__ starts,
                        const int* __restrict__ ends,
                        const int* __restrict__ meta,
                        float* __restrict__ out) {
  __shared__ float sf[USED][CHUNK];
  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int e = ends[t];  // the tile's sentinel slot
  if (e >= meta[0] * CHUNK) return;  // never flushed on a clamped frame
  const int s = starts[t];
  const float px = static_cast<float>(p % TILE_X);
  const float py = static_cast<float>(p / TILE_X);

  float lt = 0.f, cr = 0.f, cg = 0.f, cb = 0.f;
  float frz = static_cast<float>(meta[3]);
  int pos = s;
  while (pos < e) {
    if ((pos % CHUNK) == 0 && pos + CHUNK <= e) {
      // freeze test (uniform across the block). !(lt < x) keeps a NaN
      // pixel live, as the TPU's max-reduction does.
      if (!__syncthreads_or(!(lt < LOG_EXIT_T))) {
        frz = static_cast<float>(pos);
        break;
      }
    }
    const int batch_end = min(e, (pos / CHUNK + 1) * CHUNK);
    const int nb = batch_end - pos;
    __syncthreads();  // every thread is done with the previous batch
    for (int i = p; i < USED * CHUNK; i += PIX) {
      const int f = i / CHUNK, l = i % CHUNK;
      if (l < nb) sf[f][l] = fields[f * stride + pos + l];
    }
    __syncthreads();
    for (int l = 0; l < nb; ++l) {
      const float dx = sf[0][l] - px;
      const float dy = sf[1][l] - py;
      const float power =
          fminf((sf[2][l] * dx + sf[3][l] * dy) * dx + (sf[4][l] * dy) * dy, 0.f);
      const float raw = sf[5][l] * expf(power);
      const float alpha = raw >= MIN_ALPHA ? fminf(MAX_ALPHA, raw) : 0.f;
      if (alpha > 0.f) {
        const float t_in = expf(lt);
        if (t_in * (1.f - alpha) >= STOP_T) {
          const float w = alpha * t_in;
          cr += w * sf[6][l];
          cg += w * sf[7][l];
          cb += w * sf[8][l];
        }
        lt += log1pf(-alpha);
      }
    }
    pos = batch_end;
  }

  float* o = out + static_cast<long long>(t) * OUT_ROWS * PIX + p;
  o[0 * PIX] = cr;
  o[1 * PIX] = cg;
  o[2 * PIX] = cb;
  o[3 * PIX] = expf(lt);
  o[4 * PIX] = lt;
  o[5 * PIX] = frz;
  o[6 * PIX] = 0.f;
  o[7 * PIX] = 0.f;
}

}  // namespace

extern "C" {

// fields: (16, stride) f32 staged sorted fields (rows 0-8 read);
// starts/ends: (num_tiles,) i32 tile slot ranges (ends = sentinel slots);
// meta: (4,) i32 on the device, [chunks_exec, tile_start, tile_end, cap];
// out: (num_tiles, 8, 512) f32. Launches on `stream`; returns
// cudaGetLastError() (0 when the launch was accepted).
int c3dgs_tiles_packed_fwd(const float* fields, long long stride,
                           const int* starts, const int* ends,
                           const int* meta, float* out, int num_tiles,
                           void* stream) {
  if (num_tiles > 0) {
    tiles_packed_fwd_kernel<<<num_tiles, PIX, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        fields, stride, starts, ends, meta, out);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* c3dgs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
