// K3: per-tile forward alpha compositing, written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel c3dgs_tpu/render/tiles.py:212
// (forward_kernel, launched by pallas_call at
// c3dgs_tpu/render/rasterizer.py:401). Same contract: the staged fields of
// rasterizer._build_fields (global means) and the binning's per-tile
// tile_ids / starts / ends / nchunks in, the same (T, 8, 512) f32 blocks
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
// blended (the backward skips the same set).
//
// Design. One CTA per 32x16 tile (4,080 at 1080p), one thread per pixel,
// as K1 (tiles_packed_fwd.cu). The TPU kernel double-buffers two aligned
// 128-slot chunks per window and rolls them into place; here the CTA reads
// its window's 9 field rows (x, y, a', b', c', opacity, r, g, b; 4.6 KB)
// straight into shared memory at the window's unaligned offset, and every
// thread walks the window front to back. A lane with alpha == 0 changes
// nothing and is skipped after its first exp. The exit test is one
// __syncthreads_or per window; !(lt < x) keeps a NaN pixel live, as the
// TPU's max-reduction does.
//
// Bound on the card: one exp per walked (pixel, real lane) pair, and a
// log1p and an exp more per pair with alpha > 0, on the special-function
// units (16 a clock on each of 132 SMs); the staged fields of the walked
// windows and the blocks written are far fewer bytes. chip_smoke.py
// computes each run's bound from that run's own counts. This first version
// keeps the accurate expf/log1pf and makes no attempt at load balance
// across heavy tiles.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tiles_common.cuh"

namespace {

using namespace c3dgs;

constexpr int USED = 9;  // x, y, a', b', c', opacity, r, g, b

__global__ void __launch_bounds__(PIX)
tiles_fwd_kernel(const float* __restrict__ fields, long long stride,
                 const int* __restrict__ tile_ids,
                 const int* __restrict__ starts,
                 const int* __restrict__ ends,
                 const int* __restrict__ nchunks, int tiles_x,
                 float* __restrict__ out) {
  __shared__ float sf[USED][CHUNK];
  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int s = starts[t];
  const int count = ends[t] - s;
  const int nw = nchunks[t];
  float px, py;
  pixel_coords(tile_ids[t], tiles_x, p, &px, &py);

  float lt = 0.f, cr = 0.f, cg = 0.f, cb = 0.f;
  int stop = nw;
  for (int w = 0; w < nw; ++w) {
    const int base = s + w * CHUNK;
    const int nb = min(CHUNK, count - w * CHUNK);
    __syncthreads();  // every thread is done with the previous window
    for (int i = p; i < USED * CHUNK; i += PIX) {
      const int f = i / CHUNK, l = i % CHUNK;
      if (l < nb) sf[f][l] = fields[f * stride + base + l];
    }
    __syncthreads();
    float sx = 0.f;  // in-window exclusive sum of log1p(-alpha)
    for (int l = 0; l < nb; ++l) {
      float raw;
      const float alpha =
          alpha_of(sf[0][l] - px, sf[1][l] - py, sf[2][l], sf[3][l], sf[4][l], sf[5][l], &raw);
      if (alpha > 0.f) {
        const float t_in = expf(sx + lt);
        if (t_in * (1.f - alpha) >= STOP_T) {
          const float wgt = alpha * t_in;
          cr += wgt * sf[6][l];
          cg += wgt * sf[7][l];
          cb += wgt * sf[8][l];
        }
        sx += log1pf(-alpha);
      }
    }
    lt += sx;
    if (!__syncthreads_or(!(lt < LOG_EXIT_T))) {  // uniform across the block
      stop = w + 1;
      break;
    }
  }

  float* o = out + static_cast<long long>(t) * OUT_ROWS * PIX + p;
  o[0 * PIX] = cr;
  o[1 * PIX] = cg;
  o[2 * PIX] = cb;
  o[3 * PIX] = expf(lt);
  o[4 * PIX] = lt;
  o[5 * PIX] = static_cast<float>(stop);
  o[6 * PIX] = 0.f;
  o[7 * PIX] = 0.f;
}

}  // namespace

extern "C" {

// fields: (16, stride) f32 staged sorted fields (rows 0-8 read);
// tile_ids/starts/ends/nchunks: (num_tiles,) i32 (ends = sentinel slots);
// out: (num_tiles, 8, 512) f32. Launches on `stream`; returns
// cudaGetLastError() (0 when the launch was accepted).
int c3dgs_tiles_fwd(const float* fields, long long stride, const int* tile_ids,
                    const int* starts, const int* ends, const int* nchunks,
                    int tiles_x, float* out, int num_tiles, void* stream) {
  if (num_tiles > 0) {
    tiles_fwd_kernel<<<num_tiles, PIX, 0, static_cast<cudaStream_t>(stream)>>>(
        fields, stride, tile_ids, starts, ends, nchunks, tiles_x, out);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* c3dgs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
