// Shared by K3 (tiles_fwd.cu) and K4 (tiles_bwd.cu): the per-tile kernel
// family's constants and its per-(pixel, instance) alpha, the numerics of
// c3dgs_tpu/render/tiles.py:71-81 and :183-209. kernels.library_path
// hashes this header into each including library's name, so an edit here
// rebuilds both.
#pragma once

#include <cuda_runtime.h>

namespace c3dgs {

constexpr int TILE_X = 32;
constexpr int TILE_Y = 16;
constexpr int PIX = TILE_X * TILE_Y;  // one thread per pixel
constexpr int WARPS = PIX / 32;
constexpr int CHUNK = 128;  // instances per window
constexpr int OUT_ROWS = 8;
constexpr int PRESORT_ROW = 9;  // staged field row holding the pre-sort slot
constexpr float STOP_T = 1e-4f;
constexpr float MIN_ALPHA = 1.0f / 255.0f;
constexpr float MAX_ALPHA = 0.99f;
constexpr float LOG_EXIT_T = -13.815510557964274f;  // log(1e-6)
constexpr float LOG_STOP_T = -9.210340371976182f;  // log(1e-4)
constexpr unsigned FULL = 0xffffffffu;

// The pixel's global coordinates in the tile with global id `tile_id`.
__device__ __forceinline__ void pixel_coords(int tile_id, int tiles_x, int p, float* px, float* py) {
  *px = static_cast<float>((tile_id % tiles_x) * TILE_X + p % TILE_X);
  *py = static_cast<float>((tile_id / tiles_x) * TILE_Y + p / TILE_X);
}

// alpha = min(0.99, op * exp(min(power, 0))), 0 below 1/255, with the
// pre-scaled conic (power = a'dx^2 + b'dxdy + c'dy^2); `raw` is
// op * exp(power) before the cap (the backward blocks its gradient where
// raw > 0.99).
__device__ __forceinline__ float alpha_of(float dx, float dy, float a2, float b2, float c2, float op,
                                          float* raw) {
  const float power = fminf((a2 * dx + b2 * dy) * dx + (c2 * dy) * dy, 0.f);
  *raw = op * expf(power);
  return *raw >= MIN_ALPHA ? fminf(MAX_ALPHA, *raw) : 0.f;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(FULL, v, o);
  return v;
}

}  // namespace c3dgs
