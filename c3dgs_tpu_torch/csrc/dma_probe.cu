// P1-P3: the DMA probes of tools/dma_probe.py, written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of tools/dma_probe.py: probe1 (:22,
// pallas_call at :38), probe2 (:53, :65) and probe3 (:80, :106). Each TPU
// probe starts a pltpu.make_async_copy from HBM into VMEM scratch and waits
// on its DMA semaphore, to learn which copy shapes Mosaic accepts and what
// an in-kernel transpose costs. On the card the same copy is Hopper's bulk
// async copy into shared memory (cp.async.bulk, no tensor map) completed on
// an mbarrier that one thread arms with the byte count (bulk_copy.cuh):
//   P1  x (cap, 16) f32, one CTA per 128-row chunk: one 8 KB copy of the
//       contiguous chunk; out = 2 x.
//   P2  x (T, 8, 512) f32, one CTA per tile: one 16 KB copy of the block;
//       out = x + 1.
//   P3  x (16, nc*128) f32, one CTA per 128-column chunk: 16 copies of the
//       512-byte strided rows on one mbarrier; the chunk's sum over its 128
//       lanes of row0 + row5*row3, read straight from the (16, 128) rows or
//       after a shared-memory transpose to (128, 16) that crosses threads.
//       Each CTA writes its sum to sums[c]. On the TPU every grid step
//       writes the same (1, 128) block, so the result is the last step's:
//       here the last chunk's CTA alone broadcasts its sum into out (the
//       last-writer rule of K4's clamped chunk).
// The block sum runs in a fixed order (warp shuffle tree, then the 4 warps
// in order): deterministic and free of atomics.
//
// Bound on the card: bytes. P1 moves 131,072 B and P2 524,288 B (each input
// read once, each output written once), 0.04 and 0.16 us at 3.35 TB/s:
// both are bound by launch latency in practice. P3 reads 33,554,432 B per
// variant, 0.0100 ms; its 4,096 CTAs of 8 KB each keep up to 16 CTAs'
// copies in flight per SM.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bulk_copy.cuh"

namespace {

using c3dgs::bulk_copy_g2s;
using c3dgs::mbar_expect_tx;
using c3dgs::mbar_fence_init;
using c3dgs::mbar_init;
using c3dgs::mbar_wait;

constexpr int CHUNK = 128;
constexpr int P1_COLS = 16;
constexpr int P2_ROWS = 8;
constexpr int P2_PIX = 512;
constexpr int P3_ROWS = 16;
constexpr int THREADS = 128;
constexpr unsigned FULL = 0xffffffffu;

// a one-shot barrier, initialized before any thread waits on it; thread 0
// arms it for `bytes` and then issues the copies
__device__ __forceinline__ void arm(uint64_t* bar, uint32_t bytes) {
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) mbar_expect_tx(bar, bytes);
}

__global__ void __launch_bounds__(THREADS) probe1_kernel(const float* __restrict__ x, float* __restrict__ out) {
  __shared__ __align__(128) float buf[CHUNK * P1_COLS];
  __shared__ __align__(8) uint64_t bar;
  const long long base = static_cast<long long>(blockIdx.x) * CHUNK * P1_COLS;
  arm(&bar, sizeof(buf));
  if (threadIdx.x == 0) bulk_copy_g2s(buf, x + base, sizeof(buf), &bar);
  mbar_wait(&bar, 0);
  const float4* b4 = reinterpret_cast<const float4*>(buf);
  float4* o4 = reinterpret_cast<float4*>(out + base);
  for (int i = threadIdx.x; i < CHUNK * P1_COLS / 4; i += THREADS) {
    float4 v = b4[i];
    v.x *= 2.f;
    v.y *= 2.f;
    v.z *= 2.f;
    v.w *= 2.f;
    o4[i] = v;
  }
}

__global__ void __launch_bounds__(THREADS) probe2_kernel(const float* __restrict__ x, float* __restrict__ out) {
  __shared__ __align__(128) float buf[P2_ROWS * P2_PIX];
  __shared__ __align__(8) uint64_t bar;
  const long long base = static_cast<long long>(blockIdx.x) * P2_ROWS * P2_PIX;
  arm(&bar, sizeof(buf));
  if (threadIdx.x == 0) bulk_copy_g2s(buf, x + base, sizeof(buf), &bar);
  mbar_wait(&bar, 0);
  const float4* b4 = reinterpret_cast<const float4*>(buf);
  float4* o4 = reinterpret_cast<float4*>(out + base);
  for (int i = threadIdx.x; i < P2_ROWS * P2_PIX / 4; i += THREADS) {
    float4 v = b4[i];
    v.x += 1.f;
    v.y += 1.f;
    v.z += 1.f;
    v.w += 1.f;
    o4[i] = v;
  }
}

template <bool kTranspose>
__global__ void __launch_bounds__(THREADS)
probe3_kernel(const float* __restrict__ x, long long stride, int nc, float* __restrict__ sums,
              float* __restrict__ out) {
  __shared__ __align__(128) float buf[P3_ROWS][CHUNK];
  __shared__ float ft[CHUNK][P3_ROWS + 1];  // the transposed chunk, padded
  __shared__ float wsum[THREADS / 32];
  __shared__ __align__(8) uint64_t bar;
  const int c = blockIdx.x;
  const int l = threadIdx.x;
  arm(&bar, sizeof(buf));
  if (l == 0) {
    for (int r = 0; r < P3_ROWS; ++r) {
      bulk_copy_g2s(buf[r], x + r * stride + static_cast<long long>(c) * CHUNK, CHUNK * 4, &bar);
    }
  }
  mbar_wait(&bar, 0);
  float acc;
  if (kTranspose) {
    // thread l moves 16 consecutive elements of row l/8 into column l/8 of
    // the (128, 16) array, so each lane below reads values that 3 other
    // threads wrote
    const int r = l / 8, k0 = (l % 8) * 16;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float4 v = *reinterpret_cast<const float4*>(&buf[r][k0 + 4 * q]);
      ft[k0 + 4 * q + 0][r] = v.x;
      ft[k0 + 4 * q + 1][r] = v.y;
      ft[k0 + 4 * q + 2][r] = v.z;
      ft[k0 + 4 * q + 3][r] = v.w;
    }
    __syncthreads();
    acc = ft[l][0] + ft[l][5] * ft[l][3];
  } else {
    acc = buf[0][l] + buf[5][l] * buf[3][l];
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_down_sync(FULL, acc, o);
  if ((l & 31) == 0) wsum[l >> 5] = acc;
  __syncthreads();
  const float total = ((wsum[0] + wsum[1]) + wsum[2]) + wsum[3];
  if (l == 0) sums[c] = total;
  if (c == nc - 1) out[l] = total;  // the TPU grid's last step writes last
}

}  // namespace

extern "C" {

// x: (chunks*128, 16) f32; out: the same shape. Returns cudaGetLastError().
int c3dgs_dma_probe1(const float* x, float* out, int chunks, void* stream) {
  if (chunks > 0) probe1_kernel<<<chunks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(x, out);
  return static_cast<int>(cudaGetLastError());
}

// x: (tiles, 8, 512) f32; out: the same shape.
int c3dgs_dma_probe2(const float* x, float* out, int tiles, void* stream) {
  if (tiles > 0) probe2_kernel<<<tiles, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(x, out);
  return static_cast<int>(cudaGetLastError());
}

// x: (16, stride) f32 with stride = nc*128; sums: (nc,) f32; out: (1, 128)
// f32. transpose != 0 runs the shared-memory transpose variant.
int c3dgs_dma_probe3(const float* x, long long stride, int nc, int transpose, float* sums, float* out,
                     void* stream) {
  if (nc > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (transpose) {
      probe3_kernel<true><<<nc, THREADS, 0, s>>>(x, stride, nc, sums, out);
    } else {
      probe3_kernel<false><<<nc, THREADS, 0, s>>>(x, stride, nc, sums, out);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

const char* c3dgs_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"
