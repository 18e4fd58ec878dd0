// SEG: the training backward's per-splat sums of K2's per-slot gradient
// rows, written for Hopper (sm_90a).
//
// Replaces no Pallas kernel: c3dgs_tpu/render/rasterizer.py:272
// (_reduce_instance_grads_packed) is XLA's, a row gather of K2's rows into
// gaussian-major order, a prefix scan of them, in exact mode a second scan
// of the scan's rounding residues, and differences of the prefix at the
// emission boundaries. On the card PyTorch ran each scan with one block per
// row (9 rows, millions of columns, 18 blocks on 132 SMs): ~45 ms of a
// ~200 ms training step at 5M splats. A splat's emissions are contiguous in
// emission order, so the sums need no prefix, no sort and no atomics:
//   for g in [0, n):  seg = [emit_cum[g-1], emit_cum[g])   (emit_cum[-1] := 0)
//     out[g, f] = sum over e in seg with e < n_perm and perm[e] < live of
//                 grads[f * rows + perm[e]]                           f < 9
//     out[g, 9:16] = 0
// with live = min(rows, meta[0] * 128): K2 writes no slot past its
// executed chunks, so their zero rows are not read. Emissions at or past
// n_perm (the permutation's length) or whose sorted slot lies at or past
// `live` add nothing; the whole permutation is read, past the execution
// bucket's index too.
//
// Numerics: each sum accumulates in float64 registers in a fixed order and
// is rounded once to float32, with no cancellation for a compensation to
// repair (the prefix differences erred by eps * |prefix|). The order
// depends only on the segment lengths, so two launches on the same inputs
// give the same bits.
//
// Bound on the card: bytes. The garden-5m frame (5M splats, 1297x840,
// 5.88M kept emissions in 5.13M executed slots; H100 80GB HBM3, 3.35 TB/s)
// reads perm and emit_cum (23.5 MB and 20 MB) and 9 floats of each kept
// emission, and writes 5M x 16 floats (320 MB): 575 MB of useful bytes,
// 0.17 ms. K2's rows lie (16, rows) in tile order, so gathering them
// emission by emission reads each float as a 32-byte sector of its own
// (1.7 GB of sectors): a one-pass kernel took 1.48 ms there.
// chip_smoke.py computes the useful-byte bound from each run's counts.
//
// Design for the card, two passes on one stream:
//   1. one thread per executed slot copies its 9 rows into a 48-byte
//      record of a (rows, 12) scratch: 9 reads of neighbouring floats and
//      three 16-byte stores, coalesced on both sides (185 MB read, 246 MB
//      written at garden-5m);
//   2. one thread per splat, 256 a block: a warp's 32 splats read
//      contiguous emit_cum and, emission by emission, neighbouring perm
//      entries, and gather each kept emission's record in three 16-byte
//      loads (two sectors). Most splats emit 0-3 instances, and their
//      thread sums them in emission order. A segment of WARP_MIN or more
//      emissions (a splat covers up to 256 tiles at 5M splats, more at
//      fewer: 792 in a 300k-splat 1920x1080 training frame) would hold
//      its warp for that many dependent round trips, so the warp sums it
//      together: lane l takes emissions lo + l, lo + l + 32, ..., and a
//      five-step xor butterfly adds the lanes' sums in a fixed order (each
//      pair's sum is the same on both lanes). The length is read from
//      emit_cum in the kernel, so the split follows the data. Each output
//      row of 16 floats is four 16-byte stores, zero columns included.
// At garden-5m: 0.65 ms (the one-pass kernel's 1.48, or 0.90 with pass 1
// over every row of the execution bucket; bitwise the same sums). Without
// the warp path (a thread for every segment; H100 80GB HBM3): 0.347 ms
// against 0.088 at bench.py's 300k scene at 1920x1080 after densification
// (chip_smoke.py phase 9's exact step: 201 segments of 16+, the longest
// 792), 0.244 against 0.108 on a made-up 300k frame with 3,000 of 16-256,
// and 0.651 against 0.657 at garden-5m, whose longest is 40.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LIVE = 9;  // gradient rows summed (NUM_USED_FIELDS)
constexpr int OUT_COLS = 16;  // NUM_FIELDS
constexpr int REC = 12;  // floats of a slot's record: the 9 live rows and 3 of padding (48 bytes)
constexpr int CHUNK = 128;  // slots of a chunk (binning.CHUNK)
constexpr int THREADS = 256;
constexpr int WARP_MIN = 16;  // a segment this long is summed by its whole warp
constexpr unsigned FULL = 0xffffffffu;

// the slots that can hold a nonzero row: min(rows, meta[0] * CHUNK)
__device__ __forceinline__ long long live_rows(long long rows, const int* meta) {
  return min(rows, static_cast<long long>(__ldg(meta)) * CHUNK);
}

// pass 1: the 9 live rows of each slot -> its record, read and written in
// slot order
__global__ void __launch_bounds__(THREADS)
to_records_kernel(const float* __restrict__ grads, long long rows, const int* __restrict__ meta,
                  float* __restrict__ rec) {
  const long long s = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (s >= live_rows(rows, meta)) return;
  float v[LIVE];
#pragma unroll
  for (int f = 0; f < LIVE; ++f) v[f] = __ldcs(grads + f * rows + s);
  float4* r = reinterpret_cast<float4*>(rec + s * REC);
  r[0] = make_float4(v[0], v[1], v[2], v[3]);
  r[1] = make_float4(v[4], v[5], v[6], v[7]);
  r[2] = make_float4(v[8], 0.f, 0.f, 0.f);
}

// acc[f] += record s's value f: three 16-byte loads, two sectors
__device__ __forceinline__ void add_record(double (&acc)[LIVE], const float* __restrict__ rec, int s) {
  const float4* r = reinterpret_cast<const float4*>(rec + static_cast<long long>(s) * REC);
  const float4 a = __ldg(r), b = __ldg(r + 1), c = __ldg(r + 2);
  acc[0] += static_cast<double>(a.x);
  acc[1] += static_cast<double>(a.y);
  acc[2] += static_cast<double>(a.z);
  acc[3] += static_cast<double>(a.w);
  acc[4] += static_cast<double>(b.x);
  acc[5] += static_cast<double>(b.y);
  acc[6] += static_cast<double>(b.z);
  acc[7] += static_cast<double>(b.w);
  acc[8] += static_cast<double>(c.x);
}

// pass 2: one thread per splat, a warp per long segment
__global__ void __launch_bounds__(THREADS)
segment_sum_kernel(const float* __restrict__ rec, long long rows, const int* __restrict__ meta,
                   const int* __restrict__ perm, long long n_perm, const int* __restrict__ emit_cum, long long n,
                   float* __restrict__ out) {
  const long long g = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const long long live = live_rows(rows, meta);
  long long lo = 0, hi = 0;
  if (g < n) {
    hi = min(static_cast<long long>(__ldg(emit_cum + g)), n_perm);
    if (g > 0) lo = min(static_cast<long long>(__ldg(emit_cum + g - 1)), hi);
  }
  double acc[LIVE];
#pragma unroll
  for (int f = 0; f < LIVE; ++f) acc[f] = 0.0;
  if (hi - lo < WARP_MIN) {
    for (long long e = lo; e < hi; ++e) {
      const int s = __ldg(perm + e);
      if (s >= 0 && s < live) add_record(acc, rec, s);
    }
  }
  // the warp's long segments, one after another in lane order
  unsigned long_lanes = __ballot_sync(FULL, hi - lo >= WARP_MIN);
  while (long_lanes) {
    const int src = __ffs(long_lanes) - 1;
    long_lanes &= long_lanes - 1;
    const long long slo = __shfl_sync(FULL, lo, src);
    const long long shi = __shfl_sync(FULL, hi, src);
    double part[LIVE];
#pragma unroll
    for (int f = 0; f < LIVE; ++f) part[f] = 0.0;
    for (long long e = slo + lane; e < shi; e += 32) {
      const int s = __ldg(perm + e);
      if (s >= 0 && s < live) add_record(part, rec, s);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
      for (int f = 0; f < LIVE; ++f) part[f] += __shfl_xor_sync(FULL, part[f], o);
    }
    if (lane == src) {
#pragma unroll
      for (int f = 0; f < LIVE; ++f) acc[f] = part[f];
    }
  }
  if (g < n) {
    float4* row = reinterpret_cast<float4*>(out + g * OUT_COLS);
    row[0] = make_float4(__double2float_rn(acc[0]), __double2float_rn(acc[1]), __double2float_rn(acc[2]),
                         __double2float_rn(acc[3]));
    row[1] = make_float4(__double2float_rn(acc[4]), __double2float_rn(acc[5]), __double2float_rn(acc[6]),
                         __double2float_rn(acc[7]));
    row[2] = make_float4(__double2float_rn(acc[8]), 0.f, 0.f, 0.f);
    row[3] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

}  // namespace

extern "C" {

// grads: (16, rows) f32, K2's per-slot rows (0-8 read); meta: (4,) i32 on
// the device, K1/K2's [chunks_exec, ...]: slots at or past meta[0] * 128
// add nothing (K2 leaves their rows zero); perm: (n_perm,) i32, emission
// -> sorted slot; emit_cum: (n,) i32, the inclusive per-splat emission
// prefix (nondecreasing); rec: (rows, 12) f32 scratch; out: (n, 16) f32.
// rec and out 16-byte aligned; every entry of out written. Launches both
// passes on `stream`; returns cudaGetLastError() (0 when the launches were
// accepted).
int c3dgs_segment_sum(const float* grads, long long rows, const int* meta, const int* perm, long long n_perm,
                      const int* emit_cum, long long n, float* rec, float* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows > 0) {
    to_records_kernel<<<static_cast<unsigned>((rows + THREADS - 1) / THREADS), THREADS, 0, st>>>(grads, rows, meta,
                                                                                                 rec);
  }
  if (n > 0) {
    segment_sum_kernel<<<static_cast<unsigned>((n + THREADS - 1) / THREADS), THREADS, 0, st>>>(
        rec, rows, meta, perm, n_perm, emit_cum, n, out);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* c3dgs_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"
