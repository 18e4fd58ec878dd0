// TAB: the gradient of a gathered table (ops/segment.py::segment_sum, which
// _GatherRows.backward, compress/vq.py and compress/pipeline.py call),
// written for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package leaves the transpose of its
// table gathers (c3dgs_tpu/models/gaussians.py:139-172) and its
// jax.ops.segment_sum (c3dgs_tpu/compress/vq.py:84) to XLA's scatter-add.
// The port summed by a difference of float64 prefix sums: a sort of the
// ids, two searchsorted calls over every table row, a float64 scan of the
// (D, n) values and two gathers at the segment ends. A finetune step of
// garden-5m-c3dgs runs it 21 times (20 colour blocks of 262,144 splats
// into 504,096 rows of 48 floats, the shape gather of 5M splats into
// 1,254,096 rows of 7): 42 ms busy, ~0.6 GB of float64 intermediates a
// colour block. What it computes, for values (n, D) f32 and ids (n,):
//   out[t, :] = sum over j with ids[j] == t of values[j, :]      t < rows
// (an empty row, and a row of rows past every id, is 0; an id outside
// [0, rows) adds nothing).
//
// Numerics: each sum accumulates in float64 registers in an order that
// depends only on the ids and is rounded once to float32: within float32
// rounding of the exact sum, and the same bits on every launch. No float
// atomics.
//
// Bound on the card: bytes. Each value read once, each table row written
// once, zeros included, the ids and the sort's permutation read once: a
// colour block reads 50.3 MB and writes 96.8 MB, the shape gather reads
// 140 MB of values and 40 MB of ids and writes 35 MB. A finetune step's
// ~3.2 GB is ~0.96 ms at 3.35 TB/s (H100 80GB HBM3), most of it the colour
// blocks' full-table outputs.
//
// Design for the card, one C call, every pass on one stream:
//   0. the ids become int32 keys beside their positions, and cub's stable
//      radix sort (CUDA's own library; it orders and does no arithmetic)
//      orders them over the key bits that `rows` needs (19 for the colour
//      table, 21 for the shape table: three passes, not an int64 sort's
//      eight): `keys_s`, and `order`, sorted position -> value row, so a
//      segment's rows are summed in their original order. One call makes
//      every launch, and the caller allocates one scratch buffer: the host,
//      which paces the finetune step's backward, issues few operations;
//   1. the (2, rows) bounds are zeroed (cudaMemsetAsync), so a row that no
//      id names reads as the empty segment [0, 0); then one thread per
//      sorted position writes the start of its run if it opens one and the
//      end if it closes one (bounds from the sorted ids: no search over the
//      table's rows);
//   2. the sorted positions are cut into tiles of TILE. A segment that
//      crosses a tile boundary is summed in pieces: each tile sums the
//      segment that entered it from the tile before (`head`) and the one
//      that leaves it for the next (`tail`), into float64 partials. Then,
//      one launch a level, pieces of TILE^2, TILE^3, ... positions, up to
//      the first level of at most TILE pieces: a piece sums, in order, the
//      pieces of the level below in its span that belong to the segment
//      that entered it from before;
//   3. every table row is written once, by a warp that writes 32 rows:
//      0 for an empty row, the value for a segment of one, the direct sum
//      of a segment inside one tile (at most TILE values), or a crossing
//      segment's first-tile tail, then up the levels: at each, the pieces
//      after those already counted, to the end of their parent's span or
//      to the piece that holds the segment's end. Its rows are RUN
//      consecutive rows from each of four runs far apart, so rows read by
//      many ids, which a table may hold side by side (a codebook's 4,096),
//      are spread over many warps.
// So no lane group sums more than TILE values, or more than one tail and
// TILE - 1 pieces a level: a row read by any number of ids up to 2^31 is
// finished after at most 1 + 31 x 6 partials in a chain, where tiles
// alone would chain L / TILE for a row read by L ids.
// A lane group is G = min(32, next power of two >= D) neighbouring lanes
// (8 for the shape's 7 floats, 32 for colour's 48), each lane holding CPL
// columns: a row's D contiguous floats are read, and written, by
// neighbouring lanes, with IN_FLIGHT loads in flight a lane. D past
// 32 * MAX_CPL runs in column windows.
// Times against the byte bound at garden-5m-c3dgs's shapes and on skewed
// rows: chip_smoke.py phase 17, the kernels line's table_segment_sum row
// (PERF.md section 6, TAB).

#include <cub/device/device_radix_sort.cuh>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int TILE = 32;  // sorted positions of a tile
constexpr int IN_FLIGHT = 16;  // loads in flight a lane: value rows of CPL floats, partials of CPL doubles
constexpr int RUN = 8;  // consecutive table rows a warp writes together
constexpr int MAX_CPL = 8;  // columns a lane, a window
constexpr int MAX_LEVELS = 8;  // levels of pieces: TILE^7 > 2^31 positions
constexpr unsigned FULL = 0xffffffffu;

// pass 0: the sort's input, the ids as int32 keys (an id outside [0, rows)
// as rows, which sorts last and names no row) and their positions
__global__ void __launch_bounds__(THREADS)
keys_kernel(const long long* __restrict__ ids, long long n, long long rows, int* __restrict__ keys,
            int* __restrict__ pos) {
  const long long i = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (i >= n) return;
  const long long t = __ldg(ids + i);
  keys[i] = static_cast<int>(t >= 0 && t < rows ? t : rows);
  pos[i] = static_cast<int>(i);
}

// pass 1: the run of sorted ids around position i opens at i and/or closes
// after it
__global__ void __launch_bounds__(THREADS)
bounds_kernel(const int* __restrict__ ids_s, long long n, long long rows, int* __restrict__ start,
              int* __restrict__ end) {
  const long long i = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (i >= n) return;
  const int t = __ldg(ids_s + i);
  if (t >= rows) return;
  if (i == 0 || __ldg(ids_s + i - 1) != t) start[t] = static_cast<int>(i);
  if (i == n - 1 || __ldg(ids_s + i + 1) != t) end[t] = static_cast<int>(i + 1);
}

// the lanes of the calling lane's group of g
__device__ __forceinline__ unsigned group_mask(int g) {
  return g == 32 ? FULL : ((1u << g) - 1u) << ((threadIdx.x & 31) / g * g);
}

// value rows a lane has in flight at CPL columns
__host__ __device__ constexpr int unroll(int cpl) { return cpl >= IN_FLIGHT ? 1 : IN_FLIGHT / cpl; }

template <int CPL>
__device__ __forceinline__ void zero(double (&acc)[CPL]) {
#pragma unroll
  for (int k = 0; k < CPL; ++k) acc[k] = 0.0;
}

// acc[k] += the column c0 + lane + k * g of each value row order[j], j in
// [lo, hi), in order of j. The group's g lanes read g entries of order at
// once, and UNROLL value rows are in flight before their adds.
template <int CPL>
__device__ __forceinline__ void add_values(double (&acc)[CPL], const float* __restrict__ values,
                                           const int* __restrict__ order, long long lo, long long hi,
                                           long long d, long long c0, int lane, int g, unsigned mask) {
  constexpr int UNROLL = unroll(CPL);
  for (long long j0 = lo; j0 < hi; j0 += g) {
    const int m = static_cast<int>(min(static_cast<long long>(g), hi - j0));
    const long long mine = lane < m ? static_cast<long long>(__ldg(order + j0 + lane)) * d : 0;
    for (int u = 0; u < m; u += UNROLL) {
      float v[UNROLL][CPL];
#pragma unroll
      for (int x = 0; x < UNROLL; ++x) {
        const long long p = __shfl_sync(mask, mine, (u + x) & (g - 1), g);
#pragma unroll
        for (int k = 0; k < CPL; ++k) {
          const long long c = c0 + lane + k * g;
          v[x][k] = u + x < m && c < d ? __ldg(values + p + c) : 0.f;
        }
      }
#pragma unroll
      for (int x = 0; x < UNROLL; ++x) {
        if (u + x < m) {
#pragma unroll
          for (int k = 0; k < CPL; ++k) acc[k] += static_cast<double>(v[x][k]);
        }
      }
    }
  }
}

// acc[k] += the same columns of the `count` partials at `at`, in order
template <int CPL>
__device__ __forceinline__ void add_partials(double (&acc)[CPL], const double* __restrict__ at, long long count,
                                             long long d, long long c0, int lane, int g) {
  constexpr int UNROLL = unroll(2 * CPL);
  for (long long m0 = 0; m0 < count; m0 += UNROLL) {
    double v[UNROLL][CPL];
#pragma unroll
    for (int x = 0; x < UNROLL; ++x) {
      const long long m = m0 + x;
#pragma unroll
      for (int k = 0; k < CPL; ++k) {
        const long long c = c0 + lane + k * g;
        v[x][k] = m < count && c < d ? __ldg(at + m * d + c) : 0.0;
      }
    }
#pragma unroll
    for (int x = 0; x < UNROLL; ++x) {
      if (m0 + x < count) {
#pragma unroll
        for (int k = 0; k < CPL; ++k) acc[k] += v[x][k];
      }
    }
  }
}

template <int CPL>
__device__ __forceinline__ void store_partial(double* __restrict__ dst, const double (&acc)[CPL], long long d,
                                              long long c0, int lane, int g) {
#pragma unroll
  for (int k = 0; k < CPL; ++k) {
    const long long c = c0 + lane + k * g;
    if (c < d) dst[c] = acc[k];
  }
}

// pass 2: one lane group per tile; the crossing segments' pieces in it
template <int CPL>
__global__ void __launch_bounds__(THREADS)
partials_kernel(const float* __restrict__ values, const int* __restrict__ ids_s, const int* __restrict__ order,
                long long n, long long d, long long rows, const int* __restrict__ start,
                const int* __restrict__ end, int g, double* __restrict__ head, double* __restrict__ tail) {
  const long long tile = (static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x) / g;
  const int lane = threadIdx.x & (g - 1);
  if (tile * TILE >= n) return;
  const unsigned mask = group_mask(g);
  const long long t0 = tile * TILE, t1 = min(t0 + TILE, n);
  // the segment at t0, if it began in an earlier tile
  const int rh = __ldg(ids_s + t0);
  const bool head_on = rh < rows && __ldg(start + rh) < t0;
  // the segment at t1 - 1, if it goes on into the next tile and is not
  // the head (a segment over the whole tile is its head)
  const int rt = __ldg(ids_s + t1 - 1);
  const bool tail_on = rt < rows && __ldg(end + rt) > t1 && !(rt == rh && head_on);
  double acc[CPL];
  for (long long c0 = 0; c0 < d; c0 += static_cast<long long>(g) * CPL) {
    if (head_on) {
      zero(acc);
      add_values(acc, values, order, t0, min(static_cast<long long>(__ldg(end + rh)), t1), d, c0, lane, g, mask);
      store_partial(head + tile * d, acc, d, c0, lane, g);
    }
    if (tail_on) {
      zero(acc);
      add_values(acc, values, order, max(static_cast<long long>(__ldg(start + rt)), t0), t1, d, c0, lane, g, mask);
      store_partial(tail + tile * d, acc, d, c0, lane, g);
    }
  }
}

// the pieces of each level: at[0] the tiles' heads, at[k] those of level
// k + 1; top the highest level, the first with at most TILE pieces
struct Levels {
  const double* at[MAX_LEVELS];
  int top;
};

// pass 2b, one launch a level above the tiles: a piece of level k >= 2
// spans the sorted positions [i * TILE^k, (i + 1) * TILE^k) and, like a
// tile's head, is the sum over that span of the segment that entered it
// from before, if one did: the in-order sum of that segment's pieces of
// level k - 1 among the span's TILE children. One lane group a piece.
template <int CPL>
__global__ void __launch_bounds__(THREADS)
level_kernel(const int* __restrict__ ids_s, long long rows, const int* __restrict__ start,
             const int* __restrict__ end, long long unit, long long count, long long d, int g,
             const double* __restrict__ below, double* __restrict__ up) {
  const long long i = (static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x) / g;
  const int lane = threadIdx.x & (g - 1);
  if (i >= count) return;
  const long long p0 = i * unit;
  const int r = __ldg(ids_s + p0);
  if (r >= rows || __ldg(start + r) >= p0) return;
  const long long c0 = i * TILE, c1 = min(c0 + TILE, (__ldg(end + r) - 1) / (unit / TILE) + 1);
  double acc[CPL];
  for (long long w = 0; w < d; w += static_cast<long long>(g) * CPL) {
    zero(acc);
    add_partials(acc, below + c0 * d, c1 - c0, d, w, lane, g);
    store_partial(up + i * d, acc, d, w, lane, g);
  }
}

// pass 3: every table row written once. A warp writes 32 rows, RUN
// consecutive rows from each of 32 / RUN runs `warps` runs apart, so rows
// read by many ids, which a table may hold together (a codebook's), are
// spread over warps. Lane l reads the bounds of row l of the warp, and the
// value row of a segment of one. Each lane group then writes its rows of
// at most one value, unroll(CPL) in flight, and after them its rows of
// more, one at a time.
template <int CPL>
__global__ void __launch_bounds__(THREADS)
rows_kernel(const float* __restrict__ values, const int* __restrict__ order, long long d, long long rows,
            const int* __restrict__ start, const int* __restrict__ end, int g, const Levels levels,
            const double* __restrict__ tail, float* __restrict__ out) {
  constexpr int UNROLL = unroll(CPL);
  const int lane = threadIdx.x & 31;
  const long long warp = (static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x) / 32;
  const long long warps = static_cast<long long>(gridDim.x) * (THREADS / 32);
  if (warp * RUN >= rows) return;
  const auto row = [&](int r) { return (warp + r / RUN * warps) * RUN + r % RUN; };
  int s = 0, e = 0;
  if (row(lane) < rows) {
    s = __ldg(start + row(lane));
    e = __ldg(end + row(lane));
  }
  const long long one = e - s == 1 ? static_cast<long long>(__ldg(order + s)) * d : 0;
  const unsigned live = __ballot_sync(FULL, row(lane) < rows);
  const unsigned single = __ballot_sync(FULL, e - s == 1), many = __ballot_sync(FULL, e - s > 1);
  const int per = 32 / g, gl = lane & (g - 1);
  const unsigned mask = group_mask(g);
  double acc[CPL];
  for (long long c0 = 0; c0 < d; c0 += static_cast<long long>(g) * CPL) {
    for (int r0 = lane / g; r0 < 32; r0 += per * UNROLL) {
      float v[UNROLL][CPL];
#pragma unroll
      for (int x = 0; x < UNROLL; ++x) {
        const int r = r0 + x * per;
        const long long ro = __shfl_sync(FULL, one, r & 31);
        const bool load = r < 32 && (single >> r & 1u);
#pragma unroll
        for (int k = 0; k < CPL; ++k) {
          const long long c = c0 + gl + k * g;
          v[x][k] = load && c < d ? __ldg(values + ro + c) : 0.f;
        }
      }
#pragma unroll
      for (int x = 0; x < UNROLL; ++x) {
        const int r = r0 + x * per;
        if (r < 32 && (live >> r & 1u) && !(many >> r & 1u)) {
#pragma unroll
          for (int k = 0; k < CPL; ++k) {
            const long long c = c0 + gl + k * g;
            if (c < d) out[row(r) * d + c] = v[x][k];
          }
        }
      }
    }
    for (int r = lane / g; r < 32; r += per) {
      const long long rs = __shfl_sync(FULL, s, r), re = __shfl_sync(FULL, e, r);
      if (!(many >> r & 1u)) continue;
      zero(acc);
      const long long first = rs / TILE, last = (re - 1) / TILE;
      if (first == last) {
        add_values(acc, values, order, rs, re, d, c0, gl, g, mask);
      } else {
        // the first tile's tail, then up the levels: at each, the pieces
        // after the last one counted, to the end of its parent's span or
        // to the piece that holds the segment's end
        add_partials(acc, tail + first * d, 1, d, c0, gl, g);
        long long i = first, to = last;
        for (int k = 0;; ++k) {
          const long long hi = k == levels.top ? to : min(to, (i / TILE + 1) * TILE - 1);
          add_partials(acc, levels.at[k] + (i + 1) * d, hi - i, d, c0, gl, g);
          if (hi == to) break;
          i /= TILE;
          to /= TILE;
        }
      }
#pragma unroll
      for (int k = 0; k < CPL; ++k) {
        const long long c = c0 + gl + k * g;
        if (c < d) out[row(r) * d + c] = __double2float_rn(acc[k]);
      }
    }
  }
}

unsigned blocks(long long threads) { return static_cast<unsigned>((threads + THREADS - 1) / THREADS); }

// the pieces above the tiles, level by level, up to the first level of at
// most TILE pieces
long long pieces_above(long long tiles) {
  long long total = 0;
  for (long long count = tiles; count > TILE;) {
    count = (count + TILE - 1) / TILE;
    total += count;
  }
  return total;
}

// partials: the tiles' heads, their tails, then the levels above
template <int CPL>
void launch_sums(const float* values, const int* ids_s, const int* order, long long n, long long d,
                 long long rows, const int* start, const int* end, int g, double* partials, float* out,
                 cudaStream_t st) {
  const long long tiles = (n + TILE - 1) / TILE;
  double* head = partials;
  double* tail = head + tiles * d;
  Levels levels{};
  levels.at[0] = head;
  if (tiles > 0) {
    partials_kernel<CPL><<<blocks(tiles * g), THREADS, 0, st>>>(values, ids_s, order, n, d, rows, start, end, g,
                                                                 head, tail);
    double* up = tail + tiles * d;
    for (long long unit = TILE, count = tiles; count > TILE;) {
      unit *= TILE;
      count = (count + TILE - 1) / TILE;
      level_kernel<CPL><<<blocks(count * g), THREADS, 0, st>>>(ids_s, rows, start, end, unit, count, d, g,
                                                                levels.at[levels.top], up);
      levels.at[++levels.top] = up;
      up += count * d;
    }
  }
  const long long warps = ((rows + RUN - 1) / RUN + 32 / RUN - 1) / (32 / RUN);
  rows_kernel<CPL><<<blocks(warps * 32), THREADS, 0, st>>>(values, order, d, rows, start, end, g, levels, tail, out);
}

// the key bits the sort orders: enough for `rows`, the largest key
int key_bits(long long rows) {
  int bits = 1;
  while ((1LL << bits) <= rows) ++bits;
  return bits;
}

// where each scratch array starts, 256-byte aligned, and the bytes in all
struct Scratch {
  size_t keys, pos, keys_s, order, bounds, partials, sort, sort_bytes, total;
};

Scratch scratch_layout(long long n, long long d, long long rows) {
  Scratch l{};
  if (n > 0) {
    cub::DeviceRadixSort::SortPairs(nullptr, l.sort_bytes, static_cast<const int*>(nullptr),
                                    static_cast<int*>(nullptr), static_cast<const int*>(nullptr),
                                    static_cast<int*>(nullptr), static_cast<int>(n), 0, key_bits(rows));
  }
  size_t at = 0;
  const auto take = [&at](size_t bytes) {
    const size_t p = at;
    at += (bytes + 255) / 256 * 256;
    return p;
  };
  l.keys = take(4 * n);
  l.pos = take(4 * n);
  l.keys_s = take(4 * n);
  l.order = take(4 * n);
  l.bounds = take(8 * rows);
  const long long tiles = (n + TILE - 1) / TILE;
  l.partials = take(8 * (2 * tiles + pieces_above(tiles)) * d);
  l.sort = take(l.sort_bytes);
  l.total = at;
  return l;
}

}  // namespace

extern "C" {

// The bytes of scratch c3dgs_table_segment_sum needs for n ids of a table
// of rows rows of d floats.
unsigned long long c3dgs_table_segment_sum_scratch(long long n, long long d, long long rows) {
  return scratch_layout(n, d, rows).total;
}

// values: (n, d) f32; ids: (n,) i64; scratch: the bytes
// c3dgs_table_segment_sum_scratch gives, 256-byte aligned; out: (rows, d)
// f32, every entry written. n and rows below 2^31, d >= 1. Sorts the ids
// (cub's stable radix sort over key_bits(rows) bits) and launches the
// passes on `stream`; returns the first CUDA error (0 when every launch
// was accepted).
int c3dgs_table_segment_sum(const float* values, const long long* ids, long long n, long long d, long long rows,
                            void* scratch, unsigned long long scratch_bytes, float* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows <= 0) return static_cast<int>(cudaGetLastError());
  const Scratch l = scratch_layout(n, d, rows);
  if (scratch_bytes < l.total) return static_cast<int>(cudaErrorInvalidValue);
  char* base = static_cast<char*>(scratch);
  int* keys = reinterpret_cast<int*>(base + l.keys);
  int* pos = reinterpret_cast<int*>(base + l.pos);
  int* keys_s = reinterpret_cast<int*>(base + l.keys_s);
  int* order = reinterpret_cast<int*>(base + l.order);
  int* start = reinterpret_cast<int*>(base + l.bounds);
  int* end = start + rows;
  double* partials = reinterpret_cast<double*>(base + l.partials);
  cudaError_t err = cudaMemsetAsync(start, 0, 2 * rows * sizeof(int), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > 0) {
    keys_kernel<<<blocks(n), THREADS, 0, st>>>(ids, n, rows, keys, pos);
    size_t sort_bytes = l.sort_bytes;
    err = cub::DeviceRadixSort::SortPairs(base + l.sort, sort_bytes, keys, keys_s, pos, order, static_cast<int>(n), 0,
                                          key_bits(rows), st);
    if (err != cudaSuccess) return static_cast<int>(err);
    bounds_kernel<<<blocks(n), THREADS, 0, st>>>(keys_s, n, rows, start, end);
  }
  int g = 1;
  while (g < d && g < 32) g *= 2;
  const long long cpl = (d + g - 1) / g;
  if (cpl <= 1) {
    launch_sums<1>(values, keys_s, order, n, d, rows, start, end, g, partials, out, st);
  } else if (cpl <= 2) {
    launch_sums<2>(values, keys_s, order, n, d, rows, start, end, g, partials, out, st);
  } else if (cpl <= 4) {
    launch_sums<4>(values, keys_s, order, n, d, rows, start, end, g, partials, out, st);
  } else {
    launch_sums<MAX_CPL>(values, keys_s, order, n, d, rows, start, end, g, partials, out, st);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* c3dgs_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"
