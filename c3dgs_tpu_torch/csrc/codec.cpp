// Host codec of the port (port of c3dgs_tpu/native/codec.cpp): the two
// host I/O paths that are per-element Python loops or bit twiddling in
// numpy, the COLMAP points3D.bin parser (scene/colmap_loader.py:125 walks
// 5M+ points in Python) and the Morton order (scene/gaussian_model.py:
// 997-1023, :1417-1431).
//
// Host C++, not a kernel: c3dgs_tpu_torch/native.py builds it with g++
// into build/c3dgs_tpu_torch/ at first use and binds it with ctypes. Its
// results equal the numpy versions data/colmap.py::read_points3D_binary
// and ops/morton.py::morton_order; the Morton quantization evaluates
// (2^21 - 1) * (x - min) / extent in that order, as numpy does, so the
// truncated codes agree to the bit.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <utility>
#include <vector>

extern "C" {

// points3D.bin per point:
//   uint64 id; double xyz[3]; uint8 rgb[3]; double error;
//   uint64 track_len; { int32 image_id; int32 point2D_idx; } * track_len
// With n_points_only, returns the point count of the header. Otherwise
// fills the capacity-sized buffers and returns the points parsed (fewer
// than min(count, capacity) for a truncated file). -1: the file does not
// open or has no header.
long long colmap_points3d_parse(const char* path, double* xyz, uint8_t* rgb, double* err, long long capacity,
                                int n_points_only) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  uint64_t n = 0;
  if (fread(&n, 8, 1, f) != 1) {
    fclose(f);
    return -1;
  }
  if (n_points_only) {
    fclose(f);
    return (long long)n;
  }
  if ((long long)n > capacity) n = (uint64_t)capacity;

  // the rest of the file in one read, then one walk over it
  long long data_start = ftell(f);
  fseek(f, 0, SEEK_END);
  long long fsize = ftell(f);
  fseek(f, data_start, SEEK_SET);
  std::vector<unsigned char> buf((size_t)(fsize - data_start));
  if (fread(buf.data(), 1, buf.size(), f) != buf.size()) {
    fclose(f);
    return -1;
  }
  fclose(f);

  const unsigned char* p = buf.data();
  const unsigned char* end = buf.data() + buf.size();
  for (uint64_t i = 0; i < n; i++) {
    if (end - p < 8 + 24 + 3 + 8 + 8) return (long long)i;
    p += 8;  // id
    memcpy(xyz + 3 * i, p, 24);
    p += 24;
    memcpy(rgb + 3 * i, p, 3);
    p += 3;
    memcpy(err + i, p, 8);
    p += 8;
    uint64_t track;
    memcpy(&track, p, 8);
    p += 8;
    if ((uint64_t)(end - p) / 8 < track) return (long long)(i + 1);
    p += track * 8;  // the (image_id, point2D_idx) pairs
  }
  return (long long)n;
}

static inline uint64_t split_by_3(uint64_t a) {
  uint64_t x = a & 0x1FFFFF;
  x = (x | x << 32) & 0x1F00000000FFFFull;
  x = (x | x << 16) & 0x1F0000FF0000FFull;
  x = (x | x << 8) & 0x100F00F00F00F00Full;
  x = (x | x << 4) & 0x10C30C30C30C30C3ull;
  x = (x | x << 2) & 0x1249249249249249ull;
  return x;
}

// The Morton permutation of n points (xyz row-major f32): 21-bit
// quantization over the bounding box (an axis of zero extent divides by
// 1), axes interleaved by ascending extent (ties keep axis order), codes
// sorted ascending and stably.
void morton_order_f32(const float* xyz, long long n, int* perm_out) {
  if (n <= 0) return;
  double mn[3] = {xyz[0], xyz[1], xyz[2]};
  double mx[3] = {xyz[0], xyz[1], xyz[2]};
  for (long long i = 0; i < n; i++) {
    for (int d = 0; d < 3; d++) {
      double v = xyz[3 * i + d];
      if (v < mn[d]) mn[d] = v;
      if (v > mx[d]) mx[d] = v;
    }
  }
  double ext[3], denom[3];
  int order[3] = {0, 1, 2};
  for (int d = 0; d < 3; d++) {
    ext[d] = mx[d] - mn[d];
    denom[d] = ext[d] > 0 ? ext[d] : 1.0;
  }
  std::stable_sort(order, order + 3, [&](int a, int b) { return ext[a] < ext[b]; });

  std::vector<std::pair<uint64_t, int>> keyed((size_t)n);
  const double scale = (double)((1 << 21) - 1);
  for (long long i = 0; i < n; i++) {
    uint64_t q[3];
    for (int d = 0; d < 3; d++) {
      double v = scale * ((double)xyz[3 * i + d] - mn[d]) / denom[d];
      q[d] = (uint64_t)v;  // v >= 0: truncation, as numpy's astype(int64)
    }
    uint64_t code = split_by_3(q[order[0]]) | (split_by_3(q[order[1]]) << 1) | (split_by_3(q[order[2]]) << 2);
    keyed[(size_t)i] = {code, (int)i};
  }
  std::stable_sort(keyed.begin(), keyed.end(), [](const auto& a, const auto& b) { return a.first < b.first; });
  for (long long i = 0; i < n; i++) perm_out[i] = keyed[(size_t)i].second;
}

}  // extern "C"
