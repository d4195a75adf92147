// Device helpers shared by the gather-merge kernels whose snapshot ring is
// stored in a wire format: float32, bfloat16 (kept as its raw 16 bits in a
// uint16_t) or int8 with one float32 scale per (ring row, parameter leaf).
//
// Widening is exact in every format: a bfloat16 value is the top half of a
// float32, so it widens by a shift; an int8 value converts exactly.
//
// A node's parameters are one flat row with the leaves packed back to back
// and no padding between them, so a leaf may start anywhere, also inside
// the four columns that one thread loads. The kernels take the leaves'
// start columns ([L], start[0] == 0, increasing) and look each column's
// leaf up with leaf_of().

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace wire {

// Wire format codes, as the Python wrappers pass them.
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;
constexpr int kInt8 = 2;

constexpr int kMaxLeaves = 256;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(uint16_t v) {
  return __uint_as_float(static_cast<uint32_t>(v) << 16);
}
__device__ __forceinline__ float widen(int8_t v) {
  return static_cast<float>(v);
}

// Four consecutive values of a ring row, widened to float32. `e` is a
// multiple of 4 and the row base is aligned to 4 values, so the load is one
// 16-byte (float32), 8-byte (bfloat16) or 4-byte (int8) word.
__device__ __forceinline__ float4 load4(const float* row, int64_t e) {
  return *reinterpret_cast<const float4*>(row + e);
}
__device__ __forceinline__ float4 load4(const uint16_t* row, int64_t e) {
  const uint2 u = *reinterpret_cast<const uint2*>(row + e);
  // Little endian: the low half of each word is the lower column.
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}
__device__ __forceinline__ float4 load4(const int8_t* row, int64_t e) {
  const char4 c = *reinterpret_cast<const char4*>(row + e);
  return make_float4(static_cast<float>(c.x), static_cast<float>(c.y),
                     static_cast<float>(c.z), static_cast<float>(c.w));
}

// The leaf holding column c: the last l < L with start[l] <= c. Binary
// search over the block's shared copy of the start table.
__device__ __forceinline__ int leaf_of(const int32_t* start, int L,
                                       int64_t c) {
  int lo = 0, hi = L;  // start[lo] <= c < start[hi], start[L] = infinity
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (start[mid] <= c) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// The leaves of columns c, c+1, c+2, c+3.
__device__ __forceinline__ int4 leaves4(const int32_t* start, int L,
                                        int64_t c) {
  int4 l;
  l.x = leaf_of(start, L, c);
  l.y = l.x;
  while (l.y + 1 < L && start[l.y + 1] <= c + 1) ++l.y;
  l.z = l.y;
  while (l.z + 1 < L && start[l.z + 1] <= c + 2) ++l.z;
  l.w = l.z;
  while (l.w + 1 < L && start[l.w + 1] <= c + 3) ++l.w;
  return l;
}

inline bool aligned(const void* ptr, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(ptr) % bytes) == 0;
}

}  // namespace wire
