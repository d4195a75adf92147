// Multi-slot gather-merge: drain a K-slot mailbox into every receiver row
// in one launch, over a snapshot ring in float32 or in a wire format whose
// peer rows are widened inside the kernel.
//
// Replaces two TPU kernels of gossipy_tpu/ops/merge.py:
//   - _multi_kernel (K1): a float32 ring, entry point gather_merge_multi;
//   - _multi_dq_kernel (K2): a ring in a wire format (bfloat16, or int8
//     with a scale table), entry point gather_merge_multi_dq.
// For each receiver row i it folds the K slots left to right,
//
//     out = p[i];  for k < K:
//     out = ws[i,k] * out + (wp[i,k] != 0 ? wp[i,k] * peer(i,k) : 0)
//     peer(i,k) = widen(h[idx[i,k]]) * scale[idx[i,k], leaf(column)]
//
// where h is the flat [D*N, F] snapshot ring. Without a scale table
// (float32, bfloat16) the peer is the widened row, the TPU kernel's scale
// of 1. With one (int8), the kernel reads the named rows' scales straight
// from the ring's [M, L] sidecar and finds a column's leaf in the [L] table
// of leaf start columns; the TPU kernel takes scales gathered outside it
// and maps 512-column blocks to leaves, every leaf padded to a block
// multiple. An empty slot carries (ws, wp) = (1, 0) and an arbitrary
// in-range index: its ring row and its scales are never read and its term
// is 0, never 0 * row, so a non-finite row or scale behind it stays inert.
//
// Bound: memory. A live slot costs 2 to 4 operations per element (widen,
// scale, multiply, then the blend's multiply and add) against 8 bytes of p
// and out per row plus 4, 2 or 1 bytes of each live peer row; the card
// does hundreds of operations per byte it reads. The least traffic is p
// read once, out written once, each live ring row read once at wire width,
// plus the tables. The design keeps to that:
//   - the grid is (receiver row, feature tile); blocks run in parallel, in
//     no order, so the TPU grid's slot-minor axis becomes a loop over k
//     inside the thread, the running sum kept in registers;
//   - each block copies its row's K indices and weights, the live slots'
//     K x L scales and the leaf start table to shared memory once (the TPU
//     kernel's scalar prefetch);
//   - a peer row is loaded only when its slot is live, a test uniform
//     across the block, since a block covers one row;
//   - each thread takes 4 consecutive columns: float4 for p and out, one
//     16-byte (float32), 8-byte (bfloat16) or 4-byte (int8) word of ring
//     row, which the ring's row alignment allows (wire_rows.cuh), so
//     neighbouring threads touch neighbouring words and loads coalesce; the
//     4 columns' leaves are looked up once, before the slot loop, and may
//     differ, since leaves are packed with no padding. Any other shape
//     takes the scalar form of the same kernel.
//
// Numerics: built with --fmad=false, so `ws * out + term` is a multiply
// then an add, rounded as the plain PyTorch version rounds them: the two
// agree bit for bit.
//
// C interface for ctypes. The launch goes on the caller's stream and does
// not synchronise; each function returns cudaGetLastError() after it.

#include <cuda_runtime.h>
#include <stdint.h>

#include "wire_rows.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSlots = 64;
constexpr int kMaxScales = 8192;  // K x L floats of dynamic shared memory

template <bool kScaled>
__device__ __forceinline__ void load_tables(
    const int32_t* idx, const float* ws, const float* wp, const float* scale,
    const int32_t* start, int L, int64_t row, int k, int32_t* s_idx,
    float* s_ws, float* s_wp, int32_t* s_start, float* s_scale) {
  for (int t = threadIdx.x; t < k; t += blockDim.x) {
    s_idx[t] = idx[row * k + t];
    s_ws[t] = ws[row * k + t];
    s_wp[t] = wp[row * k + t];
  }
  if (kScaled) {
    for (int t = threadIdx.x; t < L; t += blockDim.x) s_start[t] = start[t];
    __syncthreads();
    for (int t = threadIdx.x; t < k * L; t += blockDim.x) {
      const int s = t / L;
      s_scale[t] = s_wp[s] != 0.f ? scale[(int64_t)s_idx[s] * L + t % L]
                                  : 0.f;
    }
  }
  __syncthreads();
}

// f is a multiple of 4; cols = f / 4 words per row.
template <typename T, bool kScaled>
__global__ void multi_vec4(const float4* __restrict__ p,
                           const T* __restrict__ h,
                           const int32_t* __restrict__ idx,
                           const float* __restrict__ ws,
                           const float* __restrict__ wp,
                           const float* __restrict__ scale,
                           const int32_t* __restrict__ start, int L,
                           float4* __restrict__ out, int64_t f, int k) {
  __shared__ int32_t s_idx[kMaxSlots];
  __shared__ float s_ws[kMaxSlots];
  __shared__ float s_wp[kMaxSlots];
  __shared__ int32_t s_start[wire::kMaxLeaves];
  extern __shared__ float s_scale[];  // [k, L]
  const int64_t row = blockIdx.x;
  load_tables<kScaled>(idx, ws, wp, scale, start, L, row, k, s_idx, s_ws,
                       s_wp, s_start, s_scale);
  const int64_t cols = f / 4;
  const int64_t col = (int64_t)blockIdx.y * blockDim.x + threadIdx.x;
  if (col >= cols) return;
  int4 leaf = make_int4(0, 0, 0, 0);
  if (kScaled) leaf = wire::leaves4(s_start, L, 4 * col);
  float4 acc = p[row * cols + col];
  for (int s = 0; s < k; ++s) {
    const float w = s_wp[s];
    float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
    if (w != 0.f) {
      float4 v = wire::load4(h + (int64_t)s_idx[s] * f, 4 * col);
      if (kScaled) {
        const float* sc = s_scale + s * L;
        v.x = v.x * sc[leaf.x];
        v.y = v.y * sc[leaf.y];
        v.z = v.z * sc[leaf.z];
        v.w = v.w * sc[leaf.w];
      }
      t.x = w * v.x;
      t.y = w * v.y;
      t.z = w * v.z;
      t.w = w * v.w;
    }
    const float a = s_ws[s];
    acc.x = a * acc.x + t.x;
    acc.y = a * acc.y + t.y;
    acc.z = a * acc.z + t.z;
    acc.w = a * acc.w + t.w;
  }
  out[row * cols + col] = acc;
}

template <typename T, bool kScaled>
__global__ void multi_scalar(const float* __restrict__ p,
                             const T* __restrict__ h,
                             const int32_t* __restrict__ idx,
                             const float* __restrict__ ws,
                             const float* __restrict__ wp,
                             const float* __restrict__ scale,
                             const int32_t* __restrict__ start, int L,
                             float* __restrict__ out, int64_t f, int k) {
  __shared__ int32_t s_idx[kMaxSlots];
  __shared__ float s_ws[kMaxSlots];
  __shared__ float s_wp[kMaxSlots];
  __shared__ int32_t s_start[wire::kMaxLeaves];
  extern __shared__ float s_scale[];  // [k, L]
  const int64_t row = blockIdx.x;
  load_tables<kScaled>(idx, ws, wp, scale, start, L, row, k, s_idx, s_ws,
                       s_wp, s_start, s_scale);
  const int64_t col = (int64_t)blockIdx.y * blockDim.x + threadIdx.x;
  if (col >= f) return;
  const int leaf = kScaled ? wire::leaf_of(s_start, L, col) : 0;
  float acc = p[row * f + col];
  for (int s = 0; s < k; ++s) {
    const float w = s_wp[s];
    float t = 0.f;
    if (w != 0.f) {
      float v = wire::widen(h[(int64_t)s_idx[s] * f + col]);
      if (kScaled) v = v * s_scale[s * L + leaf];
      t = w * v;
    }
    acc = s_ws[s] * acc + t;
  }
  out[row * f + col] = acc;
}

template <typename T, bool kScaled>
int launch(const void* p, const void* h, const void* idx, const void* ws,
           const void* wp, const void* scale, const void* start, int L,
           void* out, int64_t n, int64_t f, int k, cudaStream_t st) {
  const bool vec = (f % 4 == 0) && wire::aligned(p, 16) &&
                   wire::aligned(out, 16) && wire::aligned(h, 4 * sizeof(T));
  const int64_t cols = vec ? f / 4 : f;
  const int64_t tiles = (cols + kThreads - 1) / kThreads;
  if (tiles > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)n, (unsigned)tiles);
  const size_t smem = kScaled ? sizeof(float) * (size_t)k * L : 0;
  const T* hh = static_cast<const T*>(h);
  const int32_t* ii = static_cast<const int32_t*>(idx);
  const float* a = static_cast<const float*>(ws);
  const float* w = static_cast<const float*>(wp);
  const float* sc = static_cast<const float*>(scale);
  const int32_t* so = static_cast<const int32_t*>(start);
  if (vec) {
    multi_vec4<T, kScaled><<<grid, kThreads, smem, st>>>(
        static_cast<const float4*>(p), hh, ii, a, w, sc, so, L,
        static_cast<float4*>(out), f, k);
  } else {
    multi_scalar<T, kScaled><<<grid, kThreads, smem, st>>>(
        static_cast<const float*>(p), hh, ii, a, w, sc, so, L,
        static_cast<float*>(out), f, k);
  }
  return (int)cudaGetLastError();
}

bool bad_shape(int64_t n, int64_t f, int64_t k) {
  return k < 1 || k > kMaxSlots || n < 1 || f < 1 || n > 0x7fffffff ||
         f > 0x7fffffff;
}

}  // namespace

// K1. p, out: [n, f] float32; h: [m, f] float32; idx: [n, k] int32 in
// [0, m) wherever wp != 0; ws, wp: [n, k] float32. All row-major and
// contiguous.
extern "C" int gather_merge_multi(const void* p, const void* h, const void* idx,
                                  const void* ws, const void* wp, void* out,
                                  int64_t n, int64_t f, int64_t k,
                                  void* stream) {
  if (bad_shape(n, f, k)) return (int)cudaErrorInvalidValue;
  return launch<float, false>(p, h, idx, ws, wp, nullptr, nullptr, 0, out, n,
                              f, (int)k, static_cast<cudaStream_t>(stream));
}

// K2. As gather_merge_multi with h: [m, f] in wire format `format`: a
// bfloat16 ring with no scale (scale null), or a float32, bfloat16 or int8
// ring with scale: [m, L] float32, one scale per (ring row, leaf), and
// start: [L] int32 leaf start columns (start[0] == 0, increasing, each
// < f). The float32 ring with no scale is K1's.
extern "C" int gather_merge_multi_dq(const void* p, const void* h, int format,
                                     const void* idx, const void* ws,
                                     const void* wp, const void* scale,
                                     const void* start, int64_t n_leaves,
                                     void* out, int64_t n, int64_t f,
                                     int64_t k, void* stream) {
  if (bad_shape(n, f, k)) return (int)cudaErrorInvalidValue;
  const int kk = (int)k;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (scale == nullptr) {
    if (format != wire::kBFloat16) return (int)cudaErrorInvalidValue;
    return launch<uint16_t, false>(p, h, idx, ws, wp, nullptr, nullptr, 0,
                                   out, n, f, kk, st);
  }
  if (start == nullptr || n_leaves < 1 || n_leaves > wire::kMaxLeaves ||
      k * n_leaves > kMaxScales)
    return (int)cudaErrorInvalidValue;
  const int L = (int)n_leaves;
  switch (format) {
    case wire::kFloat32:
      return launch<float, true>(p, h, idx, ws, wp, scale, start, L, out, n,
                                 f, kk, st);
    case wire::kBFloat16:
      return launch<uint16_t, true>(p, h, idx, ws, wp, scale, start, L, out,
                                    n, f, kk, st);
    case wire::kInt8:
      return launch<int8_t, true>(p, h, idx, ws, wp, scale, start, L, out, n,
                                  f, kk, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
