// Single-slot gather-merge: blend one mailbox slot's peer snapshots into
// every receiver row in one launch.
//
// Replaces two TPU kernels of gossipy_tpu/ops/merge.py:
//   - _kernel (K3): a float32 ring, entry point gather_merge_flat;
//   - _dq_kernel (K4): a ring in a wire format (bfloat16 or int8), widened
//     inside the kernel, entry point gather_merge_flat_dq.
// For each receiver row i,
//
//     out[i] = ws[i] * p[i] + wp[i] * peer,   peer = widen(h[idx[i]]) * scale
//
// where h is the flat [D*N, F] snapshot ring. Without a scale table the
// peer is the widened row (the TPU kernel's scale of 1). With one, the
// scale of a column is that of (ring row idx[i], the column's leaf): the
// kernel reads the row's scales straight from the ring's [M, L] sidecar
// (the TPU kernel takes them gathered outside it) and looks the leaf up in
// the [L] table of leaf start columns. As in the TPU
// kernel there is no zero-weight mask: a receiver without a message
// (wp = 0) is blended all the same, and the caller discards its row.
//
// Bound: memory. Per element the kernel does 2 multiplies and an add (a
// third multiply for a scaled ring) against 8 bytes of p and out plus 4, 2
// or 1 bytes of ring row, far below the card's ratio of operations to
// bytes. The least traffic is p read once, out written once and each ring
// row that idx names read once at wire width, plus the tables. The design
// keeps to that:
//   - the grid is (receiver row, feature tile); the TPU kernel's scalar
//     prefetch of idx and the weights becomes one load per block;
//   - each thread takes 4 consecutive columns: float4 loads and stores of p
//     and out, and one 16-, 8- or 4-byte word of ring row by format, so
//     neighbouring threads touch neighbouring words and loads coalesce;
//   - the ring stays at wire width in device memory: a bfloat16 row of the
//     port's 73,420-column stride is only 8-byte aligned and an int8 row
//     4-byte aligned, which the 4-column word respects (F a multiple of 4);
//     any other shape takes the scalar form of the same kernel;
//   - leaves are packed with no padding, so one 4-column word may straddle
//     a leaf edge: each of its columns gets its own leaf (wire_rows.cuh),
//     from a start table and scale row in shared memory. The TPU kernel
//     pads every leaf to 512 columns instead.
//
// Numerics: built with --fmad=false, so the products and the sum round as
// the plain PyTorch version rounds them: the two agree bit for bit.
//
// C interface for ctypes. The launch goes on the caller's stream and does
// not synchronise; each function returns cudaGetLastError() after it.

#include <cuda_runtime.h>
#include <stdint.h>

#include "wire_rows.cuh"

namespace {

constexpr int kThreads = 256;

template <bool kScaled>
__device__ __forceinline__ void load_leaf_tables(const float* scale,
                                                 const int32_t* start, int L,
                                                 int64_t peer, int32_t* s_start,
                                                 float* s_scale) {
  if (kScaled) {
    for (int t = threadIdx.x; t < L; t += blockDim.x) {
      s_start[t] = start[t];
      s_scale[t] = scale[peer * L + t];
    }
    __syncthreads();
  }
}

// f is a multiple of 4; cols = f / 4 words per row.
template <typename T, bool kScaled>
__global__ void flat_vec4(const float4* __restrict__ p,
                          const T* __restrict__ h,
                          const int32_t* __restrict__ idx,
                          const float* __restrict__ ws,
                          const float* __restrict__ wp,
                          const float* __restrict__ scale,
                          const int32_t* __restrict__ start, int L,
                          float4* __restrict__ out, int64_t f) {
  __shared__ int32_t s_start[wire::kMaxLeaves];
  __shared__ float s_scale[wire::kMaxLeaves];
  const int64_t row = blockIdx.x;
  load_leaf_tables<kScaled>(scale, start, L, idx[row], s_start, s_scale);
  const int64_t cols = f / 4;
  const int64_t col = (int64_t)blockIdx.y * blockDim.x + threadIdx.x;
  if (col >= cols) return;
  const float a = ws[row];
  const float w = wp[row];
  float4 v = wire::load4(h + (int64_t)idx[row] * f, 4 * col);
  if (kScaled) {
    const int4 l = wire::leaves4(s_start, L, 4 * col);
    v.x = v.x * s_scale[l.x];
    v.y = v.y * s_scale[l.y];
    v.z = v.z * s_scale[l.z];
    v.w = v.w * s_scale[l.w];
  }
  const float4 x = p[row * cols + col];
  float4 o;
  o.x = a * x.x + w * v.x;
  o.y = a * x.y + w * v.y;
  o.z = a * x.z + w * v.z;
  o.w = a * x.w + w * v.w;
  out[row * cols + col] = o;
}

template <typename T, bool kScaled>
__global__ void flat_scalar(const float* __restrict__ p,
                            const T* __restrict__ h,
                            const int32_t* __restrict__ idx,
                            const float* __restrict__ ws,
                            const float* __restrict__ wp,
                            const float* __restrict__ scale,
                            const int32_t* __restrict__ start, int L,
                            float* __restrict__ out, int64_t f) {
  __shared__ int32_t s_start[wire::kMaxLeaves];
  __shared__ float s_scale[wire::kMaxLeaves];
  const int64_t row = blockIdx.x;
  load_leaf_tables<kScaled>(scale, start, L, idx[row], s_start, s_scale);
  const int64_t col = (int64_t)blockIdx.y * blockDim.x + threadIdx.x;
  if (col >= f) return;
  float v = wire::widen(h[(int64_t)idx[row] * f + col]);
  if (kScaled) v = v * s_scale[wire::leaf_of(s_start, L, col)];
  out[row * f + col] = ws[row] * p[row * f + col] + wp[row] * v;
}

template <typename T, bool kScaled>
int launch(const void* p, const void* h, const void* idx, const void* ws,
           const void* wp, const void* scale, const void* start, int L,
           void* out, int64_t n, int64_t f, cudaStream_t st) {
  const bool vec = (f % 4 == 0) && wire::aligned(p, 16) &&
                   wire::aligned(out, 16) && wire::aligned(h, 4 * sizeof(T));
  const int64_t cols = vec ? f / 4 : f;
  const int64_t tiles = (cols + kThreads - 1) / kThreads;
  if (tiles > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)n, (unsigned)tiles);
  const T* hh = static_cast<const T*>(h);
  const int32_t* ii = static_cast<const int32_t*>(idx);
  const float* a = static_cast<const float*>(ws);
  const float* w = static_cast<const float*>(wp);
  const float* sc = static_cast<const float*>(scale);
  const int32_t* so = static_cast<const int32_t*>(start);
  if (vec) {
    flat_vec4<T, kScaled><<<grid, kThreads, 0, st>>>(
        static_cast<const float4*>(p), hh, ii, a, w, sc, so, L,
        static_cast<float4*>(out), f);
  } else {
    flat_scalar<T, kScaled><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(p), hh, ii, a, w, sc, so, L,
        static_cast<float*>(out), f);
  }
  return (int)cudaGetLastError();
}

bool bad_shape(int64_t n, int64_t f) {
  return n < 1 || f < 1 || n > 0x7fffffff || f > 0x7fffffff;
}

}  // namespace

// K3. p, out: [n, f] float32; h: [m, f] float32; idx: [n] int32 in [0, m);
// ws, wp: [n] float32. All row-major and contiguous.
extern "C" int gather_merge_flat(const void* p, const void* h, const void* idx,
                                 const void* ws, const void* wp, void* out,
                                 int64_t n, int64_t f, void* stream) {
  if (bad_shape(n, f)) return (int)cudaErrorInvalidValue;
  return launch<float, false>(p, h, idx, ws, wp, nullptr, nullptr, 0, out, n,
                              f, static_cast<cudaStream_t>(stream));
}

// K4. As gather_merge_flat with h: [m, f] in wire format `format`: a
// bfloat16 ring with no scale (scale null), or a float32, bfloat16 or int8
// ring with scale: [m, L] float32, one scale per (ring row, leaf), and
// start: [L] int32 leaf start columns (start[0] == 0, increasing, each
// < f). The float32 ring with no scale is K3's.
extern "C" int gather_merge_flat_dq(const void* p, const void* h, int format,
                                    const void* idx, const void* ws,
                                    const void* wp, const void* scale,
                                    const void* start, int64_t n_leaves,
                                    void* out, int64_t n, int64_t f,
                                    void* stream) {
  if (bad_shape(n, f)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (scale == nullptr) {
    if (format != wire::kBFloat16) return (int)cudaErrorInvalidValue;
    return launch<uint16_t, false>(p, h, idx, ws, wp, nullptr, nullptr, 0,
                                   out, n, f, st);
  }
  if (start == nullptr || n_leaves < 1 || n_leaves > wire::kMaxLeaves)
    return (int)cudaErrorInvalidValue;
  const int L = (int)n_leaves;
  switch (format) {
    case wire::kFloat32:
      return launch<float, true>(p, h, idx, ws, wp, scale, start, L, out, n,
                                 f, st);
    case wire::kBFloat16:
      return launch<uint16_t, true>(p, h, idx, ws, wp, scale, start, L, out,
                                    n, f, st);
    case wire::kInt8:
      return launch<int8_t, true>(p, h, idx, ws, wp, scale, start, L, out, n,
                                  f, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
