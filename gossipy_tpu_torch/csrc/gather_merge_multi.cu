// Multi-slot gather-merge: drain a K-slot mailbox into every receiver row
// in one launch.
//
// Replaces the TPU kernel gossipy_tpu/ops/merge.py::_multi_kernel. For each
// receiver row i it folds the K slots left to right,
//
//     out = p[i];  for k < K:  out = ws[i,k] * out + (wp[i,k] != 0 ? wp[i,k] * h[idx[i,k]] : 0)
//
// where h is the flat [D*N, F] snapshot ring. An empty slot carries
// (ws, wp) = (1, 0) and an arbitrary in-range index whose ring row may hold
// anything, NaN or Inf included: its row is never read, and its term is 0,
// never 0 * row.
//
// Bound: memory. The fold does 3 flops per live slot per element against
// 4 bytes per element per row moved, far below the card's ratio of flops
// to bytes. The least traffic is p read once, out written once and each
// live peer row read once: 4 * F * (2 * rows + live rows) bytes, plus the
// [N, K] tables. The design keeps that traffic and nothing more:
//   - the grid is (receiver row, feature tile); blocks run in parallel, in
//     no order, so the TPU's slot-minor grid axis becomes a loop over k
//     inside the thread, with the running sum in registers;
//   - each block loads its row's K indices and weights into shared memory
//     (the TPU kernel's scalar prefetch);
//   - p is read once and out written once per element; a peer row is read
//     only when its slot is live (wp != 0) — the test is uniform across a
//     block, since a block covers one row;
//   - neighbouring threads touch neighbouring 16-byte words (float4), so
//     loads and stores coalesce. The vector form needs F to be a multiple
//     of 4 and 16-byte aligned bases; the port pads its flat parameter and
//     ring rows to a stride that is a multiple of 4 floats for that. Any
//     other shape takes the scalar form of the same kernel.
//
// Numerics: built with --fmad=false, so `ws * out + term` is a multiply
// then an add, rounded as the plain PyTorch version rounds them (two
// elementwise kernels, no contraction): the two agree bit for bit.
//
// C interface for ctypes. The launch goes on the caller's stream and does
// not synchronise; the function returns cudaGetLastError() after it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSlots = 64;

__device__ __forceinline__ float4 fold(float a, float w, float4 acc, float4 v,
                                       bool live) {
  float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
  if (live) {
    t.x = w * v.x;
    t.y = w * v.y;
    t.z = w * v.z;
    t.w = w * v.w;
  }
  acc.x = a * acc.x + t.x;
  acc.y = a * acc.y + t.y;
  acc.z = a * acc.z + t.z;
  acc.w = a * acc.w + t.w;
  return acc;
}

__device__ __forceinline__ void load_tables(const int32_t* idx, const float* ws,
                                            const float* wp, int64_t row, int k,
                                            int32_t* s_idx, float* s_ws,
                                            float* s_wp) {
  for (int t = threadIdx.x; t < k; t += blockDim.x) {
    s_idx[t] = idx[row * k + t];
    s_ws[t] = ws[row * k + t];
    s_wp[t] = wp[row * k + t];
  }
  __syncthreads();
}

// cols = F / 4 float4 words per row.
__global__ void gather_merge_multi_vec4(const float4* __restrict__ p,
                                        const float4* __restrict__ h,
                                        const int32_t* __restrict__ idx,
                                        const float* __restrict__ ws,
                                        const float* __restrict__ wp,
                                        float4* __restrict__ out, int64_t cols,
                                        int k) {
  __shared__ int32_t s_idx[kMaxSlots];
  __shared__ float s_ws[kMaxSlots];
  __shared__ float s_wp[kMaxSlots];
  const int64_t row = blockIdx.x;
  load_tables(idx, ws, wp, row, k, s_idx, s_ws, s_wp);
  const int64_t col = (int64_t)blockIdx.y * blockDim.x + threadIdx.x;
  if (col >= cols) return;
  float4 acc = p[row * cols + col];
  for (int s = 0; s < k; ++s) {
    const float w = s_wp[s];
    const bool live = w != 0.f;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (live) v = h[(int64_t)s_idx[s] * cols + col];
    acc = fold(s_ws[s], w, acc, v, live);
  }
  out[row * cols + col] = acc;
}

__global__ void gather_merge_multi_scalar(const float* __restrict__ p,
                                          const float* __restrict__ h,
                                          const int32_t* __restrict__ idx,
                                          const float* __restrict__ ws,
                                          const float* __restrict__ wp,
                                          float* __restrict__ out, int64_t cols,
                                          int k) {
  __shared__ int32_t s_idx[kMaxSlots];
  __shared__ float s_ws[kMaxSlots];
  __shared__ float s_wp[kMaxSlots];
  const int64_t row = blockIdx.x;
  load_tables(idx, ws, wp, row, k, s_idx, s_ws, s_wp);
  const int64_t col = (int64_t)blockIdx.y * blockDim.x + threadIdx.x;
  if (col >= cols) return;
  float acc = p[row * cols + col];
  for (int s = 0; s < k; ++s) {
    const float w = s_wp[s];
    float t = 0.f;
    if (w != 0.f) t = w * h[(int64_t)s_idx[s] * cols + col];
    acc = s_ws[s] * acc + t;
  }
  out[row * cols + col] = acc;
}

bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15u) == 0;
}

}  // namespace

// p, out: [n, f] float32; h: [m, f] float32; idx: [n, k] int32 in [0, m)
// wherever wp != 0; ws, wp: [n, k] float32. All row-major and contiguous.
extern "C" int gather_merge_multi(const void* p, const void* h, const void* idx,
                                  const void* ws, const void* wp, void* out,
                                  int64_t n, int64_t f, int64_t k,
                                  void* stream) {
  if (k < 1 || k > kMaxSlots || n < 1 || f < 1 || n > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = (f % 4 == 0) && aligned16(p) && aligned16(h) &&
                   aligned16(out);
  const int64_t cols = vec ? f / 4 : f;
  const int64_t tiles = (cols + kThreads - 1) / kThreads;
  if (tiles > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)n, (unsigned)tiles);
  if (vec) {
    gather_merge_multi_vec4<<<grid, kThreads, 0, st>>>(
        static_cast<const float4*>(p), static_cast<const float4*>(h),
        static_cast<const int32_t*>(idx), static_cast<const float*>(ws),
        static_cast<const float*>(wp), static_cast<float4*>(out), cols,
        (int)k);
  } else {
    gather_merge_multi_scalar<<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(p), static_cast<const float*>(h),
        static_cast<const int32_t*>(idx), static_cast<const float*>(ws),
        static_cast<const float*>(wp), static_cast<float*>(out), cols, (int)k);
  }
  return (int)cudaGetLastError();
}
