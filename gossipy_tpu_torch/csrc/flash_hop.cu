// Flash-attention hop, wide float32 route: absorb one key/value chunk into
// the per-query streaming-softmax carry (m, l, acc), with the score block
// kept on chip.
//
// Replaces the TPU kernel gossipy_tpu/ops/attention.py::_hop_kernel (K5)
// for float32 q, k and v whose D or Dv lies above 128 (up to 256), entry
// point flash_hop. Narrower float32 heads go to flash_hop_tf32.cu (3xTF32
// on the tensor cores), bfloat16 operands to flash_hop_sm90.cu; both
// replaced instances of this file. For each query row i and key row j of
// the chunk,
//
//     s[i,j] = scale * (q[i] . k[j]),  masked (-> kNeg) where j >= sl_k or,
//              when causal, where k_off + j > q_off + i (global positions);
//     m_new  = max(m[i], max_j s[i,j]);   alpha = exp(m[i] - m_new);
//     p[i,j] = masked ? 0 : exp(s[i,j] - m_new);
//     acc[i] = alpha * acc[i] + sum_j p[i,j] v[j];
//     l[i]   = alpha * l[i] + sum_j p[i,j];   m[i] = m_new.
//
// The TPU kernel applies this update once per 512-key block; this kernel
// once per 64-key tile. The two are equal up to rounding (a finer blocking
// of the same streaming softmax); the plain PyTorch version streams as the
// TPU kernel does and the two are held to a tolerance. A row whose tile is
// wholly masked keeps its carry (p = 0, and alpha = exp(0) = 1 while
// m >= kNeg), as in the TPU kernel.
//
// Bound: operations. Per (query, key) pair the kernel does D + Dv
// multiply-adds against q, k and v read once (D=128: a few hundred
// operations per byte), far above what the card's memory needs; its least
// time is the pairs' 2 (D + Dv) flops at the float32 rate outside the
// tensor cores (which would round float32 operands). This kernel runs on
// the CUDA cores in float32 (no tensor cores, TMA or wgmma) and keeps the
// score block out of device memory, which is the point of the TPU kernel:
//   - a block of 128 threads owns 32 query rows: it loads its q tile into
//     shared memory once, then streams 64-row k and v tiles
//     through shared memory;
//   - each thread holds a 4 x 4 patch of the score tile (rows 4ty..4ty+3,
//     keys tx, tx+16, tx+32, tx+48) in registers; row max and row sum are
//     taken across the 16 threads of a row group with warp shuffles;
//   - p goes to shared memory only (32 x 64 floats), and each thread
//     accumulates its 4 rows x 4*NG columns of acc in registers, carried
//     across all tiles and written once at the end;
//   - shared rows are padded to an odd number of 16-byte words, so the
//     float4 reads of 8 consecutive threads hit distinct banks;
//   - causal: a k tile wholly after the block's last query is skipped (it
//     would leave the carry bit-identical), and blocks start in reverse
//     order so the longest ones are scheduled first;
//   - ragged sl_q and sl_k are masked in the kernel; no padding copies.
//
// Numerics: the dot products and the p v sums use explicit fmaf (the
// build's --fmad=false only stops the compiler from contracting), expf
// (not __expf, whose error grows for arguments near kNeg), float32
// throughout.
//
// C interface for ctypes. The launch goes on the caller's stream and does
// not synchronise; the function returns cudaGetLastError() after it.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "wire_rows.cuh"

namespace {

constexpr int kBlockQ = 32;     // query rows per block
constexpr int kBlockK = 64;     // key rows per tile
constexpr int kThreads = 128;   // 8 row groups x 16 key groups
constexpr int kWarps = kThreads / 32;
constexpr int kLdP = kBlockK + 4;  // row stride of the p tile (floats)
constexpr int kMaxDim = 256;
constexpr float kNeg = -1e30f;

// Row stride (floats) of the q and k tiles for head dim `dim`: the dim
// rounded up to 4, then to an odd number of 16-byte words.
__host__ __device__ inline int row_stride(int dim) {
  const int d4 = (dim + 3) & ~3;
  return ((d4 / 4) & 1) ? d4 : d4 + 4;
}

__host__ __device__ inline size_t smem_bytes(int dim, int ng) {
  const int ld = row_stride(dim);
  return sizeof(float) * ((size_t)kBlockQ * ld + (size_t)kBlockK * ld +
                          (size_t)kBlockK * 64 * ng + (size_t)kBlockQ * kLdP);
}

// Rows [row0, row0 + rows) of a [n_rows, dim] matrix into shared memory as
// float32, `width` columns per row at stride `ld`; rows past n_rows and
// columns past dim are 0. One warp per row, 4 columns per lane when `vec`
// (dim % 4 == 0 and the rows are aligned to 4 values).
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src,
                                          int64_t row0, int rows,
                                          int64_t n_rows, int dim, int width,
                                          bool vec) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < rows; r += kWarps) {
    const int64_t g = row0 + r;
    const bool live = g < n_rows;
    const T* row = src + g * dim;
    float* out = dst + r * ld;
    if (vec) {
      for (int c = 4 * lane; c < width; c += 128) {
        float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
        if (live && c < dim) x = wire::load4(row, c);
        *reinterpret_cast<float4*>(out + c) = x;
      }
    } else {
      for (int c = lane; c < width; c += 32) {
        out[c] = (live && c < dim) ? wire::widen(row[c]) : 0.f;
      }
    }
  }
}

__device__ __forceinline__ float row_max16(float x) {
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float row_sum16(float x) {
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float comp(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// NG: acc columns in groups of 64 (Dv <= 64 * NG); a thread holds columns
// 64 g + 4 tx + {0..3} of each group.
template <typename T, int NG>
__global__ void __launch_bounds__(kThreads)
    hop_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const float* __restrict__ m_in,
               const float* __restrict__ l_in,
               const float* __restrict__ acc_in, float* __restrict__ m_out,
               float* __restrict__ l_out, float* __restrict__ acc_out,
               int sl_q, int sl_k, int dim, int dv, int64_t q_off,
               int64_t k_off, float scale, int causal, bool vec_qk,
               bool vec_v) {
  extern __shared__ __align__(16) float smem[];
  constexpr int kDvp = 64 * NG;
  const int ld = row_stride(dim);
  const int d4 = (dim + 3) & ~3;
  float* sq = smem;
  float* sk = sq + kBlockQ * ld;
  float* sv = sk + kBlockK * ld;
  float* sp = sv + kBlockK * kDvp;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int qt = causal ? (int)(gridDim.x - 1 - blockIdx.x) : (int)blockIdx.x;
  const int q0 = qt * kBlockQ;

  // The carry of this thread's 4 rows (replicated over the row's 16
  // threads) and its 4 x 4NG patch of acc.
  float m_r[4], l_r[4], acc[4][4 * NG];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = q0 + 4 * ty + r;
    const bool live = row < sl_q;
    m_r[r] = live ? m_in[row] : kNeg;
    l_r[r] = live ? l_in[row] : 0.f;
#pragma unroll
    for (int g = 0; g < NG; ++g) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = 64 * g + 4 * tx + i;
        acc[r][4 * g + i] =
            (live && c < dv) ? acc_in[(int64_t)row * dv + c] : 0.f;
      }
    }
  }
  load_tile(sq, ld, q, q0, kBlockQ, sl_q, dim, d4, vec_qk);

  const int n_kt = (sl_k + kBlockK - 1) / kBlockK;
  int need = n_kt;
  if (causal) {
    // Tile kt holds a key at or before the block's last query iff
    // k_off + kt * kBlockK <= q_off + last row.
    const int64_t last = q_off + min(q0 + kBlockQ, sl_q) - 1 - k_off;
    need = last < 0 ? 0 : (int)min((int64_t)n_kt, last / kBlockK + 1);
  }
  // Key j of a tile is causally masked for row i iff j - i > diag.
  const int64_t diag = q_off - k_off;

  for (int kt = 0; kt < need; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();  // the previous tile's k, v and p are consumed
    load_tile(sk, ld, k, k0, kBlockK, sl_k, dim, d4, vec_qk);
    load_tile(sv, kDvp, v, k0, kBlockK, sl_k, dv, kDvp, vec_v);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
    for (int d = 0; d < d4; d += 4) {
      float4 a[4], b[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        a[r] = *reinterpret_cast<const float4*>(sq + (4 * ty + r) * ld + d);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        b[c] = *reinterpret_cast<const float4*>(sk + (tx + 16 * c) * ld + d);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float x = s[r][c];
          x = fmaf(a[r].x, b[c].x, x);
          x = fmaf(a[r].y, b[c].y, x);
          x = fmaf(a[r].z, b[c].z, x);
          x = fmaf(a[r].w, b[c].w, x);
          s[r][c] = x;
        }
    }

#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = q0 + 4 * ty + r;
      bool bad[4];
      float mx = kNeg;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = k0 + tx + 16 * c;
        bad[c] = j >= sl_k || (causal && (int64_t)(j - i) > diag);
        s[r][c] = bad[c] ? kNeg : s[r][c] * scale;
        mx = fmaxf(mx, s[r][c]);
      }
      const float m_new = fmaxf(m_r[r], row_max16(mx));
      const float alpha = expf(m_r[r] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = bad[c] ? 0.f : expf(s[r][c] - m_new);
        sp[(4 * ty + r) * kLdP + tx + 16 * c] = p;
        sum += p;
      }
      l_r[r] = l_r[r] * alpha + row_sum16(sum);
      m_r[r] = m_new;
#pragma unroll
      for (int j = 0; j < 4 * NG; ++j) acc[r][j] *= alpha;
    }
    __syncthreads();

    for (int j = 0; j < kBlockK; j += 4) {
      float4 p4[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        p4[r] = *reinterpret_cast<const float4*>(sp + (4 * ty + r) * kLdP + j);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
        for (int g = 0; g < NG; ++g) {
          const float4 w = *reinterpret_cast<const float4*>(
              sv + (j + jj) * kDvp + 64 * g + 4 * tx);
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float pr = comp(p4[r], jj);
            acc[r][4 * g + 0] = fmaf(pr, w.x, acc[r][4 * g + 0]);
            acc[r][4 * g + 1] = fmaf(pr, w.y, acc[r][4 * g + 1]);
            acc[r][4 * g + 2] = fmaf(pr, w.z, acc[r][4 * g + 2]);
            acc[r][4 * g + 3] = fmaf(pr, w.w, acc[r][4 * g + 3]);
          }
        }
      }
    }
  }

  // The skipped causal tiles, as the TPU kernel would apply them: wholly
  // masked, so m = max(m, kNeg) and the carry scales by exp(m_old - m),
  // which is exactly 1 unless the incoming m lies below kNeg.
  if (need < n_kt) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float m_new = fmaxf(m_r[r], kNeg);
      const float alpha = expf(m_r[r] - m_new);
      l_r[r] = l_r[r] * alpha;
      m_r[r] = m_new;
#pragma unroll
      for (int j = 0; j < 4 * NG; ++j) acc[r][j] *= alpha;
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = q0 + 4 * ty + r;
    if (row >= sl_q) continue;
    if (tx == 0) {
      m_out[row] = m_r[r];
      l_out[row] = l_r[r];
    }
#pragma unroll
    for (int g = 0; g < NG; ++g) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = 64 * g + 4 * tx + i;
        if (c < dv) acc_out[(int64_t)row * dv + c] = acc[r][4 * g + i];
      }
    }
  }
}

template <typename T, int NG>
int launch(const void* q, const void* k, const void* v, const void* m,
           const void* l, const void* acc, void* m_out, void* l_out,
           void* acc_out, int sl_q, int sl_k, int dim, int dv, int64_t q_off,
           int64_t k_off, float scale, int causal, cudaStream_t st) {
  // Above 48 KB a block's dynamic shared memory must be allowed first; allow
  // the most any head dim needs, once per instance.
  static bool allowed = false;
  if (!allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        hop_kernel<T, NG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_bytes(kMaxDim, NG));
    if (err != cudaSuccess) return (int)err;
    allowed = true;
  }
  const size_t bytes = smem_bytes(dim, NG);
  const bool vec_qk = dim % 4 == 0 && wire::aligned(q, 4 * sizeof(T)) &&
                      wire::aligned(k, 4 * sizeof(T));
  const bool vec_v = dv % 4 == 0 && wire::aligned(v, 4 * sizeof(T));
  const int blocks = (sl_q + kBlockQ - 1) / kBlockQ;
  hop_kernel<T, NG><<<blocks, kThreads, bytes, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(m),
      static_cast<const float*>(l), static_cast<const float*>(acc),
      static_cast<float*>(m_out), static_cast<float*>(l_out),
      static_cast<float*>(acc_out), sl_q, sl_k, dim, dv, q_off, k_off, scale,
      causal, vec_qk, vec_v);
  return (int)cudaGetLastError();
}

int launch_dv(const void* q, const void* k, const void* v, const void* m,
              const void* l, const void* acc, void* m_out, void* l_out,
              void* acc_out, int sl_q, int sl_k, int dim, int dv,
              int64_t q_off, int64_t k_off, float scale, int causal,
              cudaStream_t st) {
  switch ((dv + 63) / 64) {
    case 1:
      return launch<float, 1>(q, k, v, m, l, acc, m_out, l_out, acc_out, sl_q,
                              sl_k, dim, dv, q_off, k_off, scale, causal, st);
    case 2:
      return launch<float, 2>(q, k, v, m, l, acc, m_out, l_out, acc_out, sl_q,
                              sl_k, dim, dv, q_off, k_off, scale, causal, st);
    case 3:
      return launch<float, 3>(q, k, v, m, l, acc, m_out, l_out, acc_out, sl_q,
                              sl_k, dim, dv, q_off, k_off, scale, causal, st);
    case 4:
      return launch<float, 4>(q, k, v, m, l, acc, m_out, l_out, acc_out, sl_q,
                              sl_k, dim, dv, q_off, k_off, scale, causal, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// K5, float32 route. q: [sl_q, dim], k: [sl_k, dim], v: [sl_k, dv],
// m, l, m_out, l_out: [sl_q]; acc, acc_out: [sl_q, dv]; all float32,
// row-major and contiguous; 1 <= dim, dv <= 256. q_off, k_off: the chunks'
// global row offsets; causal: 0 or 1.
extern "C" int flash_hop(const void* q, const void* k, const void* v,
                         const void* m, const void* l, const void* acc,
                         void* m_out, void* l_out, void* acc_out,
                         int64_t sl_q, int64_t sl_k, int64_t dim, int64_t dv,
                         int64_t q_off, int64_t k_off, float scale,
                         int causal, void* stream) {
  if (sl_q < 1 || sl_k < 1 || sl_q > 0x7fffffff - kBlockQ ||
      sl_k > 0x7fffffff - kBlockK || dim < 1 || dim > kMaxDim || dv < 1 ||
      dv > kMaxDim)
    return (int)cudaErrorInvalidValue;
  return launch_dv(q, k, v, m, l, acc, m_out, l_out, acc_out, (int)sl_q,
                   (int)sl_k, (int)dim, (int)dv, q_off, k_off, scale, causal,
                   static_cast<cudaStream_t>(stream));
}
