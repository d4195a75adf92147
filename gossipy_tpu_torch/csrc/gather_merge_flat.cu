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
// kernel reads it straight from the ring's [M, L] sidecar (the TPU kernel
// takes the scales gathered outside it) and finds the leaf in the [L]
// table of leaf start columns. As in the TPU kernel there is no
// zero-weight mask: a receiver without a message (wp = 0) is blended all
// the same, a non-finite ring row behind it included, and the caller
// discards its row.
//
// Bound: memory. Per element 2 multiplies and an add (a third multiply for
// a scaled ring) against 8 bytes of p and out plus 4, 2 or 1 bytes of ring
// row, far below the card's ratio of operations to bytes. The least
// traffic is p read once, out written once and each named ring row read
// once at wire width, plus the tables. At the token north star's shape
// (100 rows of 116 columns) that is 116 KB: the call sits at the launch's
// floor and the chain of dependent loads (the index, then the ring row).
// What held the block-per-(row, tile) kernel this replaces back, and what
// the layout does about it:
//   - a second launch a call: its wrapper cast the engine's int64 index
//     to int32. The kernel reads the int64 table as it is.
//   - one geometry for every width: a 256-lane block per (row, tile), one
//     word a lane, so 29 of 256 lanes worked on LogReg's 116 columns and
//     every block paid its own chain. Rows map to lanes by width instead,
//     as in gather_merge_multi.cu. A row of at most 32 words (4 columns a
//     word in the vector form, 1 in the scalar form) goes to a group of G
//     lanes, G the power of two at or above its words, and a block holds
//     blockDim / G rows: LogReg's row takes G = 32, 8 rows a block, 13
//     blocks for 100 rows. A wider row (CIFAR10Net's 73,420 columns) goes
//     to a block per (row, tile), each lane taking kWideWords (2) words of
//     the tile, all of them loaded before the first is blended; the tiles
//     of a row are of one size (ceil(words / tiles)), so the last is not
//     mostly empty. ops/merge.py::flat_plan picks the route, G, the block,
//     the grid and the tile; the entry points check what they get.
//   - the chain: lane 0 of each group loads the row's index and weights
//     and shares them by __shfl_sync; every lane loads its words of p
//     before that, so only index -> ring word is serial.
//   - the scaled form waited on its tables: a barrier staging the leaf
//     starts and the row's scales came before the first ring load. Here a
//     lane loads its share of the starts at the top, beside its p words
//     and the index, and the scale of a word's first column comes from
//     the sidecar beside the ring word (a word across a leaf edge reads
//     its others when it blends). The barrier that stages the starts goes
//     where it costs least: on the narrow route under the index's
//     latency, so the ring word and its scale go out together as the one
//     dependent step; on the wide route after the ring words, so it does
//     not hold back the bytes the call is bound by (PERF.md gives both
//     orders' times). A lane's words lie in increasing columns, so one
//     search finds the first word's leaf and a cursor the others', one
//     read of the table for a word inside one leaf.
// Tried and taken out (PERF.md gives the times): programmatic dependent
// launch, which overlaps a launch with the grid before it on the stream
// only where that grid releases it early, as no kernel before K3/K4 on
// the engine's path does; and 1-D bulk copies (cp.async.bulk) of a
// block's tile of p and of the ring row into shared memory behind an
// mbarrier, 5-6% behind these register loads on K3's wide route (a block
// blends nothing until its whole tile has landed).
// A vector word is a float4 of p and out and a 16-byte (float32), 8-byte
// (bfloat16) or 4-byte (int8) word of ring row, which the ring's row
// alignment allows (wire_rows.cuh); any other shape takes the scalar form
// with the same routes.
//
// Numerics: built with --fmad=false, so the products and the sum round as
// the plain PyTorch version rounds them: the two agree bit for bit, the
// signs of zeros included.
//
// C interface for ctypes. The launch goes on the caller's stream and does
// not synchronise; each function returns cudaErrorInvalidValue for a call
// or plan it does not take, else cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "wire_rows.cuh"

namespace {

constexpr int kWarp = 32;
constexpr int kMaxThreads = 256;
constexpr int kWideWords = 2;  // words a lane on the wide route
constexpr unsigned kFull = 0xffffffffu;

// The launch plan's values: see ops/merge.py::FlatPlan.
struct Plan {
  int vec, wide, g_log2, threads;
  int64_t grid_x, grid_y, tile;
};

// One ring word widened to float32.
template <typename T>
__device__ __forceinline__ void load_word(float4& v, const T* row,
                                          int64_t word) {
  v = wire::load4(row, 4 * word);
}
template <typename T>
__device__ __forceinline__ void load_word(float& v, const T* row,
                                          int64_t word) {
  v = wire::widen(row[word]);
}

// The leaves of a word's columns, searching forward from leaf `from` (the
// leaf of an earlier column of the same lane). A word inside one leaf, the
// common case, costs one read of the table.
__device__ __forceinline__ int leaf_from(const int32_t* start, int L,
                                         int64_t c, int from) {
  int l = from;
  while (l + 1 < L && start[l + 1] <= c) ++l;
  return l;
}
__device__ __forceinline__ void leaves_from(int4& l, const int32_t* start,
                                            int L, int64_t word, int from) {
  const int64_t c = 4 * word;
  l.x = leaf_from(start, L, c, from);
  if (l.x + 1 >= L || start[l.x + 1] > c + 3) {
    l.y = l.z = l.w = l.x;
    return;
  }
  l.y = leaf_from(start, L, c + 1, l.x);
  l.z = leaf_from(start, L, c + 2, l.y);
  l.w = leaf_from(start, L, c + 3, l.z);
}
__device__ __forceinline__ void leaves_from(int& l, const int32_t* start,
                                            int L, int64_t word, int from) {
  l = leaf_from(start, L, word, from);
}
__device__ __forceinline__ int first_leaf(const int4& l) { return l.x; }
__device__ __forceinline__ int first_leaf(int l) { return l; }
__device__ __forceinline__ int last_leaf(const int4& l) { return l.w; }
__device__ __forceinline__ int last_leaf(int l) { return l; }

// v times its columns' scales: `first`, the first column's, loaded with
// the word; a word across a leaf edge reads the others from the row's
// scales `sc`.
__device__ __forceinline__ void scale_word(float4& v, float first,
                                           const float* sc, const int4& l) {
  const bool one = l.x == l.w;
  v.x = v.x * first;
  v.y = v.y * (one ? first : sc[l.y]);
  v.z = v.z * (one ? first : sc[l.z]);
  v.w = v.w * (one ? first : sc[l.w]);
}
__device__ __forceinline__ void scale_word(float& v, float first,
                                           const float*, int) {
  v = v * first;
}

// out = a * x + w * v, element by element.
__device__ __forceinline__ float4 blend(float a, const float4& x, float w,
                                        const float4& v) {
  float4 o;
  o.x = a * x.x + w * v.x;
  o.y = a * x.y + w * v.y;
  o.z = a * x.z + w * v.z;
  o.w = a * x.w + w * v.w;
  return o;
}
__device__ __forceinline__ float blend(float a, float x, float w, float v) {
  return a * x + w * v;
}

// Both routes. Narrow (kWide false): lane t of block x takes row
// x * (blockDim / G) + t / G and word t % G. Wide: lane t of block (x, y)
// takes row x and words y * tile + i * blockDim + t, i < kWideWords, that
// lie inside the tile and the row; G is a warp.
template <typename T, bool kVec, bool kScaled, bool kWide>
__global__ void __launch_bounds__(kMaxThreads)
    flat_rows(const float* __restrict__ p, const T* __restrict__ h,
              const int64_t* __restrict__ idx, const float* __restrict__ ws,
              const float* __restrict__ wp, const float* __restrict__ scale,
              const int32_t* __restrict__ start, int L,
              float* __restrict__ out, int64_t n, int64_t f, int g_log2,
              int64_t tile) {
  constexpr int kWords = kWide ? kWideWords : 1;
  using W = std::conditional_t<kVec, float4, float>;
  using Leaf = std::conditional_t<kVec, int4, int>;
  const int G = 1 << g_log2;
  const int64_t words = kVec ? f / 4 : f;
  int64_t row, word[kWords];
  bool ok[kWords];
  if constexpr (kWide) {
    row = blockIdx.x;
    const int64_t base = (int64_t)blockIdx.y * tile;
    const int64_t end = base + tile < words ? base + tile : words;
#pragma unroll
    for (int i = 0; i < kWords; ++i) {
      word[i] = base + (int64_t)i * blockDim.x + threadIdx.x;
      ok[i] = word[i] < end;
    }
  } else {
    row = (int64_t)blockIdx.x * (blockDim.x >> g_log2) +
          (threadIdx.x >> g_log2);
    word[0] = threadIdx.x & (G - 1);
    ok[0] = row < n && word[0] < words;
  }
  const bool row_ok = row < n;

  // The scaled form's share of the leaf starts, loaded first.
  int32_t my_start = 0;
  if constexpr (kScaled) {
    if (threadIdx.x < L) my_start = start[threadIdx.x];
  }
  // The receiver's words, then the row's index and weights from lane 0 of
  // the group.
  W x[kWords];
#pragma unroll
  for (int i = 0; i < kWords; ++i) {
    if (ok[i]) x[i] = reinterpret_cast<const W*>(p)[row * words + word[i]];
  }
  int64_t j = 0;
  float a = 0.f, w = 0.f;
  if (row_ok && (threadIdx.x & (G - 1)) == 0) {
    j = idx[row];
    a = ws[row];
    w = wp[row];
  }
  // The scaled form stages the starts in shared memory behind its one
  // barrier and finds its words' leaves: one search, then a cursor
  // forward, the lane's words lying in increasing columns. On the narrow
  // route it does so while the index is in flight, so that the ring word
  // and the scale of its first column go out together, the one dependent
  // step; on the wide route the ring words go out first, so that the
  // barrier does not hold back the bytes the call is bound by.
  Leaf leaf[kWords];
  auto stage_leaves = [&]() {
    extern __shared__ int32_t s_start[];  // [L]
    if (threadIdx.x < L) s_start[threadIdx.x] = my_start;
    for (int t = threadIdx.x + blockDim.x; t < L; t += blockDim.x)
      s_start[t] = start[t];
    __syncthreads();
    int from = 0;
#pragma unroll
    for (int i = 0; i < kWords; ++i) {
      if (ok[i]) {
        if (i == 0)
          from = wire::leaf_of(s_start, L, kVec ? 4 * word[0] : word[0]);
        leaves_from(leaf[i], s_start, L, word[i], from);
        from = last_leaf(leaf[i]);
      }
    }
  };
  if constexpr (kScaled && !kWide) stage_leaves();
  j = __shfl_sync(kFull, j, 0, G);
  a = __shfl_sync(kFull, a, 0, G);
  w = __shfl_sync(kFull, w, 0, G);
  const T* hrow = h + j * f;
  W v[kWords];
#pragma unroll
  for (int i = 0; i < kWords; ++i) {
    if (ok[i]) load_word(v[i], hrow, word[i]);
  }
  float sc[kWords];
  if constexpr (kScaled) {
    if constexpr (kWide) stage_leaves();
#pragma unroll
    for (int i = 0; i < kWords; ++i) {
      if (ok[i]) sc[i] = scale[j * L + first_leaf(leaf[i])];
    }
  }
#pragma unroll
  for (int i = 0; i < kWords; ++i) {
    if (ok[i]) {
      if constexpr (kScaled) scale_word(v[i], sc[i], scale + j * L, leaf[i]);
      reinterpret_cast<W*>(out)[row * words + word[i]] =
          blend(a, x[i], w, v[i]);
    }
  }
}

bool bad_shape(int64_t n, int64_t f) {
  return n < 1 || f < 1 || n > 0x7fffffff || f > 0x7fffffff;
}

// Reads the plan and checks it against the call.
bool plan_ok(const int64_t* raw, Plan* pl, int64_t n, int64_t f,
             const void* p, const void* h, size_t tsize, const void* out) {
  pl->vec = (int)raw[0];
  pl->wide = (int)raw[1];
  const int64_t group = raw[2];
  pl->threads = (int)raw[3];
  pl->grid_x = raw[4];
  pl->grid_y = raw[5];
  const int64_t words_per_lane = raw[6];
  pl->tile = raw[7];
  int g_log2 = 0;
  while (g_log2 < 5 && (int64_t{1} << g_log2) < group) ++g_log2;
  if ((int64_t{1} << g_log2) != group) return false;
  pl->g_log2 = g_log2;
  const int threads = pl->threads;
  if (threads < kWarp || threads > kMaxThreads || threads % kWarp != 0)
    return false;
  if (pl->vec && (f % 4 != 0 || !wire::aligned(p, 16) ||
                  !wire::aligned(out, 16) || !wire::aligned(h, 4 * tsize)))
    return false;
  const int64_t words = pl->vec ? f / 4 : f;
  if (pl->wide) {
    return words_per_lane == kWideWords && group == kWarp &&
           pl->tile >= 1 && pl->tile <= (int64_t)threads * kWideWords &&
           pl->grid_x == n &&
           pl->grid_y >= 1 && pl->grid_y <= 65535 &&
           pl->grid_y * pl->tile >= words &&
           (pl->grid_y - 1) * pl->tile < words;
  }
  const int64_t rows = threads / group;
  return words_per_lane == 1 && words <= group &&
         pl->grid_y == 1 && pl->grid_x >= 1 && pl->grid_x <= 0x7fffffff &&
         pl->grid_x * rows >= n && (pl->grid_x - 1) * rows < n;
}

template <typename T, bool kVec, bool kScaled, bool kWide>
cudaError_t launch_rows(const void* p, const void* h, const void* idx,
                        const void* ws, const void* wp, const void* scale,
                        const void* start, int L, void* out, int64_t n,
                        int64_t f, const Plan& pl, cudaStream_t st) {
  const size_t smem = kScaled ? sizeof(int32_t) * L : 0;
  flat_rows<T, kVec, kScaled, kWide>
      <<<dim3((unsigned)pl.grid_x, (unsigned)pl.grid_y), pl.threads, smem,
         st>>>(static_cast<const float*>(p), static_cast<const T*>(h),
               static_cast<const int64_t*>(idx),
               static_cast<const float*>(ws), static_cast<const float*>(wp),
               static_cast<const float*>(scale),
               static_cast<const int32_t*>(start), L,
               static_cast<float*>(out), n, f, pl.g_log2, pl.tile);
  return cudaGetLastError();
}

template <typename T, bool kVec, bool kScaled>
cudaError_t launch_route(const void* p, const void* h, const void* idx,
                         const void* ws, const void* wp, const void* scale,
                         const void* start, int L, void* out, int64_t n,
                         int64_t f, const Plan& pl, cudaStream_t st) {
  return pl.wide ? launch_rows<T, kVec, kScaled, true>(
                       p, h, idx, ws, wp, scale, start, L, out, n, f, pl, st)
                 : launch_rows<T, kVec, kScaled, false>(
                       p, h, idx, ws, wp, scale, start, L, out, n, f, pl,
                       st);
}

template <typename T, bool kScaled>
int launch(const void* p, const void* h, const void* idx, const void* ws,
           const void* wp, const void* scale, const void* start, int L,
           void* out, int64_t n, int64_t f, const int64_t* plan,
           cudaStream_t st) {
  Plan pl;
  if (!plan_ok(plan, &pl, n, f, p, h, sizeof(T), out))
    return (int)cudaErrorInvalidValue;
  return (int)(pl.vec ? launch_route<T, true, kScaled>(
                            p, h, idx, ws, wp, scale, start, L, out, n, f,
                            pl, st)
                      : launch_route<T, false, kScaled>(
                            p, h, idx, ws, wp, scale, start, L, out, n, f,
                            pl, st));
}

}  // namespace

// K3. p, out: [n, f] float32; h: [m, f] float32; idx: [n] int64 in
// [0, m); ws, wp: [n] float32. All row-major and contiguous. plan: the
// eight int64 values of ops/merge.py::FlatPlan.as_args (vec, wide, group,
// threads, grid x, grid y, words a lane, tile).
extern "C" int gather_merge_flat(const void* p, const void* h, const void* idx,
                                 const void* ws, const void* wp, void* out,
                                 int64_t n, int64_t f, const int64_t* plan,
                                 void* stream) {
  if (bad_shape(n, f) || plan == nullptr) return (int)cudaErrorInvalidValue;
  return launch<float, false>(p, h, idx, ws, wp, nullptr, nullptr, 0, out, n,
                              f, plan, static_cast<cudaStream_t>(stream));
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
                                    const int64_t* plan, void* stream) {
  if (bad_shape(n, f) || plan == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (scale == nullptr) {
    if (format != wire::kBFloat16) return (int)cudaErrorInvalidValue;
    return launch<uint16_t, false>(p, h, idx, ws, wp, nullptr, nullptr, 0,
                                   out, n, f, plan, st);
  }
  if (start == nullptr || n_leaves < 1 || n_leaves > wire::kMaxLeaves)
    return (int)cudaErrorInvalidValue;
  const int L = (int)n_leaves;
  switch (format) {
    case wire::kFloat32:
      return launch<float, true>(p, h, idx, ws, wp, scale, start, L, out, n,
                                 f, plan, st);
    case wire::kBFloat16:
      return launch<uint16_t, true>(p, h, idx, ws, wp, scale, start, L, out,
                                    n, f, plan, st);
    case wire::kInt8:
      return launch<int8_t, true>(p, h, idx, ws, wp, scale, start, L, out, n,
                                  f, plan, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
