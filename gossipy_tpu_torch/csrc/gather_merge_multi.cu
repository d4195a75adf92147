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
// of 1. With one (int8), the kernel reads the live rows' scales from the
// ring's [M, L] sidecar and finds a column's leaf in the [L] table of leaf
// start columns; the TPU kernel takes scales gathered outside it and maps
// 512-column blocks to leaves, every leaf padded to a block multiple. An
// empty slot carries wp = 0 and an arbitrary in-range index: its ring row
// and its scales are never read and its term is 0, never 0 * row, so a
// non-finite row or scale behind it stays inert. Its ws is applied all the
// same (whatever it is): 1 * (-0) + 0 is +0, so skipping it would change
// bits.
//
// Bound: memory. A live slot costs 2 to 4 operations per element against
// 8 bytes of p and out per element plus 4, 2 or 1 bytes of each live peer
// row; the card does hundreds of operations per byte it reads. The least
// traffic is p read once, out written once, each live ring row read once
// at wire width, plus the [N, K] tables (8 + 4 + 4 bytes a slot with int64
// indices). The TPU grid walks (row, feature block, slot) in order; here
// blocks run in parallel, so the slot axis is a loop inside the thread,
// the running sum kept in registers. What held a block-per-row design back
// on narrow rows (29 of 256 lanes working at LogReg's 116 columns, a
// barrier before any useful load, one peer row loaded at a time, K slots
// walked whether live or not) and what the layout does about it:
//   - rows map to lanes by width. A row's words (4 columns each in the
//     vector form, 1 in the scalar form) go to a group of G lanes, G a
//     power of two up to a warp, and a block of 256 lanes holds 256 / G
//     rows: LogReg's 116 columns take G = 32 (29 words), AdaLine's 60
//     take G = 16 (15 words). Rows of more than 32 words (CIFAR10Net's
//     73,420 columns) take a block per (row, tile) instead, each warp a
//     group of the same row and each lane 2 words of the tile (1 for K >
//     8). ops/merge.py::launch_plan picks the route, G, the block, the
//     grid and the depth below; the entry points check what they get.
//   - no block-wide barrier on the tables: lane s % G of a group loads
//     slots s and s + G of its row's tables (K <= 2 G; coalesced, beside
//     the load of p; indices kept as 32 bits), the group shares a slot's
//     entries with __shfl_sync, and __ballot_sync finds the warp's events
//     (slots live in one of its rows, or empty with a w_self other than
//     1) and each row's live slots. The warp walks the union of its rows'
//     events, so every shuffle runs with the whole warp; another row's
//     event costs this row an exact fold of its own slot.
//   - an empty slot with w_self 1 maps x to 1 * x + 0 = x + 0, which is
//     idempotent: a run of them between two events folds as one add, so
//     a row costs its events, not its K (Giaretta's 59 slots, about one
//     live).
//   - every live peer word of a pass is in flight before the first is
//     folded: a pass takes the next 4 events (K <= 8; 2 on the wide
//     route, whose lanes hold 2 words each) or 8 (K > 8; 4 on the narrow
//     route with a scale table), in two halves, the second only when the
//     first is full.
//   - the index table is read as the engine makes it, int64: one launch
//     a call, no cast kernel beside it. Offsets are 64-bit.
//   - the scaled form (a scale table) on the narrow route stages the [L]
//     leaf starts in shared memory behind its one __syncthreads; a lane
//     loads a live row's scale for its word's first column with the
//     word, and a word across a leaf edge reads the others when it folds.
//   - the slot walk (multi_slots) takes the two calls the event walk
//     serves badly. The wide route with a scale table (int8 CIFAR10Net
//     rows): the event walk there held 62-64 registers a lane, half the
//     occupancy of one word a lane at 32. And a call of fewer rows than
//     the card has multiprocessors, with K > 8: most of the card idles,
//     and a row with many live slots pays a pass of shuffles and a
//     memory latency per 8 events. A block per (row, tile), one word a
//     lane, 8 blocks an SM; the row's tables, the leaf starts and the
//     live slots' K x L scales (the TPU kernel's scalar prefetch; K x L
//     <= kMaxScales) staged in shared memory, the receiver's word
//     loading beside them. For K <= 8 it folds the events one at a time
//     (walking every slot lost to the block-per-row kernel this replaced
//     at the flagship's int8 shape, this beat it); for K > 8 every slot,
//     the loop unrolled 4 deep so that the loads of a row's many live
//     slots overlap (one event at a time lost to that kernel at every
//     dense edge).
// A vector word is a float4 of p and out and a 16-byte (float32), 8-byte
// (bfloat16) or 4-byte (int8) word of ring row, which the ring's row
// alignment allows (wire_rows.cuh); any other shape takes the scalar form
// with the same row grouping.
//
// Numerics: built with --fmad=false, so `ws * out + term` is a multiply
// then an add, rounded as the plain PyTorch version rounds them: the two
// agree bit for bit, the signs of zeros included.
//
// C interface for ctypes. The launch goes on the caller's stream and does
// not synchronise; each function returns cudaGetLastError() after it.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "wire_rows.cuh"

namespace {

constexpr int kMaxSlots = 64;
constexpr int kMaxScales = 8192;  // K x L floats the wide route stages
constexpr int kWarp = 32;
constexpr int kMaxThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void set_zero(float4& v) {
  v = make_float4(0.f, 0.f, 0.f, 0.f);
}
__device__ __forceinline__ void set_zero(float& v) { v = 0.f; }

// acc = a * acc + (w != 0 ? w * v : 0), element by element.
__device__ __forceinline__ void blend(float4& acc, float a, float w,
                                      const float4& v) {
  const bool live = w != 0.f;
  acc.x = a * acc.x + (live ? w * v.x : 0.f);
  acc.y = a * acc.y + (live ? w * v.y : 0.f);
  acc.z = a * acc.z + (live ? w * v.z : 0.f);
  acc.w = a * acc.w + (live ? w * v.w : 0.f);
}
__device__ __forceinline__ void blend(float& acc, float a, float w, float v) {
  acc = a * acc + (w != 0.f ? w * v : 0.f);
}

// acc = 1 * acc + 0: an empty slot whose w_self is 1. 1 * x is x, so this
// is x + 0 (which turns -0 into +0); it is idempotent, so a run of such
// slots folds as one.
__device__ __forceinline__ void blend_one(float4& acc) {
  acc.x = acc.x + 0.f;
  acc.y = acc.y + 0.f;
  acc.z = acc.z + 0.f;
  acc.w = acc.w + 0.f;
}
__device__ __forceinline__ void blend_one(float& acc) { acc = acc + 0.f; }

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

// The leaf of a word's first column.
__device__ __forceinline__ int first_leaf(const int4& l) { return l.x; }
__device__ __forceinline__ int first_leaf(int l) { return l; }

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

// v times its columns' scales from a row of staged scales.
__device__ __forceinline__ void scale_by(float4& v, const float* sc,
                                         const int4& l) {
  v.x = v.x * sc[l.x];
  v.y = v.y * sc[l.y];
  v.z = v.z * sc[l.z];
  v.w = v.w * sc[l.w];
}
__device__ __forceinline__ void scale_by(float& v, const float* sc, int l) {
  v = v * sc[l];
}

// r[c] for a c that is the same in every lane of the warp.
template <int R, typename V>
__device__ __forceinline__ V pick(const V (&r)[R], int c) {
  V v = r[0];
#pragma unroll
  for (int i = 1; i < R; ++i) v = c == i ? r[i] : v;
  return v;
}

// Entry s of a table held as slot s in lane s % G, register s / G.
template <int R, typename V>
__device__ __forceinline__ V slot(const V (&r)[R], int s, int g_log2) {
  return __shfl_sync(kFull, pick<R>(r, s >> g_log2), s & ((1 << g_log2) - 1),
                     1 << g_log2);
}

// The launch plan's values: see ops/merge.py::MultiPlan.
struct Plan {
  int vec, wide, g_log2, threads, words_per_lane, in_flight;
  int64_t grid_x, grid_y;
};

// Lane s % G of a row group holds slots s and s + G of the row's tables.
constexpr int kTableRegs = 2;

// kWide: the route. kInFlight: events (below) whose peer words a lane
// loads before it folds the first of them; kWords: words a lane takes.
// The plan takes (8, 1) for K > 8; for K <= 8, (4, 1) on the narrow route
// and (2, 2) on the wide one ((1, 1) is the slot walk's, multi_slots).
// The narrow route's scaled form holds a
// scale an event and takes 4 events a pass at most. The bound on resident
// blocks caps the registers: 40 a thread for (4, 1) and 48 for (2, 2)
// without a scale table, 64 otherwise.
template <int kInFlight, int kWords, bool kScaled>
constexpr int min_blocks() {
  return kInFlight == 8 || kScaled ? 4 : kWords == 2 ? 5 : 6;
}
template <int kInFlight, bool kScaled>
__host__ __device__ constexpr int in_flight() {
  return kScaled && kInFlight > 4 ? 4 : kInFlight;
}

// The event walk: both routes without a scale table, and the narrow route
// with one (kScaled && kWide is the slot walk's).
template <typename T, bool kVec, bool kScaled, bool kWide, int kPlanInFlight,
          int kWords>
__global__ void __launch_bounds__(
    kMaxThreads, min_blocks<kPlanInFlight, kWords, kScaled>())
    multi_rows(const float* __restrict__ p, const T* __restrict__ h,
               const int64_t* __restrict__ idx, const float* __restrict__ ws,
               const float* __restrict__ wp, const float* __restrict__ scale,
               const int32_t* __restrict__ start, int L,
               float* __restrict__ out, int64_t n, int64_t f, int k,
               int g_log2) {
  static_assert(!(kScaled && kWide), "the wide scaled route is its own");
  using W = std::conditional_t<kVec, float4, float>;
  using Leaf = std::conditional_t<kVec, int4, int>;
  constexpr int kInFlight = in_flight<kPlanInFlight, kScaled>();
  const int G = 1 << g_log2;
  const int gl = threadIdx.x & (G - 1);  // lane in the row group
  const int64_t words = kVec ? f / 4 : f;
  int64_t row, word[kWords];  // a lane's words: word[0] + i * blockDim.x
  if constexpr (kWide) {
    row = blockIdx.x;
    word[0] = (int64_t)blockIdx.y * blockDim.x * kWords + threadIdx.x;
  } else {
    row = (int64_t)blockIdx.x * (blockDim.x >> g_log2) +
          (threadIdx.x >> g_log2);
    word[0] = gl;
  }
  const bool row_ok = row < n;
  bool col_ok[kWords];
  W acc[kWords];
#pragma unroll
  for (int i = 0; i < kWords; ++i) {
    word[i] = word[0] + (int64_t)i * blockDim.x;
    col_ok[i] = row_ok && word[i] < words;
    // The receiver's own words first, so their loads run beside the
    // tables'.
    set_zero(acc[i]);
    if (col_ok[i]) acc[i] = reinterpret_cast<const W*>(p)[row * words + word[i]];
  }

  // A ring row index fits 32 bits (the wrapper checks the ring's rows).
  float t_ws[kTableRegs], t_wp[kTableRegs];
  int32_t t_idx[kTableRegs];
  const int64_t tab = row * k;
#pragma unroll
  for (int c = 0; c < kTableRegs; ++c) {
    const int s = c * G + gl;
    t_ws[c] = 1.f;
    t_wp[c] = 0.f;
    t_idx[c] = 0;
    if (row_ok && s < k) {
      t_ws[c] = ws[tab + s];
      t_wp[c] = wp[tab + s];
      t_idx[c] = (int32_t)idx[tab + s];
    }
  }
  // The scaled form's [L] leaf starts in shared memory, behind its one
  // barrier; a lane reads a live row's scale with its word.
  Leaf leaf[kWords];
  if constexpr (kScaled) {
    extern __shared__ int32_t s_start[];  // [L]
    for (int t = threadIdx.x; t < L; t += blockDim.x) s_start[t] = start[t];
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kWords; ++i) {
      leaf[i] = Leaf{};
      if (col_ok[i]) {
        if constexpr (kVec) {
          leaf[i] = wire::leaves4(s_start, L, 4 * word[i]);
        } else {
          leaf[i] = wire::leaf_of(s_start, L, word[i]);
        }
      }
    }
  }
  // The warp's events: slots live in one of its rows, or empty with a
  // w_self other than 1. The same masks in every lane: slots 0-31 and
  // 32-63. And the row's own live slots, in its group's lanes.
  uint32_t ev_lo = 0u, ev_hi = 0u, live_lo = 0u, live_hi = 0u;
  const unsigned gmask = G == kWarp ? kFull : (1u << G) - 1u;
  const int gbase = (threadIdx.x & (kWarp - 1)) & ~(G - 1);
#pragma unroll
  for (int c = 0; c < kTableRegs; ++c) {
    if (c * G < k) {
      unsigned b = __ballot_sync(kFull, t_wp[c] != 0.f || t_ws[c] != 1.f);
      const unsigned mine = (__ballot_sync(kFull, t_wp[c] != 0.f) >> gbase) &
                            gmask;
      for (int sh = kWarp / 2; sh >= G; sh >>= 1) b |= b >> sh;
      b &= gmask;
      const int at = c * G;  // G divides 32, or G == 32
      if (at < 32) {
        ev_lo |= b << at;
        live_lo |= mine << at;
      } else {
        ev_hi |= b;
        live_hi |= mine;
      }
    }
  }

  // Fold the slots in order. Between two events every slot of every row
  // of the warp is empty with w_self 1: the run folds as one x + 0. A pass
  // takes the next kInFlight events of a mask in two halves; the second
  // runs only when the first is full (a test the same in every lane), and
  // within a half the shuffles run in every lane whatever the event, so
  // the compiler may issue its shuffles and loads back to back.
  constexpr int kHalf = kInFlight / 2;
  int s = 0;  // the next slot to fold
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    uint32_t m = half ? ev_hi : ev_lo;
    const uint32_t live = half ? live_hi : live_lo;
    const int base = 32 * half;
    while (m) {
      int pos[kInFlight];
      bool lv[kInFlight];  // the event is live in this lane's row
      int32_t j[kInFlight];
      W v[kInFlight][kWords];
      float sc[kInFlight][kWords];  // the first column's scale, if any
      const bool full = __popc(m) > kHalf;
#pragma unroll
      for (int c = 0; c < kInFlight; ++c) {
        pos[c] = -1;
        lv[c] = false;
        j[c] = 0;
#pragma unroll
        for (int i = 0; i < kWords; ++i) {
          set_zero(v[c][i]);
          sc[c][i] = 0.f;
        }
        if (c < kHalf || full) {
          const int b = m ? __ffs(m) - 1 : -1;
          m &= m - 1;
          pos[c] = b < 0 ? -1 : base + b;
          lv[c] = b >= 0 && ((live >> b) & 1u);
          j[c] = slot<kTableRegs>(t_idx, pos[c] < 0 ? 0 : pos[c], g_log2);
#pragma unroll
          for (int i = 0; i < kWords; ++i) {
            if (lv[c] && col_ok[i]) {
              load_word(v[c][i], h + (int64_t)j[c] * f, word[i]);
              if constexpr (kScaled)  // a live row's, read here only
                sc[c][i] = scale[(int64_t)j[c] * L + first_leaf(leaf[i])];
            }
          }
        }
      }
#pragma unroll
      for (int c = 0; c < kInFlight; ++c) {
        if ((c < kHalf || full) && pos[c] >= 0) {
          const float a = slot<kTableRegs>(t_ws, pos[c], g_log2);
          const float w = slot<kTableRegs>(t_wp, pos[c], g_log2);
          const bool run = pos[c] > s;  // plain empty slots before it
#pragma unroll
          for (int i = 0; i < kWords; ++i) {
            if (run) blend_one(acc[i]);
            if constexpr (kScaled) {
              if (lv[c] && col_ok[i])
                scale_word(v[c][i], sc[c][i], scale + (int64_t)j[c] * L,
                           leaf[i]);
            }
            blend(acc[i], a, w, v[c][i]);
          }
          s = pos[c] + 1;
        }
      }
    }
  }
  if (s < k) {  // plain empty slots after the last event
#pragma unroll
    for (int i = 0; i < kWords; ++i) blend_one(acc[i]);
  }
#pragma unroll
  for (int i = 0; i < kWords; ++i) {
    if (col_ok[i])
      reinterpret_cast<W*>(out)[row * words + word[i]] = acc[i];
  }
}

// The slot walk: a block per (row, tile of blockDim.x words), one word a
// lane; the row's tables, its events and, with a scale table, the [L] leaf
// starts and then the live slots' K x L scales staged in shared memory
// (the receiver's word loads beside them). Then, for K <= 8,
// the events one at a time, a run of plain empty slots as one x + 0; for
// K > 8 every slot in order, the loop unrolled so that the loads of a
// row's many live slots overlap.
template <typename T, bool kVec, bool kScaled>
__global__ void __launch_bounds__(kMaxThreads, 8)
    multi_slots(const float* __restrict__ p, const T* __restrict__ h,
                const int64_t* __restrict__ idx, const float* __restrict__ ws,
                const float* __restrict__ wp, const float* __restrict__ scale,
                const int32_t* __restrict__ start, int L,
                float* __restrict__ out, int64_t f, int k) {
  using W = std::conditional_t<kVec, float4, float>;
  using Leaf = std::conditional_t<kVec, int4, int>;
  __shared__ int32_t s_idx[kMaxSlots];
  __shared__ float s_ws[kMaxSlots], s_wp[kMaxSlots];
  __shared__ uint32_t s_ev;        // the row's events, for K <= 8
  extern __shared__ float smem[];  // [L] starts, then [K, L] scales
  const int64_t row = blockIdx.x, tab = row * k;
  const int64_t words = kVec ? f / 4 : f;
  const int64_t word = (int64_t)blockIdx.y * blockDim.x + threadIdx.x;
  const bool ok = word < words;
  W acc;
  set_zero(acc);
  if (ok) acc = reinterpret_cast<const W*>(p)[row * words + word];
  if (threadIdx.x < kWarp) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int t = c * kWarp + threadIdx.x;
      float a = 1.f, w = 0.f;
      if (t < k) {
        a = ws[tab + t];
        w = wp[tab + t];
        s_idx[t] = (int32_t)idx[tab + t];
        s_ws[t] = a;
        s_wp[t] = w;
      }
      const uint32_t ev = __ballot_sync(kFull, w != 0.f || a != 1.f);
      if (threadIdx.x == 0 && c == 0) s_ev = ev;
    }
  }
  int32_t* s_start = reinterpret_cast<int32_t*>(smem);
  float* s_scale = smem + L;
  if constexpr (kScaled) {
    // The scales from the staged tables: no chain of global loads a
    // round of a warp-sized block's loop.
    for (int t = threadIdx.x; t < L; t += blockDim.x) s_start[t] = start[t];
    __syncthreads();
#pragma unroll 4
    for (int t = threadIdx.x; t < k * L; t += blockDim.x) {
      const int s = t / L;
      s_scale[t] = s_wp[s] != 0.f ? scale[(int64_t)s_idx[s] * L + t % L]
                                  : 0.f;
    }
  }
  __syncthreads();
  if (!ok) return;
  Leaf leaf{};
  if constexpr (kScaled) {
    if constexpr (kVec) {
      leaf = wire::leaves4(s_start, L, 4 * word);
    } else {
      leaf = wire::leaf_of(s_start, L, word);
    }
  }
  if (k > 8) {
#pragma unroll 4
    for (int s = 0; s < k; ++s) {
      const float w = s_wp[s];
      W v;
      set_zero(v);
      if (w != 0.f) {
        load_word(v, h + (int64_t)s_idx[s] * f, word);
        if constexpr (kScaled) scale_by(v, s_scale + s * L, leaf);
      }
      blend(acc, s_ws[s], w, v);
    }
  } else {
    int s = 0;  // the next slot to fold
    for (uint32_t m = s_ev; m; m &= m - 1) {
      const int pos = __ffs(m) - 1;
      if (pos > s) blend_one(acc);  // plain empty slots before it
      const float w = s_wp[pos];
      W v;
      set_zero(v);
      if (w != 0.f) {
        load_word(v, h + (int64_t)s_idx[pos] * f, word);
        if constexpr (kScaled) scale_by(v, s_scale + pos * L, leaf);
      }
      blend(acc, s_ws[pos], w, v);
      s = pos + 1;
    }
    if (s < k) blend_one(acc);  // plain empty slots after the last event
  }
  reinterpret_cast<W*>(out)[row * words + word] = acc;
}

bool bad_shape(int64_t n, int64_t f, int64_t k) {
  return k < 1 || k > kMaxSlots || n < 1 || f < 1 || n > 0x7fffffff ||
         f > 0x7fffffff;
}

// Reads the plan and checks it against the call.
bool plan_ok(const int64_t* raw, Plan* pl, int64_t n, int64_t f, int k,
             bool scaled, const void* p, const void* h, size_t tsize,
             const void* out) {
  pl->vec = (int)raw[0];
  pl->wide = (int)raw[1];
  const int64_t group = raw[2];
  pl->threads = (int)raw[3];
  pl->grid_x = raw[4];
  pl->grid_y = raw[5];
  pl->words_per_lane = (int)raw[6];
  pl->in_flight = (int)raw[7];
  // 11: the slot walk, a block per (row, tile) whatever the width, and
  // the only walk of the wide route with a scale table.
  const int cfg = pl->in_flight * 10 + pl->words_per_lane;
  const bool slots = cfg == 11;
  if (!slots && (k > 8 ? cfg != 81 : cfg != (pl->wide ? 22 : 41)))
    return false;
  if (pl->wide && scaled && !slots) return false;
  int g_log2 = 0;
  while (g_log2 < 5 && (int64_t{1} << g_log2) < group) ++g_log2;
  if ((int64_t{1} << g_log2) != group) return false;
  pl->g_log2 = g_log2;
  const int threads = pl->threads;
  if (threads < kWarp || threads > kMaxThreads || threads % kWarp != 0 ||
      k > kTableRegs * group)
    return false;
  if (pl->vec && (f % 4 != 0 || !wire::aligned(p, 16) ||
                  !wire::aligned(out, 16) || !wire::aligned(h, 4 * tsize)))
    return false;
  const int64_t words = pl->vec ? f / 4 : f;
  if (pl->wide || slots) {
    const int64_t tile = (int64_t)threads * pl->words_per_lane;
    return (slots || group == kWarp) && pl->grid_x == n && pl->grid_y >= 1 &&
           pl->grid_y <= 65535 && pl->grid_y * tile >= words &&
           (pl->grid_y - 1) * tile < words;
  }
  const int64_t rows = threads / group;
  return words <= group && pl->grid_y == 1 && pl->grid_x >= 1 &&
         pl->grid_x <= 0x7fffffff && pl->grid_x * rows >= n &&
         (pl->grid_x - 1) * rows < n;
}

template <typename T, bool kVec, bool kScaled, bool kWide, int kInFlight,
          int kWords>
void launch_one(const void* p, const void* h, const void* idx, const void* ws,
                const void* wp, const void* scale, const void* start, int L,
                void* out, int64_t n, int64_t f, int k, const Plan& pl,
                cudaStream_t st) {
  dim3 grid((unsigned)pl.grid_x, (unsigned)pl.grid_y);
  const size_t smem = kScaled ? sizeof(float) * L : 0;
  multi_rows<T, kVec, kScaled, kWide, kInFlight, kWords>
      <<<grid, pl.threads, smem, st>>>(
          static_cast<const float*>(p), static_cast<const T*>(h),
          static_cast<const int64_t*>(idx), static_cast<const float*>(ws),
          static_cast<const float*>(wp), static_cast<const float*>(scale),
          static_cast<const int32_t*>(start), L, static_cast<float*>(out), n,
          f, k, pl.g_log2);
}

template <typename T, bool kVec, bool kScaled>
void launch_cfg(const void* p, const void* h, const void* idx, const void* ws,
                const void* wp, const void* scale, const void* start, int L,
                void* out, int64_t n, int64_t f, int k, const Plan& pl,
                cudaStream_t st) {
  if (pl.in_flight == 1) {
    dim3 grid((unsigned)pl.grid_x, (unsigned)pl.grid_y);
    multi_slots<T, kVec, kScaled>
        <<<grid, pl.threads, kScaled ? sizeof(float) * L * (1 + k) : 0, st>>>(
            static_cast<const float*>(p), static_cast<const T*>(h),
            static_cast<const int64_t*>(idx), static_cast<const float*>(ws),
            static_cast<const float*>(wp), static_cast<const float*>(scale),
            static_cast<const int32_t*>(start), L, static_cast<float*>(out), f,
            k);
  } else if (pl.in_flight == 2) {
    if constexpr (!kScaled)
      launch_one<T, kVec, false, true, 2, 2>(p, h, idx, ws, wp, scale, start,
                                             L, out, n, f, k, pl, st);
  } else if (pl.in_flight == 4) {
    launch_one<T, kVec, kScaled, false, 4, 1>(p, h, idx, ws, wp, scale, start,
                                              L, out, n, f, k, pl, st);
  } else if (pl.wide) {
    if constexpr (!kScaled)
      launch_one<T, kVec, false, true, 8, 1>(p, h, idx, ws, wp, scale, start,
                                             L, out, n, f, k, pl, st);
  } else {
    launch_one<T, kVec, kScaled, false, 8, 1>(p, h, idx, ws, wp, scale, start,
                                              L, out, n, f, k, pl, st);
  }
}

template <typename T, bool kScaled>
int launch(const void* p, const void* h, const void* idx, const void* ws,
           const void* wp, const void* scale, const void* start, int L,
           void* out, int64_t n, int64_t f, int k, const int64_t* plan,
           cudaStream_t st) {
  Plan pl;
  if (!plan_ok(plan, &pl, n, f, k, kScaled, p, h, sizeof(T), out))
    return (int)cudaErrorInvalidValue;
  if (pl.vec)
    launch_cfg<T, true, kScaled>(p, h, idx, ws, wp, scale, start, L, out, n,
                                 f, k, pl, st);
  else
    launch_cfg<T, false, kScaled>(p, h, idx, ws, wp, scale, start, L, out, n,
                                  f, k, pl, st);
  return (int)cudaGetLastError();
}

}  // namespace

// K1. p, out: [n, f] float32; h: [m, f] float32; idx: [n, k] int64 in
// [0, m) wherever wp != 0; ws, wp: [n, k] float32. All row-major and
// contiguous; m < 2^31. plan: the eight int64 values of
// ops/merge.py::MultiPlan.as_args (vec, wide, group, threads, grid x,
// grid y, words a lane, events in flight).
extern "C" int gather_merge_multi(const void* p, const void* h, const void* idx,
                                  const void* ws, const void* wp, void* out,
                                  int64_t n, int64_t f, int64_t k,
                                  const int64_t* plan, void* stream) {
  if (bad_shape(n, f, k) || plan == nullptr) return (int)cudaErrorInvalidValue;
  return launch<float, false>(p, h, idx, ws, wp, nullptr, nullptr, 0, out, n,
                              f, (int)k, plan,
                              static_cast<cudaStream_t>(stream));
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
                                     int64_t k, const int64_t* plan,
                                     void* stream) {
  if (bad_shape(n, f, k) || plan == nullptr) return (int)cudaErrorInvalidValue;
  const int kk = (int)k;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (scale == nullptr) {
    if (format != wire::kBFloat16) return (int)cudaErrorInvalidValue;
    return launch<uint16_t, false>(p, h, idx, ws, wp, nullptr, nullptr, 0,
                                   out, n, f, kk, plan, st);
  }
  if (start == nullptr || n_leaves < 1 || n_leaves > wire::kMaxLeaves ||
      k * n_leaves > kMaxScales)
    return (int)cudaErrorInvalidValue;
  const int L = (int)n_leaves;
  switch (format) {
    case wire::kFloat32:
      return launch<float, true>(p, h, idx, ws, wp, scale, start, L, out, n,
                                 f, kk, plan, st);
    case wire::kBFloat16:
      return launch<uint16_t, true>(p, h, idx, ws, wp, scale, start, L, out,
                                    n, f, kk, plan, st);
    case wire::kInt8:
      return launch<int8_t, true>(p, h, idx, ws, wp, scale, start, L, out, n,
                                  f, kk, plan, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
