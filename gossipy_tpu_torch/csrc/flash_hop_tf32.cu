// Flash-attention hop, float32 routes, written for Hopper (sm_90a) as
// 3xTF32 on the tensor cores: absorb one key/value chunk into the
// per-query streaming-softmax carry (m, l, acc), with the score block kept
// in registers. One kernel template serves both float32 routes through
// one entry point (flash_hop_tf32): G = 1..4 groups of 32 columns for D,
// Dv up to 128 (flash_hop[f32]: two row warpgroups on a 128-row query
// tile, 32-key tiles) and G = 5..8 for D or Dv in 129..256
// (flash_hop[f32-wide]: one on a 64-row tile, 32-key tiles, 16 at G = 8).
// The split pre-pass both routes run first (tf32_split) is here too.
//
// Replaces the TPU kernel gossipy_tpu/ops/attention.py::_hop_kernel (K5)
// for float32 q, k and v; bfloat16 ones go to flash_hop_sm90.cu. The
// update is the TPU kernel's:
//
//     s[i,j] = scale * (q[i] . k[j]),  masked (-> kNeg) where j >= sl_k or,
//              when causal, where k_off + j > q_off + i (global positions);
//     m_new  = max(m[i], max_j s[i,j]);   alpha = exp(m[i] - m_new);
//     p[i,j] = masked ? 0 : exp(s[i,j] - m_new);
//     acc[i] = alpha * acc[i] + sum_j p[i,j] v[j];
//     l[i]   = alpha * l[i] + sum_j p[i,j];   m[i] = m_new.
//
// Bound: operations. Per (query, key) pair the hop does 2 (D + Dv) flops,
// hundreds per byte of q, k and v. The JAX kernel computes in float32, and
// one TF32 product (10 explicit mantissa bits) is ~5e-4 off in m, 50 times
// the routes' tolerance. So each float32 operand x is split into two TF32
// values, hi = rna(x) and lo = rna(x - hi) (cvt.rna.tf32: to nearest, ties
// away from zero), and each product a b is hi_a lo_b + lo_a hi_b + hi_a
// hi_b, three TF32 products, the small ones first into each accumulator
// (as CUTLASS's FastF32 does): ~1e-6 in m. The least time is the unmasked
// pairs' 3 x 2 (D + Dv) flops at the TF32 tensor-core rate. The design:
//   - Split pre-pass (tf32_split, one launch per
//     hop): from q, k, v it writes [2, rows, 32 G] hi and lo planes of q
//     and k (zero columns past D), and v transposed as [2, 32 G, ld_k],
//     keys contiguous: wgmma takes .tf32 operands K-major only (its
//     transpose bits exist for 16-bit types alone), and the K of P V is
//     the key.
//   - Tensor cores. A work item is a query tile of 64 RW rows, owned by RW
//     row warpgroups of 64 rows that share its k and v tiles. Each
//     computes S = q k^T as one wgmma chain per BK-key tile (m64nBKk8, q
//     and k from 128B-swizzled shared memory: a k-step of 8 TF32 values
//     is 32 bytes, as a bf16 k-step is, so the swizzle arithmetic is the
//     bf16 route's in bytes). P = exp(S - m) goes to P V as the register
//     A operand, split into hi and lo in the registers; B is the v^T
//     tile. Warpgroups queue their wgmma on the same tensor cores, so
//     one's softmax runs while another's products do.
//   - P without shuffles. For 32-bit A a thread's fragment holds keys
//     (t, t + 4) of each 8-key step (t = lane % 4), its accumulator holds
//     keys (2t, 2t + 1). The pre-pass stores v^T with the keys of every
//     8-key group in the order (0, 2, 4, 6, 1, 3, 5, 7), so the k-step's
//     key t is the tile's key 2t and key t + 4 is 2t + 1: the accumulator
//     registers are the A fragment as they stand.
//   - Shared memory. Hi and lo of a float32 element take 8 bytes, four
//     times a bf16 element. q stays resident for its work item; k and v
//     have rings of their own, each with full and empty mbarriers (Cfg:
//     as many stages as fit, up to 2 each): the next k tile loads while
//     the softmax and P V of this one run, the next v tile while S runs.
//     At D = Dv = 128 a 128-row q tile takes 128 KB and 32-key tiles fill
//     the rest. Past 128 columns a 128-row q tile alone would take more
//     than the 227 KB a block may have: the wide route works 64-row
//     tiles, with 32-key tiles up to G = 7 (224 KB at G = 7) and 16-key
//     tiles at G = 8 (q 128 KB, two k stages and one v stage of 32 KB).
//     A 16-key v^T tile has rows of 64 bytes: it is 64B-swizzled.
//   - Overlapped loads. One producer thread (warpgroup 0) issues the TMA
//     loads of q, k and v. 128 (1 + RW) threads: 384 leave ptxas 168
//     registers a thread, 256 leave 255 for the wide route's one consumer
//     warpgroup and its accumulator of up to 128 registers (ptxas uses
//     them all and spills a little at G = 7 and 8). On an H100, two
//     consumers that split acc's columns, both computing S, took 1.06-1.34
//     times as long, and one that queued tile j's S with tile j - 1's P V
//     to hide its softmax 1.28-1.63 times (it spilled more).
//   - Balanced causal work. The grid is persistent, at most one CTA per
//     SM, walking the work list of ops/attention.py::hop_schedule for the
//     instance's tiles; the pieces of a query tile cut into several are
//     merged in the launch by the last to finish (a ticket per tile), as
//     in flash_hop_sm90.cu.
//
// G = ceil(max(D, Dv) / 32) selects the instance with the tiles: 32-column
// groups of q and k, v^T rows (Dv rounded up to 32 G). Columns past D or
// Dv and keys past sl_k are zero in the pre-pass's planes; rows past sl_q
// or sl_k are zero-filled by TMA.
//
// Numerics: the softmax is float32 with expf (not __expf, whose error
// grows near kNeg); TF32 x TF32 products are exact in the float32
// accumulators, which add in an order of the tensor cores' own.
//
// The pre-pass is bound by bytes: it reads q, k and v once and writes
// each as two planes. A q or k element is one thread; v goes through
// shared memory in 32 x 32 tiles so that both its reads and its
// transposed writes are coalesced.
//
// C interface for ctypes: each launch goes on the caller's stream and does
// not synchronise; each function returns cudaGetLastError() after it (or
// 10000 plus the CUresult when a tensor map cannot be encoded).

#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int kSmemData = 232448 - 1024 - 128;  // for tiles, after alignment
constexpr float kNeg = -1e30f;
constexpr int kItemInts = 6;    // (q tile, kt0, kt1, slot0, pieces, slot)

// Instance of G 32-column groups: RW consumer warpgroups of 64 query
// rows, BK-key tiles. Shared memory from a 1024-byte aligned base: q (hi
// plane, lo plane), the k ring, the v ring; q and k planes in 32-column
// (128-byte) groups, 128B-swizzled as TMA writes them; v^T planes of 32 G
// rows of BK keys, 128B-swizzled (BK = 32) or 64B-swizzled (BK = 16).
template <int G, int RW, int BK>
struct Cfg {
  static_assert(BK == 16 || BK == 32, "S is one m64nBKk8 chain per tile");
  static constexpr int kBlockQ = 64 * RW;        // query rows per work item
  static constexpr int kConsumers = 128 * RW;
  static constexpr int kThreads = 128 + kConsumers;  // warpgroup 0: producer
  static constexpr int kNV = 32 * G;             // v^T rows (acc columns)
  static_assert(kNV <= 256, "P V is one m64nNVk8 chain");
  static constexpr int kVRow = 4 * BK;           // bytes of a v^T tile row
  static constexpr int kGroupQ = kBlockQ * 128;  // one group of a q plane
  static constexpr int kPlaneQ = G * kGroupQ;
  static constexpr int kGroupK = BK * 128;
  static constexpr int kPlaneK = G * kGroupK;
  static constexpr int kPlaneV = kNV * kVRow;
  static constexpr int kQBytes = 2 * kPlaneQ;
  static constexpr int kKBytes = 2 * kPlaneK;
  static constexpr int kVBytes = 2 * kPlaneV;    // == kKBytes
  // k and v tiles that fit beside q: up to 2 stages each, k first.
  static constexpr int kTiles = (kSmemData - kQBytes) / kKBytes;
  static constexpr int kKS = kTiles - 1 < 2 ? kTiles - 1 : 2;  // k stages
  static constexpr int kVS = kTiles - kKS < 2 ? kTiles - kKS : 2;
  static_assert(kKS >= 1 && kVS >= 1, "q and one k and v tile must fit");
  static constexpr int kKOff = kQBytes;
  static constexpr int kVOff = kKOff + kKS * kKBytes;
  static constexpr int kBarOff = 1024 + kVOff + kVS * kVBytes;
  static constexpr int kSmem = kBarOff + 128;
};

struct Params {
  const float* m_in;
  const float* l_in;
  const float* acc_in;
  float* m_out;
  float* l_out;
  float* acc_out;
  const int* sched;
  float* part;
  int* tickets;
  int sl_q, sl_k, dv, n_cta;
  long long q_off, k_off;
  float scale;
  int causal;
};

// x rounded to TF32 (to nearest, ties away from zero): its float32 bits
// with the low 13 cleared.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// S (+)= A B^T and O += A B as m64nNk8 wgmma, specialised for each N
// below.
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a,
                                         uint64_t b, int acc);
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t b);

// S (+)= A B^T: m64n16k8, A and B K-major in shared memory.
template <>
__device__ __forceinline__ void wgmma_ss<16>(float (&d)[8], uint64_t a,
                                             uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "%8, %9, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(a), "l"(b), "r"(acc));
}

// S (+)= A B^T: m64n32k8, A and B K-major in shared memory.
template <>
__device__ __forceinline__ void wgmma_ss<32>(float (&d)[16], uint64_t a,
                                             uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(acc));
}

// O += A B: m64n32k8, A in registers, B K-major in shared memory.
template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// O += A B: m64n64k8, A in registers, B K-major in shared memory.
template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// O += A B: m64n96k8, A in registers, B K-major in shared memory.
template <>
__device__ __forceinline__ void wgmma_rs<96>(float (&d)[48],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
      "{%48, %49, %50, %51}, %52, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// O += A B: m64n128k8, A in registers, B K-major in shared memory.
template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// O += A B: m64n160k8, A in registers, B K-major in shared memory.
template <>
__device__ __forceinline__ void wgmma_rs<160>(float (&d)[80],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %85, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79}, "
      "{%80, %81, %82, %83}, %84, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// O += A B: m64n192k8, A in registers, B K-major in shared memory.
template <>
__device__ __forceinline__ void wgmma_rs<192>(float (&d)[96],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, "
      "{%96, %97, %98, %99}, %100, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// O += A B: m64n224k8, A in registers, B K-major in shared memory.
template <>
__device__ __forceinline__ void wgmma_rs<224>(float (&d)[112],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %117, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n224k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111}, "
      "{%112, %113, %114, %115}, %116, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// O += A B: m64n256k8, A in registers, B K-major in shared memory.
template <>
__device__ __forceinline__ void wgmma_rs<256>(float (&d)[128],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// Key tiles of query tile qt that hold a key at or before its last row.
template <class C, int BK>
__device__ __forceinline__ int tiles_needed(const Params& p, int qt,
                                            int n_kt) {
  if (!p.causal) return n_kt;
  const long long last =
      p.q_off + min(qt * C::kBlockQ + C::kBlockQ, p.sl_q) - 1 - p.k_off;
  return last < 0 ? 0 : (int)min((long long)n_kt, last / BK + 1);
}

// The barriers of an instance, after the tiles in shared memory.
template <class C>
struct Bars {
  uint64_t* kfull;
  uint64_t* kempty;
  uint64_t* vfull;
  uint64_t* vempty;
  uint64_t* qfull;
  uint64_t* qempty;
  int* flag;
  __device__ explicit Bars(uint8_t* smem_raw) {
    kfull = reinterpret_cast<uint64_t*>(smem_raw + C::kBarOff);
    kempty = kfull + C::kKS;
    vfull = kempty + C::kKS;
    vempty = vfull + C::kVS;
    qfull = vempty + C::kVS;
    qempty = qfull + 1;
    flag = reinterpret_cast<int*>(qempty + 1);
  }
};

// Accumulator element i of a 64 x N wgmma tile lies in row r0 (i % 4 < 2)
// or r0 + 8 and column 8 (i / 4) + 2 (lane % 4) + (i % 2).
template <int G, int RW, int BK>
__device__ void consumer(const Params& p, uint32_t base,
                         const Bars<Cfg<G, RW, BK>>& bar) {
  using C = Cfg<G, RW, BK>;
  constexpr int NV = C::kNV, NO = NV / 2, NS = BK / 2;
  constexpr int KK = BK / 8;  // k-steps of P V
  constexpr int kBlockQ = C::kBlockQ;
  const int ctid = threadIdx.x - 128;
  const int cwg = ctid / 128, warp = (ctid % 128) / 32, lane = ctid % 32;
  const int rq = cwg * 64 + warp * 16 + lane / 4;  // tile row of r0
  const int cq = 2 * (lane % 4);
  const int n_kt = (p.sl_k + BK - 1) / BK;
  const long long diag = p.q_off - p.k_off;  // masked iff j - i > diag
  const uint32_t q_base = base + cwg * 64 * 128;  // this warpgroup's rows
  const int* items = p.sched + p.n_cta + 1;
  const int i0 = p.sched[blockIdx.x], i1 = p.sched[blockIdx.x + 1];

  int ks = 0, vs = 0;
  uint32_t kph = 0, vph = 0, qph = 0;
  for (int it = i0; it < i1; ++it) {
    const int* item = items + kItemInts * it;
    const int qt = item[0], kt0 = item[1], kt1 = item[2];
    const int slot0 = item[3], pieces = item[4], slot = item[5];
    const int q0 = qt * kBlockQ;
    float m_r[2] = {kNeg, kNeg}, l_r[2] = {0.f, 0.f};
    float o[NO];
#pragma unroll
    for (int i = 0; i < NO; ++i) o[i] = 0.f;

    if (kt1 > kt0) {
      mbar_wait(smem_u32(bar.qfull), qph);
      qph ^= 1;
    }
    for (int kt = kt0; kt < kt1; ++kt) {
      mbar_wait(smem_u32(bar.kfull + ks), kph);
      const uint32_t k_base = base + C::kKOff + ks * C::kKBytes;

      // S = q k^T: q_lo k_hi and q_hi k_lo over the 4 G k-steps of 8
      // columns, then q_hi k_hi.
      float s[NS];
#pragma unroll
      for (int i = 0; i < NS; ++i) s[i] = 0.f;
      reg_fence(s);
      wg_fence();
#pragma unroll
      for (int pass = 0; pass < 3; ++pass) {
#pragma unroll
        for (int st = 0; st < 4 * G; ++st) {
          const uint32_t off = (st / 4) * C::kGroupQ + (st % 4) * 32;
          const uint32_t koff = (st / 4) * C::kGroupK + (st % 4) * 32;
          const uint64_t a = sw128_desc(
              q_base + (pass == 0 ? C::kPlaneQ : 0) + off, 16, 1024);
          const uint64_t b = sw128_desc(
              k_base + (pass == 1 ? C::kPlaneK : 0) + koff, 16, 1024);
          wgmma_ss<BK>(s, a, b, pass > 0 || st > 0);
        }
      }
      wg_commit();
      wg_wait_all();
      reg_fence(s);
      mbar_arrive(smem_u32(bar.kempty + ks));
      if (++ks == C::kKS) {
        ks = 0;
        kph ^= 1;
      }
      if (kt == kt1 - 1) mbar_arrive(smem_u32(bar.qempty));

      // Scale, mask, row max (across the 4 threads of a row).
      const int k0 = kt * BK;
      const long long r_first = q0 + cwg * 64;
      const bool masked_tile =
          k0 + BK > p.sl_k ||
          (p.causal && (long long)(k0 + BK - 1) - r_first > diag);
      const int ra = q0 + rq;
      float mx[2] = {kNeg, kNeg};
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        float x = s[i] * p.scale;
        if (masked_tile) {
          const int j = k0 + 8 * (i / 4) + cq + (i & 1);
          const int r = ra + ((i & 2) ? 8 : 0);
          if (j >= p.sl_k || (p.causal && (long long)(j - r) > diag))
            x = kNeg;
        }
        s[i] = x;
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
      }
      float alpha[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float m_new = fmaxf(m_r[h], quad_max(mx[h]));
        alpha[h] = expf(m_r[h] - m_new);
        m_r[h] = m_new;
      }

      // p = exp(s - m), 0 where masked, split into TF32 hi and lo A
      // fragments: k-step kk holds (r0, 2t), (r0 + 8, 2t), (r0, 2t + 1),
      // (r0 + 8, 2t + 1) of the tile's keys 8 kk ...
      uint32_t hi[KK][4], lo[KK][4];
      float sum[2] = {0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < KK; ++kk) {
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          const int i = 4 * kk + (w == 1 ? 2 : w == 2 ? 1 : w);
          const int h = (i >> 1) & 1;
          float x = expf(s[i] - m_r[h]);
          if (masked_tile) {
            const int j = k0 + 8 * (i / 4) + cq + (i & 1);
            const int r = ra + (h ? 8 : 0);
            if (j >= p.sl_k || (p.causal && (long long)(j - r) > diag))
              x = 0.f;
          }
          sum[h] += x;
          split_tf32(x, hi[kk][w], lo[kk][w]);
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) l_r[h] = l_r[h] * alpha[h] + sum[h];
#pragma unroll
      for (int i = 0; i < NO; ++i) o[i] *= alpha[(i >> 1) & 1];
      reg_fence(o);

      // O += P_lo V_hi + P_hi V_lo, then P_hi V_hi, over the k-steps of 8
      // keys (32 bytes of a v^T row).
      mbar_wait(smem_u32(bar.vfull + vs), vph);
      const uint32_t v_base = base + C::kVOff + vs * C::kVBytes;
      wg_fence();
#pragma unroll
      for (int pass = 0; pass < 3; ++pass) {
#pragma unroll
        for (int kk = 0; kk < KK; ++kk) {
          const uint32_t addr =
              v_base + (pass == 1 ? C::kPlaneV : 0) + kk * 32;
          const uint64_t b = BK == 32 ? sw128_desc(addr, 16, 1024)
                                      : sw64_desc(addr, 16, 512);
          wgmma_rs<NV>(o, pass == 0 ? lo[kk] : hi[kk], b);
        }
      }
      wg_commit();
      wg_wait_all();
      reg_fence(o);
      mbar_arrive(smem_u32(bar.vempty + vs));
      if (++vs == C::kVS) {
        vs = 0;
        vph ^= 1;
      }
    }

    // Epilogue: this thread's rows r0 = q0 + rq and r0 + 8, columns
    // 8 j + cq + {0, 1}.
#pragma unroll
    for (int h = 0; h < 2; ++h) l_r[h] = quad_sum(l_r[h]);
    const size_t slot_floats = (size_t)kBlockQ * (2 + NV);
    if (pieces > 1) {
      float* ws = p.part + (size_t)slot * slot_floats;
      float* ws_acc = ws + 2 * kBlockQ;
      if (lane % 4 == 0) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          ws[rq + 8 * h] = m_r[h];
          ws[kBlockQ + rq + 8 * h] = l_r[h];
        }
      }
#pragma unroll
      for (int j = 0; j < NV / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<float2*>(ws_acc + (size_t)(rq + 8 * h) * NV +
                                     8 * j + cq) =
              make_float2(o[4 * j + 2 * h], o[4 * j + 2 * h + 1]);
      __threadfence();
      bar_sync<C::kConsumers>();
      if (ctid == 0) *bar.flag = atomicAdd(p.tickets + qt, 1) == pieces - 1;
      bar_sync<C::kConsumers>();
      if (!*bar.flag) continue;
      __threadfence();
    }

    const bool skipped = tiles_needed<C, BK>(p, qt, n_kt) < n_kt;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = q0 + rq + 8 * h;
      const bool live = row < p.sl_q;
      const float m0 = live ? p.m_in[row] : kNeg;
      const float l0 = live ? p.l_in[row] : 0.f;
      float m = fmaxf(m0, skipped ? kNeg : -INFINITY);
      if (pieces > 1) {
        for (int i = 0; i < pieces; ++i)
          m = fmaxf(m, __ldcg(p.part + (size_t)(slot0 + i) * slot_floats +
                              rq + 8 * h));
      } else {
        m = fmaxf(m, m_r[h]);
      }
      const float e0 = expf(m0 - m);
      const float e1 = pieces > 1 ? 0.f : expf(m_r[h] - m);
      float l = l0 * e0;
#pragma unroll
      for (int j = 0; j < NV / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * j + cq + e;
          const float a0 =
              (live && c < p.dv) ? p.acc_in[(size_t)row * p.dv + c] : 0.f;
          float& x = o[4 * j + 2 * h + e];
          x = pieces > 1 ? a0 * e0 : a0 * e0 + x * e1;
        }
      if (pieces > 1) {
        for (int i = 0; i < pieces; ++i) {
          const float* ws = p.part + (size_t)(slot0 + i) * slot_floats;
          const float w = expf(__ldcg(ws + rq + 8 * h) - m);
          l += __ldcg(ws + kBlockQ + rq + 8 * h) * w;
          const float* wa = ws + 2 * kBlockQ + (size_t)(rq + 8 * h) * NV;
#pragma unroll
          for (int j = 0; j < NV / 8; ++j) {
            const float2 a =
                __ldcg(reinterpret_cast<const float2*>(wa + 8 * j + cq));
            o[4 * j + 2 * h] += a.x * w;
            o[4 * j + 2 * h + 1] += a.y * w;
          }
        }
      } else {
        l += l_r[h] * e1;
      }
      if (!live) continue;
      if (lane % 4 == 0) {
        p.m_out[row] = m;
        p.l_out[row] = l;
      }
#pragma unroll
      for (int j = 0; j < NV / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * j + cq + e;
          if (c < p.dv) p.acc_out[(size_t)row * p.dv + c] = o[4 * j + 2 * h + e];
        }
    }
  }
}

template <int G, int RW, int BK>
__global__ void __launch_bounds__(Cfg<G, RW, BK>::kThreads, 1)
    hop_tf32(const __grid_constant__ CUtensorMap tq,
             const __grid_constant__ CUtensorMap tk,
             const __grid_constant__ CUtensorMap tv, const Params p) {
  using C = Cfg<G, RW, BK>;
  extern __shared__ uint8_t smem_raw[];
  // Swizzled tiles start on 1024-byte boundaries.
  const uint32_t base =
      smem_u32(smem_raw) + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const Bars<C> bar(smem_raw);

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::kKS; ++s) {
      mbar_init(smem_u32(bar.kfull + s), 1);
      mbar_init(smem_u32(bar.kempty + s), C::kConsumers);
    }
    for (int s = 0; s < C::kVS; ++s) {
      mbar_init(smem_u32(bar.vfull + s), 1);
      mbar_init(smem_u32(bar.vempty + s), C::kConsumers);
    }
    mbar_init(smem_u32(bar.qfull), 1);
    mbar_init(smem_u32(bar.qempty), C::kConsumers);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 128) {
    consumer<G, RW, BK>(p, base, bar);
    return;
  }
  if (threadIdx.x != 0) return;
  // Producer: one thread issues every load of this CTA's work list, in
  // the order the consumers take them (q of an item, then k and v of each
  // key tile).
  const int* items = p.sched + p.n_cta + 1;
  const int i0 = p.sched[blockIdx.x], i1 = p.sched[blockIdx.x + 1];
  int ks = 0, vs = 0;
  uint32_t kph = 0, vph = 0, qph = 0;
  for (int it = i0; it < i1; ++it) {
    const int* item = items + kItemInts * it;
    const int qt = item[0], kt0 = item[1], kt1 = item[2];
    if (kt1 <= kt0) continue;
    mbar_wait(smem_u32(bar.qempty), qph ^ 1);
    qph ^= 1;
    const uint32_t qb = smem_u32(bar.qfull);
    mbar_expect_tx(qb, C::kQBytes);
    for (int pl = 0; pl < 2; ++pl)
      for (int g = 0; g < G; ++g)
        tma_load_3d(base + pl * C::kPlaneQ + g * C::kGroupQ, &tq, qb, 32 * g,
                    qt * C::kBlockQ, pl);
    for (int kt = kt0; kt < kt1; ++kt) {
      mbar_wait(smem_u32(bar.kempty + ks), kph ^ 1);
      const uint32_t kb = smem_u32(bar.kfull + ks);
      mbar_expect_tx(kb, C::kKBytes);
      const uint32_t k_dst = base + C::kKOff + ks * C::kKBytes;
      for (int pl = 0; pl < 2; ++pl)
        for (int g = 0; g < G; ++g)
          tma_load_3d(k_dst + pl * C::kPlaneK + g * C::kGroupK, &tk, kb,
                      32 * g, kt * BK, pl);
      if (++ks == C::kKS) {
        ks = 0;
        kph ^= 1;
      }
      mbar_wait(smem_u32(bar.vempty + vs), vph ^ 1);
      const uint32_t vb = smem_u32(bar.vfull + vs);
      mbar_expect_tx(vb, C::kVBytes);
      const uint32_t v_dst = base + C::kVOff + vs * C::kVBytes;
      for (int pl = 0; pl < 2; ++pl)
        tma_load_3d(v_dst + pl * C::kPlaneV, &tv, vb, kt * BK, 0, pl);
      if (++vs == C::kVS) {
        vs = 0;
        vph ^= 1;
      }
    }
  }
}

// A [2, rows, cols] float32 tensor in boxes of box_cols columns by
// box_rows rows of one plane.
inline int plane_map(CUtensorMap* map, const void* ptr, int64_t rows,
                     int64_t cols, int box_cols, int box_rows,
                     CUtensorMapSwizzle swizzle) {
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows, 2};
  const cuuint64_t strides[2] = {(cuuint64_t)cols * 4,
                                 (cuuint64_t)(rows * cols * 4)};
  const cuuint32_t box[3] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows, 1};
  return sm90::tensor_map(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, ptr, dims,
                          strides, box, swizzle);
}

template <int G, int RW, int BK>
int launch(const void* qs, const void* ks, const void* vt, int64_t ld_k,
           const Params& p, cudaStream_t st) {
  using C = Cfg<G, RW, BK>;
  static bool allowed = false;
  if (!allowed) {
    const cudaError_t err =
        cudaFuncSetAttribute(hop_tf32<G, RW, BK>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             C::kSmem);
    if (err != cudaSuccess) return (int)err;
    allowed = true;
  }
  CUtensorMap tq, tk, tv;
  int rc = plane_map(&tq, qs, p.sl_q, 32 * G, 32, C::kBlockQ,
                     CU_TENSOR_MAP_SWIZZLE_128B);
  if (rc == 0)
    rc = plane_map(&tk, ks, p.sl_k, 32 * G, 32, BK,
                   CU_TENSOR_MAP_SWIZZLE_128B);
  if (rc == 0)
    rc = plane_map(&tv, vt, C::kNV, ld_k, BK, C::kNV,
                   BK == 32 ? CU_TENSOR_MAP_SWIZZLE_128B
                            : CU_TENSOR_MAP_SWIZZLE_64B);
  if (rc != 0) return rc;
  hop_tf32<G, RW, BK><<<p.n_cta, C::kThreads, C::kSmem, st>>>(tq, tk,
                                                                 tv, p);
  return (int)cudaGetLastError();
}

// The hop's Params from the entry point's arguments, or false when they
// do not fit an instance of groups in 1..8, block_q query rows and
// block_k-key tiles.
inline bool hop_params(Params& p, int64_t groups, int64_t ld_k, int64_t dv, const void* m, const void* l,
                       const void* acc, void* m_out, void* l_out,
                       void* acc_out, int64_t sl_q, int64_t sl_k,
                       int64_t q_off, int64_t k_off, float scale, int causal,
                       const void* sched, int n_cta, void* part,
                       void* tickets, int block_q, int block_k) {
  if (sl_q < 1 || sl_k < 1 || sl_q > 0x7fffffff - block_q ||
      sl_k > 0x7fffffff - block_k || groups < 1 || groups > 8 ||
      dv < 1 || dv > 32 * groups || ld_k < sl_k || ld_k % 8 || n_cta < 1)
    return false;
  p.m_in = static_cast<const float*>(m);
  p.l_in = static_cast<const float*>(l);
  p.acc_in = static_cast<const float*>(acc);
  p.m_out = static_cast<float*>(m_out);
  p.l_out = static_cast<float*>(l_out);
  p.acc_out = static_cast<float*>(acc_out);
  p.sched = static_cast<const int*>(sched);
  p.part = static_cast<float*>(part);
  p.tickets = static_cast<int*>(tickets);
  p.sl_q = (int)sl_q;
  p.sl_k = (int)sl_k;
  p.dv = (int)dv;
  p.n_cta = n_cta;
  p.q_off = q_off;
  p.k_off = k_off;
  p.scale = scale;
  p.causal = causal;
  return true;
}

// -- split pre-pass ----------------------------------------------------------

constexpr int kSplitThreads = 256;

struct SplitParams {
  const float* q;
  const float* k;
  const float* v;
  float* qs;
  float* ks;
  float* vt;
  int sl_q, sl_k, dim, dv, ld, nv, ld_k;
  int q_blocks, k_blocks, v_col_tiles;
};

// The pre-pass. Blocks [0, q_blocks) split q, the next k_blocks split k,
// one element a thread, into planes [2, rows, ld] (hi, then lo; zero
// columns past dim). The rest transpose v through shared memory, a tile of
// 32 keys x 32 columns a block, into [2, nv, ld_k] with position 8 g + t
// of each row holding key 8 g + perm(t), perm = (0, 2, 4, 6, 1, 3, 5, 7),
// and zeros past dv and sl_k.
__global__ void __launch_bounds__(kSplitThreads)
    tf32_split_kernel(const SplitParams p) {
  int b = blockIdx.x;
  if (b < p.q_blocks + p.k_blocks) {
    const bool is_q = b < p.q_blocks;
    const float* src = is_q ? p.q : p.k;
    float* dst = is_q ? p.qs : p.ks;
    const long long n = (long long)(is_q ? p.sl_q : p.sl_k) * p.ld;
    const long long i =
        (long long)(is_q ? b : b - p.q_blocks) * kSplitThreads + threadIdx.x;
    if (i >= n) return;
    const long long r = i / p.ld;
    const int c = (int)(i % p.ld);
    const float x = c < p.dim ? src[r * p.dim + c] : 0.f;
    uint32_t hi, lo;
    split_tf32(x, hi, lo);
    dst[i] = __uint_as_float(hi);
    dst[n + i] = __uint_as_float(lo);
    return;
  }
  __shared__ float t[32][33];
  b -= p.q_blocks + p.k_blocks;
  const int key0 = (b / p.v_col_tiles) * 32, col0 = (b % p.v_col_tiles) * 32;
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  for (int r = ty; r < 32; r += kSplitThreads / 32) {
    const int key = key0 + r, col = col0 + tx;
    t[r][tx] = (key < p.sl_k && col < p.dv)
                   ? p.v[(size_t)key * p.dv + col]
                   : 0.f;
  }
  __syncthreads();
  const int g = tx & 7;
  const int src_key = (tx & ~7) + (g < 4 ? 2 * g : 2 * g - 7);
  const size_t plane = (size_t)p.nv * p.ld_k;
  for (int r = ty; r < 32; r += kSplitThreads / 32) {
    const int col = col0 + r, key = key0 + tx;
    if (col >= p.nv || key >= p.ld_k) continue;
    uint32_t hi, lo;
    split_tf32(t[src_key][r], hi, lo);
    const size_t o = (size_t)col * p.ld_k + key;
    p.vt[o] = __uint_as_float(hi);
    p.vt[plane + o] = __uint_as_float(lo);
  }
}

}  // namespace

// The split pre-pass. q: [sl_q, dim], k: [sl_k, dim], v: [sl_k, dv]
// float32, row-major; groups = ceil(max(dim, dv) / 32) in 1..8; ld_k: sl_k
// rounded up to 8. Writes qs [2, sl_q, 32 groups], ks [2, sl_k, 32 groups]
// and vt [2, 32 groups, ld_k] float32 (hi plane, then lo plane).
extern "C" int tf32_split(const void* q, const void* k, const void* v,
                          void* qs, void* ks, void* vt, int64_t sl_q,
                          int64_t sl_k, int64_t dim, int64_t dv,
                          int64_t groups, int64_t ld_k, void* stream) {
  if (sl_q < 1 || sl_k < 1 || groups < 1 || groups > 8 || dim < 1 ||
      dim > 32 * groups || dv < 1 || dv > 32 * groups || ld_k < sl_k ||
      ld_k % 8 || sl_q * 32 * groups > 0x7fffffffll * kSplitThreads / 4 ||
      sl_k * 32 * groups > 0x7fffffffll * kSplitThreads / 4 ||
      ld_k > 0x7fffffff - 32)
    return (int)cudaErrorInvalidValue;
  SplitParams p;
  p.q = static_cast<const float*>(q);
  p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v);
  p.qs = static_cast<float*>(qs);
  p.ks = static_cast<float*>(ks);
  p.vt = static_cast<float*>(vt);
  p.sl_q = (int)sl_q;
  p.sl_k = (int)sl_k;
  p.dim = (int)dim;
  p.dv = (int)dv;
  p.ld = (int)(32 * groups);
  p.nv = (int)(32 * groups);
  p.ld_k = (int)ld_k;
  p.q_blocks = (int)((sl_q * p.ld + kSplitThreads - 1) / kSplitThreads);
  p.k_blocks = (int)((sl_k * p.ld + kSplitThreads - 1) / kSplitThreads);
  p.v_col_tiles = (int)groups;
  const long long blocks = (long long)p.q_blocks + p.k_blocks +
                           (ld_k + 31) / 32 * p.v_col_tiles;
  if (blocks > 0x7fffffffll) return (int)cudaErrorInvalidValue;
  tf32_split_kernel<<<(unsigned)blocks, kSplitThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

// K5, both float32 routes. qs, ks, vt: tf32_split's planes for the same
// groups and ld_k, 16-byte aligned; m, l, m_out, l_out: [sl_q] float32;
// acc, acc_out: [sl_q, dv] float32. sched: the work list of
// ops/attention.py::hop_schedule for the instance's tiles (n_cta + 1
// offsets, then 6 ints per item); part: its partial-carry slots, n_slots x
// block_q x (2 + 32 groups) float32; tickets: one int32 per query tile,
// all 0. q_off, k_off: the chunks' global row offsets; causal: 0 or 1;
// block_q and block_k: the work list's tiles, which must be the
// instance's: 128 and 32 for groups 1..4, 64 and 32 for 5..7, 64 and 16
// for 8.
extern "C" int flash_hop_tf32(const void* qs, const void* ks, const void* vt,
                              int64_t groups, int64_t ld_k, int64_t dv,
                              const void* m, const void* l, const void* acc,
                              void* m_out, void* l_out, void* acc_out,
                              int64_t sl_q, int64_t sl_k, int64_t q_off,
                              int64_t k_off, float scale, int causal,
                              const void* sched, int n_cta, void* part,
                              void* tickets, int block_q, int block_k,
                              void* stream) {
  Params p;
  if (block_q != (groups <= 4 ? 128 : 64) ||
      block_k != (groups < 8 ? 32 : 16) ||
      !hop_params(p, groups, ld_k, dv, m, l, acc, m_out, l_out, acc_out,
                  sl_q, sl_k, q_off, k_off, scale, causal, sched, n_cta,
                  part, tickets, block_q, block_k))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (groups) {
    case 1:
      return launch<1, 2, 32>(qs, ks, vt, ld_k, p, st);
    case 2:
      return launch<2, 2, 32>(qs, ks, vt, ld_k, p, st);
    case 3:
      return launch<3, 2, 32>(qs, ks, vt, ld_k, p, st);
    case 4:
      return launch<4, 2, 32>(qs, ks, vt, ld_k, p, st);
    case 5:
      return launch<5, 1, 32>(qs, ks, vt, ld_k, p, st);
    case 6:
      return launch<6, 1, 32>(qs, ks, vt, ld_k, p, st);
    case 7:
      return launch<7, 1, 32>(qs, ks, vt, ld_k, p, st);
    default:
      return launch<8, 1, 16>(qs, ks, vt, ld_k, p, st);
  }
}
