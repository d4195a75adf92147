// Flash-attention hop, bfloat16 route, written for Hopper (sm_90a): absorb
// one key/value chunk into the per-query streaming-softmax carry
// (m, l, acc), with the score block kept in registers.
//
// Replaces the TPU kernel gossipy_tpu/ops/attention.py::_hop_kernel (K5)
// for bfloat16 q, k and v (entry point flash_hop_sm90); float32 operands go
// to flash_hop_tf32.cu (3xTF32 on the same machinery, heads up to 256
// wide). For each query row i and key row j of the chunk,
//
//     s[i,j] = scale * (q[i] . k[j]),  masked (-> kNeg) where j >= sl_k or,
//              when causal, where k_off + j > q_off + i (global positions);
//     m_new  = max(m[i], max_j s[i,j]);   alpha = exp(m[i] - m_new);
//     p[i,j] = masked ? 0 : exp(s[i,j] - m_new);
//     acc[i] = alpha * acc[i] + sum_j p[i,j] v[j];
//     l[i]   = alpha * l[i] + sum_j p[i,j];   m[i] = m_new.
//
// A row whose keys are all masked keeps its carry (p = 0); a key tile
// wholly after a query tile's last row is not computed and acts as
// m = max(m, kNeg), which is exact: it scales the carry by exp(m_old - m),
// 1 unless the incoming m lies below kNeg.
//
// Bound: operations. Per (query, key) pair the hop does 2 (D + Dv) flops
// against q, k and v read once, hundreds of flops per byte, so its least
// time is the unmasked pairs' flops at the bf16 tensor-core rate. The
// design, against what held back the first (CUDA-core) kernel:
//   - Tensor cores. A CTA owns a 128-row query tile as two consumer
//     warpgroups of 64 rows. S = q k^T is one wgmma chain per key tile
//     with q and k read from shared memory (128B-swizzled, K-major); the
//     score tile stays in the accumulator registers. P = exp(S - m) goes
//     to the P V product as the register A operand, split into a bf16 high
//     part and a bf16 low part (hi = bf16(p), lo = bf16(p - hi)), two
//     wgmma chains on the same V tile: rounding P to bf16 alone is off by
//     ~1e-3 of the output, the split by ~1e-6. V is read from shared
//     memory as an MN-major B operand, 64 columns per instruction.
//   - Overlapped loads. One producer thread (warpgroup 0, which gives its
//     registers to the consumers with setmaxnreg) issues TMA loads of the
//     q tile and of the k and v tiles into a ring of stages guarded by
//     mbarriers (full: bytes arrived; empty: both consumers are done).
//   - Balanced causal work. The grid is persistent, at most one CTA per
//     SM, and walks a work list built on the host (ops/attention.py::
//     hop_schedule): (query tile, key-tile range) items, longest first,
//     the key range of a long query tile cut into pieces of a bounded
//     number of tiles, assigned longest-processing-time first to the
//     least loaded CTA. Pieces of one query tile are merged in the same
//     launch: each writes its partial carry (m_i, l_i, acc_i, started
//     from m = kNeg, l = 0, acc = 0) to a workspace slot, takes a ticket
//     for its tile, and the last to finish combines the incoming carry and
//     every piece: m = max m_i, l = sum l_i exp(m_i - m), acc likewise.
//   - Masking. Only tiles that cross the diagonal or the ragged end are
//     masked element by element.
//
// Tiles: 128 query rows; key tiles of 128 rows while D and Dv are at most
// 128 (G <= 2 column groups of 64), of 64 rows above (G = 3, 4), so that q
// and the ring fit in 227 KB of shared memory. Columns past D (or Dv) up
// to 64 G, and rows past sl_q or sl_k, are zero-filled by TMA.
//
// Numerics: bf16 x bf16 products accumulate exactly in float32 in the
// tensor cores; the softmax is float32 with expf (not __expf, whose error
// grows near kNeg).
//
// Tensor maps come from cuTensorMapEncodeTiled, looked up at run time
// (sm90.cuh, with the pipeline's other building blocks), so the library
// does not link libcuda.
// C interface for ctypes: the launch goes on the caller's stream and does
// not synchronise; the function returns cudaGetLastError() after it (or
// 10000 plus the CUresult when a tensor map cannot be encoded).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int kBlockQ = 128;    // query rows per CTA
constexpr int kThreads = 384;   // warpgroup 0: producer; 1, 2: consumers
constexpr int kConsumers = 256;
constexpr float kNeg = -1e30f;
constexpr int kItemInts = 6;    // (q tile, kt0, kt1, slot0, pieces, slot)

template <int G>
struct Cfg {
  static constexpr int BK = G <= 2 ? 128 : 64;        // key rows per tile
  static constexpr int kStages = G == 4 ? 2 : 3;
  static constexpr int kQBytes = G * kBlockQ * 128;   // 64 bf16 per row
  static constexpr int kKBytes = G * BK * 128;        // k (or v) of a stage
  static constexpr int kStageBytes = 2 * kKBytes;
  static constexpr int kBarOff = 1024 + kQBytes + kStages * kStageBytes;
  static constexpr int kSmem = kBarOff + 128;
  static constexpr int kDvp = 64 * G;                 // acc columns held
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

// S (+)= A B^T: m64nNk16, A and B K-major in shared memory.
// O (+)= A B: m64n64k16, A in registers, B MN-major in shared memory.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a,
                                                uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(acc));
}

__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a,
                                                uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(acc));
}

__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo_col, float hi_col) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo_col, hi_col);
  return *reinterpret_cast<uint32_t*>(&h);
}

// Key tiles of query tile qt that hold a key at or before its last row.
__device__ __forceinline__ int tiles_needed(const Params& p, int qt, int bk,
                                            int n_kt) {
  if (!p.causal) return n_kt;
  const long long last =
      p.q_off + min(qt * kBlockQ + kBlockQ, p.sl_q) - 1 - p.k_off;
  return last < 0 ? 0 : (int)min((long long)n_kt, last / bk + 1);
}

// Accumulator element i of a 64 x N wgmma tile lies in row r0 (i % 4 < 2)
// or r0 + 8 and column 8 (i / 4) + 2 (lane % 4) + (i % 2).
template <int G>
__device__ void consumer(const Params& p, const uint8_t* sQ,
                         const uint8_t* sKV, uint64_t* full, uint64_t* empty,
                         uint64_t* qfull, uint64_t* qempty, int* s_flag) {
  using C = Cfg<G>;
  constexpr int BK = C::BK, S = C::kStages, NS = BK / 2;
  const int ctid = threadIdx.x - 128;
  const int cwg = ctid / 128, warp = (ctid % 128) / 32, lane = ctid % 32;
  const int rq = cwg * 64 + warp * 16 + lane / 4;  // tile row of r0
  const int cq = 2 * (lane % 4);
  const int n_kt = (p.sl_k + BK - 1) / BK;
  const long long diag = p.q_off - p.k_off;  // masked iff j - i > diag
  const uint32_t q_base = smem_u32(sQ) + cwg * 64 * 128;
  const uint32_t kv_base = smem_u32(sKV);
  const int* items = p.sched + p.n_cta + 1;
  const int i0 = p.sched[blockIdx.x], i1 = p.sched[blockIdx.x + 1];

  int stage = 0;
  uint32_t phase = 0, qphase = 0;
  for (int it = i0; it < i1; ++it) {
    const int* item = items + kItemInts * it;
    const int qt = item[0], kt0 = item[1], kt1 = item[2];
    const int slot0 = item[3], pieces = item[4], slot = item[5];
    const int q0 = qt * kBlockQ;
    float m_r[2] = {kNeg, kNeg}, l_r[2] = {0.f, 0.f};
    float o[G][32];
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[g][i] = 0.f;

    if (kt1 > kt0) mbar_wait(smem_u32(qfull), qphase);
    if (kt1 > kt0) qphase ^= 1;
    for (int kt = kt0; kt < kt1; ++kt) {
      const uint32_t fb = smem_u32(full + stage);
      mbar_wait(fb, phase);
      const uint32_t k_base = kv_base + stage * C::kStageBytes;
      const uint32_t v_base = k_base + C::kKBytes;

      // S = q k^T over 4 G k-steps of 16 columns.
      float s[NS];
#pragma unroll
      for (int i = 0; i < NS; ++i) s[i] = 0.f;
      reg_fence(s);
      wg_fence();
#pragma unroll
      for (int ks = 0; ks < 4 * G; ++ks) {
        const uint32_t off = (ks % 4) * 32;
        const uint64_t a = sw128_desc(
            q_base + (ks / 4) * (kBlockQ * 128) + off, 16, 1024);
        const uint64_t b =
            sw128_desc(k_base + (ks / 4) * (BK * 128) + off, 16, 1024);
        if constexpr (BK == 128) {
          wgmma_ss_n128(s, a, b, ks > 0);
        } else {
          wgmma_ss_n64(s, a, b, ks > 0);
        }
      }
      wg_commit();
      wg_wait_all();
      reg_fence(s);
      if (kt == kt1 - 1) mbar_arrive(smem_u32(qempty));

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

      // p = exp(s - m), 0 where masked; its hi/lo bf16 parts as A fragments
      // (one per 16 keys: rows r0, r0 + 8 x key pairs 2c and 2c + 8).
      uint32_t hi[BK / 16][4], lo[BK / 16][4];
      float sum[2] = {0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          float pv[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 8 * kk + 2 * w + e;
            const int h = (i >> 1) & 1;
            float x = expf(s[i] - m_r[h]);
            if (masked_tile) {
              const int j = k0 + 8 * (i / 4) + cq + (i & 1);
              const int r = ra + (h ? 8 : 0);
              if (j >= p.sl_k || (p.causal && (long long)(j - r) > diag))
                x = 0.f;
            }
            sum[h] += x;
            pv[e] = x;
          }
          const float h0 = __bfloat162float(__float2bfloat16_rn(pv[0]));
          const float h1 = __bfloat162float(__float2bfloat16_rn(pv[1]));
          hi[kk][w] = pack_bf16(h0, h1);
          lo[kk][w] = pack_bf16(pv[0] - h0, pv[1] - h1);
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) l_r[h] = l_r[h] * alpha[h] + sum[h];
#pragma unroll
      for (int g = 0; g < G; ++g) {
#pragma unroll
        for (int i = 0; i < 32; ++i) o[g][i] *= alpha[(i >> 1) & 1];
        reg_fence(o[g]);
      }

      // O += P_hi V + P_lo V, 64 value columns per instruction.
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const uint64_t b = sw128_desc(
              v_base + g * (BK * 128) + kk * (16 * 128), BK * 128, 1024);
          wgmma_rs_n64(o[g], hi[kk], b);
          wgmma_rs_n64(o[g], lo[kk], b);
        }
      }
      wg_commit();
      wg_wait_all();
#pragma unroll
      for (int g = 0; g < G; ++g) reg_fence(o[g]);
      mbar_arrive(smem_u32(empty + stage));
      if (++stage == S) {
        stage = 0;
        phase ^= 1;
      }
    }

    // Epilogue: this thread's rows r0 = q0 + rq and r0 + 8, columns
    // 64 g + 8 j + cq + {0, 1}.
#pragma unroll
    for (int h = 0; h < 2; ++h) l_r[h] = quad_sum(l_r[h]);
    const size_t slot_floats = (size_t)kBlockQ * (2 + C::kDvp);
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
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            *reinterpret_cast<float2*>(
                ws_acc + (size_t)(rq + 8 * h) * C::kDvp + 64 * g + 8 * j +
                cq) = make_float2(o[g][4 * j + 2 * h], o[g][4 * j + 2 * h + 1]);
      __threadfence();
      bar_sync<kConsumers>();
      if (ctid == 0) *s_flag = atomicAdd(p.tickets + qt, 1) == pieces - 1;
      bar_sync<kConsumers>();
      if (!*s_flag) continue;
      __threadfence();
    }

    const bool skipped = tiles_needed(p, qt, BK, n_kt) < n_kt;
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
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = 64 * g + 8 * j + cq + e;
            const float a0 =
                (live && c < p.dv) ? p.acc_in[(size_t)row * p.dv + c] : 0.f;
            float& x = o[g][4 * j + 2 * h + e];
            x = pieces > 1 ? a0 * e0 : a0 * e0 + x * e1;
          }
      if (pieces > 1) {
        for (int i = 0; i < pieces; ++i) {
          const float* ws = p.part + (size_t)(slot0 + i) * slot_floats;
          const float w = expf(__ldcg(ws + rq + 8 * h) - m);
          l += __ldcg(ws + kBlockQ + rq + 8 * h) * w;
          const float* wa = ws + 2 * kBlockQ + (size_t)(rq + 8 * h) * C::kDvp;
#pragma unroll
          for (int g = 0; g < G; ++g)
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              const float2 a =
                  __ldcg(reinterpret_cast<const float2*>(wa + 64 * g + 8 * j +
                                                         cq));
              o[g][4 * j + 2 * h] += a.x * w;
              o[g][4 * j + 2 * h + 1] += a.y * w;
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
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = 64 * g + 8 * j + cq + e;
            if (c < p.dv) p.acc_out[(size_t)row * p.dv + c] = o[g][4 * j + 2 * h + e];
          }
    }
  }
}

template <int G>
__global__ void __launch_bounds__(kThreads, 1)
    hop_sm90(const __grid_constant__ CUtensorMap tq,
             const __grid_constant__ CUtensorMap tk,
             const __grid_constant__ CUtensorMap tv, const Params p) {
  using C = Cfg<G>;
  constexpr int BK = C::BK, S = C::kStages;
  extern __shared__ uint8_t smem_raw[];
  // Swizzled tiles start on 1024-byte boundaries.
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sQ = base;
  uint8_t* sKV = base + C::kQBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_raw + C::kBarOff);
  uint64_t* empty = full + S;
  uint64_t* qfull = empty + S;
  uint64_t* qempty = qfull + 1;
  int* s_flag = reinterpret_cast<int*>(qempty + 1);

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(smem_u32(full + s), 1);
      mbar_init(smem_u32(empty + s), kConsumers);
    }
    mbar_init(smem_u32(qfull), 1);
    mbar_init(smem_u32(qempty), kConsumers);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // Producer: one thread issues every load of this CTA's work list.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      const int* items = p.sched + p.n_cta + 1;
      const int i0 = p.sched[blockIdx.x], i1 = p.sched[blockIdx.x + 1];
      const uint32_t q_base = smem_u32(sQ), kv_base = smem_u32(sKV);
      int stage = 0;
      uint32_t phase = 0, qphase = 0;
      for (int it = i0; it < i1; ++it) {
        const int* item = items + kItemInts * it;
        const int qt = item[0], kt0 = item[1], kt1 = item[2];
        if (kt1 <= kt0) continue;
        mbar_wait(smem_u32(qempty), qphase ^ 1);
        qphase ^= 1;
        mbar_expect_tx(smem_u32(qfull), C::kQBytes);
        for (int g = 0; g < G; ++g)
          tma_load(q_base + g * (kBlockQ * 128), &tq, smem_u32(qfull), 64 * g,
                   qt * kBlockQ);
        for (int kt = kt0; kt < kt1; ++kt) {
          mbar_wait(smem_u32(empty + stage), phase ^ 1);
          const uint32_t fb = smem_u32(full + stage);
          mbar_expect_tx(fb, C::kStageBytes);
          const uint32_t k_dst = kv_base + stage * C::kStageBytes;
          for (int g = 0; g < G; ++g) {
            tma_load(k_dst + g * (BK * 128), &tk, fb, 64 * g, kt * BK);
            tma_load(k_dst + C::kKBytes + g * (BK * 128), &tv, fb, 64 * g,
                     kt * BK);
          }
          if (++stage == S) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    consumer<G>(p, sQ, sKV, full, empty, qfull, qempty, s_flag);
  }
}

// A [rows, cols] row-major bf16 matrix cut in boxes of 64 columns by
// box_rows rows, 128B-swizzled in shared memory; out-of-bounds reads are 0.
int tensor_map(CUtensorMap* map, const void* ptr, int64_t rows, int64_t cols,
               int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  return sm90::tensor_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, ptr, dims,
                          strides, box);
}

template <int G>
int launch(const void* q, const void* k, const void* v, int64_t ld_qk,
           int64_t ld_v, const Params& p, int block_k, cudaStream_t st) {
  using C = Cfg<G>;
  if (block_k != C::BK) return (int)cudaErrorInvalidValue;
  static bool allowed = false;
  if (!allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        hop_sm90<G>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
    if (err != cudaSuccess) return (int)err;
    allowed = true;
  }
  CUtensorMap tq, tk, tv;
  int rc = tensor_map(&tq, q, p.sl_q, ld_qk, kBlockQ);
  if (rc == 0) rc = tensor_map(&tk, k, p.sl_k, ld_qk, C::BK);
  if (rc == 0) rc = tensor_map(&tv, v, p.sl_k, ld_v, C::BK);
  if (rc != 0) return rc;
  hop_sm90<G><<<p.n_cta, kThreads, C::kSmem, st>>>(tq, tk, tv, p);
  return (int)cudaGetLastError();
}

}  // namespace

// K5, bf16 route. q: [sl_q, ld_qk], k: [sl_k, ld_qk], v: [sl_k, ld_v]
// bfloat16, row-major, 16-byte aligned, ld_qk and ld_v multiples of 8 and
// at most 256 (columns past D or Dv hold zeros); m, l, m_out, l_out: [sl_q]
// float32; acc, acc_out: [sl_q, dv] float32 (dv <= ld_v). sched: the work
// list of ops/attention.py::hop_schedule for key tiles of block_k rows
// (n_cta + 1 offsets, then 6 ints per item); part: its partial-carry
// slots, n_slots x 128 x (2 + 64 G) float32; tickets: one int32 per query
// tile, all 0. q_off, k_off: the chunks' global row offsets; causal: 0 or 1.
extern "C" int flash_hop_sm90(const void* q, const void* k, const void* v,
                              int64_t ld_qk, int64_t ld_v, int64_t dv,
                              const void* m, const void* l, const void* acc,
                              void* m_out, void* l_out, void* acc_out,
                              int64_t sl_q, int64_t sl_k, int64_t q_off,
                              int64_t k_off, float scale, int causal,
                              const void* sched, int n_cta, void* part,
                              void* tickets, int block_k, void* stream) {
  if (sl_q < 1 || sl_k < 1 || sl_q > 0x7fffffff - kBlockQ ||
      sl_k > 0x7fffffff - 128 || ld_qk < 8 || ld_qk > 256 || ld_qk % 8 ||
      ld_v < 8 || ld_v > 256 || ld_v % 8 || dv < 1 || dv > ld_v ||
      n_cta < 1)
    return (int)cudaErrorInvalidValue;
  Params p;
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
  const int64_t cols = ld_qk > ld_v ? ld_qk : ld_v;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch ((cols + 63) / 64) {
    case 1:
      return launch<1>(q, k, v, ld_qk, ld_v, p, block_k, st);
    case 2:
      return launch<2>(q, k, v, ld_qk, ld_v, p, block_k, st);
    case 3:
      return launch<3>(q, k, v, ld_qk, ld_v, p, block_k, st);
    case 4:
      return launch<4>(q, k, v, ld_qk, ld_v, p, block_k, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
