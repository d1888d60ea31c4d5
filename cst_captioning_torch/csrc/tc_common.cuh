// Tensor-core pieces of row_gemm.cu's bf16 kernel and the attention
// recurrence's products in attlstm_recurrence.cu (Hopper, sm_90a):
// mma.sync m16n8k16 with bf16 operands and float32 accumulation,
// ldmatrix, cp.async, the summation rule, and a tile GEMM.
//
// The summation rule: an output's k range is walked in
// ascending chunks of TC_KCHUNK = 32.  Each chunk is two chained
// m16n8k16 products into a zeroed float32 fragment (the tensor core's
// own sum of those 32 products), then ONE __fadd_rn into the running
// float32 accumulator, which starts at zero.  Nothing in the order
// depends on how many rows the call holds or on which row of a tile an
// output sits in, so each row's bits are the same whatever the row
// count.  Promoting every 32 products keeps the tensor core's internal
// alignment from adding up over a long K (K = 4,096 at the encode).
//
// Fragment layouts (PTX ISA, mma.m16n8k16 .bf16), with g = lane / 4 and
// t = lane % 4: A (16 x 16, row-major) a0 = A[g][2t..2t+1], a1 = A[g+8]
// [2t..], a2 = A[g][2t+8..], a3 = A[g+8][2t+8..]; B (16 x 8) b0 =
// B[2t..2t+1][g], b1 = B[2t+8..2t+9][g]; C/D c0, c1 = C[g][2t], C[g][2t+1]
// and c2, c3 = C[g+8][2t], C[g+8][2t+1].  The lower index sits in the
// lower 16 bits of a packed pair.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cstk {

constexpr int TC_KCHUNK = 32;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte copy global -> shared through L2 only (.cg).
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's cp.async groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 b16 matrices; lane l gives the row address of matrix l / 8.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// The same, transposed: from a row-major (k, n) tile, the B fragments.
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += A (16 x 16) @ B (16 x 8), bf16 operands, float32 accumulator.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to bf16 (round to nearest even), lo in bits 0-15.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// acc += chunk, element by element (the one float32 add per chunk).
template <int N>
__device__ __forceinline__ void add_chunk(float (&acc)[N],
                                          const float (&c)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] = __fadd_rn(acc[i], c[i]);
}

// ------------------------------------------------------- tile GEMM
//
// One TT_BM x TT_BN output tile of C = A @ B^T on TT_THREADS threads,
// bf16 operands, float32 accumulators, the summation rule above (the
// attention recurrence's and the attention decoders' products).  A (M,
// K) comes from up to three row-major sources split at k = K0 and K1:
// a0 (row stride lda0) for k < K0, a1 (lda1) for K0 <= k < K1 and a2
// (lda2) for k >= K1, so [ctx | h] or [emb | ctx | h] is one operand
// without a copy.  With rows0 given, row r of a0 is a0 row rows0[r] (the
// decoders' embedding rows, picked by the fed token).  B^T is (N, K)
// row-major with row stride ldb:
// the weights as (output column, k), which ldmatrix reads as the col
// operand without a transpose.  With gate_h != 0 output column n of the
// tile order reads B^T row tt_gate_col(n, gate_h), so that each warp's
// 32 columns hold the four gates of 8 hidden units (see tt_gate_col).
// K streams in TT_BK-deep stages through a TT_NS-stage cp.async ring of
// XOR-swizzled tiles.  Needs K % 8 == 0, K0 and K1 multiples of
// TC_KCHUNK, rows and pointers 16-byte aligned.
constexpr int TT_BM = 64;
constexpr int TT_BN = 128;
constexpr int TT_BK = 64;
constexpr int TT_NS = 3;
constexpr int TT_THREADS = 256;
constexpr int TT_A_BYTES = TT_BM * TT_BK * 2;
constexpr int TT_B_BYTES = TT_BN * TT_BK * 2;
constexpr int TT_STAGE = TT_A_BYTES + TT_B_BYTES;
constexpr int TT_SMEM = TT_NS * TT_STAGE;  // 72 KiB of dynamic shared memory

struct TtOperands {
  const __nv_bfloat16* a0;
  long long lda0;
  const __nv_bfloat16* a1;  // unused when K0 >= K
  long long lda1;
  int K0;
  const __nv_bfloat16* bt;
  long long ldb;
  int M, N, K;
  // The third source and the row gather; left out, A has two sources.
  const __nv_bfloat16* a2 = nullptr;  // unused when K1 >= K
  long long lda2 = 0;
  int K1 = 1 << 30;
  const int* rows0 = nullptr;  // null: row r of a0 is row r
};

// Row r, 16-byte chunk c (8 bf16 of k) of a tile with TT_BK k per row.
__device__ __forceinline__ int tt_swz(int row, int chunk) {
  return row * TT_BK + ((chunk ^ (row & 7)) << 3);
}

// The gate order of a 128-column tile block b (hidden units 32b..32b+31):
// tile column nt = 32 w + 8 q + u (warp column w, gate q, unit u) holds
// gate q of unit 32b + 8w + u, i.e. column q * H + 32b + 8w + u of the
// (., 4H) i|f|g|o layout.  A thread's C fragment then holds all four
// gates of its two units.
__device__ __forceinline__ int tt_gate_col(int n, int H) {
  const int nt = n & (TT_BN - 1);
  return ((nt >> 3) & 3) * H + (n >> 7) * 32 + ((nt >> 5) << 3) + (nt & 7);
}

__device__ __forceinline__ void tt_load_stage(unsigned char* slot,
                                              const TtOperands& op,
                                              int gate_h, int m0, int n0,
                                              int k0) {
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(slot);
  __nv_bfloat16* Bs = reinterpret_cast<__nv_bfloat16*>(slot + TT_A_BYTES);
#pragma unroll
  for (int j = 0; j < TT_BM * TT_BK / 8 / TT_THREADS; ++j) {
    const int i = threadIdx.x + j * TT_THREADS;
    const int row = i >> 3, c8 = i & 7;
    const int gr = m0 + row, gk = k0 + 8 * c8;
    __nv_bfloat16* dst = As + tt_swz(row, c8);
    if (gr < op.M && gk < op.K) {
      const __nv_bfloat16* src;
      if (gk < op.K0)
        src = op.a0 + (size_t)(op.rows0 ? op.rows0[gr] : gr) * op.lda0 + gk;
      else if (gk < op.K1)
        src = op.a1 + (size_t)gr * op.lda1 + (gk - op.K0);
      else
        src = op.a2 + (size_t)gr * op.lda2 + (gk - op.K1);
      cp_async16(dst, src);
    } else {
      *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
    }
  }
#pragma unroll
  for (int j = 0; j < TT_BN * TT_BK / 8 / TT_THREADS; ++j) {
    const int i = threadIdx.x + j * TT_THREADS;
    const int row = i >> 3, c8 = i & 7;
    const int gn = n0 + row, gk = k0 + 8 * c8;
    __nv_bfloat16* dst = Bs + tt_swz(row, c8);
    if (gn < op.N && gk < op.K) {
      const int bn = gate_h ? tt_gate_col(gn, gate_h) : gn;
      cp_async16(dst, op.bt + (size_t)bn * op.ldb + gk);
    } else {
      *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
    }
  }
}

// The tile at (m0, n0): warp w = 4 wr + wc holds rows 32 wr .. +31 and
// tile columns 32 wc .. +31; each 32-deep chunk of k from kbeg up (to
// op.K, the last one zero-filled past it), in ascending order, is summed
// by the tensor core from zero into part[mi][ni][e] and handed to
// on_chunk(k, part) (k: the chunk's first index): row m0 + 32 wr + 16 mi
// + lane / 4 + 8 (e / 2), column n0 + 32 wc + 8 ni + 2 (lane % 4) + e %
// 2.
template <typename OnChunk>
__device__ __forceinline__ void tt_mainloop_chunks(const TtOperands& op,
                                                   int gate_h, int m0, int n0,
                                                   unsigned char* smem,
                                                   OnChunk&& on_chunk,
                                                   int kbeg = 0) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wr = warp >> 2, wc = warp & 3;
  const int nk = (op.K - kbeg + TT_BK - 1) / TT_BK;
#pragma unroll
  for (int s = 0; s < TT_NS - 1; ++s) {
    if (s < nk)
      tt_load_stage(smem + s * TT_STAGE, op, gate_h, m0, n0, kbeg + s * TT_BK);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<TT_NS - 2>();
    __syncthreads();  // stage kt in; every warp done with stage kt - 1
    const unsigned char* slot = smem + (kt % TT_NS) * TT_STAGE;
    const int nxt = kt + TT_NS - 1;
    if (nxt < nk)
      tt_load_stage(smem + (nxt % TT_NS) * TT_STAGE, op, gate_h, m0, n0,
                    kbeg + nxt * TT_BK);
    cp_async_commit();
    const __nv_bfloat16* As = reinterpret_cast<const __nv_bfloat16*>(slot);
    const __nv_bfloat16* Bs =
        reinterpret_cast<const __nv_bfloat16*>(slot + TT_A_BYTES);
#pragma unroll
    for (int kc = 0; kc < TT_BK / TC_KCHUNK; ++kc) {
      float part[2][4][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) part[mi][ni][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < TC_KCHUNK / 16; ++kk) {
        const int k16 = kc * (TC_KCHUNK / 16) + kk;
        uint32_t a[2][4], b[4][2];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
          ldsm_x4(a[mi], smem_u32(As + tt_swz(32 * wr + 16 * mi + (lane & 15),
                                              2 * k16 + (lane >> 4))));
#pragma unroll
        for (int nb = 0; nb < 2; ++nb) {
          uint32_t r[4];
          ldsm_x4(r, smem_u32(Bs + tt_swz(32 * wc + 16 * nb + (lane & 7) +
                                              ((lane >> 4) << 3),
                                          2 * k16 + ((lane >> 3) & 1))));
          b[2 * nb][0] = r[0];
          b[2 * nb][1] = r[1];
          b[2 * nb + 1][0] = r[2];
          b[2 * nb + 1][1] = r[3];
        }
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int ni = 0; ni < 4; ++ni)
            mma_bf16(part[mi][ni], a[mi], b[ni][0], b[ni][1]);
      }
      on_chunk(kbeg + kt * TT_BK + kc * TC_KCHUNK, part);
    }
  }
  cp_async_wait<0>();
}

// The summation rule over the tile: acc0[mi][ni][e] (layout above) is
// the float32 sum of the chunks; kSplit: chunks with k >= K0 go to acc1
// instead; without it acc1 stays zero.
template <bool kSplit>
__device__ __forceinline__ void tt_mainloop(const TtOperands& op, int gate_h,
                                            int m0, int n0,
                                            unsigned char* smem,
                                            float (&acc0)[2][4][4],
                                            float (&acc1)[2][4][4]) {
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc0[mi][ni][e] = acc1[mi][ni][e] = 0.f;
  tt_mainloop_chunks(op, gate_h, m0, n0, smem,
                     [&](int k, const float (&part)[2][4][4]) {
                       const bool second = kSplit && k >= op.K0;
#pragma unroll
                       for (int mi = 0; mi < 2; ++mi)
#pragma unroll
                         for (int ni = 0; ni < 4; ++ni) {
                           if (second)
                             add_chunk(acc1[mi][ni], part[mi][ni]);
                           else
                             add_chunk(acc0[mi][ni], part[mi][ni]);
                         }
                     });
}

}  // namespace cstk
