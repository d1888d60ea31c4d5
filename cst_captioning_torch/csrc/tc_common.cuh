// Tensor-core pieces of row_gemm.cu's bf16 kernel (Hopper, sm_90a):
// mma.sync m16n8k16 with bf16 operands and float32 accumulation,
// ldmatrix, cp.async, and the summation rule.
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

}  // namespace cstk
