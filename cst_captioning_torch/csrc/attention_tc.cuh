// Attention pieces shared by the attention recurrence
// (attlstm_recurrence.cu) and the bf16 attention decoders (decode_tc.cuh):
// the tanhf table of bf16 arguments, the query on tc_common.cuh's
// fixed-order mma.sync tile GEMM, and the per-video attention step.
#pragma once

#include <cmath>

#include "attention_common.cuh"
#include "tc_common.cuh"

namespace cstk {

constexpr int AT_ROWS = 4;  // rows of one video per attention block

static cudaError_t set_smem(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// Eight bf16 (16 bytes, element 0 in the low half) as floats, exactly.
__device__ __forceinline__ void unpack8(const uint4 v, float (&x)[8]) {
  x[0] = __uint_as_float(v.x << 16);
  x[1] = __uint_as_float(v.x & 0xffff0000u);
  x[2] = __uint_as_float(v.y << 16);
  x[3] = __uint_as_float(v.y & 0xffff0000u);
  x[4] = __uint_as_float(v.z << 16);
  x[5] = __uint_as_float(v.z & 0xffff0000u);
  x[6] = __uint_as_float(v.w << 16);
  x[7] = __uint_as_float(v.w & 0xffff0000u);
}

__device__ __forceinline__ uint4 pack8(const float (&x)[8]) {
  return make_uint4(pack_bf16(x[0], x[1]), pack_bf16(x[2], x[3]),
                    pack_bf16(x[4], x[5]), pack_bf16(x[6], x[7]));
}

// Eight consecutive elements (16-byte aligned) read through the
// read-only path, as floats.
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&x)[8]) {
  unpack8(__ldg(reinterpret_cast<const uint4*>(p)), x);
}
__device__ __forceinline__ void load8(const float* p, float (&x)[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  x[0] = a.x;
  x[1] = a.y;
  x[2] = a.z;
  x[3] = a.w;
  x[4] = b.x;
  x[5] = b.y;
  x[6] = b.z;
  x[7] = b.w;
}

// The max-subtracted softmax of one row of F scores, by one warp (an
// all-masked row gets uniform weights, as jax.nn.softmax gives).
__device__ __forceinline__ void softmax_warp(float* s, int F, int lane) {
  float m = -INFINITY;
  for (int f = lane; f < F; f += 32) m = fmaxf(m, s[f]);
  m = warp_max(m);
  float sum = 0.f;
  for (int f = lane; f < F; f += 32) {
    const float e = expf(__fsub_rn(s[f], m));
    s[f] = e;
    sum += e;
  }
  sum = warp_sum(sum);
  for (int f = lane; f < F; f += 32) s[f] = __fdiv_rn(s[f], sum);
}

// tanhf of the bf16 kernels' arguments, from a table.  Every tanh
// argument there is a bf16 value (the reference rounds proj + q to T
// first), so tanhf takes at most 2^16 inputs.  A block fills a table of
// tanhf itself for |x| in [2^-16, 64), both signs (22 binades x 128
// mantissas x 2 = 5,632 floats, 22 KiB of shared memory).  Outside that
// range tanhf(x) is x (|x| < 2^-16: the cubic term is under half an ulp)
// or +-1 (|x| >= 64), and NaN stays NaN.  The lookup takes the offset d
// of |x|'s code from 2^-16's: one unsigned compare finds the codes that
// return x (d wraps past the top for |x| < 2^-16; NaN lies above inf),
// and every other code past the table clamps to its last entry of that
// sign, tanhf of the largest bf16 below 64, which is +-1.
// tanh_table_check_kernel holds it to tanhf on every bf16 value.
constexpr int TB_ELO = 127 - 16;                      // biased exponent of 2^-16
constexpr int TB_EHI = 127 + 5;                       // ... of [32, 64)
constexpr int TB_SPAN = (TB_EHI - TB_ELO + 1) * 128;  // entries per sign
constexpr size_t TB_BYTES = 2 * TB_SPAN * sizeof(float);

__device__ __forceinline__ void tanh_table_fill(float* tab) {
  for (int i = threadIdx.x; i < 2 * TB_SPAN; i += blockDim.x) {
    const uint32_t s = i >= TB_SPAN ? 1u : 0u;
    const uint32_t k = (uint32_t)i - s * TB_SPAN;
    tab[i] = tanhf(__uint_as_float((s << 31) | ((k + (TB_ELO << 7)) << 16)));
  }
}

// tanhf of the bf16 value with code c (its 16 bits, sign in bit 15).
__device__ __forceinline__ float tanh_code(uint32_t c, const float* tab) {
  const uint32_t d = (c & 0x7fffu) - (uint32_t)(TB_ELO << 7);
  const float t = tab[(c >> 15) * TB_SPAN + min(d, (uint32_t)TB_SPAN - 1)];
  return d > (uint32_t)(0x7f80 - (TB_ELO << 7)) ? __uint_as_float(c << 16) : t;
}

// tanhf(x) for x a bf16 value (its low 16 bits zero).
__device__ __forceinline__ float tanh_bf16(float x, const float* tab) {
  return tanh_code(__float_as_uint(x) >> 16, tab);
}

// tanh(T(x)): the rounded argument's tanhf, from the table under bf16.
template <typename T>
__device__ __forceinline__ float tanh_t(float x, const float* tab);
template <>
__device__ __forceinline__ float tanh_t<float>(float x, const float*) {
  return tanhf(x);
}
template <>
__device__ __forceinline__ float tanh_t<__nv_bfloat16>(float x,
                                                       const float* tab) {
  return tanh_code(__bfloat16_as_ushort(__float2bfloat16_rn(x)), tab);
}

template <typename T>
__host__ __device__ constexpr size_t table_bytes() {
  return std::is_same<T, __nv_bfloat16>::value ? TB_BYTES : 0;
}

// ------------------------------------------------- the query

// out (M, N) = T(A @ B^T [* scale]) in bf16 (row stride ldo): the query.
__global__ void __launch_bounds__(TT_THREADS, 2) att_query_tc_kernel(
    TtOperands op, const float* __restrict__ scale,
    __nv_bfloat16* __restrict__ out, long long ldo) {
  extern __shared__ __align__(128) unsigned char tt_smem[];
  float acc[2][4][4], unused[2][4][4];
  const int m0 = blockIdx.y * TT_BM, n0 = blockIdx.x * TT_BN;
  tt_mainloop<false>(op, 0, m0, n0, tt_smem, acc, unused);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wr = warp >> 2, wc = warp & 3;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = m0 + 32 * wr + 16 * mi + (lane >> 2) + 8 * hh;
      if (row >= op.M) continue;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n0 + 32 * wc + 8 * ni + 2 * (lane & 3) + e;
          if (n >= op.N) continue;
          float v = acc[mi][ni][2 * hh + e];
          if (scale != nullptr) v = __fmul_rn(v, scale[n]);
          out[(size_t)row * ldo + n] = __float2bfloat16_rn(v);
        }
    }
}

// ------------------------------------------------- the attention step

// Dynamic shared memory of att_fwd_step_kernel<kRows>.
template <int kRows = AT_ROWS>
__host__ __device__ constexpr size_t att_fwd_smem(int F, int A) {
  return (kRows > 1 ? TB_BYTES : 0) + (size_t)kRows * A * 2 + (size_t)A * 4 +
         (size_t)kRows * F * 4;
}

// Score, softmax and context for up to kRows rows of one video (bf16):
// block i is video b = i / groups, rows r0 = b * rep + (i % groups) *
// kRows onwards.  One warp per frame for every row of the block (the
// frame's att_proj read once, from L2): each row's score sum_a th * v is
// the lane's 16-byte chunks in order, then the warp's butterfly; one warp
// per row takes the softmax; one thread per (row, 8 columns of E) mixes
// the context in frame order.  ctx (R, E) is written rounded to bf16 (the
// gate product's operand), the weights into a_out (row stride a_ld)
// unless it is null.  q null: zero queries (step 0).  Dynamic shared
// memory: att_fwd_smem<kRows>(F, A).  Each tanh is tanhf of the bf16
// argument: looked up in the block's table for kRows > 1 (the recurrence
// and the beam decoder), computed for kRows = 1 (the sampler, one row a
// block), where a development run read the lookups slower than tanhf
// itself (PERF.md, PR 9); the table's entries are bitwise tanhf.
template <int kRows = AT_ROWS>
__global__ void __launch_bounds__(THREADS) att_fwd_step_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ att_v,
    const __nv_bfloat16* __restrict__ proj, const float* __restrict__ mask,
    const __nv_bfloat16* __restrict__ vals, int rep, int groups, int F, int A,
    int E, __nv_bfloat16* __restrict__ ctx, float* __restrict__ a_out,
    long long a_ld) {
  constexpr bool kTable = kRows > 1;
  extern __shared__ __align__(16) unsigned char att_smem[];
  float* tab = reinterpret_cast<float*>(att_smem);
  __nv_bfloat16* q_s =
      reinterpret_cast<__nv_bfloat16*>(att_smem + (kTable ? TB_BYTES : 0));
  float* v_s = reinterpret_cast<float*>(q_s + kRows * A);
  float* s_s = v_s + A;
  const int b = blockIdx.x / groups;
  const int r0 = b * rep + (blockIdx.x % groups) * kRows;
  const int nr = min(kRows, (b + 1) * rep - r0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ach = A / 8;
  if constexpr (kTable) tanh_table_fill(tab);
  for (int i = threadIdx.x; i < kRows * ach; i += THREADS) {
    const int rr = i / ach;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (q != nullptr && rr < nr)
      v = __ldg(reinterpret_cast<const uint4*>(q + (size_t)(r0 + rr) * A) +
                (i - rr * ach));
    reinterpret_cast<uint4*>(q_s)[i] = v;
  }
  for (int i = threadIdx.x; i < A; i += THREADS) v_s[i] = to_f(att_v[i]);
  __syncthreads();

  const __nv_bfloat16* pb = proj + (size_t)b * F * A;
  for (int f = warp; f < F; f += THREADS / 32) {
    float s[kRows];
#pragma unroll
    for (int rr = 0; rr < kRows; ++rr) s[rr] = 0.f;
#pragma unroll 2
    for (int c = lane; c < ach; c += 32) {
      float pv[8];
      load8(pb + (size_t)f * A + 8 * c, pv);
      const float4 v0 = reinterpret_cast<const float4*>(v_s)[2 * c];
      const float4 v1 = reinterpret_cast<const float4*>(v_s)[2 * c + 1];
      const float vv[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
#pragma unroll
      for (int rr = 0; rr < kRows; ++rr) {
        float qv[8];
        unpack8(reinterpret_cast<const uint4*>(q_s + rr * A)[c], qv);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float x = __fadd_rn(pv[j], qv[j]);
          const float th = kTable ? tanh_t<__nv_bfloat16>(x, tab)
                                  : tanhf(round_cdt<__nv_bfloat16>(x));
          s[rr] = __fadd_rn(s[rr], __fmul_rn(th, vv[j]));
        }
      }
    }
    const bool live = mask[(size_t)b * F + f] > 0.f;
#pragma unroll
    for (int rr = 0; rr < kRows; ++rr) {
      const float v = warp_sum(s[rr]);
      if (lane == 0 && rr < nr) s_s[rr * F + f] = live ? v : NEG_INF;
    }
  }
  __syncthreads();
  if (warp < nr) {
    float* sr = s_s + warp * F;
    softmax_warp(sr, F, lane);
    if (a_out != nullptr)
      for (int f = lane; f < F; f += 32)
        a_out[(size_t)(r0 + warp) * a_ld + f] = sr[f];
  }
  __syncthreads();

  const int ech = E / 8;
  const __nv_bfloat16* vb = vals + (size_t)b * F * E;
  for (int i = threadIdx.x; i < nr * ech; i += THREADS) {
    const int rr = i / ech, c = i - rr * ech;
    const float* a = s_s + rr * F;
    float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll 8
    for (int f = 0; f < F; ++f) {
      float x[8];
      load8(vb + (size_t)f * E + 8 * c, x);
      const float af = a[f];
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[j] = __fadd_rn(acc[j], __fmul_rn(af, x[j]));
    }
    reinterpret_cast<uint4*>(ctx + (size_t)(r0 + rr) * E)[c] = pack8(acc);
  }
}

}  // namespace cstk
