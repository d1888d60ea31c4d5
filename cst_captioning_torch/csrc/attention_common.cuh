// Pieces shared by the attention kernels: the attention decoders in
// lstm_beam.cu and lstm_sample.cu (float32 compute; their bf16 chain is
// decode_tc.cuh's), the teacher-forced recurrence and its backward in
// attlstm_recurrence.cu, and the context kernels.  The SIMT gate kernels
// are decode_common.cuh's, instantiated with the ctx @ W_ctx term.
//
// The Bahdanau step of the reference's fused kernels (pallas_attlstm.py
// _make_fwd_kernel, pallas_beam.py / pallas_sampler.py attention blocks):
//   q   = T(T(h) @ att_wh)                     float32 accumulation
//   th  = tanh(T(proj + q))                    float32 tanh of a T value
//   s_f = sum_a th * v (float32), -1e30 where the frame is masked
//   a   = softmax over frames (max-subtracted, float32)
//   ctx = sum_f a_f * vals_f                   float32
// with T the compute dtype (float or __nv_bfloat16).  A row whose frames
// are all masked gets uniform weights (exp(0) everywhere), as
// jax.nn.softmax gives.  The tanh result is used in float32: the
// reference's XLA path keeps it there (see ops/attlstm.py).
//
// Design (first, simple; PERF.md has the times): plain SIMT tiles, like
// decode_common.cuh.  One generic row GEMM (32 rows x 128 columns per
// block, W read as (K, N) or transposed) serves the query and the
// backward's cotangent products; one block per row walks that row's
// video's frames for the score, softmax and context, so a beam decoder
// serves a video's K beams from one copy of att_proj / att_vals (row r
// reads video r / rep) instead of the TPU kernel's K-fold repeat.
#pragma once

#include <cmath>

#include "decode_common.cuh"

namespace cstk {

// Row GEMM tiling: 32 rows x 128 output columns per block.
constexpr int M_TM = 32;
constexpr int M_TN = 128;
constexpr int M_KC = 32;

// What a row GEMM does with its float32 accumulator.
constexpr int kStore = 0;         // out = acc
constexpr int kStoreRounded = 1;  // out = T(acc)
constexpr int kAdd = 2;           // out = out + acc (one float32 add)

// out[r, n] (mode) sum_k T(x[r * ldx + k]) * W(k, n) for rows r0..r0+31
// and columns n0..n0+127, where W(k, n) = w[k * N + n] (w is (K, N)) or,
// with kTransW, w[n * K + k] (w is (N, K): x @ w^T).  w holds WT: T, or
// int8 codes (T(code) exactly) with the column scale applied to the
// float32 sum, acc * scale[n], before the mode (scale null: none).
template <typename T, typename S, bool kTransW, typename WT = T>
__global__ void __launch_bounds__(THREADS) row_gemm_kernel(
    const S* __restrict__ x, long long ldx, const WT* __restrict__ w,
    float* out, long long ldo, int R, int Kd, int N, int mode,
    const float* __restrict__ scale) {
  __shared__ float As[M_TM][M_KC + 1];
  __shared__ float Ws[M_KC][M_TN + 1];
  const int r0 = blockIdx.x * M_TM, n0 = blockIdx.y * M_TN;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[r][q] = 0.f;
  for (int k0 = 0; k0 < Kd; k0 += M_KC) {
    for (int i = threadIdx.x; i < M_TM * M_KC; i += THREADS) {
      const int rr = i / M_KC, kk = i % M_KC;
      const int row = r0 + rr, k = k0 + kk;
      As[rr][kk] = (row < R && k < Kd)
                       ? round_cdt<T>(to_f(x[(size_t)row * ldx + k]))
                       : 0.f;
    }
    for (int i = threadIdx.x; i < M_KC * M_TN; i += THREADS) {
      int kk, cc;
      if (kTransW) {
        cc = i / M_KC;
        kk = i % M_KC;
      } else {
        kk = i / M_TN;
        cc = i % M_TN;
      }
      const int k = k0 + kk, n = n0 + cc;
      float v = 0.f;
      if (k < Kd && n < N)
        v = to_f(kTransW ? w[(size_t)n * Kd + k] : w[(size_t)k * N + n]);
      Ws[kk][cc] = v;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < M_KC; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = As[ty * 4 + r][kk];
#pragma unroll
      for (int q = 0; q < 4; ++q) b[q] = Ws[kk][tx + 32 * q];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[r][q] = fmaf(a[r], b[q], acc[r][q]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = r0 + ty * 4 + r;
    if (row >= R) continue;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int n = n0 + tx + 32 * q;
      if (n >= N) continue;
      float* o = out + (size_t)row * ldo + n;
      const float v =
          scale != nullptr ? __fmul_rn(acc[r][q], scale[n]) : acc[r][q];
      if (mode == kAdd)
        *o = __fadd_rn(*o, v);
      else
        *o = mode == kStoreRounded ? round_cdt<T>(v) : v;
    }
  }
}

template <typename T, typename S, bool kTransW, typename WT = T>
static cudaError_t row_gemm(const S* x, long long ldx, const WT* w,
                            float* out, long long ldo, int R, int Kd, int N,
                            int mode, cudaStream_t st,
                            const float* scale = nullptr) {
  const dim3 grid((R + M_TM - 1) / M_TM, (N + M_TN - 1) / M_TN);
  row_gemm_kernel<T, S, kTransW, WT>
      <<<grid, THREADS, 0, st>>>(x, ldx, w, out, ldo, R, Kd, N, mode, scale);
  return cudaGetLastError();
}

// ctx_row[e] = sum_f a_s[f] * vals_row[f, e] in frame order (float32),
// stored as C (float, or rounded once to __nv_bfloat16).
template <typename T, typename C = float>
__device__ __forceinline__ void mix_context(const float* a_s,
                                            const T* __restrict__ vals_row,
                                            int F, int E,
                                            C* __restrict__ ctx_row) {
  for (int e = threadIdx.x; e < E; e += THREADS) {
    float acc = 0.f;
    for (int f = 0; f < F; ++f)
      acc = __fadd_rn(acc, __fmul_rn(a_s[f], to_f(vals_row[(size_t)f * E + e])));
    store_cdt<C>(ctx_row + e, acc);
  }
}

// The score, softmax and context of one row per block (THREADS threads).
// q (R, A) holds T-rounded queries (float, or T itself); proj (B, F, A),
// vals (B, F, E) and mask (B, F) are per video, row r reading video
// r / rep.  ctx (R, E) is float or T.  Dynamic shared memory: (2A + F)
// floats.  a_out (row stride a_ld) may be null.
template <typename T, typename Q = float, typename C = float>
__global__ void __launch_bounds__(THREADS) att_context_kernel(
    const Q* __restrict__ q, const T* __restrict__ att_v,
    const T* __restrict__ proj, const float* __restrict__ mask,
    const T* __restrict__ vals, int rep, int F, int A, int E,
    C* __restrict__ ctx, float* __restrict__ a_out, long long a_ld) {
  extern __shared__ float sm[];
  float* q_s = sm;
  float* v_s = sm + A;
  float* s_s = sm + 2 * A;
  const int r = blockIdx.x, vid = r / rep;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < A; i += THREADS) {
    q_s[i] = to_f(q[(size_t)r * A + i]);
    v_s[i] = to_f(att_v[i]);
  }
  __syncthreads();
  const T* pr = proj + (size_t)vid * F * A;
  for (int f = warp; f < F; f += THREADS / 32) {
    float s = 0.f;
    for (int a = lane; a < A; a += 32) {
      const float pre =
          round_cdt<T>(__fadd_rn(to_f(pr[(size_t)f * A + a]), q_s[a]));
      s = __fadd_rn(s, __fmul_rn(tanhf(pre), v_s[a]));
    }
    s = warp_sum(s);
    if (lane == 0) s_s[f] = mask[(size_t)vid * F + f] > 0.f ? s : NEG_INF;
  }
  __syncthreads();
  if (warp == 0) {
    float m = -INFINITY;
    for (int f = lane; f < F; f += 32) m = fmaxf(m, s_s[f]);
    m = warp_max(m);
    float sum = 0.f;
    for (int f = lane; f < F; f += 32) {
      const float e = expf(__fsub_rn(s_s[f], m));
      s_s[f] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int f = lane; f < F; f += 32) s_s[f] = __fdiv_rn(s_s[f], sum);
  }
  __syncthreads();
  if (a_out != nullptr)
    for (int f = threadIdx.x; f < F; f += THREADS)
      a_out[(size_t)r * a_ld + f] = s_s[f];
  mix_context<T, C>(s_s, vals + (size_t)vid * F * E, F, E, ctx + (size_t)r * E);
}

// The attention operands of one call, per video, plus its scratch.  WT
// is the weights' type: T, or int8 codes (the int8w decoders and
// recurrence) with att_scale the (A,) column scales of att_wh (null for
// float weights).
template <typename T, typename WT = T>
struct AttArgs {
  const WT* w_ctx;  // (E, 4H)
  const WT* att_wh;  // (H, A)
  const T* att_v;   // (A,)
  const T* proj;    // (B, F, A)
  const float* mask;  // (B, F)
  const T* vals;    // (B, F, E)
  float* q;         // (R, A) scratch
  float* ctx;       // (R, E) scratch
  int A;
  int F;
  const float* att_scale;  // (A,) or null
};

// One attention step for R rows (rep rows per video): q = T(T(h) @ att_wh
// [* att_scale]), then ctx (and the weights into a_out when it is not
// null).
template <typename T, typename WT>
static cudaError_t attention_step(const AttArgs<T, WT>& at, const float* h,
                                  int R, int rep, int H, int E, float* a_out,
                                  long long a_ld, cudaStream_t st) {
  cudaError_t e = row_gemm<T, float, false, WT>(
      h, H, at.att_wh, at.q, at.A, R, H, at.A, kStoreRounded, st,
      at.att_scale);
  if (e != cudaSuccess) return e;
  const size_t smem = (size_t)(2 * at.A + at.F) * sizeof(float);
  att_context_kernel<T><<<R, THREADS, smem, st>>>(
      at.q, at.att_v, at.proj, at.mask, at.vals, rep, at.F, at.A, E, at.ctx,
      a_out, a_ld);
  return cudaGetLastError();
}

}  // namespace cstk
