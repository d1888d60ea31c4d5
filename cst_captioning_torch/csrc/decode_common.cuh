// Pieces shared by the port's kernels (lstm_beam.cu, lstm_sample.cu,
// lstm_recurrence.cu, attlstm_recurrence.cu).
//
// Every LSTM step runs one gate kernel over gate_preacts: gates = gx +
// emb @ W_x (decoders) + ctx @ W_ctx (attention fusion) + h @ W_h, one
// float32 accumulator per product, added in that order, then the i|f|g|o
// update with a float32 cell.  The decoders then stream the vocab
// projection h @ W_out in 128-column tiles whose logits never leave
// shared memory.  T is a
// template parameter over the compute dtype (float or __nv_bfloat16):
// operands are rounded to T, products accumulate in float32, exactly the
// contract of the reference's dot_general(preferred_element_type=f32).
//
// These are plain SIMT tile GEMMs (smem-staged, FMA in registers): a
// first, correct design.  Tensor cores (wgmma), TMA and a persistent
// whole-recurrence kernel are later work (PERF.md has the times).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cstk {

constexpr int PAD_ID = 0;
constexpr int BOS_ID = 1;
constexpr int EOS_ID = 2;
constexpr float NEG_INF = -1e30f;

// Gate kernel tiling: 32 rows x 32 hidden units (x 4 gates) per block.
constexpr int G_TM = 32;
constexpr int G_TJ = 32;
constexpr int G_KC = 32;
// Vocab tile kernel tiling: 32 rows x 128 vocab columns per block.
constexpr int L_TM = 32;
constexpr int L_TV = 128;
constexpr int L_KC = 32;
constexpr int THREADS = 256;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ float round_cdt(float x);
template <>
__device__ __forceinline__ float round_cdt<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ float round_cdt<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float sigmoidf_(float x) {
  return __frcp_rn(__fadd_rn(1.0f, expf(-x)));
}

// (value desc, id asc): the reference's top-K / argmax tie order.
__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

__device__ __forceinline__ void warp_best(float& bv, int& bi) {
#pragma unroll
  for (int off = 16; off; off >>= 1) {
    float ov = __shfl_xor_sync(0xffffffffu, bv, off);
    int oi = __shfl_xor_sync(0xffffffffu, bi, off);
    if (better(ov, oi, bv, bi)) {
      bv = ov;
      bi = oi;
    }
  }
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename T>
__device__ __forceinline__ void store_cdt(T* p, float x);
template <>
__device__ __forceinline__ void store_cdt<float>(float* p, float x) {
  *p = x;
}
template <>
__device__ __forceinline__ void store_cdt<__nv_bfloat16>(__nv_bfloat16* p,
                                                         float x) {
  *p = __float2bfloat16_rn(x);
}

// One K-chunked pass of a gate GEMM into acc[4 rows][4 gates].  A row r
// is x[i * ldx + k], i = tok[r] with kTok (the feed tokens' embedding
// rows), else i = r; of element type S, rounded to T.  x == nullptr
// stands for zero rows and leaves acc at zero.
template <typename T, typename S, bool kTok>
__device__ __forceinline__ void gate_pass(
    float (&acc)[4][4], float (*As)[G_KC + 1], float (*Ws)[4 * G_TJ],
    const T* __restrict__ W, const S* __restrict__ x, long long ldx,
    const int* __restrict__ tok, int R, int Kdim, int H, int r0, int j0) {
  if (x == nullptr) return;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int H4 = 4 * H;
  for (int k0 = 0; k0 < Kdim; k0 += G_KC) {
    for (int i = threadIdx.x; i < G_TM * G_KC; i += THREADS) {
      const int rr = i / G_KC, kk = i % G_KC;
      const int row = r0 + rr, k = k0 + kk;
      float v = 0.f;
      if (row < R && k < Kdim) {
        size_t src = row;
        if constexpr (kTok) src = tok[row];
        v = round_cdt<T>(to_f(x[src * ldx + k]));
      }
      As[rr][kk] = v;
    }
    for (int i = threadIdx.x; i < G_KC * 4 * G_TJ; i += THREADS) {
      const int kk = i / (4 * G_TJ), cc = i % (4 * G_TJ);
      const int g = cc / G_TJ, j = j0 + cc % G_TJ;
      const int k = k0 + kk;
      Ws[kk][cc] =
          (k < Kdim && j < H) ? to_f(W[(size_t)k * H4 + g * H + j]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < G_KC; ++kk) {
      float a[4], w[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = As[ty * 4 + r][kk];
#pragma unroll
      for (int g = 0; g < 4; ++g) w[g] = Ws[kk][g * G_TJ + tx];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int g = 0; g < 4; ++g) acc[r][g] = fmaf(a[r], w[g], acc[r][g]);
    }
    __syncthreads();
  }
}

// The gate pre-activations of one block's tile, 32 rows x 32 hidden
// units x 4 gates: thread (ty, tx) gets rows r0+ty*4..+3 of hidden unit
// j0+tx, in the reference's order
//   pre = ((gx + emb[tok] @ W_x) + T(ctx) @ W_ctx) + T(h) @ W_h,
// each product a float32 accumulator, each term only where the path has
// it (kEmb: the decoders' fed tokens; kCtx: attention fusion's context,
// so the meanpool instantiations carry no ctx accumulator).  Row r of gx
// starts at gx + r * ldg, row r of h at h + r * ldh (h null: zero state).
// Entries of rows >= R or units >= H are left unset.
template <typename T, bool kEmb, bool kCtx, typename S>
__device__ __forceinline__ void gate_preacts(
    float (&pre)[4][4], const float* __restrict__ gx, long long ldg,
    const T* __restrict__ w_x, const T* __restrict__ emb,
    const int* __restrict__ tok, const T* __restrict__ w_ctx,
    const float* __restrict__ ctx, const T* __restrict__ wh,
    const S* __restrict__ h, long long ldh, int R, int E, int H, int r0,
    int j0) {
  __shared__ float As[G_TM][G_KC + 1];
  __shared__ float Ws[G_KC][4 * G_TJ];
  float acc_e[4][4], acc_c[4][4], acc_h[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int g = 0; g < 4; ++g) acc_e[r][g] = acc_c[r][g] = acc_h[r][g] = 0.f;
  if constexpr (kEmb)
    gate_pass<T, T, true>(acc_e, As, Ws, w_x, emb, E, tok, R, E, H, r0, j0);
  if constexpr (kCtx)
    gate_pass<T, float, false>(acc_c, As, Ws, w_ctx, ctx, E, nullptr, R, E,
                               H, r0, j0);
  gate_pass<T, S, false>(acc_h, As, Ws, wh, h, ldh, nullptr, R, H, H, r0,
                         j0);

  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int j = j0 + tx;
  if (j >= H) return;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = r0 + ty * 4 + r;
    if (row >= R) continue;
    const float* g = gx + (size_t)row * ldg;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float p = g[q * H + j];
      if constexpr (kEmb) p = __fadd_rn(p, acc_e[r][q]);
      if constexpr (kCtx) p = __fadd_rn(p, acc_c[r][q]);
      pre[r][q] = __fadd_rn(p, acc_h[r][q]);
    }
  }
}

// The i|f|g|o update of one unit: c becomes the new cell, returns h.
__device__ __forceinline__ float lstm_cell(const float (&p)[4], float& c) {
  const float ig = sigmoidf_(p[0]);
  const float fg = sigmoidf_(p[1]);
  const float gg = tanhf(p[2]);
  const float og = sigmoidf_(p[3]);
  c = __fadd_rn(__fmul_rn(fg, c), __fmul_rn(ig, gg));
  return __fmul_rn(og, tanhf(c));
}

// A decode step: the gates of the fed tokens (gate_preacts with the
// embedding term; kCtx adds attention's ctx @ W_ctx), then the LSTM
// update.  Grid (ceil(R/32), ceil(H/32)), 256 threads.  h_out must not
// alias h; c_out may alias c_in (each element is read and written by one
// thread).
template <typename T, bool kCtx>
__global__ void __launch_bounds__(THREADS) lstm_gates_kernel(
    const float* __restrict__ gx, const T* __restrict__ w_x,
    const T* __restrict__ w_ctx, const T* __restrict__ wh,
    const T* __restrict__ emb, const int* __restrict__ tok,
    const float* __restrict__ ctx, const float* __restrict__ h,
    const float* c_in, float* __restrict__ h_out, float* c_out, int R, int E,
    int H) {
  const int r0 = blockIdx.x * G_TM, j0 = blockIdx.y * G_TJ;
  float pre[4][4];
  gate_preacts<T, true, kCtx, float>(pre, gx, 4LL * H, w_x, emb, tok, w_ctx,
                                     ctx, wh, h, H, R, E, H, r0, j0);
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int j = j0 + tx;
  if (j >= H) return;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = r0 + ty * 4 + r;
    if (row >= R) continue;
    const size_t o = (size_t)row * H + j;
    float c = c_in[o];
    const float hn = lstm_cell(pre[r], c);
    c_out[o] = c;
    h_out[o] = hn;
  }
}

// A teacher-forced step t of R rows over T_ steps of precomputed input
// gates gx (R, T_, 4H): gate_preacts without the embedding term (kCtx
// adds attention's context), the update with the cell in place, h_seq[:,
// t] written in T and, when c_seq is not null, c_seq[:, t] in float32.
// Layout as lstm_gates_kernel; h_out must not alias h.
template <typename T, bool kCtx>
__global__ void __launch_bounds__(THREADS) lstm_rec_step_kernel(
    const float* __restrict__ gx, const T* __restrict__ w_ctx,
    const T* __restrict__ wh, const float* __restrict__ ctx,
    const float* __restrict__ h, float* __restrict__ h_out, float* c,
    T* __restrict__ h_seq, float* __restrict__ c_seq, int R, int T_, int E,
    int H, int t) {
  const int r0 = blockIdx.x * G_TM, j0 = blockIdx.y * G_TJ;
  float pre[4][4];
  gate_preacts<T, false, kCtx, float>(
      pre, gx + (size_t)t * 4 * H, (long long)T_ * 4 * H, nullptr, nullptr,
      nullptr, w_ctx, ctx, wh, h, H, R, E, H, r0, j0);
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int j = j0 + tx;
  if (j >= H) return;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = r0 + ty * 4 + r;
    if (row >= R) continue;
    const size_t o = (size_t)row * H + j;
    const size_t step = (size_t)row * T_ + t;
    float cn = c[o];
    const float hn = lstm_cell(pre[r], cn);
    c[o] = cn;
    h_out[o] = hn;
    store_cdt<T>(h_seq + step * H + j, hn);
    if (c_seq != nullptr) c_seq[step * H + j] = cn;
  }
}

// The logits of rows r0..r0+31 x columns v0..v0+127 into Ls:
// logit = T(T(h @ W_out) + T(bias)) as float — the reference's
// rounding of the vocab dot and bias add through the compute dtype.
// w_out is (H, Vp) in T, bias (Vp,) float32 with the decode-policy mask
// and padding folded in.  Rows >= R hold garbage and are never read.
template <typename T>
__device__ __forceinline__ void logit_tile(
    float (*Ls)[L_TV + 1], float (*As)[L_KC + 1], float (*Ws)[L_TV],
    const float* __restrict__ h, const T* __restrict__ w_out,
    const float* __restrict__ bias, int R, int H, int Vp, int r0, int v0) {
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[r][q] = 0.f;
  for (int k0 = 0; k0 < H; k0 += L_KC) {
    for (int i = threadIdx.x; i < L_TM * L_KC; i += THREADS) {
      const int rr = i / L_KC, kk = i % L_KC;
      const int row = r0 + rr, k = k0 + kk;
      As[rr][kk] =
          (row < R && k < H) ? round_cdt<T>(h[(size_t)row * H + k]) : 0.f;
    }
    for (int i = threadIdx.x; i < L_KC * L_TV; i += THREADS) {
      const int kk = i / L_TV, cc = i % L_TV;
      const int k = k0 + kk;
      Ws[kk][cc] = k < H ? to_f(w_out[(size_t)k * Vp + v0 + cc]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < L_KC; ++kk) {
      float a[4], w[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = As[ty * 4 + r][kk];
#pragma unroll
      for (int q = 0; q < 4; ++q) w[q] = Ws[kk][tx + 32 * q];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[r][q] = fmaf(a[r], w[q], acc[r][q]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float b = round_cdt<T>(bias[v0 + tx + 32 * q]);
#pragma unroll
    for (int r = 0; r < 4; ++r)
      Ls[ty * 4 + r][tx + 32 * q] =
          round_cdt<T>(__fadd_rn(round_cdt<T>(acc[r][q]), b));
  }
  __syncthreads();
}

}  // namespace cstk

extern "C" const char* cst_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
