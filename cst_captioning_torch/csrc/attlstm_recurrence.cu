// Teacher-forced attention + LSTM recurrence and its backward for Hopper
// (sm_90a).
//
// Replaces the TPU kernels of the JAX package, ops/pallas_attlstm.py::
// attlstm_recurrence: the forward (_fwd_call -> pallas_call, kernel
// _make_fwd_kernel; entry cst_attlstm_recurrence_fwd) and the backward of
// its custom VJP (_vjp_bwd -> _bwd_call -> pallas_call, kernel
// _bwd_kernel; entry cst_attlstm_recurrence_bwd).  Same functions:
//
// forward, R rows from zero state over T steps of precomputed input
// gates gx (R, T, 4H) float32: the attention step of attention_common.cuh
// queried by h, then gates = (gx_t + T(ctx) @ W_ctx) + T(h) @ W_h and the
// i|f|g|o update with a float32 cell.  h_seq is written in T and, under
// autograd, the float32 residuals c_seq (R, T, H) and a_seq (R, T, F).
//
// backward, reversed time: gates recomputed from the stored h_seq and the
// saved weights (ctx = sum_f a_f vals_f), the LSTM cotangents, dgx_t =
// dgates (float32), dctx = T(dgates) @ W_ctx^T, dh = T(dgates) @ W_h^T +
// T(dq) @ att_wh^T, the attention cotangents (da, ds, th recomputed)
// with dproj and dvals accumulated per row across time and dv per row,
// then summed over rows in a second pass: no float atomics, so the result
// repeats run to run.  The three weight cotangents (dW_h, dW_ctx,
// datt_wh) are contractions the caller does outside, as the reference.
//
// Bound on the H100.  Forward at the XE shape (bf16, R = 1280, T = 29,
// H = E = A = 512, F = 56): 2*R*T*(H*4H + E*4H + H*A + F*(A+E)) ~ 179
// GFLOP (0.18 ms on the tensor cores) against ~0.58 GB of compulsory
// bytes (gx 304 MB, att_proj + att_vals 147 MB, h_seq, c_seq, a_seq);
// plus R*T*F*A = 1.06 G tanh evaluations, which at the SFU rate (16 per
// SM per clock, ~4.2 T/s) take ~0.25 ms themselves.  The backward does
// about twice the products and reads and writes about twice the bytes.
//
// Design (first, simple; PERF.md has the times): the TPU kernels keep the
// attention tensors, W_h, W_ctx and the (h, c) carry in one core's VMEM
// across a sequential grid.  Here the host loops over T on the caller's
// stream, no host sync: per forward step the query GEMM, one block per
// row for score / softmax / context, and the gate GEMM + update (3
// launches); per backward step 7 launches (query GEMM, context from the
// saved weights, gate recompute + LSTM cotangents, two cotangent GEMMs,
// the attention cotangents one block per row, the dh_att GEMM).  Each
// step re-reads the row's att_proj and att_vals (from L2 or HBM).
#include <cmath>

#include "attention_common.cuh"

namespace cstk {

// ------------------------------------------------------------ forward

template <typename T>
static int run_fwd(const float* gx, const T* wh, const AttArgs<T>& at,
                   float* h_a, float* h_b, float* c, T* h_seq, float* c_seq,
                   float* a_seq, int R, int T_, int H, int E,
                   cudaStream_t st) {
  const dim3 grid((R + G_TM - 1) / G_TM, (H + G_TJ - 1) / G_TJ);
  float* h_in = h_a;
  float* h_out = h_b;
  for (int t = 0; t < T_; ++t) {
    cudaError_t e = attention_step<T>(
        at, h_in, R, 1, H, E,
        a_seq != nullptr ? a_seq + (size_t)t * at.F : nullptr,
        (long long)T_ * at.F, st);
    if (e != cudaSuccess) return (int)e;
    lstm_rec_step_kernel<T, true><<<grid, THREADS, 0, st>>>(
        gx, at.w_ctx, wh, at.ctx, h_in, h_out, c, h_seq, c_seq, R, T_, E, H,
        t);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    float* tmp = h_in;
    h_in = h_out;
    h_out = tmp;
  }
  return 0;
}

// ----------------------------------------------------------- backward

// ctx[r] = sum_f a[r * a_ld + f] * vals[r, f, :], one block per row, the
// forward's mix order.  Dynamic shared memory: F floats.
template <typename T>
__global__ void __launch_bounds__(THREADS) att_mix_kernel(
    const float* __restrict__ a, long long a_ld, const T* __restrict__ vals,
    int F, int E, float* __restrict__ ctx) {
  extern __shared__ float a_s[];
  const int r = blockIdx.x;
  for (int f = threadIdx.x; f < F; f += THREADS)
    a_s[f] = a[(size_t)r * a_ld + f];
  __syncthreads();
  mix_context<T>(a_s, vals + (size_t)r * F * E, F, E, ctx + (size_t)r * E);
}

// Step t: recompute the gates (gx_t + T(ctx) @ W_ctx + T(h_{t-1}) @ W_h,
// decode_common.cuh gate_preacts), then the LSTM cotangents with dh =
// dh_out_t + dh_c and the cell carry dc_c: write dgates into dgx[:, t] and
// dc_c = dc * f.  h_prev (row stride ldh) is null at t = 0 (zero state);
// the thread layout is lstm_rec_step_kernel's, so every element is read
// and written by one thread.
template <typename T>
__global__ void __launch_bounds__(THREADS) attlstm_bwd_gates_kernel(
    const float* __restrict__ gx, const T* __restrict__ w_ctx,
    const T* __restrict__ wh, const float* __restrict__ ctx,
    const T* __restrict__ h_prev, long long ldh,
    const float* __restrict__ c_seq, const float* __restrict__ dh_out,
    const float* __restrict__ dh_c, float* dc_c, float* __restrict__ dgx,
    int R, int T_, int E, int H, int t) {
  const int r0 = blockIdx.x * G_TM, j0 = blockIdx.y * G_TJ;
  float pre[4][4];
  gate_preacts<T, false, true, T>(
      pre, gx + (size_t)t * 4 * H, (long long)T_ * 4 * H, nullptr, nullptr,
      nullptr, w_ctx, ctx, wh, h_prev, ldh, R, E, H, r0, j0);
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int j = j0 + tx;
  if (j >= H) return;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = r0 + ty * 4 + r;
    if (row >= R) continue;
    const size_t step = (size_t)row * T_ + t;
    const float ig = sigmoidf_(pre[r][0]);
    const float fg = sigmoidf_(pre[r][1]);
    const float gg = tanhf(pre[r][2]);
    const float og = sigmoidf_(pre[r][3]);
    const float tch = tanhf(c_seq[step * H + j]);
    const float cp = t > 0 ? c_seq[(step - 1) * H + j] : 0.f;
    const size_t o = (size_t)row * H + j;
    const float dh = __fadd_rn(dh_out[step * H + j], dh_c[o]);
    const float d_o = __fmul_rn(__fmul_rn(__fmul_rn(dh, tch), og),
                                __fsub_rn(1.f, og));
    const float dc = __fadd_rn(
        dc_c[o], __fmul_rn(__fmul_rn(dh, og),
                           __fsub_rn(1.f, __fmul_rn(tch, tch))));
    const float di = __fmul_rn(__fmul_rn(__fmul_rn(dc, gg), ig),
                               __fsub_rn(1.f, ig));
    const float df = __fmul_rn(__fmul_rn(__fmul_rn(dc, cp), fg),
                               __fsub_rn(1.f, fg));
    const float dg = __fmul_rn(__fmul_rn(dc, ig),
                               __fsub_rn(1.f, __fmul_rn(gg, gg)));
    float* d = dgx + step * 4 * H;
    d[j] = di;
    d[H + j] = df;
    d[2 * H + j] = dg;
    d[3 * H + j] = d_o;
    dc_c[o] = __fmul_rn(dc, fg);
  }
}

// The attention cotangents of step t, one block per row (rows are
// per-caption here): da_f = dctx . vals_f, ds = a * (da - sum(a * da)),
// th recomputed from the T-rounded query, dpre = ds * v * (1 - th^2).
// dvals += a * dctx and dproj += dpre (this row's accumulators, touched
// by this block only), dv_part[r] += sum_f th * ds, dq[r] = sum_f dpre.
// Dynamic shared memory: (E + 2A + 2F) floats.
template <typename T>
__global__ void __launch_bounds__(THREADS) att_bwd_kernel(
    const float* __restrict__ dctx, const float* __restrict__ a,
    long long a_ld, const float* __restrict__ q, const T* __restrict__ att_v,
    const T* __restrict__ proj, const T* __restrict__ vals,
    float* __restrict__ dproj, float* __restrict__ dvals,
    float* __restrict__ dv_part, float* __restrict__ dq, long long dq_ld,
    int F, int A, int E) {
  extern __shared__ float sm[];
  float* dctx_s = sm;
  float* q_s = dctx_s + E;
  float* v_s = q_s + A;
  float* a_s = v_s + A;
  float* ds_s = a_s + F;
  const int r = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < E; i += THREADS)
    dctx_s[i] = dctx[(size_t)r * E + i];
  for (int i = threadIdx.x; i < A; i += THREADS) {
    q_s[i] = q[(size_t)r * A + i];
    v_s[i] = to_f(att_v[i]);
  }
  for (int f = threadIdx.x; f < F; f += THREADS)
    a_s[f] = a[(size_t)r * a_ld + f];
  __syncthreads();
  const T* vl = vals + (size_t)r * F * E;
  const T* pr = proj + (size_t)r * F * A;
  for (int f = warp; f < F; f += THREADS / 32) {
    float s = 0.f;
    for (int e = lane; e < E; e += 32)
      s = __fadd_rn(s, __fmul_rn(dctx_s[e], to_f(vl[(size_t)f * E + e])));
    s = warp_sum(s);
    if (lane == 0) ds_s[f] = s;
  }
  __syncthreads();
  if (warp == 0) {
    float sad = 0.f;
    for (int f = lane; f < F; f += 32) sad += __fmul_rn(a_s[f], ds_s[f]);
    sad = warp_sum(sad);
    for (int f = lane; f < F; f += 32)
      ds_s[f] = __fmul_rn(a_s[f], __fsub_rn(ds_s[f], sad));
  }
  __syncthreads();
  float* dvl = dvals + (size_t)r * F * E;
  for (int i = threadIdx.x; i < F * E; i += THREADS)
    dvl[i] = __fadd_rn(dvl[i], __fmul_rn(a_s[i / E], dctx_s[i % E]));
  float* dpr = dproj + (size_t)r * F * A;
  for (int col = threadIdx.x; col < A; col += THREADS) {
    const float qa = q_s[col], va = v_s[col];
    float dqa = 0.f, dva = 0.f;
    for (int f = 0; f < F; ++f) {
      const size_t o = (size_t)f * A + col;
      const float th =
          tanhf(round_cdt<T>(__fadd_rn(to_f(pr[o]), qa)));
      dva = __fadd_rn(dva, __fmul_rn(th, ds_s[f]));
      const float dpre = __fmul_rn(__fmul_rn(ds_s[f], va),
                                   __fsub_rn(1.f, __fmul_rn(th, th)));
      dpr[o] = __fadd_rn(dpr[o], dpre);
      dqa = __fadd_rn(dqa, dpre);
    }
    dq[(size_t)r * dq_ld + col] = dqa;
    dv_part[(size_t)r * A + col] = __fadd_rn(dv_part[(size_t)r * A + col], dva);
  }
}

// out[n] = sum over rows of part[r, n], in row order (the second pass of
// the dv reduction).
__global__ void col_sum_kernel(const float* __restrict__ part, int R, int N,
                               float* __restrict__ out) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  float s = 0.f;
  for (int r = 0; r < R; ++r) s = __fadd_rn(s, part[(size_t)r * N + n]);
  out[n] = s;
}

template <typename T>
static int run_bwd(const float* gx, const T* wh, const T* w_ctx,
                   const T* att_wh, const T* att_v, const T* proj,
                   const T* vals, const T* h_seq, const float* c_seq,
                   const float* a_seq, const float* dh, float* dgx,
                   float* dq_seq, float* dproj, float* dvals, float* dv_part,
                   float* dv, float* dh_c, float* dc_c, float* q, float* ctx,
                   float* dctx, int R, int T_, int H, int E, int A, int F,
                   cudaStream_t st) {
  const dim3 gate_grid((R + G_TM - 1) / G_TM, (H + G_TJ - 1) / G_TJ);
  const long long G = 4LL * H;
  const size_t att_smem = (size_t)(E + 2 * A + 2 * F) * sizeof(float);
  cudaError_t e;
  for (int t = T_ - 1; t >= 0; --t) {
    const T* hp = t > 0 ? h_seq + (size_t)(t - 1) * H : nullptr;
    if (hp != nullptr)
      e = row_gemm<T, T, false>(hp, (long long)T_ * H, att_wh, q, A, R, H, A,
                                kStoreRounded, st);
    else
      e = cudaMemsetAsync(q, 0, sizeof(float) * (size_t)R * A, st);
    if (e != cudaSuccess) return (int)e;
    att_mix_kernel<T><<<R, THREADS, F * sizeof(float), st>>>(
        a_seq + (size_t)t * F, (long long)T_ * F, vals, F, E, ctx);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    attlstm_bwd_gates_kernel<T><<<gate_grid, THREADS, 0, st>>>(
        gx, w_ctx, wh, ctx, hp, (long long)T_ * H, c_seq, dh, dh_c, dc_c,
        dgx, R, T_, E, H, t);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    const float* dg = dgx + (size_t)t * G;
    e = row_gemm<T, float, true>(dg, T_ * G, w_ctx, dctx, E, R, (int)G, E,
                                 kStore, st);
    if (e != cudaSuccess) return (int)e;
    e = row_gemm<T, float, true>(dg, T_ * G, wh, dh_c, H, R, (int)G, H,
                                 kStore, st);
    if (e != cudaSuccess) return (int)e;
    att_bwd_kernel<T><<<R, THREADS, att_smem, st>>>(
        dctx, a_seq + (size_t)t * F, (long long)T_ * F, q, att_v, proj, vals,
        dproj, dvals, dv_part, dq_seq + (size_t)t * A, (long long)T_ * A, F,
        A, E);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    e = row_gemm<T, float, true>(dq_seq + (size_t)t * A, (long long)T_ * A,
                                 att_wh, dh_c, H, R, A, H, kAdd, st);
    if (e != cudaSuccess) return (int)e;
  }
  col_sum_kernel<<<(A + THREADS - 1) / THREADS, THREADS, 0, st>>>(dv_part, R,
                                                                  A, dv);
  return (int)cudaGetLastError();
}

}  // namespace cstk

// dtype: 0 = float32, 1 = bfloat16 (wh, w_ctx, att_wh, att_v, att_proj,
// att_vals, h_seq).  gx (R, T, 4H) float32; att_mask (R, F) float32; the
// caller zeroes h_a and c and passes scratch q (R, A), ctx (R, E);
// c_seq (R, T, H) and a_seq (R, T, F) float32 or both null.  Returns 0 or
// the CUDA error code of the first refused launch.
extern "C" int cst_attlstm_recurrence_fwd(
    int dtype, const void* gx, const void* wh, const void* w_ctx,
    const void* att_wh, const void* att_v, const void* proj,
    const void* mask, const void* vals, void* h_a, void* h_b, void* c,
    void* q, void* ctx, void* h_seq, void* c_seq, void* a_seq, int R, int T,
    int H, int E, int A, int F, void* stream) {
  if (R < 1 || T < 1 || H < 1 || E < 1 || A < 1 || F < 1)
    return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
#define CST_FWD_CALL(CT)                                                     \
  cstk::run_fwd<CT>(                                                         \
      static_cast<const float*>(gx), static_cast<const CT*>(wh),             \
      cstk::AttArgs<CT>{static_cast<const CT*>(w_ctx),                       \
                        static_cast<const CT*>(att_wh),                      \
                        static_cast<const CT*>(att_v),                       \
                        static_cast<const CT*>(proj),                        \
                        static_cast<const float*>(mask),                     \
                        static_cast<const CT*>(vals), static_cast<float*>(q), \
                        static_cast<float*>(ctx), A, F},                     \
      static_cast<float*>(h_a), static_cast<float*>(h_b),                    \
      static_cast<float*>(c), static_cast<CT*>(h_seq),                       \
      static_cast<float*>(c_seq), static_cast<float*>(a_seq), R, T, H, E,    \
      st)
  if (dtype == 0) return CST_FWD_CALL(float);
  if (dtype == 1) return CST_FWD_CALL(__nv_bfloat16);
#undef CST_FWD_CALL
  return (int)cudaErrorInvalidValue;
}

// dtype as the forward.  Inputs: gx, the weights, att_proj, att_vals, the
// forward's h_seq, c_seq, a_seq and the float32 cotangent dh (R, T, H).
// Outputs (float32): dgx (R, T, 4H), dq_seq (R, T, A), dproj (R, F, A)
// and dvals (R, F, E) zeroed by the caller and accumulated here, dv (A).
// Scratch: dv_part (R, A), dh_c, dc_c (R, H) zeroed by the caller; q
// (R, A), ctx, dctx (R, E).
extern "C" int cst_attlstm_recurrence_bwd(
    int dtype, const void* gx, const void* wh, const void* w_ctx,
    const void* att_wh, const void* att_v, const void* proj,
    const void* vals, const void* h_seq, const void* c_seq,
    const void* a_seq, const void* dh, void* dgx, void* dq_seq, void* dproj,
    void* dvals, void* dv_part, void* dv, void* dh_c, void* dc_c, void* q,
    void* ctx, void* dctx, int R, int T, int H, int E, int A, int F,
    void* stream) {
  if (R < 1 || T < 1 || H < 1 || E < 1 || A < 1 || F < 1)
    return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
#define CST_BWD_CALL(CT)                                                      \
  cstk::run_bwd<CT>(                                                          \
      static_cast<const float*>(gx), static_cast<const CT*>(wh),              \
      static_cast<const CT*>(w_ctx), static_cast<const CT*>(att_wh),          \
      static_cast<const CT*>(att_v), static_cast<const CT*>(proj),            \
      static_cast<const CT*>(vals), static_cast<const CT*>(h_seq),            \
      static_cast<const float*>(c_seq), static_cast<const float*>(a_seq),     \
      static_cast<const float*>(dh), static_cast<float*>(dgx),                \
      static_cast<float*>(dq_seq), static_cast<float*>(dproj),                \
      static_cast<float*>(dvals), static_cast<float*>(dv_part),               \
      static_cast<float*>(dv), static_cast<float*>(dh_c),                     \
      static_cast<float*>(dc_c), static_cast<float*>(q),                      \
      static_cast<float*>(ctx), static_cast<float*>(dctx), R, T, H, E, A, F,  \
      st)
  if (dtype == 0) return CST_BWD_CALL(float);
  if (dtype == 1) return CST_BWD_CALL(__nv_bfloat16);
#undef CST_BWD_CALL
  return (int)cudaErrorInvalidValue;
}
