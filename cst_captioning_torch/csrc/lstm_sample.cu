// Fused greedy / multinomial sampling decode for Hopper (sm_90a),
// meanpool and attention fusion.
//
// Replaces the TPU kernels of the JAX package, ops/pallas_sampler.py::
// lstm_sample (_sample_impl -> pallas_call, kernel _make_sample_kernel,
// static_ctx=True; entry cst_lstm_sample) and ops/pallas_sampler.py::
// attlstm_sample (the same pallas_call with static_ctx=False; entry
// cst_attlstm_sample).  Same function: B rows decoded from zero state for
// T steps; per step the LSTM update, the vocab logits streamed in tiles
// with an online log-sum-exp of logits * inv_temp and an online argmax
// (greedy) or Gumbel-max (multinomial, a murmur3 counter hash), then the
// finished-row rule (a finished row emits PAD / 0 / mask 0, EOS feeds
// back, the step that samples EOS keeps mask 1).
//
// The multinomial stream is the reference's, bit for bit: counter
// ((row + b*bt)*T + t)*V_pad + v and seed word
// fmix32(fmix32(s0 + 0x9E3779B9*b*bt) + s1), in uint32 wraparound.  bt
// and V_pad are the TPU tile picker's and arrive as stream parameters,
// apart from this kernel's own 128-column tiling (under attention the
// picker counts the attention operands, so the wrapper passes that
// geometry).  Attention adds the Bahdanau step of attention_common.cuh and
// the ctx @ W_ctx term, in the gate order gx_static + emb + ctx + h.
//
// Bound on the H100: operations.  Per step 2*B*(E+H)*4H + 2*B*H*V
// multiply-adds; at B=64, E=H=512, V=10,496, T=30 about 28.7 GFLOP;
// attention adds 2*B*(H*A + E*4H + F*(A+E)) per step (~5 GFLOP at F=56,
// A=512) and B*F*A tanh evaluations per step.
//
// Design (first, simple; PERF.md has its times): the host loops over T,
// three launches per step on the caller's stream, no host sync — the
// gate GEMM + update (shared with the beam kernel), the vocab tile GEMM
// reducing its logits in shared memory to per-(row, tile) max, sum-exp
// and best z, and a per-row merge in tile order (earliest tile wins a
// tie, as the reference's strict '>' does).  The attention decoder adds
// two launches per step before the gates (query GEMM; score / softmax /
// context, one block per row).
#include <climits>
#include <cmath>

#include "attention_common.cuh"

namespace cstk {

__device__ __forceinline__ uint32_t fmix32(uint32_t z) {
  z ^= z >> 16;
  z *= 0x85EBCA6Bu;
  z ^= z >> 13;
  z *= 0xC2B2AE35u;
  z ^= z >> 16;
  return z;
}

__device__ __forceinline__ float gumbel(uint32_t counter, uint32_t seed_word) {
  const uint32_t bits = fmix32(fmix32(counter + seed_word));
  const float u = __fadd_rn(
      __fmul_rn(__uint2float_rn(bits >> 8), 5.9604644775390625e-08f),
      2.98023223876953125e-08f);
  return -logf(-logf(u));
}

template <typename T>
__global__ void __launch_bounds__(THREADS) sample_tile_kernel(
    const float* __restrict__ h, const T* __restrict__ w_out,
    const float* __restrict__ bias, int R, int H, int Vp, int t, int T_,
    int bt, int vpad_stream, uint32_t s0, uint32_t s1, float inv_temp,
    int greedy, float* __restrict__ part_m, float* __restrict__ part_s,
    float* __restrict__ part_z, int* __restrict__ part_zi,
    float* __restrict__ part_zs) {
  __shared__ float Ls[L_TM][L_TV + 1];
  __shared__ float As[L_TM][L_KC + 1];
  __shared__ float Ws[L_KC][L_TV];
  const int r0 = blockIdx.x * L_TM, tile = blockIdx.y, v0 = tile * L_TV;
  const int nT = gridDim.y;
  logit_tile<T>(Ls, As, Ws, h, w_out, bias, R, H, Vp, r0, v0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int rr = warp; rr < L_TM; rr += THREADS / 32) {
    const int row = r0 + rr;
    if (row >= R) break;
    const uint32_t tile_base = (uint32_t)((row / bt) * bt);
    const uint32_t seed_word =
        fmix32(fmix32(s0 + 0x9E3779B9u * tile_base) + s1);
    const uint32_t row_counter =
        (uint32_t)(row * T_ + t) * (uint32_t)vpad_stream;
    float sc[4];
    float mx = -INFINITY, bz = -INFINITY;
    int bi = INT_MAX;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int col = v0 + lane + 32 * q;
      sc[q] = __fmul_rn(Ls[rr][lane + 32 * q], inv_temp);
      mx = fmaxf(mx, sc[q]);
      const float z =
          greedy ? sc[q]
                 : __fadd_rn(sc[q], gumbel(row_counter + (uint32_t)col,
                                           seed_word));
      if (better(z, col, bz, bi)) {
        bz = z;
        bi = col;
      }
    }
    mx = warp_max(mx);
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < 4; ++q) s += expf(__fsub_rn(sc[q], mx));
    s = warp_sum(s);
    warp_best(bz, bi);
    const int qb = (bi - v0) >> 5;
    float mine = sc[0];
#pragma unroll
    for (int q = 1; q < 4; ++q)
      if (q == qb) mine = sc[q];
    const float zs = __shfl_sync(0xffffffffu, mine, (bi - v0) & 31);
    if (lane == 0) {
      const size_t o = (size_t)row * nT + tile;
      part_m[o] = mx;
      part_s[o] = s;
      part_z[o] = bz;
      part_zi[o] = bi;
      part_zs[o] = zs;
    }
  }
}

// One thread per row: merge the tiles in vocab order, emit the step.
__global__ void sample_select_kernel(
    const float* __restrict__ part_m, const float* __restrict__ part_s,
    const float* __restrict__ part_z, const int* __restrict__ part_zi,
    const float* __restrict__ part_zs, int nT, int R, int t, int T_,
    float* __restrict__ fin, int* __restrict__ tok, int* __restrict__ out_tok,
    float* __restrict__ out_lp, float* __restrict__ out_mask) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= R) return;
  const size_t o = (size_t)row * nT;
  float m = -INFINITY;
  for (int tt = 0; tt < nT; ++tt) m = fmaxf(m, part_m[o + tt]);
  float s = 0.f;
  for (int tt = 0; tt < nT; ++tt)
    s = __fadd_rn(s, __fmul_rn(part_s[o + tt], expf(__fsub_rn(part_m[o + tt], m))));
  float best_z = NEG_INF, chosen = 0.f;
  int best_i = 0;
  for (int tt = 0; tt < nT; ++tt) {
    if (part_z[o + tt] > best_z) {
      best_z = part_z[o + tt];
      best_i = part_zi[o + tt];
      chosen = part_zs[o + tt];
    }
  }
  const float lse = __fadd_rn(m, logf(s));
  const bool valid = fin[row] == 0.f;
  const int out = valid ? best_i : PAD_ID;
  const size_t w = (size_t)row * T_ + t;
  out_tok[w] = out;
  out_lp[w] = valid ? __fsub_rn(chosen, lse) : 0.f;
  out_mask[w] = valid ? 1.f : 0.f;
  if (best_i == EOS_ID || best_i == PAD_ID) fin[row] = 1.f;
  tok[row] = out == PAD_ID ? EOS_ID : out;
}

template <typename T>
static int run_sample(const float* gx, const void* w_x, const void* wh,
                      const void* emb, const void* w_out, const float* bias,
                      float* h_a, float* h_b, float* c, float* fin, int* tok,
                      int* out_tok, float* out_lp, float* out_mask, float* pm,
                      float* ps, float* pz, int* pzi, float* pzs, int B,
                      int T_, int E, int H, int Vp, int bt, int vpad_stream,
                      uint32_t s0, uint32_t s1, float inv_temp, int greedy,
                      cudaStream_t st, const AttArgs<T>* at) {
  const int R = B;
  const int nT = Vp / L_TV;
  const dim3 gate_grid((R + G_TM - 1) / G_TM, (H + G_TJ - 1) / G_TJ);
  const dim3 tile_grid((R + L_TM - 1) / L_TM, nT);
  const int sel_threads = 128;
  const int sel_blocks = (R + sel_threads - 1) / sel_threads;
  float* h_in = h_a;
  float* h_out = h_b;
  for (int t = 0; t < T_; ++t) {
    cudaError_t e;
    if (at != nullptr) {
      e = attention_step<T>(*at, h_in, R, 1, H, E, nullptr, 0, st);
      if (e != cudaSuccess) return (int)e;
      lstm_gates_kernel<T, true><<<gate_grid, THREADS, 0, st>>>(
          gx, static_cast<const T*>(w_x), at->w_ctx,
          static_cast<const T*>(wh), static_cast<const T*>(emb), tok, at->ctx,
          h_in, c, h_out, c, R, E, H);
    } else {
      lstm_gates_kernel<T, false><<<gate_grid, THREADS, 0, st>>>(
          gx, static_cast<const T*>(w_x), nullptr, static_cast<const T*>(wh),
          static_cast<const T*>(emb), tok, nullptr, h_in, c, h_out,
          c, R, E, H);
    }
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    sample_tile_kernel<T><<<tile_grid, THREADS, 0, st>>>(
        h_out, static_cast<const T*>(w_out), bias, R, H, Vp, t, T_, bt,
        vpad_stream, s0, s1, inv_temp, greedy, pm, ps, pz, pzi, pzs);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    sample_select_kernel<<<sel_blocks, sel_threads, 0, st>>>(
        pm, ps, pz, pzi, pzs, nT, R, t, T_, fin, tok, out_tok, out_lp,
        out_mask);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    float* tmp = h_in;
    h_in = h_out;
    h_out = tmp;
  }
  return 0;
}

}  // namespace cstk

// dtype: 0 = float32, 1 = bfloat16.  The caller initialises h_a, c,
// fin = 0 and tok = BOS; outputs are (B, T) row-major.  Returns 0 or the
// CUDA error code of the first refused launch.
#define CST_SAMPLE_PARAMS                                                   \
  const void *gx, const void *w_x, const void *wh, const void *emb,         \
      const void *w_out, const void *bias, void *h_a, void *h_b, void *c,   \
      void *fin, void *tok, void *out_tok, void *out_lp, void *out_mask,    \
      void *pm, void *ps, void *pz, void *pzi, void *pzs, int B, int T,     \
      int E, int H, int Vp, int bt, int vpad_stream, unsigned int s0,       \
      unsigned int s1, float inv_temp, int greedy
#define CST_SAMPLE_ARGS                                                    \
  static_cast<const float*>(gx), w_x, wh, emb, w_out,                      \
      static_cast<const float*>(bias), static_cast<float*>(h_a),           \
      static_cast<float*>(h_b), static_cast<float*>(c),                    \
      static_cast<float*>(fin), static_cast<int*>(tok),                    \
      static_cast<int*>(out_tok), static_cast<float*>(out_lp),             \
      static_cast<float*>(out_mask), static_cast<float*>(pm),              \
      static_cast<float*>(ps), static_cast<float*>(pz),                    \
      static_cast<int*>(pzi), static_cast<float*>(pzs), B, T, E, H, Vp, bt, \
      vpad_stream, s0, s1, inv_temp, greedy, st

extern "C" int cst_lstm_sample(int dtype, CST_SAMPLE_PARAMS, void* stream) {
  if (Vp % cstk::L_TV != 0 || bt < 1) return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return cstk::run_sample<float>(CST_SAMPLE_ARGS, nullptr);
  if (dtype == 1)
    return cstk::run_sample<__nv_bfloat16>(CST_SAMPLE_ARGS, nullptr);
  return (int)cudaErrorInvalidValue;
}

// Attention fusion: the meanpool entry's operands (gx = the lstm bias),
// then the attention operands w_ctx (E, 4H), att_wh (H, A), att_v (A),
// att_proj (B, F, A), att_mask (B, F) float32, att_vals (B, F, E), and
// the scratch q (B, A), ctx (B, E) float32.  (CT is the compute dtype:
// the parameter list names an int T.)
template <typename CT>
static int run_attlstm_sample(const void* w_ctx, const void* att_wh,
                              const void* att_v, const void* proj,
                              const void* mask, const void* vals, void* q,
                              void* ctx, int A, int F, CST_SAMPLE_PARAMS,
                              cudaStream_t st) {
  const cstk::AttArgs<CT> at{
      static_cast<const CT*>(w_ctx), static_cast<const CT*>(att_wh),
      static_cast<const CT*>(att_v), static_cast<const CT*>(proj),
      static_cast<const float*>(mask), static_cast<const CT*>(vals),
      static_cast<float*>(q), static_cast<float*>(ctx), A, F};
  return cstk::run_sample<CT>(CST_SAMPLE_ARGS, &at);
}

extern "C" int cst_attlstm_sample(int dtype, CST_SAMPLE_PARAMS,
                                  const void* w_ctx, const void* att_wh,
                                  const void* att_v, const void* proj,
                                  const void* mask, const void* vals, void* q,
                                  void* ctx, int A, int F, void* stream) {
  if (Vp % cstk::L_TV != 0 || bt < 1 || A < 1 || F < 1)
    return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
#define CST_ATT_CALL(TT)                                                      \
  run_attlstm_sample<TT>(w_ctx, att_wh, att_v, proj, mask, vals, q, ctx, A, \
                         F, gx, w_x, wh, emb, w_out, bias, h_a, h_b, c, fin, \
                         tok, out_tok, out_lp, out_mask, pm, ps, pz, pzi,    \
                         pzs, B, T, E, H, Vp, bt, vpad_stream, s0, s1,       \
                         inv_temp, greedy, st)
  if (dtype == 0) return CST_ATT_CALL(float);
  if (dtype == 1) return CST_ATT_CALL(__nv_bfloat16);
#undef CST_ATT_CALL
  return (int)cudaErrorInvalidValue;
}
#undef CST_SAMPLE_ARGS
#undef CST_SAMPLE_PARAMS
