// Fused beam-search decode for Hopper (sm_90a), meanpool and attention
// fusion.
//
// Replaces the TPU kernels of the JAX package, ops/pallas_beam.py::
// lstm_beam (_beam_impl -> pallas_call, kernel _make_beam_kernel,
// static_ctx=True; entry cst_lstm_beam) and ops/pallas_beam.py::
// attlstm_beam (the same pallas_call with static_ctx=False; entry
// cst_attlstm_beam).  Same function: K beams per video decoded from zero
// state for T steps,
// R = B*K video-major rows; per step the LSTM update, the vocab logits
// streamed in tiles with a per-row log-sum-exp and top-K (ties to the
// lowest vocab id), candidate totals score + logp with flat keys k*V + v,
// each video's next K beams as the top-K of its K*K union (total desc,
// key asc), the parent reorder of hypotheses / h / c / finished flags,
// and the EOS freeze (a finished beam continues with PAD at zero cost,
// PAD feeds back as EOS).
//
// Attention fusion adds, before the gates, the Bahdanau step of
// attention_common.cuh (query from the reordered h, score, softmax over
// the video's F frames, context) and the ctx @ W_ctx term, in the
// reference's gate order gx_static + emb + ctx + h.
//
// Bound on the H100: operations.  Per step 2*R*(E+H)*4H (gates) +
// 2*R*H*V (vocab) multiply-adds; at B=64, K=5, E=H=512, V=10,496, T=30
// that is ~143 GFLOP against ~15 MB of weights.  Attention adds
// 2*R*(H*A + E*4H + F*(A+E)) per step (~26 GFLOP at F=56, A=512) and
// R*F*A tanh evaluations per step (0.43 G over the call).
//
// Design, float32 compute (the first design; PERF.md has its times):
// the host loops over T and launches three kernels per step on the
// caller's stream with no host synchronisation — the gate GEMM + update,
// the vocab tile GEMM whose logits stay in shared memory and leave as
// per-(row, tile) max, sum-exp and top-K, and a per-video
// merge/select/reorder.  The TPU kernel carried h, c and the hypotheses
// in VMEM across its sequential grid; here blocks run in parallel with no
// carry, so the state lives in device memory between launches and the
// cross-tile reductions happen in the select kernel.  No (R, V) logits
// array is ever written.  The attention decoder adds two launches per
// step (query GEMM, then one block per row for score / softmax /
// context); each row reads its video's att_proj and att_vals in place
// (row / K), so the K beams share one copy instead of the TPU kernel's
// K-fold repeat.  Products are SIMT fmaf chains (tensor cores would need
// TF32, which the float32 tier rules out).
//
// Design, bf16 compute (float or int8 weights; entries cst_lstm_beam_tc
// and cst_attlstm_beam_tc): decode_tc.cuh's tensor-core chain — the gate
// GEMM with the update in its epilogue over [emb(tok) | T(h)] (meanpool)
// or [emb(tok) | T(ctx) | T(h)] (attention), a cluster of one CTA per
// source per tile where the grid would leave SMs idle; the vocab tile
// GEMM (64 rows x 128 columns, mma.sync in the fixed k order) whose
// epilogue writes the same per-(row, tile) partials as the SIMT tile
// kernel; and the select: three launches a step.  Attention adds two
// before the gates: the query and the attention step per video (the K
// beams of a video in one block, tanhf from the table of its bf16
// arguments).  h is kept in bf16 (every reader rounds it so first); the
// wrapper stages the weights as the tile GEMM's B^T once a call.  Each
// row's bits are the same whatever the row count.
//
// Design, f16 compute (float weights; entries cst_lstm_beam_tc and
// cst_attlstm_beam_tc with dtype 2): the same chain instantiated at
// __half (tc_common.cuh Tc16): f16 operands and h, the mma.sync .f16
// instruction, every rounding to f16, the same tiles and order of sums;
// under attention each tanh is tanhf of the f16-rounded argument,
// rounded to f16 (attention_tc.cuh tanh_direct).  A masked column's
// f16 bias is -inf (f16 holds no -1e30), so its logit and its candidate
// total are -inf where bf16's are about -1e30: it adds exp(-inf) = 0 to
// the log-sum-exp and loses every comparison to a real word, as at bf16.
// The same operations bound it.
//
// int8w (the reference's quant= mode of the same pallas_call, entries
// with wq = 1, or the scales given at bf16): int8 codes with float32
// scales, every float32 kernel above instantiated with WT = int8_t
// (decode_common.cuh states what changes; the vocab logit is acc *
// column scale + bias in float32, not rounded to T, so the candidate
// totals and the K*K select see the reference's logits).  At bf16
// compute the tensor-core chain runs on the codes widened to bf16 once a
// call (exact), the scales in the epilogues.  The same operations bound
// it; the weight bytes are a quarter.
#include <climits>
#include <cmath>

#include "decode_tc.cuh"

namespace cstk {

constexpr int MAXK = 16;

// The per-(row, tile) partials of tile `tile` (columns v0 = tile * L_TV
// onwards) from its logits Ls (rows r0 .. r0 + TM - 1): max, sum of
// exp(logit - max) and the top-K (value desc, id asc), at [row * nT +
// tile].
template <int TM>
__device__ __forceinline__ void beam_tile_reduce(
    const float (*Ls)[L_TV + 1], int r0, int tile, int nT, int R, int K,
    float* __restrict__ part_m, float* __restrict__ part_s,
    float* __restrict__ part_v, int* __restrict__ part_i) {
  const int v0 = tile * L_TV;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int rr = warp; rr < TM; rr += THREADS / 32) {
    const int row = r0 + rr;
    if (row >= R) break;
    float v[4];
    float mx = -INFINITY;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      v[q] = Ls[rr][lane + 32 * q];
      mx = fmaxf(mx, v[q]);
    }
    mx = warp_max(mx);
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < 4; ++q) s += expf(__fsub_rn(v[q], mx));
    s = warp_sum(s);
    const size_t base = (size_t)row * nT + tile;
    if (lane == 0) {
      part_m[base] = mx;
      part_s[base] = s;
    }
    for (int kk = 0; kk < K; ++kk) {
      float bv = -INFINITY;
      int bi = INT_MAX;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int col = v0 + lane + 32 * q;
        if (better(v[q], col, bv, bi)) {
          bv = v[q];
          bi = col;
        }
      }
      warp_best(bv, bi);
      if (lane == 0) {
        part_v[base * K + kk] = bv;
        part_i[base * K + kk] = bi;
      }
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (v0 + lane + 32 * q == bi) v[q] = -INFINITY;
    }
  }
}

template <typename T, typename WT = T>
__global__ void __launch_bounds__(THREADS) beam_tile_kernel(
    const float* __restrict__ h, const WT* __restrict__ w_out,
    const float* __restrict__ bias, const float* __restrict__ out_scale,
    int R, int H, int Vp, int K, float* __restrict__ part_m,
    float* __restrict__ part_s, float* __restrict__ part_v,
    int* __restrict__ part_i) {
  __shared__ float Ls[L_TM][L_TV + 1];
  __shared__ float As[L_TM][L_KC + 1];
  __shared__ float Ws[L_KC][L_TV];
  const int r0 = blockIdx.x * L_TM, tile = blockIdx.y;
  logit_tile<T, WT>(Ls, As, Ws, h, w_out, bias, R, H, Vp, r0, tile * L_TV,
                    out_scale);
  beam_tile_reduce<L_TM>(Ls, r0, tile, gridDim.y, R, K, part_m, part_s,
                         part_v, part_i);
}

// The tensor-core twin (16-bit compute): the logits of a 64-row tile from
// decode_tc.cuh's vocab GEMM.  Grid (Vp / 128, ceil(R / 64)).
template <typename T16>
__global__ void __launch_bounds__(TT_THREADS, 2) beam_tile_tc_kernel(
    TtOps<T16> op, const float* __restrict__ bias,
    const float* __restrict__ out_scale, int K, float* __restrict__ part_m,
    float* __restrict__ part_s, float* __restrict__ part_v,
    int* __restrict__ part_i) {
  extern __shared__ __align__(128) unsigned char tt_smem[];
  const int m0 = blockIdx.y * TT_BM, tile = blockIdx.x;
  logit_tile_tc(op, bias, out_scale, m0, tile * TT_BN, tt_smem);
  beam_tile_reduce<TT_BM>(reinterpret_cast<const float(*)[L_TV + 1]>(tt_smem),
                          m0, tile, gridDim.x, op.M, K, part_m, part_s,
                          part_v, part_i);
}

// One block per video, 32*K threads: warp k merges row v*K+k across the
// vocab tiles and writes its K candidates; warp 0 selects the video's
// next K beams; then all threads reorder the state by parent (h in HT:
// float, or the compute dtype under the tensor-core chain).
template <typename HT>
__global__ void beam_select_kernel(
    const float* __restrict__ part_m, const float* __restrict__ part_s,
    const float* __restrict__ part_v, const int* __restrict__ part_i, int nT,
    const HT* __restrict__ h_new, const float* __restrict__ c_new,
    HT* __restrict__ h, float* __restrict__ c, float* __restrict__ fin,
    float* __restrict__ score, int* __restrict__ seqs, int* __restrict__ tok,
    int K, int T, int t, int H, int V) {
  extern __shared__ int seq_s[];  // K*T hypotheses of this video
  __shared__ float tot_s[MAXK * MAXK];
  __shared__ int key_s[MAXK * MAXK];
  __shared__ float fin_s[MAXK], sc_s[MAXK];
  __shared__ int par_s[MAXK], tok_s[MAXK];
  const int vid = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row0 = vid * K;
  for (int i = threadIdx.x; i < K * T; i += blockDim.x)
    seq_s[i] = seqs[(size_t)row0 * T + i];
  if (threadIdx.x < K) fin_s[threadIdx.x] = fin[row0 + threadIdx.x];

  if (warp < K) {
    const int row = row0 + warp;
    const float* pm = part_m + (size_t)row * nT;
    const float* ps = part_s + (size_t)row * nT;
    float m = -INFINITY;
    for (int tt = lane; tt < nT; tt += 32) m = fmaxf(m, pm[tt]);
    m = warp_max(m);
    float s = 0.f;
    for (int tt = lane; tt < nT; tt += 32)
      s += __fmul_rn(ps[tt], expf(__fsub_rn(pm[tt], m)));
    s = warp_sum(s);
    const float log_s = logf(s);
    const float sc0 = score[row];
    const bool frozen = fin[row] > 0.f;
    const float* pv = part_v + (size_t)row * nT * K;
    const int* pi = part_i + (size_t)row * nT * K;
    float prev_v = INFINITY;
    int prev_i = -1;
    for (int kk = 0; kk < K; ++kk) {
      // Best candidate strictly after the previous pick in the
      // (value desc, id asc) order: a top-K without removal marks.
      float bv = -INFINITY;
      int bi = INT_MAX;
      for (int j = lane; j < nT * K; j += 32) {
        const float cv = pv[j];
        const int ci = pi[j];
        const bool after = cv < prev_v || (cv == prev_v && ci > prev_i);
        if (after && better(cv, ci, bv, bi)) {
          bv = cv;
          bi = ci;
        }
      }
      warp_best(bv, bi);
      prev_v = bv;
      prev_i = bi;
      if (lane == 0) {
        float total;
        int key;
        if (frozen) {
          total = kk == 0 ? __fadd_rn(sc0, 0.0f) : __fadd_rn(sc0, NEG_INF);
          key = warp * V + (kk == 0 ? PAD_ID : kk);
        } else {
          total = __fadd_rn(sc0, __fsub_rn(__fsub_rn(bv, m), log_s));
          key = warp * V + bi;
        }
        tot_s[warp * K + kk] = total;
        key_s[warp * K + kk] = key;
      }
    }
  }
  __syncthreads();
  if (warp == 0) {
    float prev_v = INFINITY;
    int prev_i = -1;
    for (int kk = 0; kk < K; ++kk) {
      float bv = -INFINITY;
      int bi = INT_MAX;
      for (int j = lane; j < K * K; j += 32) {
        const float cv = tot_s[j];
        const int ci = key_s[j];
        const bool after = cv < prev_v || (cv == prev_v && ci > prev_i);
        if (after && better(cv, ci, bv, bi)) {
          bv = cv;
          bi = ci;
        }
      }
      warp_best(bv, bi);
      prev_v = bv;
      prev_i = bi;
      if (lane == 0) {
        const int parent = bi / V;
        sc_s[kk] = bv;
        par_s[kk] = parent;
        tok_s[kk] = bi - parent * V;
      }
    }
  }
  __syncthreads();
  if (threadIdx.x < K) {
    const int k = threadIdx.x;
    const int tk = tok_s[k];
    const float ended = (tk == EOS_ID || tk == PAD_ID) ? 1.f : 0.f;
    fin[row0 + k] = fmaxf(fin_s[par_s[k]], ended);
    score[row0 + k] = sc_s[k];
    tok[row0 + k] = tk == PAD_ID ? EOS_ID : tk;
  }
  for (int i = threadIdx.x; i < K * T; i += blockDim.x) {
    const int k = i / T, l = i % T;
    seqs[(size_t)row0 * T + i] = l == t ? tok_s[k] : seq_s[par_s[k] * T + l];
  }
  for (int i = threadIdx.x; i < K * H; i += blockDim.x) {
    const int k = i / H, j = i % H;
    const size_t src = (size_t)(row0 + par_s[k]) * H + j;
    const size_t dst = (size_t)(row0 + k) * H + j;
    h[dst] = h_new[src];
    c[dst] = c_new[src];
  }
}

// at == nullptr: meanpool (the context is folded into gx).  WT: T
// (float weights, qs all null) or int8_t (int8w, qs the scales).
template <typename T, typename WT = T>
static int run_beam(const float* gx, const void* w_x, const void* wh,
                    const void* emb, const void* w_out, const float* bias,
                    float* h, float* c, float* h_new, float* c_new,
                    float* fin, float* score, int* seqs, int* tok, float* pm,
                    float* ps, float* pv, int* pi, int B, int K, int T_,
                    int E, int H, int V, int Vp, cudaStream_t st,
                    const AttArgs<T, WT>* at, QScales qs) {
  const int R = B * K;
  const int nT = Vp / L_TV;
  const dim3 gate_grid((R + G_TM - 1) / G_TM, (H + G_TJ - 1) / G_TJ);
  const dim3 tile_grid((R + L_TM - 1) / L_TM, nT);
  const size_t smem = (size_t)K * T_ * sizeof(int);
  for (int t = 0; t < T_; ++t) {
    cudaError_t e;
    if (at != nullptr) {
      e = attention_step<T>(*at, h, R, K, H, E, nullptr, 0, st);
      if (e != cudaSuccess) return (int)e;
      lstm_gates_kernel<T, true, WT><<<gate_grid, THREADS, 0, st>>>(
          gx, static_cast<const WT*>(w_x), at->w_ctx,
          static_cast<const WT*>(wh), static_cast<const WT*>(emb), tok,
          at->ctx, h, c, h_new, c_new, R, E, H, qs);
    } else {
      lstm_gates_kernel<T, false, WT><<<gate_grid, THREADS, 0, st>>>(
          gx, static_cast<const WT*>(w_x), nullptr,
          static_cast<const WT*>(wh), static_cast<const WT*>(emb), tok,
          nullptr, h, c, h_new, c_new, R, E, H, qs);
    }
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    beam_tile_kernel<T, WT><<<tile_grid, THREADS, 0, st>>>(
        h_new, static_cast<const WT*>(w_out), bias, qs.out, R, H, Vp, K, pm,
        ps, pv, pi);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    beam_select_kernel<float><<<B, 32 * K, smem, st>>>(
        pm, ps, pv, pi, nT, h_new, c_new, h, c, fin, score, seqs, tok, K, T_,
        t, H, V);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

// 16-bit compute (bf16 with float or int8 weights, f16 with float weights)
// on the tensor cores: per step decode_tc.cuh's step (meanpool: the gate
// GEMM; attention: the query, the attention step with the K beams of a
// video sharing its att_proj / att_vals, and the gate GEMM), the vocab
// tile GEMM with the beam partials in its epilogue, and the select: three
// launches (five under attention), no host sync.  h, h_new (R, H) T16.
template <typename T16>
static int run_beam_tc(DecTc<T16> d, T16* h, float* c, T16* h_new,
                       float* c_new, float* fin,
                       float* score, int* seqs, int* tok, float* pm,
                       float* ps, float* pv, int* pi, int B, int K, int T_,
                       int V, int Vp, cudaStream_t st) {
  const int R = B * K, nT = Vp / L_TV;
  cudaError_t e = dec_tc_prepare(d);
  if (e == cudaSuccess)
    e = set_smem((const void*)beam_tile_tc_kernel<T16>, TT_SMEM);
  if (e != cudaSuccess) return (int)e;
  const dim3 tile_grid(nT, (R + TT_BM - 1) / TT_BM);
  const size_t smem = (size_t)K * T_ * sizeof(int);
  for (int t = 0; t < T_; ++t) {
    e = dec_tc_step(d, h, tok, c, c_new, h_new, R, K, st);
    if (e != cudaSuccess) return (int)e;
    beam_tile_tc_kernel<T16><<<tile_grid, TT_THREADS, TT_SMEM, st>>>(
        dec_vocab_op(d, h_new, R, Vp), d.bias, d.out_s, K, pm, ps, pv, pi);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    beam_select_kernel<T16><<<B, 32 * K, smem, st>>>(
        pm, ps, pv, pi, nT, h_new, c_new, h, c, fin, score, seqs, tok, K, T_,
        t, d.H, V);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  return 0;
}

}  // namespace cstk

// Meanpool at float32 compute (dtype 0; bf16 and f16 take
// cst_lstm_beam_tc):
// w_x, wh, emb, w_out float32 unless wq.  wq: 1 when those weights are
// int8 codes
// (int8w) with the float32 scales emb_s (V,), lstm_s (4H,), out_s (Vp,)
// (and att_s (A,) under attention), null otherwise.  State buffers are
// initialised by the caller (h, c, fin = 0; score = 0 for beam 0 and
// -1e30 otherwise; seqs = PAD; tok = BOS).  Returns 0 or the CUDA error
// code of the first refused launch.
#define CST_BEAM_PARAMS                                                     \
  const void *gx, const void *w_x, const void *wh, const void *emb,         \
      const void *w_out, const void *bias, void *h, void *c, void *h_new,   \
      void *c_new, void *fin, void *score, void *seqs, void *tok, void *pm, \
      void *ps, void *pv, void *pi, int B, int K, int T, int E, int H,      \
      int V, int Vp
#define CST_BEAM_ARGS                                                       \
  static_cast<const float*>(gx), w_x, wh, emb, w_out,                       \
      static_cast<const float*>(bias), static_cast<float*>(h),              \
      static_cast<float*>(c), static_cast<float*>(h_new),                   \
      static_cast<float*>(c_new), static_cast<float*>(fin),                 \
      static_cast<float*>(score), static_cast<int*>(seqs),                  \
      static_cast<int*>(tok), static_cast<float*>(pm),                      \
      static_cast<float*>(ps), static_cast<float*>(pv),                     \
      static_cast<int*>(pi), B, K, T, E, H, V, Vp, st

#define CST_QSCALES                                                  \
  cstk::QScales{static_cast<const float*>(emb_s),                   \
                static_cast<const float*>(lstm_s),                  \
                static_cast<const float*>(out_s)}

extern "C" int cst_lstm_beam(int dtype, int wq, CST_BEAM_PARAMS,
                             const void* emb_s, const void* lstm_s,
                             const void* out_s, void* stream) {
  if (dtype != 0 || K < 1 || K > cstk::MAXK || Vp % cstk::L_TV != 0)
    return (int)cudaErrorInvalidValue;
  if (wq && (emb_s == nullptr || lstm_s == nullptr || out_s == nullptr))
    return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  const cstk::QScales qs = wq ? CST_QSCALES : cstk::QScales{};
  return wq ? cstk::run_beam<float, int8_t>(CST_BEAM_ARGS, nullptr, qs)
            : cstk::run_beam<float, float>(CST_BEAM_ARGS, nullptr, qs);
}

// The meanpool tensor-core call of cst_lstm_beam_tc at T16.
template <typename T16>
static int lstm_beam_tc(const void* gx, const void* emb, const void* wcat_t,
                        const void* w_out_t, const void* bias,
                        const void* lstm_s, const void* out_s, void* h,
                        void* c, void* h_new, void* c_new, void* fin,
                        void* score, void* seqs, void* tok, void* pm,
                        void* ps, void* pv, void* pi, int B, int K, int T,
                        int E, int H, int V, int Vp, void* stream) {
  const cstk::DecTc<T16> d{
      static_cast<const float*>(gx), static_cast<const T16*>(emb),
      static_cast<const T16*>(wcat_t), nullptr,
      static_cast<const T16*>(w_out_t), static_cast<const float*>(bias),
      static_cast<const float*>(lstm_s), nullptr,
      static_cast<const float*>(out_s), nullptr, nullptr, nullptr, nullptr,
      nullptr, nullptr, E, H, 0, 0, 0};
  return cstk::run_beam_tc<T16>(
      d, static_cast<T16*>(h), static_cast<float*>(c),
      static_cast<T16*>(h_new), static_cast<float*>(c_new),
      static_cast<float*>(fin), static_cast<float*>(score),
      static_cast<int*>(seqs), static_cast<int*>(tok), static_cast<float*>(pm),
      static_cast<float*>(ps), static_cast<float*>(pv), static_cast<int*>(pi),
      B, K, T, V, Vp, static_cast<cudaStream_t>(stream));
}

// Meanpool at 16-bit compute, the tensor-core chain (dtype 1: bf16 with
// float or int8 weights, dtype 2: f16 with float weights, as the wrapper
// stages them; decode_tc.cuh DecTc): gx (B*K, 4H) float32 (gx_static
// repeated per beam: the lstm bias and the static context), emb (V, E)
// (int8w: T(code * row scale)), wcat_t (4H, E + H) [W_x ; W_h]^T,
// w_out_t (Vp, H), all in the compute dtype, bias (Vp,) float32, the
// int8w scales lstm_s (4H,), out_s (Vp,) or both null (always at f16).
// State as cst_lstm_beam's, except h and h_new (B*K, H) in the compute
// dtype.  E and H must be multiples of 32.  Returns 0 or the CUDA error
// code of the first refused launch (cudaErrorInvalidValue for a shape the
// chain does not take).
extern "C" int cst_lstm_beam_tc(
    int dtype, const void* gx, const void* emb, const void* wcat_t,
    const void* w_out_t, const void* bias, const void* lstm_s,
    const void* out_s, void* h, void* c, void* h_new, void* c_new, void* fin,
    void* score, void* seqs, void* tok, void* pm, void* ps, void* pv,
    void* pi, int B, int K, int T, int E, int H, int V, int Vp,
    void* stream) {
  if (B < 1 || T < 1 || K < 1 || K > cstk::MAXK || Vp % cstk::L_TV != 0 ||
      !cstk::dec_tc_widths_ok(E, H) ||
      (lstm_s == nullptr) != (out_s == nullptr) ||
      (dtype != 1 && dtype != 2) || (dtype == 2 && lstm_s != nullptr))
    return (int)cudaErrorInvalidValue;
#define CST_BEAM_TC_ARGS                                                     \
  gx, emb, wcat_t, w_out_t, bias, lstm_s, out_s, h, c, h_new, c_new, fin,    \
      score, seqs, tok, pm, ps, pv, pi, B, K, T, E, H, V, Vp, stream
  return dtype == 1 ? lstm_beam_tc<__nv_bfloat16>(CST_BEAM_TC_ARGS)
                    : lstm_beam_tc<__half>(CST_BEAM_TC_ARGS);
#undef CST_BEAM_TC_ARGS
}

// Attention fusion at float32 compute (dtype 0; bf16 and f16 take
// cst_attlstm_beam_tc): the meanpool entry's operands (gx = the lstm
// bias, repeated per beam), then the per-video attention operands w_ctx
// (E, 4H), att_wh (H, A), att_v (A), att_proj (B, F, A), att_mask (B, F)
// float32, att_vals (B, F, E), and the scratch q (B*K, A), ctx (B*K, E)
// float32.  (CT is the compute dtype: the parameter list names an int T;
// WT the weights' type.)
template <typename CT, typename WT>
static int run_attlstm_beam(const void* w_ctx, const void* att_wh,
                            const void* att_v, const void* proj,
                            const void* mask, const void* vals, void* q,
                            void* ctx, int A, int F, const float* att_s,
                            cstk::QScales qs, CST_BEAM_PARAMS,
                            cudaStream_t st) {
  const cstk::AttArgs<CT, WT> at{
      static_cast<const WT*>(w_ctx), static_cast<const WT*>(att_wh),
      static_cast<const CT*>(att_v), static_cast<const CT*>(proj),
      static_cast<const float*>(mask), static_cast<const CT*>(vals),
      static_cast<float*>(q), static_cast<float*>(ctx), A, F, att_s};
  return cstk::run_beam<CT, WT>(CST_BEAM_ARGS, &at, qs);
}

extern "C" int cst_attlstm_beam(int dtype, int wq, CST_BEAM_PARAMS,
                                const void* w_ctx, const void* att_wh,
                                const void* att_v, const void* proj,
                                const void* mask, const void* vals, void* q,
                                void* ctx, int A, int F, const void* emb_s,
                                const void* lstm_s, const void* att_s,
                                const void* out_s, void* stream) {
  if (dtype != 0 || K < 1 || K > cstk::MAXK || Vp % cstk::L_TV != 0 ||
      A < 1 || F < 1)
    return (int)cudaErrorInvalidValue;
  if (wq && (emb_s == nullptr || lstm_s == nullptr || att_s == nullptr ||
             out_s == nullptr))
    return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  const cstk::QScales qs = wq ? CST_QSCALES : cstk::QScales{};
  const float* as = wq ? static_cast<const float*>(att_s) : nullptr;
#define CST_ATT_CALL(WW)                                                      \
  run_attlstm_beam<float, WW>(w_ctx, att_wh, att_v, proj, mask, vals, q, ctx, \
                              A, F, as, qs, gx, w_x, wh, emb, w_out, bias, h, \
                              c, h_new, c_new, fin, score, seqs, tok, pm, ps, \
                              pv, pi, B, K, T, E, H, V, Vp, st)
  return wq ? CST_ATT_CALL(int8_t) : CST_ATT_CALL(float);
#undef CST_ATT_CALL
}

// The attention tensor-core call of cst_attlstm_beam_tc at T16.
template <typename T16>
static int attlstm_beam_tc(
    const void* gx, const void* emb, const void* wcat_t, const void* att_wh_t,
    const void* w_out_t, const void* bias, const void* lstm_s,
    const void* att_s, const void* out_s, const void* att_v, const void* proj,
    const void* mask, const void* vals, void* h, void* c, void* h_new,
    void* c_new, void* q, void* ctx, void* fin, void* score, void* seqs,
    void* tok, void* pm, void* ps, void* pv, void* pi, int B, int K, int T,
    int E, int H, int A, int F, int V, int Vp, void* stream) {
  if (!cstk::dec_tc_shapes_ok<T16>(E, H, A, F))
    return (int)cudaErrorInvalidValue;
  const cstk::DecTc<T16> d{
      static_cast<const float*>(gx), static_cast<const T16*>(emb),
      static_cast<const T16*>(wcat_t), static_cast<const T16*>(att_wh_t),
      static_cast<const T16*>(w_out_t), static_cast<const float*>(bias),
      static_cast<const float*>(lstm_s), static_cast<const float*>(att_s),
      static_cast<const float*>(out_s), static_cast<const T16*>(att_v),
      static_cast<const T16*>(proj), static_cast<const float*>(mask),
      static_cast<const T16*>(vals), static_cast<T16*>(q),
      static_cast<T16*>(ctx), E, H, A, F, 0};
  return cstk::run_beam_tc<T16>(
      d, static_cast<T16*>(h), static_cast<float*>(c),
      static_cast<T16*>(h_new), static_cast<float*>(c_new),
      static_cast<float*>(fin), static_cast<float*>(score),
      static_cast<int*>(seqs), static_cast<int*>(tok), static_cast<float*>(pm),
      static_cast<float*>(ps), static_cast<float*>(pv), static_cast<int*>(pi),
      B, K, T, V, Vp, static_cast<cudaStream_t>(stream));
}

// Attention fusion at 16-bit compute, the tensor-core chain (dtype 1: bf16
// with float or int8 weights, dtype 2: f16 with float weights, as the
// wrapper stages them; decode_tc.cuh DecTc): gx (B*K, 4H) float32 (the
// lstm bias repeated per beam), emb (V, E) (int8w: T(code * row scale)),
// wcat_t (4H, 2E + H), att_wh_t (A, H), w_out_t (Vp, H) in the compute
// dtype, bias (Vp,) float32, the int8w scales lstm_s (4H,), att_s (A,),
// out_s (Vp,) or all null (always at f16), att_v (A,), att_proj (B, F,
// A), att_vals (B, F, E) in the compute dtype, att_mask (B, F) float32.
// State as cst_lstm_beam's, except h and h_new (B*K, H) in the compute
// dtype; scratch q (B*K, A) and ctx (B*K, E) in the compute dtype.  E, H
// and A must be multiples of 32.  Returns 0 or the CUDA error code of the
// first refused launch (cudaErrorInvalidValue for a shape the chain does
// not take).
extern "C" int cst_attlstm_beam_tc(
    int dtype, const void* gx, const void* emb, const void* wcat_t,
    const void* att_wh_t, const void* w_out_t, const void* bias,
    const void* lstm_s, const void* att_s, const void* out_s,
    const void* att_v, const void* proj, const void* mask, const void* vals,
    void* h, void* c, void* h_new, void* c_new, void* q, void* ctx,
    void* fin, void* score, void* seqs, void* tok, void* pm, void* ps,
    void* pv, void* pi, int B, int K, int T, int E, int H, int A, int F,
    int V, int Vp, void* stream) {
  if (B < 1 || T < 1 || K < 1 || K > cstk::MAXK || Vp % cstk::L_TV != 0 ||
      (dtype != 1 && dtype != 2) || (dtype == 2 && lstm_s != nullptr))
    return (int)cudaErrorInvalidValue;
  if ((lstm_s == nullptr) != (att_s == nullptr) ||
      (lstm_s == nullptr) != (out_s == nullptr))
    return (int)cudaErrorInvalidValue;
#define CST_ATT_BEAM_TC_ARGS                                                 \
  gx, emb, wcat_t, att_wh_t, w_out_t, bias, lstm_s, att_s, out_s, att_v,    \
      proj, mask, vals, h, c, h_new, c_new, q, ctx, fin, score, seqs, tok,  \
      pm, ps, pv, pi, B, K, T, E, H, A, F, V, Vp, stream
  return dtype == 1 ? attlstm_beam_tc<__nv_bfloat16>(CST_ATT_BEAM_TC_ARGS)
                    : attlstm_beam_tc<__half>(CST_ATT_BEAM_TC_ARGS);
#undef CST_ATT_BEAM_TC_ARGS
}
#undef CST_QSCALES
#undef CST_BEAM_ARGS
#undef CST_BEAM_PARAMS
