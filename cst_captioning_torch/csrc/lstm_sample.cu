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
// The multinomial stream is the reference's, bit for bit, except that
// masked columns (a -1e30 logit) take no draw (kMaskedLogit): counter
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
// Design, float32 compute (first, simple; PERF.md has its times): the
// host loops over T, three launches per step on the caller's stream, no
// host sync — the gate GEMM + update (shared with the beam kernel), the
// vocab tile GEMM reducing its logits in shared memory to per-(row,
// tile) max, sum-exp and best z, and a per-row merge in tile order
// (earliest tile wins a tie, as the reference's strict '>' does).  The
// attention decoder adds two launches per step before the gates (query
// GEMM; score / softmax / context, one block per row).
//
// Design, bf16 compute (float or int8 weights; entries cst_lstm_sample_tc
// and cst_attlstm_sample_tc): decode_tc.cuh's tensor-core chain, three
// launches a step — the gate GEMM with the update (at R = 64 a cluster
// of one CTA per source per tile), the vocab tile GEMM with the same
// per-(row, tile) partials in its epilogue, and a merge with one warp
// per row (lanes over the tiles, the earliest tile still winning a tie;
// the log-sum-exp summed in the butterfly's order); attention adds the
// query and the attention step before the gates.  h is kept in bf16.
//
// Design, f16 compute (float weights; entries cst_lstm_sample_tc and
// cst_attlstm_sample_tc with dtype 2): the same chain instantiated at
// __half (tc_common.cuh Tc16): f16 operands and h, the mma.sync .f16
// instruction, every rounding to f16, the same tiles and order of sums;
// under attention each tanh is tanhf of the f16-rounded argument,
// rounded to f16 (attention_tc.cuh tanh_direct).  A masked column's
// f16 bias is -inf (f16 holds no -1e30): it takes no draw, as at bf16,
// and adds exp(-inf) = 0; every 128-column tile holds a real word (V >=
// 5 in tile 0, and the padding is under one tile), so no tile's max is
// -inf.  The same operations bound it.
//
// int8w (the reference's quant= mode of the same pallas_call, entries
// with wq = 1, or the scales given at bf16): the weights arrive as int8
// codes with float32 scales; at float32 compute every kernel above is
// instantiated with WT = int8_t (decode_common.cuh states what changes:
// emb rows T(code * row scale), each gate operand's accumulator times the
// shared LSTM scale before the sum gxs + emb [+ ctx] + h, the query
// T((T(h) @ codes) * att scale), and the vocab logit acc * column scale +
// bias in float32 with no rounding to T); at bf16 compute the
// tensor-core chain runs on the codes widened once a call.  The stream
// geometry (bt, V_pad) is the float kernel's: the wrapper picks it on the
// activation itemsize, so the hash-Gumbel counters are the same.  Bound:
// the same operations; the weight bytes are a quarter.
#include <climits>
#include <cmath>

#include "decode_tc.cuh"

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

// Columns at the decode mask's level (decode_bias's -1e30: PAD, BOS, a
// suppressed UNK, the padding past V) take no Gumbel draw.  A draw can
// be +inf: u rounds to 1.0f when bits >> 8 = 2^24 - 1, and -1e30 + inf
// would make a masked column win.  ops/decode_common.py::MASKED_LOGIT is
// the same threshold: the wrapper reads cst_sample_masked_logit() when it
// loads this library and refuses a mismatch.
constexpr float kMaskedLogit = -5e29f;

// The per-(row, tile) partials of tile `tile` (columns v0 = tile * L_TV
// onwards) from its logits Ls (rows r0 .. r0 + TM - 1): max and sum of
// exp of logits * inv_temp, the best z (greedy: the scaled logit; else
// plus the row's hash-Gumbel draw), its id and its scaled logit, at [row
// * nT + tile].
template <int TM>
__device__ __forceinline__ void sample_tile_reduce(
    const float (*Ls)[L_TV + 1], int r0, int tile, int nT, int R, int t,
    int T_, int bt, int vpad_stream, uint32_t s0, uint32_t s1,
    float inv_temp, int greedy, float* __restrict__ part_m,
    float* __restrict__ part_s, float* __restrict__ part_z,
    int* __restrict__ part_zi, float* __restrict__ part_zs) {
  const int v0 = tile * L_TV;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int rr = warp; rr < TM; rr += THREADS / 32) {
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
          greedy || !(Ls[rr][lane + 32 * q] > kMaskedLogit)
              ? sc[q]
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

#define CST_STREAM_PARAMS                                                   \
  int t, int T_, int bt, int vpad_stream, uint32_t s0, uint32_t s1,         \
      float inv_temp, int greedy, float *__restrict__ part_m,               \
      float *__restrict__ part_s, float *__restrict__ part_z,               \
      int *__restrict__ part_zi, float *__restrict__ part_zs
#define CST_STREAM_ARGS                                                     \
  t, T_, bt, vpad_stream, s0, s1, inv_temp, greedy, part_m, part_s, part_z, \
      part_zi, part_zs

template <typename T, typename WT = T>
__global__ void __launch_bounds__(THREADS) sample_tile_kernel(
    const float* __restrict__ h, const WT* __restrict__ w_out,
    const float* __restrict__ bias, const float* __restrict__ out_scale,
    int R, int H, int Vp, CST_STREAM_PARAMS) {
  __shared__ float Ls[L_TM][L_TV + 1];
  __shared__ float As[L_TM][L_KC + 1];
  __shared__ float Ws[L_KC][L_TV];
  const int r0 = blockIdx.x * L_TM, tile = blockIdx.y;
  logit_tile<T, WT>(Ls, As, Ws, h, w_out, bias, R, H, Vp, r0, tile * L_TV,
                    out_scale);
  sample_tile_reduce<L_TM>(Ls, r0, tile, gridDim.y, R, CST_STREAM_ARGS);
}

// The tensor-core twin (16-bit compute): the logits of a 64-row tile from
// decode_tc.cuh's vocab GEMM.  Grid (Vp / 128, ceil(R / 64)).
template <typename T16>
__global__ void __launch_bounds__(TT_THREADS, 2) sample_tile_tc_kernel(
    TtOps<T16> op, const float* __restrict__ bias,
    const float* __restrict__ out_scale, CST_STREAM_PARAMS) {
  extern __shared__ __align__(128) unsigned char tt_smem[];
  const int m0 = blockIdx.y * TT_BM, tile = blockIdx.x;
  logit_tile_tc(op, bias, out_scale, m0, tile * TT_BN, tt_smem);
  sample_tile_reduce<TT_BM>(
      reinterpret_cast<const float(*)[L_TV + 1]>(tt_smem), m0, tile,
      gridDim.x, op.M, CST_STREAM_ARGS);
}
#undef CST_STREAM_ARGS
#undef CST_STREAM_PARAMS

// The finished-row rule of step t for a row whose tiles merged to token
// best_i, its scaled logit `chosen` and log-sum-exp lse.
__device__ __forceinline__ void emit_step(int row, int t, int T_, int best_i,
                                          float chosen, float lse,
                                          float* __restrict__ fin,
                                          int* __restrict__ tok,
                                          int* __restrict__ out_tok,
                                          float* __restrict__ out_lp,
                                          float* __restrict__ out_mask) {
  const bool valid = fin[row] == 0.f;
  const int out = valid ? best_i : PAD_ID;
  const size_t w = (size_t)row * T_ + t;
  out_tok[w] = out;
  out_lp[w] = valid ? __fsub_rn(chosen, lse) : 0.f;
  out_mask[w] = valid ? 1.f : 0.f;
  if (best_i == EOS_ID || best_i == PAD_ID) fin[row] = 1.f;
  tok[row] = out == PAD_ID ? EOS_ID : out;
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
  emit_step(row, t, T_, best_i, chosen, __fadd_rn(m, logf(s)), fin, tok,
            out_tok, out_lp, out_mask);
}

// One warp per row (the tensor-core chain): lane l merges tiles l, l + 32,
// ... in order, then the warp's butterfly; the best z keeps the earliest
// tile on a tie, as the one-thread merge's strict '>' does.  The
// log-sum-exp sums the lanes' partial sums in the butterfly's order.
__global__ void __launch_bounds__(THREADS) sample_select_warp_kernel(
    const float* __restrict__ part_m, const float* __restrict__ part_s,
    const float* __restrict__ part_z, const int* __restrict__ part_zi,
    const float* __restrict__ part_zs, int nT, int R, int t, int T_,
    float* __restrict__ fin, int* __restrict__ tok, int* __restrict__ out_tok,
    float* __restrict__ out_lp, float* __restrict__ out_mask) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (THREADS / 32) + (threadIdx.x >> 5);
  if (row >= R) return;
  const size_t o = (size_t)row * nT;
  float m = -INFINITY;
  for (int tt = lane; tt < nT; tt += 32) m = fmaxf(m, part_m[o + tt]);
  m = warp_max(m);
  float s = 0.f;
  float bz = NEG_INF;
  int bt = INT_MAX;  // the best tile; INT_MAX: none above NEG_INF
  for (int tt = lane; tt < nT; tt += 32) {
    s = __fadd_rn(s, __fmul_rn(part_s[o + tt], expf(__fsub_rn(part_m[o + tt], m))));
    if (part_z[o + tt] > bz) {
      bz = part_z[o + tt];
      bt = tt;
    }
  }
  s = warp_sum(s);
  warp_best(bz, bt);
  if (lane != 0) return;
  const int best_i = bt == INT_MAX ? 0 : part_zi[o + bt];
  const float chosen = bt == INT_MAX ? 0.f : part_zs[o + bt];
  emit_step(row, t, T_, best_i, chosen, __fadd_rn(m, logf(s)), fin, tok,
            out_tok, out_lp, out_mask);
}

// WT: T (float weights, qs all null) or int8_t (int8w, qs the scales).
template <typename T, typename WT = T>
static int run_sample(const float* gx, const void* w_x, const void* wh,
                      const void* emb, const void* w_out, const float* bias,
                      float* h_a, float* h_b, float* c, float* fin, int* tok,
                      int* out_tok, float* out_lp, float* out_mask, float* pm,
                      float* ps, float* pz, int* pzi, float* pzs, int B,
                      int T_, int E, int H, int Vp, int bt, int vpad_stream,
                      uint32_t s0, uint32_t s1, float inv_temp, int greedy,
                      cudaStream_t st, const AttArgs<T, WT>* at,
                      QScales qs) {
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
      lstm_gates_kernel<T, true, WT><<<gate_grid, THREADS, 0, st>>>(
          gx, static_cast<const WT*>(w_x), at->w_ctx,
          static_cast<const WT*>(wh), static_cast<const WT*>(emb), tok,
          at->ctx, h_in, c, h_out, c, R, E, H, qs);
    } else {
      lstm_gates_kernel<T, false, WT><<<gate_grid, THREADS, 0, st>>>(
          gx, static_cast<const WT*>(w_x), nullptr,
          static_cast<const WT*>(wh), static_cast<const WT*>(emb), tok,
          nullptr, h_in, c, h_out, c, R, E, H, qs);
    }
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    sample_tile_kernel<T, WT><<<tile_grid, THREADS, 0, st>>>(
        h_out, static_cast<const WT*>(w_out), bias, qs.out, R, H, Vp, t, T_,
        bt, vpad_stream, s0, s1, inv_temp, greedy, pm, ps, pz, pzi, pzs);
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

// 16-bit compute (bf16 with float or int8 weights, f16 with float weights)
// on the tensor cores: per step decode_tc.cuh's step (meanpool: the gate
// GEMM; attention: the query, the attention step with row r reading
// video r, and the gate GEMM), the vocab tile GEMM with the sampling
// partials in its epilogue, and the warp-per-row merge: three launches
// (five under attention), no host sync.  h_a, h_b (B, H) T16, the
// state's two buffers.
template <typename T16>
static int run_sample_tc(DecTc<T16> d, T16* h_a, T16* h_b,
                         float* c, float* fin, int* tok, int* out_tok,
                         float* out_lp, float* out_mask, float* pm, float* ps,
                         float* pz, int* pzi, float* pzs, int B, int T_,
                         int Vp, int bt, int vpad_stream, uint32_t s0,
                         uint32_t s1, float inv_temp, int greedy,
                         cudaStream_t st) {
  const int R = B, nT = Vp / L_TV;
  cudaError_t e = dec_tc_prepare(d);
  if (e == cudaSuccess)
    e = set_smem((const void*)sample_tile_tc_kernel<T16>, TT_SMEM);
  if (e != cudaSuccess) return (int)e;
  const dim3 tile_grid(nT, (R + TT_BM - 1) / TT_BM);
  const int sel_blocks = (R + THREADS / 32 - 1) / (THREADS / 32);
  T16* h_in = h_a;
  T16* h_out = h_b;
  for (int t = 0; t < T_; ++t) {
    e = dec_tc_step(d, h_in, tok, c, c, h_out, R, 1, st);
    if (e != cudaSuccess) return (int)e;
    sample_tile_tc_kernel<T16><<<tile_grid, TT_THREADS, TT_SMEM, st>>>(
        dec_vocab_op(d, h_out, R, Vp), d.bias, d.out_s, t, T_, bt,
        vpad_stream, s0, s1, inv_temp, greedy, pm, ps, pz, pzi, pzs);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    sample_select_warp_kernel<<<sel_blocks, THREADS, 0, st>>>(
        pm, ps, pz, pzi, pzs, nT, R, t, T_, fin, tok, out_tok, out_lp,
        out_mask);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    T16* tmp = h_in;
    h_in = h_out;
    h_out = tmp;
  }
  return 0;
}

}  // namespace cstk

// Meanpool at float32 compute (dtype 0; bf16 and f16 take
// cst_lstm_sample_tc).
// wq: 0 for float32 weights, 1 for int8 codes (int8w) with the float32
// scales emb_s (V,), lstm_s (4H,), out_s (Vp,) (and att_s (A,) under
// attention), which are null otherwise.  The caller initialises h_a, c,
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

#define CST_QSCALES                                                  \
  cstk::QScales{static_cast<const float*>(emb_s),                   \
                static_cast<const float*>(lstm_s),                  \
                static_cast<const float*>(out_s)}

extern "C" float cst_sample_masked_logit() { return cstk::kMaskedLogit; }

extern "C" int cst_lstm_sample(int dtype, int wq, CST_SAMPLE_PARAMS,
                               const void* emb_s, const void* lstm_s,
                               const void* out_s, void* stream) {
  if (dtype != 0 || Vp % cstk::L_TV != 0 || bt < 1)
    return (int)cudaErrorInvalidValue;
  if (wq && (emb_s == nullptr || lstm_s == nullptr || out_s == nullptr))
    return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  const cstk::QScales qs = wq ? CST_QSCALES : cstk::QScales{};
  return wq ? cstk::run_sample<float, int8_t>(CST_SAMPLE_ARGS, nullptr, qs)
            : cstk::run_sample<float, float>(CST_SAMPLE_ARGS, nullptr, qs);
}

// The meanpool tensor-core call of cst_lstm_sample_tc at T16.
template <typename T16>
static int lstm_sample_tc(
    const void* gx, const void* emb, const void* wcat_t, const void* w_out_t,
    const void* bias, const void* lstm_s, const void* out_s, void* h_a,
    void* h_b, void* c, void* fin, void* tok, void* out_tok, void* out_lp,
    void* out_mask, void* pm, void* ps, void* pz, void* pzi, void* pzs,
    int B, int T, int E, int H, int Vp, int bt, int vpad_stream,
    unsigned int s0, unsigned int s1, float inv_temp, int greedy,
    void* stream) {
  const cstk::DecTc<T16> d{
      static_cast<const float*>(gx), static_cast<const T16*>(emb),
      static_cast<const T16*>(wcat_t), nullptr,
      static_cast<const T16*>(w_out_t), static_cast<const float*>(bias),
      static_cast<const float*>(lstm_s), nullptr,
      static_cast<const float*>(out_s), nullptr, nullptr, nullptr, nullptr,
      nullptr, nullptr, E, H, 0, 0, 0};
  return cstk::run_sample_tc<T16>(
      d, static_cast<T16*>(h_a), static_cast<T16*>(h_b),
      static_cast<float*>(c), static_cast<float*>(fin), static_cast<int*>(tok),
      static_cast<int*>(out_tok), static_cast<float*>(out_lp),
      static_cast<float*>(out_mask), static_cast<float*>(pm),
      static_cast<float*>(ps), static_cast<float*>(pz), static_cast<int*>(pzi),
      static_cast<float*>(pzs), B, T, Vp, bt, vpad_stream, s0, s1, inv_temp,
      greedy, static_cast<cudaStream_t>(stream));
}

// Meanpool at 16-bit compute, the tensor-core chain (dtype 1: bf16 with
// float or int8 weights, dtype 2: f16 with float weights, as the wrapper
// stages them; decode_tc.cuh DecTc): the operands of cst_lstm_beam_tc at
// B rows (gx (B, 4H) gx_static), the state h_a, h_b (B, H) in the
// compute dtype (the caller zeroes h_a), c, fin, tok and the outputs and
// partials of cst_lstm_sample, and its stream parameters.  E and H must
// be multiples of 32.  Returns 0 or the CUDA error code of the first
// refused launch (cudaErrorInvalidValue for a shape the chain does not
// take).
extern "C" int cst_lstm_sample_tc(
    int dtype, const void* gx, const void* emb, const void* wcat_t,
    const void* w_out_t, const void* bias, const void* lstm_s,
    const void* out_s, void* h_a,
    void* h_b, void* c, void* fin, void* tok, void* out_tok, void* out_lp,
    void* out_mask, void* pm, void* ps, void* pz, void* pzi, void* pzs,
    int B, int T, int E, int H, int Vp, int bt, int vpad_stream,
    unsigned int s0, unsigned int s1, float inv_temp, int greedy,
    void* stream) {
  if (B < 1 || T < 1 || Vp % cstk::L_TV != 0 || bt < 1 ||
      !cstk::dec_tc_widths_ok(E, H) ||
      (lstm_s == nullptr) != (out_s == nullptr) ||
      (dtype != 1 && dtype != 2) || (dtype == 2 && lstm_s != nullptr))
    return (int)cudaErrorInvalidValue;
#define CST_SAMPLE_TC_ARGS                                                  \
  gx, emb, wcat_t, w_out_t, bias, lstm_s, out_s, h_a, h_b, c, fin, tok,     \
      out_tok, out_lp, out_mask, pm, ps, pz, pzi, pzs, B, T, E, H, Vp, bt,  \
      vpad_stream, s0, s1, inv_temp, greedy, stream
  return dtype == 1 ? lstm_sample_tc<__nv_bfloat16>(CST_SAMPLE_TC_ARGS)
                    : lstm_sample_tc<__half>(CST_SAMPLE_TC_ARGS);
#undef CST_SAMPLE_TC_ARGS
}

// Attention fusion at float32 compute (dtype 0; bf16 and f16 take
// cst_attlstm_sample_tc): the meanpool entry's operands (gx = the lstm
// bias), then the attention operands w_ctx (E, 4H), att_wh (H, A), att_v
// (A), att_proj (B, F, A), att_mask (B, F) float32, att_vals (B, F, E),
// and the scratch q (B, A), ctx (B, E) float32.  (CT is the compute
// dtype: the parameter list names an int T; WT the weights' type.)
template <typename CT, typename WT>
static int run_attlstm_sample(const void* w_ctx, const void* att_wh,
                              const void* att_v, const void* proj,
                              const void* mask, const void* vals, void* q,
                              void* ctx, int A, int F, const float* att_s,
                              cstk::QScales qs, CST_SAMPLE_PARAMS,
                              cudaStream_t st) {
  const cstk::AttArgs<CT, WT> at{
      static_cast<const WT*>(w_ctx), static_cast<const WT*>(att_wh),
      static_cast<const CT*>(att_v), static_cast<const CT*>(proj),
      static_cast<const float*>(mask), static_cast<const CT*>(vals),
      static_cast<float*>(q), static_cast<float*>(ctx), A, F, att_s};
  return cstk::run_sample<CT, WT>(CST_SAMPLE_ARGS, &at, qs);
}

extern "C" int cst_attlstm_sample(int dtype, int wq, CST_SAMPLE_PARAMS,
                                  const void* w_ctx, const void* att_wh,
                                  const void* att_v, const void* proj,
                                  const void* mask, const void* vals, void* q,
                                  void* ctx, int A, int F, const void* emb_s,
                                  const void* lstm_s, const void* att_s,
                                  const void* out_s, void* stream) {
  if (dtype != 0 || Vp % cstk::L_TV != 0 || bt < 1 || A < 1 || F < 1)
    return (int)cudaErrorInvalidValue;
  if (wq && (emb_s == nullptr || lstm_s == nullptr || att_s == nullptr ||
             out_s == nullptr))
    return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  const cstk::QScales qs = wq ? CST_QSCALES : cstk::QScales{};
  const float* as = wq ? static_cast<const float*>(att_s) : nullptr;
#define CST_ATT_CALL(WW)                                                      \
  run_attlstm_sample<float, WW>(w_ctx, att_wh, att_v, proj, mask, vals, q,    \
                                ctx, A, F, as, qs, gx, w_x, wh, emb, w_out,   \
                                bias, h_a, h_b, c, fin, tok, out_tok, out_lp, \
                                out_mask, pm, ps, pz, pzi, pzs, B, T, E, H,   \
                                Vp, bt, vpad_stream, s0, s1, inv_temp,        \
                                greedy, st)
  return wq ? CST_ATT_CALL(int8_t) : CST_ATT_CALL(float);
#undef CST_ATT_CALL
}

// The attention tensor-core call of cst_attlstm_sample_tc at T16.
template <typename T16>
static int attlstm_sample_tc(
    const void* gx, const void* emb, const void* wcat_t, const void* att_wh_t,
    const void* w_out_t, const void* bias, const void* lstm_s,
    const void* att_s, const void* out_s, const void* att_v, const void* proj,
    const void* mask, const void* vals, void* h_a, void* h_b, void* c,
    void* q, void* ctx, void* fin, void* tok, void* out_tok, void* out_lp,
    void* out_mask, void* pm, void* ps, void* pz, void* pzi, void* pzs, int B,
    int T, int E, int H, int A, int F, int Vp, int bt, int vpad_stream,
    unsigned int s0, unsigned int s1, float inv_temp, int greedy,
    void* stream) {
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
  return cstk::run_sample_tc<T16>(
      d, static_cast<T16*>(h_a), static_cast<T16*>(h_b),
      static_cast<float*>(c), static_cast<float*>(fin), static_cast<int*>(tok),
      static_cast<int*>(out_tok), static_cast<float*>(out_lp),
      static_cast<float*>(out_mask), static_cast<float*>(pm),
      static_cast<float*>(ps), static_cast<float*>(pz), static_cast<int*>(pzi),
      static_cast<float*>(pzs), B, T, Vp, bt, vpad_stream, s0, s1, inv_temp,
      greedy, static_cast<cudaStream_t>(stream));
}

// Attention fusion at 16-bit compute, the tensor-core chain (dtype 1: bf16
// with float or int8 weights, dtype 2: f16 with float weights, as the
// wrapper stages them; decode_tc.cuh DecTc): the operands of
// cst_attlstm_beam_tc at B rows (gx (B, 4H) the lstm bias), the state
// h_a, h_b (B, H) in the compute dtype (the caller zeroes h_a), the
// scratch q and ctx as there, c, fin, tok and the outputs and partials of
// cst_lstm_sample, and its stream parameters.  E, H and A must be
// multiples of 32.  Returns 0 or the CUDA error code of the first refused
// launch (cudaErrorInvalidValue for a shape the chain does not take).
extern "C" int cst_attlstm_sample_tc(
    int dtype, const void* gx, const void* emb, const void* wcat_t,
    const void* att_wh_t, const void* w_out_t, const void* bias,
    const void* lstm_s, const void* att_s, const void* out_s,
    const void* att_v, const void* proj, const void* mask, const void* vals,
    void* h_a, void* h_b, void* c, void* q, void* ctx, void* fin, void* tok,
    void* out_tok, void* out_lp, void* out_mask, void* pm, void* ps, void* pz,
    void* pzi, void* pzs, int B, int T, int E, int H, int A, int F, int Vp,
    int bt, int vpad_stream, unsigned int s0, unsigned int s1,
    float inv_temp, int greedy, void* stream) {
  if (B < 1 || T < 1 || Vp % cstk::L_TV != 0 || bt < 1 ||
      (dtype != 1 && dtype != 2) || (dtype == 2 && lstm_s != nullptr))
    return (int)cudaErrorInvalidValue;
  if ((lstm_s == nullptr) != (att_s == nullptr) ||
      (lstm_s == nullptr) != (out_s == nullptr))
    return (int)cudaErrorInvalidValue;
#define CST_ATT_SAMPLE_TC_ARGS                                                \
  gx, emb, wcat_t, att_wh_t, w_out_t, bias, lstm_s, att_s, out_s, att_v,     \
      proj, mask, vals, h_a, h_b, c, q, ctx, fin, tok, out_tok, out_lp,      \
      out_mask, pm, ps, pz, pzi, pzs, B, T, E, H, A, F, Vp, bt, vpad_stream, \
      s0, s1, inv_temp, greedy, stream
  return dtype == 1 ? attlstm_sample_tc<__nv_bfloat16>(CST_ATT_SAMPLE_TC_ARGS)
                    : attlstm_sample_tc<__half>(CST_ATT_SAMPLE_TC_ARGS);
#undef CST_ATT_SAMPLE_TC_ARGS
}
#undef CST_QSCALES
#undef CST_SAMPLE_ARGS
#undef CST_SAMPLE_PARAMS
