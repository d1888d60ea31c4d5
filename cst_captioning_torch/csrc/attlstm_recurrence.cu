// Teacher-forced attention + LSTM recurrence and its backward for Hopper
// (sm_90a).
//
// Replaces the TPU kernels of the JAX package, ops/pallas_attlstm.py::
// attlstm_recurrence: the forward (_fwd_call -> pallas_call, kernel
// _make_fwd_kernel) and the backward of its custom VJP (_vjp_bwd ->
// _bwd_call -> pallas_call, kernel _bwd_kernel); with int8 weights also
// attlstm_recurrence_quant (the same pallas_call, _make_fwd_kernel(quant=
// True)).  Same functions, over R caption rows of B = R / rep videos: row
// r reads video r / rep's att_proj (B, F, A), att_mask (B, F) and att_vals
// (B, F, E), which the reference repeats to the rows first (rep = 1 is
// the reference's own signature):
//
// forward, from zero state over T steps of precomputed input gates gx
// (R, T, 4H) float32: q = T(T(h) @ att_wh), th = tanh(T(proj + q)) in
// float32, s = sum_a th * v (masked frames -1e30), a = softmax(s), ctx =
// sum_f a_f vals_f, then gates = (gx_t + T(ctx) @ W_ctx) + T(h) @ W_h and
// the i|f|g|o update with a float32 cell.  h_seq is written in T and,
// under autograd, the float32 residuals c_seq (R, T, H) and a_seq (R, T,
// F).  int8w: q = T((T(h) @ codes) * att_scale), gates = (gx_t + (T(ctx)
// @ W_ctx) * ls) + (T(h) @ W_h) * ls, each scale applied once to its
// float32 sum.
//
// backward, reversed time: gates recomputed from the stored h_seq and the
// saved weights, the LSTM cotangents, dgx_t = dgates (float32), dctx =
// T(dgates) @ W_ctx^T, dh = T(dgates) @ W_h^T + T(dq) @ att_wh^T, the
// attention cotangents (da, ds, th recomputed, dq = sum_f dpre).  A
// video's d_proj and d_vals are float32 sums: each row's sum over
// reversed time (the reference's per-row accumulator), then the video's
// rows added in row order, rounded once by the caller; so rep = 20 is
// bitwise rep = 1 on the repeated tensors with its rows folded in row
// order.  No float atomics: results repeat run to run.  The three weight
// cotangents are contractions the caller does outside, as the reference.
//
// Bound on the H100 at the XE shape (bf16, R = 1280 rows of 64 videos,
// T = 29, H = E = A = 512, F = 56): the forward's products are 179 GFLOP
// (0.18 ms on the tensor cores) and its compulsory bytes ~0.43 GB at rep
// = 20 (gx 304 MB, per-video att_proj + att_vals 7.3 MB, h_seq, c_seq,
// a_seq: 0.13 ms); it evaluates R*T*F*A = 1.06 G tanh, 0.25 ms at the SFU
// rate of one op each (16 per SM per clock), and the precise tanhf costs
// more than one op: the tanh count binds.  The backward does about twice
// the products and bytes and the same tanh count.
//
// Design, bf16 compute (the training path; PERF.md has the times): a
// chain of launches per step on the caller's stream, no host sync.  One
// persistent launch was not chosen: W_ctx and W_h for 32 units x 4 gates
// are 256 KiB of bf16, more than a CTA's shared memory, so they stream
// from L2 every step whatever the launch count, and the profiler puts
// the parent's time in the SIMT products and the per-row attention, not
// in launches.  Every product runs on the tensor cores through
// tc_common.cuh's tile GEMM (mma.sync m16n8k16, fixed k order):
//   forward, per step (3 launches): the query T(h) @ att_wh; the attention
//   step, one block per 4 rows of a video, one warp per frame for all of
//   them, so each frame of the video's att_proj is read once from L2
//   (att_fwd_step_kernel); the gate product [T(ctx) | T(h)] @ [W_ctx ;
//   W_h] as one K = E + H product with two float32 sums (split at E, the
//   reference's association), whose epilogue runs the i|f|g|o update: a
//   warp's 32 tile columns hold the four gates of 8 units (tt_gate_col),
//   so the update needs no exchange.
//   backward: the queries and contexts of every step first (2 launches
//   over all R*T rows), then per step (4 launches) the gate recompute
//   with the LSTM cotangents in its epilogue, T(dgates) @ [W_ctx ; W_h]^T
//   as one N = E + H product, the attention cotangents per 4 rows of a
//   video (ds, dq), and T(dq) @ att_wh^T added into dh; then one pass per
//   (video, 64 columns, 32 frames) folds d_proj, d_vals and d_v over the
//   video's rows and steps in registers (att_fold_kernel).  So no per-row
//   float32 accumulator lives in memory; the fold evaluates the tanh a
//   second time.
//   The tanh arguments are bf16 values, so the three tanh kernels read
//   tanhf from a table of its values on them (tanh_bf16): bitwise the
//   precise tanhf, at a shared-memory load instead of its ~20 operations.
// int8w: the caller widens the codes to bf16 once per call (exact, |code|
// <= 127: one pass over the codes instead of one per step) and the scales
// multiply the float32 sums in the epilogues.
//
// Design, float32 compute: the first design's SIMT kernels (products as
// one fmaf chain per output; tensor cores would need TF32), one launch
// per kernel per step, with the backward's attention cotangents through
// the same per-video kernels as bf16.
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
// or +-1 (|x| >= 64), and NaN stays NaN; the lookup selects among these
// without a branch.  tanh_table_check_kernel holds it to tanhf on every
// bf16 value.
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

// tanhf(x) for x a bf16 value (its low 16 bits zero).
__device__ __forceinline__ float tanh_bf16(float x, const float* tab) {
  const uint32_t u = __float_as_uint(x);
  const uint32_t m = (u >> 16) & 0x7fffu;  // |x| as bf16 bits
  const uint32_t k = m - (uint32_t)(TB_ELO << 7);
  const float t = tab[(u >> 31) * TB_SPAN + min(k, (uint32_t)TB_SPAN - 1)];
  const float out = (m < (uint32_t)(TB_ELO << 7) || m > 0x7f80u)
                        ? x                       // tiny, or NaN
                        : copysignf(1.f, x);      // |x| >= 64, or inf
  return k < (uint32_t)TB_SPAN ? t : out;
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
  return tanh_bf16(round_cdt<__nv_bfloat16>(x), tab);
}

template <typename T>
__host__ __device__ constexpr size_t table_bytes() {
  return std::is_same<T, __nv_bfloat16>::value ? TB_BYTES : 0;
}

// The table against tanhf on every bf16 value x = bits(i << 16): out[i]
// = the lookup, out[65536 + i] = tanhf(x).  One block.
__global__ void __launch_bounds__(THREADS) tanh_table_check_kernel(float* out) {
  __shared__ float tab[2 * TB_SPAN];
  tanh_table_fill(tab);
  __syncthreads();
  for (int i = threadIdx.x; i < 65536; i += THREADS) {
    const float x = __uint_as_float((uint32_t)i << 16);
    out[i] = tanh_bf16(x, tab);
    out[65536 + i] = tanhf(x);
  }
}

// ------------------------------------------------- tensor-core products

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

// Columns n < N0 of A @ B^T go to out0 (row stride ld0), the others to
// out1 (ld1), stored, or with add added to what out1 holds (one float32
// add): dctx and dh from T(dgates), then dh += T(dq) @ att_wh^T.
__global__ void __launch_bounds__(TT_THREADS, 2) att_out_tc_kernel(
    TtOperands op, float* __restrict__ out0, long long ld0, int N0,
    float* out1, long long ld1, int add) {
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
          const float v = acc[mi][ni][2 * hh + e];
          if (n < N0) {
            out0[(size_t)row * ld0 + n] = v;
          } else {
            float* o = out1 + (size_t)row * ld1 + (n - N0);
            *o = add ? __fadd_rn(*o, v) : v;
          }
        }
    }
}

// The gate kernels' per-step operands besides the product's.
struct GateArgs {
  const float* gx;      // (R, T, 4H) float32
  const float* lstm_s;  // (4H,) int8w column scale, or null
  // forward
  float* c_state;           // (R, H) the cell carry
  __nv_bfloat16* h_seq;     // (R, T, H)
  float* c_out;             // (R, T, H) residual, or null
  // backward
  const float* c_seq;   // (R, T, H) the forward's cell
  const float* dh_out;  // (R, T, H) cotangent of h_seq, float32
  const float* dh_c;    // (R, H) dh carried from step t + 1
  float* dc_c;          // (R, H) dc carried from step t + 1
  float* dgx;           // (R, T, 4H)
  __nv_bfloat16* dgb;   // (R, 4H) T(dgates), the next product's operand
  int T, H, t;
};

// The gates of step t: A = [T(ctx) | T(h_{t-1})] (K = E + H, or E at t =
// 0), B^T = [W_ctx ; W_h]^T (4H, E + H), the tile's columns in
// tt_gate_col order.  Forward (kBwd false): the i|f|g|o update; backward:
// the LSTM cotangents with dh = dh_out_t + dh_c and the cell carry dc_c
// (decode_common.cuh's lstm_cell, attention_common's formulas).  Grid
// (4H / 128, ceil(R / 64)).
template <bool kBwd>
__global__ void __launch_bounds__(TT_THREADS, 2) att_gate_tc_kernel(
    TtOperands op, GateArgs ga) {
  extern __shared__ __align__(128) unsigned char tt_smem[];
  float accc[2][4][4], acch[2][4][4];
  const int m0 = blockIdx.y * TT_BM, n0 = blockIdx.x * TT_BN;
  const int H = ga.H, T_ = ga.T, t = ga.t, G = 4 * H;
  {  // the tile's gx (64 rows x 4 gates x 32 units) into L2 meanwhile
    const int row = m0 + (threadIdx.x >> 2), q = threadIdx.x & 3;
    if (row < op.M)
      asm volatile("prefetch.global.L2 [%0];" ::"l"(
          ga.gx + ((size_t)row * T_ + t) * G + q * H + 32 * blockIdx.x));
  }
  tt_mainloop<true>(op, H, m0, n0, tt_smem, accc, acch);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wr = warp >> 2, wc = warp & 3;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = m0 + 32 * wr + 16 * mi + (lane >> 2) + 8 * hh;
      if (row >= op.M) continue;
      const size_t step = (size_t)row * T_ + t;
      // This thread's two neighbouring units, read and written in pairs.
      const int u0 = 32 * blockIdx.x + 8 * wc + 2 * (lane & 3);
      float p[2][4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float2 g2 =
            *reinterpret_cast<const float2*>(ga.gx + step * G + q * H + u0);
        float2 s2 = make_float2(1.f, 1.f);
        if (ga.lstm_s != nullptr)
          s2 = *reinterpret_cast<const float2*>(ga.lstm_s + q * H + u0);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float pc = accc[mi][q][2 * hh + e], ph = acch[mi][q][2 * hh + e];
          if (ga.lstm_s != nullptr) {
            pc = __fmul_rn(pc, e ? s2.y : s2.x);
            ph = __fmul_rn(ph, e ? s2.y : s2.x);
          }
          p[e][q] = __fadd_rn(__fadd_rn(e ? g2.y : g2.x, pc), ph);
        }
      }
      const size_t o = (size_t)row * H + u0;
      const size_t so = step * H + u0;
      if constexpr (!kBwd) {
        float2 c2 = t > 0 ? *reinterpret_cast<const float2*>(ga.c_state + o)
                          : make_float2(0.f, 0.f);
        const float h0 = lstm_cell(p[0], c2.x);
        const float h1 = lstm_cell(p[1], c2.y);
        *reinterpret_cast<float2*>(ga.c_state + o) = c2;
        *reinterpret_cast<__nv_bfloat162*>(ga.h_seq + so) =
            __floats2bfloat162_rn(h0, h1);
        if (ga.c_out != nullptr) *reinterpret_cast<float2*>(ga.c_out + so) = c2;
      } else {
        const float2 c2 = *reinterpret_cast<const float2*>(ga.c_seq + so);
        const float2 cp2 = t > 0 ? *reinterpret_cast<const float2*>(
                                       ga.c_seq + so - H)
                                 : make_float2(0.f, 0.f);
        const float2 dho = *reinterpret_cast<const float2*>(ga.dh_out + so);
        const float2 dhc = *reinterpret_cast<const float2*>(ga.dh_c + o);
        const float2 dcc = *reinterpret_cast<const float2*>(ga.dc_c + o);
        float d[2][4], dcn[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float ig = sigmoidf_(p[e][0]);
          const float fg = sigmoidf_(p[e][1]);
          const float gg = tanhf(p[e][2]);
          const float og = sigmoidf_(p[e][3]);
          const float tch = tanhf(e ? c2.y : c2.x);
          const float cp = e ? cp2.y : cp2.x;
          const float dh = __fadd_rn(e ? dho.y : dho.x, e ? dhc.y : dhc.x);
          const float dc = __fadd_rn(
              e ? dcc.y : dcc.x, __fmul_rn(__fmul_rn(dh, og),
                                           __fsub_rn(1.f, __fmul_rn(tch, tch))));
          d[e][0] = __fmul_rn(__fmul_rn(__fmul_rn(dc, gg), ig), __fsub_rn(1.f, ig));
          d[e][1] = __fmul_rn(__fmul_rn(__fmul_rn(dc, cp), fg), __fsub_rn(1.f, fg));
          d[e][2] = __fmul_rn(__fmul_rn(dc, ig), __fsub_rn(1.f, __fmul_rn(gg, gg)));
          d[e][3] = __fmul_rn(__fmul_rn(__fmul_rn(dh, tch), og), __fsub_rn(1.f, og));
          dcn[e] = __fmul_rn(dc, fg);
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          *reinterpret_cast<float2*>(ga.dgx + step * G + q * H + u0) =
              make_float2(d[0][q], d[1][q]);
          *reinterpret_cast<__nv_bfloat162*>(ga.dgb + (size_t)row * G + q * H +
                                             u0) =
              __floats2bfloat162_rn(d[0][q], d[1][q]);
        }
        *reinterpret_cast<float2*>(ga.dc_c + o) = make_float2(dcn[0], dcn[1]);
      }
    }
}

// ------------------------------------------------- the attention step

__host__ __device__ constexpr size_t att_fwd_smem(int F, int A) {
  return TB_BYTES + (size_t)AT_ROWS * A * 2 + (size_t)A * 4 +
         (size_t)AT_ROWS * F * 4;
}

// Score, softmax and context for up to AT_ROWS rows of one video (bf16):
// block i is video b = i / groups, rows r0 = b * rep + (i % groups) *
// AT_ROWS onwards.  One warp per frame for every row of the block (the
// frame's att_proj read once, from L2): each row's score sum_a th * v is
// the lane's 16-byte chunks in order, then the warp's butterfly; one warp
// per row takes the softmax; one thread per (row, 8 columns of E) mixes
// the context in frame order.  ctx (R, E) is written rounded to bf16 (the
// gate product's operand), the weights into a_out (row stride a_ld)
// unless it is null.  q null: zero queries (step 0).  Dynamic shared
// memory: att_fwd_smem(F, A).
__global__ void __launch_bounds__(THREADS) att_fwd_step_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ att_v,
    const __nv_bfloat16* __restrict__ proj, const float* __restrict__ mask,
    const __nv_bfloat16* __restrict__ vals, int rep, int groups, int F, int A,
    int E, __nv_bfloat16* __restrict__ ctx, float* __restrict__ a_out,
    long long a_ld) {
  extern __shared__ __align__(16) unsigned char att_smem[];
  float* tab = reinterpret_cast<float*>(att_smem);
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(att_smem + TB_BYTES);
  float* v_s = reinterpret_cast<float*>(q_s + AT_ROWS * A);
  float* s_s = v_s + A;
  const int b = blockIdx.x / groups;
  const int r0 = b * rep + (blockIdx.x % groups) * AT_ROWS;
  const int nr = min(AT_ROWS, (b + 1) * rep - r0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ach = A / 8;
  tanh_table_fill(tab);
  for (int i = threadIdx.x; i < AT_ROWS * ach; i += THREADS) {
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
    float s[AT_ROWS];
#pragma unroll
    for (int rr = 0; rr < AT_ROWS; ++rr) s[rr] = 0.f;
#pragma unroll 2
    for (int c = lane; c < ach; c += 32) {
      float pv[8];
      load8(pb + (size_t)f * A + 8 * c, pv);
      const float4 v0 = reinterpret_cast<const float4*>(v_s)[2 * c];
      const float4 v1 = reinterpret_cast<const float4*>(v_s)[2 * c + 1];
      const float vv[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
#pragma unroll
      for (int rr = 0; rr < AT_ROWS; ++rr) {
        float qv[8];
        unpack8(reinterpret_cast<const uint4*>(q_s + rr * A)[c], qv);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float th = tanh_t<__nv_bfloat16>(__fadd_rn(pv[j], qv[j]), tab);
          s[rr] = __fadd_rn(s[rr], __fmul_rn(th, vv[j]));
        }
      }
    }
    const bool live = mask[(size_t)b * F + f] > 0.f;
#pragma unroll
    for (int rr = 0; rr < AT_ROWS; ++rr) {
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

// The backward's contexts of every step at once: ctx_all[r, t] =
// T(sum_f a_seq[r, t, f] * vals[r / rep, f]), in frame order (the
// forward's own sum, so the recomputed gates are the forward's).  One
// block of 64 threads per (row, step), 8 columns of E a thread.  Dynamic
// shared memory: F floats.
__global__ void __launch_bounds__(64) att_mix_all_kernel(
    const float* __restrict__ a_seq, const __nv_bfloat16* __restrict__ vals,
    int rep, int T_, int F, int E, __nv_bfloat16* __restrict__ ctx_all) {
  extern __shared__ __align__(16) unsigned char att_smem[];
  float* a_s = reinterpret_cast<float*>(att_smem);
  const size_t rt = blockIdx.x;
  const int vid = (int)(rt / T_) / rep;
  for (int f = threadIdx.x; f < F; f += blockDim.x) a_s[f] = a_seq[rt * F + f];
  __syncthreads();
  const __nv_bfloat16* vb = vals + (size_t)vid * F * E;
  for (int c = threadIdx.x; c < E / 8; c += blockDim.x) {
    float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int f = 0; f < F; ++f) {
      float x[8];
      load8(vb + (size_t)f * E + 8 * c, x);
      const float af = a_s[f];
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[j] = __fadd_rn(acc[j], __fmul_rn(af, x[j]));
    }
    reinterpret_cast<uint4*>(ctx_all + rt * E)[c] = pack8(acc);
  }
}

// float32 compute: ctx[r] = sum_f a[r * a_ld + f] * vals[r / rep, f, :],
// one block per row, the forward's mix order.  Dynamic shared memory: F
// floats.
template <typename T>
__global__ void __launch_bounds__(THREADS) att_mix_kernel(
    const float* __restrict__ a, long long a_ld, const T* __restrict__ vals,
    int rep, int F, int E, float* __restrict__ ctx) {
  extern __shared__ float a_s[];
  const int r = blockIdx.x;
  for (int f = threadIdx.x; f < F; f += THREADS)
    a_s[f] = a[(size_t)r * a_ld + f];
  __syncthreads();
  mix_context<T>(a_s, vals + (size_t)(r / rep) * F * E, F, E,
                 ctx + (size_t)r * E);
}

template <typename T>
__host__ __device__ constexpr size_t att_bwd_smem(int F, int A, int E) {
  return table_bytes<T>() + (size_t)AT_ROWS * (E + A) * 4 + (size_t)A * 4 +
         (size_t)3 * AT_ROWS * F * 4;
}

// The attention cotangents of step t for up to AT_ROWS rows of one video
// (blocks as att_fwd_step_kernel): da_f = dctx . vals_f (one warp per
// frame for every row, lanes over 8-column chunks of E), ds = a * (da -
// sum(a * da)) (one warp per row), then per (row, column a) th recomputed
// from the T-rounded query and dq = sum_f ds * v * (1 - th^2) in frame
// order.  ds goes to ds_out for the fold, dq to dq
// (float32) and, when dq_lo is not null, rounded to bf16 into dq_lo (R,
// A).  q null: zero queries (step 0).  Dynamic shared memory:
// att_bwd_smem<T>(F, A, E).
template <typename T>
__global__ void __launch_bounds__(THREADS) att_bwd_step_kernel(
    const float* __restrict__ dctx, long long dctx_ld,
    const float* __restrict__ a, long long a_ld, const T* __restrict__ q,
    long long q_ld, const T* __restrict__ att_v, const T* __restrict__ proj,
    const T* __restrict__ vals, int rep, int groups, int F, int A, int E,
    float* __restrict__ ds_out, long long ds_ld, float* __restrict__ dq,
    long long dq_ld, __nv_bfloat16* __restrict__ dq_lo) {
  extern __shared__ __align__(16) unsigned char att_smem[];
  float* tab = reinterpret_cast<float*>(att_smem);
  float* dctx_s = reinterpret_cast<float*>(att_smem + table_bytes<T>());
  float* q_s = dctx_s + AT_ROWS * E;
  float* v_s = q_s + AT_ROWS * A;
  float* a_s = v_s + A;
  float* da_s = a_s + AT_ROWS * F;
  float* ds_s = da_s + AT_ROWS * F;
  const int b = blockIdx.x / groups;
  const int r0 = b * rep + (blockIdx.x % groups) * AT_ROWS;
  const int nr = min(AT_ROWS, (b + 1) * rep - r0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if constexpr (table_bytes<T>() > 0) tanh_table_fill(tab);
  for (int i = threadIdx.x; i < AT_ROWS * E; i += THREADS) {
    const int rr = i / E;
    dctx_s[i] = rr < nr ? dctx[(size_t)(r0 + rr) * dctx_ld + (i - rr * E)] : 0.f;
  }
  for (int i = threadIdx.x; i < AT_ROWS * A; i += THREADS) {
    const int rr = i / A;
    q_s[i] = (q != nullptr && rr < nr)
                 ? to_f(q[(size_t)(r0 + rr) * q_ld + (i - rr * A)])
                 : 0.f;
  }
  for (int i = threadIdx.x; i < A; i += THREADS) v_s[i] = to_f(att_v[i]);
  for (int i = threadIdx.x; i < AT_ROWS * F; i += THREADS) {
    const int rr = i / F;
    a_s[i] = rr < nr ? a[(size_t)(r0 + rr) * a_ld + (i - rr * F)] : 0.f;
  }
  __syncthreads();

  const int ech = E / 8;
  const T* vb = vals + (size_t)b * F * E;
  for (int f = warp; f < F; f += THREADS / 32) {
    float s[AT_ROWS];
#pragma unroll
    for (int rr = 0; rr < AT_ROWS; ++rr) s[rr] = 0.f;
    for (int c = lane; c < ech; c += 32) {
      float x[8];
      load8(vb + (size_t)f * E + 8 * c, x);
#pragma unroll
      for (int rr = 0; rr < AT_ROWS; ++rr) {
        const float4* dc = reinterpret_cast<const float4*>(dctx_s + rr * E);
        const float4 d0 = dc[2 * c], d1 = dc[2 * c + 1];
        const float dd[8] = {d0.x, d0.y, d0.z, d0.w, d1.x, d1.y, d1.z, d1.w};
#pragma unroll
        for (int j = 0; j < 8; ++j)
          s[rr] = __fadd_rn(s[rr], __fmul_rn(dd[j], x[j]));
      }
    }
#pragma unroll
    for (int rr = 0; rr < AT_ROWS; ++rr) {
      const float v = warp_sum(s[rr]);
      if (lane == 0 && rr < nr) da_s[rr * F + f] = v;
    }
  }
  __syncthreads();
  if (warp < nr) {
    const float* ar = a_s + warp * F;
    const float* dar = da_s + warp * F;
    float sad = 0.f;
    for (int f = lane; f < F; f += 32) sad += __fmul_rn(ar[f], dar[f]);
    sad = warp_sum(sad);
    for (int f = lane; f < F; f += 32) {
      const float d = __fmul_rn(ar[f], __fsub_rn(dar[f], sad));
      ds_s[warp * F + f] = d;
      ds_out[(size_t)(r0 + warp) * ds_ld + f] = d;
    }
  }
  __syncthreads();

  // One thread per (row, 8 columns of A): the 8 columns' att_proj read
  // in one 16-byte load per frame; each column's sum in frame order.
  const T* pb = proj + (size_t)b * F * A;
  const int ach = A / 8;
  for (int i = threadIdx.x; i < nr * ach; i += THREADS) {
    const int rr = i / ach, c = i - rr * ach;
    float qa[8], va[8], acc[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      qa[j] = q_s[rr * A + 8 * c + j];
      va[j] = v_s[8 * c + j];
      acc[j] = 0.f;
    }
    const float* dsr = ds_s + rr * F;
#pragma unroll 4
    for (int f = 0; f < F; ++f) {
      float p[8];
      load8(pb + (size_t)f * A + 8 * c, p);
      const float d = dsr[f];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float th = tanh_t<T>(__fadd_rn(p[j], qa[j]), tab);
        acc[j] = __fadd_rn(acc[j], __fmul_rn(__fmul_rn(d, va[j]),
                                             __fsub_rn(1.f, __fmul_rn(th, th))));
      }
    }
    float* dqr = dq + (size_t)(r0 + rr) * dq_ld + 8 * c;
#pragma unroll
    for (int j = 0; j < 8; ++j) dqr[j] = acc[j];
    if (dq_lo != nullptr)
      reinterpret_cast<uint4*>(dq_lo + (size_t)(r0 + rr) * A)[c] = pack8(acc);
  }
}

// ---------------------------------------------------------- the fold

constexpr int FD_COLS = 64;                    // columns per block
constexpr int FD_GROUPS = THREADS / FD_COLS;   // frame groups
constexpr int FD_PER = 8;                      // frames per thread
constexpr int FD_FRAMES = FD_GROUPS * FD_PER;  // frames per block

template <typename T>
__host__ __device__ constexpr size_t fold_smem(int T_) {
  return table_bytes<T>() + (size_t)(2 * T_ + FD_GROUPS) * FD_COLS * 4;
}

// d_proj, d_vals and d_v per video, after the reversed-time loop.  Block
// (video b, column chunk y, frame block z); thread (g, c) owns column c of
// the chunk and frames z * 32 + g + 4 i (i < 8), each sum in registers.
// For each of the video's rows in row order: s = the row's float32 sum
// over t = T-1 .. 0 (from zero), then tot = s for the first row and tot +
// s after it.  Chunks y < nA are columns of A: the terms are dpre = (ds *
// v) * (1 - th^2), th = tanh(T(proj + q_t)) (q_t = q_all[r, t - 1], zero
// at t = 0), and d_v's partial sums th * ds go to dv_part[(b, z), a]
// (ops/attlstm.py sizes dv_part from FD_FRAMES);
// the others are columns of E: a * dctx.  Dynamic shared memory:
// fold_smem(T).
template <typename T>
__global__ void __launch_bounds__(THREADS, 3) att_fold_kernel(
    const float* __restrict__ ds_seq, const T* __restrict__ q_all,
    const float* __restrict__ a_seq, const float* __restrict__ dctx_seq,
    const T* __restrict__ att_v, const T* __restrict__ proj, int rep, int T_,
    int F, int A, int E, int nA, float* __restrict__ dproj,
    float* __restrict__ dvals, float* __restrict__ dv_part) {
  extern __shared__ __align__(16) unsigned char att_smem[];
  float* tab = reinterpret_cast<float*>(att_smem);
  float* X = reinterpret_cast<float*>(att_smem + table_bytes<T>());  // T x 64: ds or a
  float* Y = X + T_ * FD_COLS;                    // T x 64: q or dctx
  float* red = Y + T_ * FD_COLS;                  // FD_GROUPS x 64
  const int b = blockIdx.x, fb = blockIdx.z * FD_FRAMES;
  const bool arole = (int)blockIdx.y < nA;
  const int c0 = (arole ? (int)blockIdx.y : (int)blockIdx.y - nA) * FD_COLS;
  const int N = arole ? A : E;
  const int c = threadIdx.x % FD_COLS, g = threadIdx.x / FD_COLS;
  const int col = c0 + c;
  const bool live = col < N;
  float p[FD_PER], tot[FD_PER];
  float va = 0.f, dv_loc = 0.f;
#pragma unroll
  for (int i = 0; i < FD_PER; ++i) {
    const int f = fb + g + FD_GROUPS * i;
    p[i] = (arole && live && f < F) ? to_f(proj[((size_t)b * F + f) * A + col])
                                    : 0.f;
    tot[i] = 0.f;
  }
  if (arole && live) va = to_f(att_v[col]);
  if constexpr (table_bytes<T>() > 0)
    if (arole) tanh_table_fill(tab);

  for (int j = 0; j < rep; ++j) {
    const size_t r = (size_t)b * rep + j;
    __syncthreads();  // the previous row is done with X and Y
    for (int i = threadIdx.x; i < T_ * FD_COLS; i += THREADS) {
      const int t = i / FD_COLS, k = i - t * FD_COLS;
      const int f = fb + k, cc = c0 + k;
      const bool in = k < FD_FRAMES && f < F;
      if (arole) {
        X[i] = in ? ds_seq[(r * T_ + t) * F + f] : 0.f;
        Y[i] = (t > 0 && cc < A) ? to_f(q_all[(r * T_ + t - 1) * A + cc]) : 0.f;
      } else {
        X[i] = in ? a_seq[(r * T_ + t) * F + f] : 0.f;
        Y[i] = cc < E ? dctx_seq[(r * T_ + t) * E + cc] : 0.f;
      }
    }
    __syncthreads();
    float s[FD_PER];
#pragma unroll
    for (int i = 0; i < FD_PER; ++i) s[i] = 0.f;
    if (arole) {
      for (int t = T_ - 1; t >= 0; --t) {
        const float qa = Y[t * FD_COLS + c];
        const float* xr = X + t * FD_COLS + g;
#pragma unroll
        for (int i = 0; i < FD_PER; ++i) {
          if (fb + g + FD_GROUPS * i < F) {
            const float d = xr[FD_GROUPS * i];
            const float th = tanh_t<T>(__fadd_rn(p[i], qa), tab);
            dv_loc = __fadd_rn(dv_loc, __fmul_rn(th, d));
            s[i] = __fadd_rn(s[i], __fmul_rn(__fmul_rn(d, va),
                                             __fsub_rn(1.f, __fmul_rn(th, th))));
          }
        }
      }
    } else {
      for (int t = T_ - 1; t >= 0; --t) {
        const float dc = Y[t * FD_COLS + c];
        const float* xr = X + t * FD_COLS + g;
#pragma unroll
        for (int i = 0; i < FD_PER; ++i)
          if (fb + g + FD_GROUPS * i < F)
            s[i] = __fadd_rn(s[i], __fmul_rn(xr[FD_GROUPS * i], dc));
      }
    }
#pragma unroll
    for (int i = 0; i < FD_PER; ++i) tot[i] = j == 0 ? s[i] : __fadd_rn(tot[i], s[i]);
  }
#pragma unroll
  for (int i = 0; i < FD_PER; ++i) {
    const int f = fb + g + FD_GROUPS * i;
    if (!live || f >= F) continue;
    if (arole)
      dproj[((size_t)b * F + f) * A + col] = tot[i];
    else
      dvals[((size_t)b * F + f) * E + col] = tot[i];
  }
  if (arole) {
    red[g * FD_COLS + c] = dv_loc;
    __syncthreads();
    if (g == 0 && live) {
      float s = red[c];
      for (int k = 1; k < FD_GROUPS; ++k) s = __fadd_rn(s, red[k * FD_COLS + c]);
      dv_part[((size_t)b * gridDim.z + blockIdx.z) * A + col] = s;
    }
  }
}

// out[n] = sum over rows of part[r, n], in row order (d_v's last pass).
__global__ void col_sum_kernel(const float* __restrict__ part, int R, int N,
                               float* __restrict__ out) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  float s = 0.f;
  for (int r = 0; r < R; ++r) s = __fadd_rn(s, part[(size_t)r * N + n]);
  out[n] = s;
}

// Launch of the fold and d_v's sum.
template <typename T>
static int run_fold(const float* ds_seq, const T* q_all, const float* a_seq,
                    const float* dctx_seq, const T* att_v, const T* proj,
                    int B, int rep, int T_, int F, int A, int E,
                    float* dproj, float* dvals, float* dv_part, float* dv,
                    cudaStream_t st) {
  const size_t smem = fold_smem<T>(T_);
  cudaError_t e = set_smem((const void*)att_fold_kernel<T>, smem);
  if (e != cudaSuccess) return (int)e;
  const int nA = (A + FD_COLS - 1) / FD_COLS, nE = (E + FD_COLS - 1) / FD_COLS;
  const int nF = (F + FD_FRAMES - 1) / FD_FRAMES;
  att_fold_kernel<T><<<dim3(B, nA + nE, nF), THREADS, smem, st>>>(
      ds_seq, q_all, a_seq, dctx_seq, att_v, proj, rep, T_, F, A, E, nA,
      dproj, dvals, dv_part);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  col_sum_kernel<<<(A + THREADS - 1) / THREADS, THREADS, 0, st>>>(
      dv_part, B * nF, A, dv);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------ bf16 forward

static int run_fwd_bf16(const float* gx, const __nv_bfloat16* wcat_t,
                        const __nv_bfloat16* att_wh_t, const float* lstm_s,
                        const float* att_s, const __nv_bfloat16* att_v,
                        const __nv_bfloat16* proj, const float* mask,
                        const __nv_bfloat16* vals, float* c_state,
                        __nv_bfloat16* q, __nv_bfloat16* ctx,
                        __nv_bfloat16* h_seq, float* c_seq, float* a_seq,
                        int R, int T_, int H, int E, int A, int F, int rep,
                        cudaStream_t st) {
  const size_t asmem = att_fwd_smem(F, A);
  cudaError_t e;
  if ((e = set_smem((const void*)att_query_tc_kernel, TT_SMEM)) != cudaSuccess ||
      (e = set_smem((const void*)att_gate_tc_kernel<false>, TT_SMEM)) !=
          cudaSuccess ||
      (e = set_smem((const void*)att_fwd_step_kernel, asmem)) != cudaSuccess)
    return (int)e;
  const int groups = (rep + AT_ROWS - 1) / AT_ROWS;
  const int B = R / rep;
  const dim3 qgrid((A + TT_BN - 1) / TT_BN, (R + TT_BM - 1) / TT_BM);
  const dim3 ggrid(4 * H / TT_BN, (R + TT_BM - 1) / TT_BM);
  GateArgs ga{};
  ga.gx = gx;
  ga.lstm_s = lstm_s;
  ga.c_state = c_state;
  ga.h_seq = h_seq;
  ga.c_out = c_seq;
  ga.T = T_;
  ga.H = H;
  for (int t = 0; t < T_; ++t) {
    const __nv_bfloat16* hp = t > 0 ? h_seq + (size_t)(t - 1) * H : nullptr;
    if (t > 0) {
      const TtOperands op{hp, (long long)T_ * H, nullptr, 0, H,
                          att_wh_t, H, R, A, H};
      att_query_tc_kernel<<<qgrid, TT_THREADS, TT_SMEM, st>>>(op, att_s, q, A);
      if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    }
    att_fwd_step_kernel<<<B * groups, THREADS, asmem, st>>>(
        t > 0 ? q : nullptr, att_v, proj, mask, vals, rep, groups, F, A, E,
        ctx, a_seq != nullptr ? a_seq + (size_t)t * F : nullptr,
        (long long)T_ * F);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    const TtOperands op{ctx, E, hp, (long long)T_ * H, E, wcat_t, E + H,
                        R, 4 * H, t > 0 ? E + H : E};
    ga.t = t;
    att_gate_tc_kernel<false><<<ggrid, TT_THREADS, TT_SMEM, st>>>(op, ga);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  return 0;
}

// ----------------------------------------------------- bf16 backward

static int run_bwd_bf16(
    const float* gx, const __nv_bfloat16* wcat, const __nv_bfloat16* wcat_t,
    const __nv_bfloat16* att_wh, const __nv_bfloat16* att_wh_t,
    const __nv_bfloat16* att_v, const __nv_bfloat16* proj,
    const __nv_bfloat16* vals, const __nv_bfloat16* h_seq, const float* c_seq,
    const float* a_seq, const float* dh, float* dgx, float* dq_seq,
    float* dproj, float* dvals, float* dv_part, float* dv,
    __nv_bfloat16* q_all, __nv_bfloat16* ctx_all, float* dctx_seq,
    float* ds_seq, __nv_bfloat16* dgb, __nv_bfloat16* dq_lo, float* dh_c,
    float* dc_c, int R, int T_, int H, int E, int A, int F, int rep,
    cudaStream_t st) {
  const size_t bsmem = att_bwd_smem<__nv_bfloat16>(F, A, E);
  cudaError_t e;
  if ((e = set_smem((const void*)att_query_tc_kernel, TT_SMEM)) != cudaSuccess ||
      (e = set_smem((const void*)att_gate_tc_kernel<true>, TT_SMEM)) !=
          cudaSuccess ||
      (e = set_smem((const void*)att_out_tc_kernel, TT_SMEM)) != cudaSuccess ||
      (e = set_smem((const void*)att_bwd_step_kernel<__nv_bfloat16>, bsmem)) !=
          cudaSuccess)
    return (int)e;
  const int G = 4 * H, B = R / rep;
  const int groups = (rep + AT_ROWS - 1) / AT_ROWS;
  const int mt = (R + TT_BM - 1) / TT_BM;
  // The query of every step: row (r, t) of h_seq gives q_all[r, t], the
  // query of step t + 1.
  {
    const TtOperands op{h_seq, H, nullptr, 0, H, att_wh_t, H, R * T_, A, H};
    att_query_tc_kernel<<<dim3((A + TT_BN - 1) / TT_BN,
                               (R * T_ + TT_BM - 1) / TT_BM),
                          TT_THREADS, TT_SMEM, st>>>(op, nullptr, q_all, A);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  att_mix_all_kernel<<<R * T_, 64, F * sizeof(float), st>>>(a_seq, vals, rep,
                                                           T_, F, E, ctx_all);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  GateArgs ga{};
  ga.gx = gx;
  ga.c_seq = c_seq;
  ga.dh_out = dh;
  ga.dh_c = dh_c;
  ga.dc_c = dc_c;
  ga.dgx = dgx;
  ga.dgb = dgb;
  ga.T = T_;
  ga.H = H;
  for (int t = T_ - 1; t >= 0; --t) {
    const __nv_bfloat16* hp = t > 0 ? h_seq + (size_t)(t - 1) * H : nullptr;
    const TtOperands gop{ctx_all + (size_t)t * E, (long long)T_ * E, hp,
                         (long long)T_ * H, E, wcat_t, E + H, R, G,
                         t > 0 ? E + H : E};
    ga.t = t;
    att_gate_tc_kernel<true><<<dim3(G / TT_BN, mt), TT_THREADS, TT_SMEM, st>>>(
        gop, ga);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    const TtOperands dop{dgb, G, nullptr, 0, G, wcat, G, R, E + H, G};
    att_out_tc_kernel<<<dim3((E + H + TT_BN - 1) / TT_BN, mt), TT_THREADS,
                        TT_SMEM, st>>>(dop, dctx_seq + (size_t)t * E,
                                       (long long)T_ * E, E, dh_c, H, 0);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    att_bwd_step_kernel<__nv_bfloat16><<<B * groups, THREADS, bsmem, st>>>(
        dctx_seq + (size_t)t * E, (long long)T_ * E, a_seq + (size_t)t * F,
        (long long)T_ * F, t > 0 ? q_all + (size_t)(t - 1) * A : nullptr,
        (long long)T_ * A, att_v, proj, vals, rep, groups, F, A, E,
        ds_seq + (size_t)t * F, (long long)T_ * F, dq_seq + (size_t)t * A,
        (long long)T_ * A, dq_lo);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    if (t > 0) {  // dh_{t-1} += T(dq) @ att_wh^T
      const TtOperands qop{dq_lo, A, nullptr, 0, A, att_wh, A, R, H, A};
      att_out_tc_kernel<<<dim3((H + TT_BN - 1) / TT_BN, mt), TT_THREADS,
                          TT_SMEM, st>>>(qop, nullptr, 0, 0, dh_c, H, 1);
      if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    }
  }
  return run_fold<__nv_bfloat16>(ds_seq, q_all, a_seq, dctx_seq, att_v, proj,
                                 B, rep, T_, F, A, E, dproj, dvals, dv_part,
                                 dv, st);
}

// ---------------------------------------------------- float32 forward

// WT = int8_t: int8w with float32 compute (W_h, W_ctx and att_wh int8
// codes, qs.lstm and at.att_scale their scales), as decode_common.cuh.
template <typename WT>
static int run_fwd_f32(const float* gx, const WT* wh,
                       const AttArgs<float, WT>& at, float* h_a, float* h_b,
                       float* c, float* h_seq, float* c_seq, float* a_seq,
                       int R, int T_, int H, int E, int rep, cudaStream_t st,
                       QScales qs) {
  const dim3 grid((R + G_TM - 1) / G_TM, (H + G_TJ - 1) / G_TJ);
  float* h_in = h_a;
  float* h_out = h_b;
  for (int t = 0; t < T_; ++t) {
    cudaError_t e = attention_step<float>(
        at, h_in, R, rep, H, E,
        a_seq != nullptr ? a_seq + (size_t)t * at.F : nullptr,
        (long long)T_ * at.F, st);
    if (e != cudaSuccess) return (int)e;
    lstm_rec_step_kernel<float, true, WT><<<grid, THREADS, 0, st>>>(
        gx, at.w_ctx, wh, at.ctx, h_in, h_out, c, h_seq, c_seq, R, T_, E, H,
        t, qs);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    float* tmp = h_in;
    h_in = h_out;
    h_out = tmp;
  }
  return 0;
}

// --------------------------------------------------- float32 backward

// Step t's gates recomputed (gx_t + ctx @ W_ctx + h_{t-1} @ W_h,
// decode_common.cuh gate_preacts), then the LSTM cotangents with dh =
// dh_out_t + dh_c and the cell carry dc_c: dgates into dgx[:, t], dc_c =
// dc * f.  h_prev (row stride ldh) is null at t = 0 (zero state); the
// thread layout is lstm_rec_step_kernel's, so every element is read and
// written by one thread.
__global__ void __launch_bounds__(THREADS) attlstm_bwd_gates_kernel(
    const float* __restrict__ gx, const float* __restrict__ w_ctx,
    const float* __restrict__ wh, const float* __restrict__ ctx,
    const float* __restrict__ h_prev, long long ldh,
    const float* __restrict__ c_seq, const float* __restrict__ dh_out,
    const float* __restrict__ dh_c, float* dc_c, float* __restrict__ dgx,
    int R, int T_, int E, int H, int t) {
  const int r0 = blockIdx.x * G_TM, j0 = blockIdx.y * G_TJ;
  float pre[4][4];
  gate_preacts<float, false, true, float, float>(
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

static int run_bwd_f32(const float* gx, const float* wh, const float* w_ctx,
                       const float* att_wh, const float* att_v,
                       const float* proj, const float* vals,
                       const float* h_seq, const float* c_seq,
                       const float* a_seq, const float* dh, float* dgx,
                       float* dq_seq, float* dproj, float* dvals,
                       float* dv_part, float* dv, float* q_all, float* ctx,
                       float* dctx_seq, float* ds_seq, float* dh_c,
                       float* dc_c, int R, int T_, int H, int E, int A,
                       int F, int rep, cudaStream_t st) {
  const size_t bsmem = att_bwd_smem<float>(F, A, E);
  cudaError_t e = set_smem((const void*)att_bwd_step_kernel<float>, bsmem);
  if (e != cudaSuccess) return (int)e;
  const dim3 gate_grid((R + G_TM - 1) / G_TM, (H + G_TJ - 1) / G_TJ);
  const long long G = 4LL * H;
  const int B = R / rep;
  const int groups = (rep + AT_ROWS - 1) / AT_ROWS;
  e = row_gemm<float, float, false>(h_seq, H, att_wh, q_all, A, R * T_, H, A,
                                    kStoreRounded, st);
  if (e != cudaSuccess) return (int)e;
  for (int t = T_ - 1; t >= 0; --t) {
    const float* hp = t > 0 ? h_seq + (size_t)(t - 1) * H : nullptr;
    att_mix_kernel<float><<<R, THREADS, F * sizeof(float), st>>>(
        a_seq + (size_t)t * F, (long long)T_ * F, vals, rep, F, E, ctx);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    attlstm_bwd_gates_kernel<<<gate_grid, THREADS, 0, st>>>(
        gx, w_ctx, wh, ctx, hp, (long long)T_ * H, c_seq, dh, dh_c, dc_c,
        dgx, R, T_, E, H, t);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    const float* dg = dgx + (size_t)t * G;
    e = row_gemm<float, float, true>(dg, T_ * G, w_ctx, dctx_seq + (size_t)t * E,
                                     (long long)T_ * E, R, (int)G, E, kStore, st);
    if (e != cudaSuccess) return (int)e;
    e = row_gemm<float, float, true>(dg, T_ * G, wh, dh_c, H, R, (int)G, H,
                                     kStore, st);
    if (e != cudaSuccess) return (int)e;
    att_bwd_step_kernel<float><<<B * groups, THREADS, bsmem, st>>>(
        dctx_seq + (size_t)t * E, (long long)T_ * E, a_seq + (size_t)t * F,
        (long long)T_ * F, t > 0 ? q_all + (size_t)(t - 1) * A : nullptr,
        (long long)T_ * A, att_v, proj, vals, rep, groups, F, A, E,
        ds_seq + (size_t)t * F, (long long)T_ * F, dq_seq + (size_t)t * A,
        (long long)T_ * A, nullptr);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    if (t > 0) {
      e = row_gemm<float, float, true>(dq_seq + (size_t)t * A, (long long)T_ * A,
                                       att_wh, dh_c, H, R, A, H, kAdd, st);
      if (e != cudaSuccess) return (int)e;
    }
  }
  return run_fold<float>(ds_seq, q_all, a_seq, dctx_seq, att_v, proj, B, rep,
                         T_, F, A, E, dproj, dvals, dv_part, dv, st);
}

// Shapes every entry takes: positive sizes, rep dividing R, 16-byte
// chunks of A and E, shared-memory plans that fit a block.
static bool shapes_ok(int R, int T, int H, int E, int A, int F, int rep,
                      size_t smem) {
  return R >= 1 && T >= 1 && H >= 1 && E >= 1 && A >= 1 && F >= 1 &&
         rep >= 1 && R % rep == 0 && A % 8 == 0 && E % 8 == 0 &&
         smem <= 232448 && fold_smem<float>(T) + TB_BYTES <= 232448;
}

}  // namespace cstk

using bf16_t = __nv_bfloat16;

// float32 compute.  wq: 1 when wh, w_ctx and att_wh are int8 codes with
// the float32 scales lstm_s (4H,) and att_s (A,) (int8w; then c_seq and
// a_seq must be null), else 0 and both scales null.  gx (R, T, 4H)
// float32; att_proj (R / rep, F, A), att_vals (R / rep, F, E), att_mask
// (R / rep, F) float32; the caller zeroes h_a and c and passes scratch q
// (R, A), ctx (R, E); c_seq (R, T, H) and a_seq (R, T, F) float32 or both
// null.  Returns 0 or the CUDA error code of the first refused launch.
extern "C" int cst_attlstm_fwd_f32(
    int wq, const void* gx, const void* wh, const void* w_ctx,
    const void* att_wh, const void* att_v, const void* proj, const void* mask,
    const void* vals, void* h_a, void* h_b, void* c, void* q, void* ctx,
    void* h_seq, void* c_seq, void* a_seq, const void* lstm_s,
    const void* att_s, int R, int T, int H, int E, int A, int F, int rep,
    void* stream) {
  if (R < 1 || T < 1 || H < 1 || E < 1 || A < 1 || F < 1 || rep < 1 ||
      R % rep != 0)
    return (int)cudaErrorInvalidValue;
  if (wq && (lstm_s == nullptr || att_s == nullptr || c_seq != nullptr ||
             a_seq != nullptr))
    return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  const cstk::QScales qs{nullptr, static_cast<const float*>(lstm_s), nullptr};
#define CST_FWD_CALL(WW)                                                      \
  cstk::run_fwd_f32<WW>(                                                      \
      static_cast<const float*>(gx), static_cast<const WW*>(wh),              \
      cstk::AttArgs<float, WW>{static_cast<const WW*>(w_ctx),                 \
                               static_cast<const WW*>(att_wh),                \
                               static_cast<const float*>(att_v),              \
                               static_cast<const float*>(proj),               \
                               static_cast<const float*>(mask),               \
                               static_cast<const float*>(vals),               \
                               static_cast<float*>(q), static_cast<float*>(ctx), \
                               A, F, static_cast<const float*>(att_s)},       \
      static_cast<float*>(h_a), static_cast<float*>(h_b),                     \
      static_cast<float*>(c), static_cast<float*>(h_seq),                     \
      static_cast<float*>(c_seq), static_cast<float*>(a_seq), R, T, H, E,     \
      rep, st, qs)
  if (wq) return CST_FWD_CALL(int8_t);
  return CST_FWD_CALL(float);
#undef CST_FWD_CALL
}

// bfloat16 compute, the tensor-core path.  wcat_t (4H, E + H) is [W_ctx ;
// W_h]^T and att_wh_t (A, H) att_wh^T, bf16 (int8w: the codes widened to
// bf16, with lstm_s (4H,) and att_s (A,) their float32 scales; else both
// null).  gx (R, T, 4H) float32; att_v (A,), att_proj (R / rep, F, A),
// att_vals (R / rep, F, E) bf16, att_mask (R / rep, F) float32.  Scratch:
// c (R, H) float32, q (R, A) and ctx (R, E) bf16.  Outputs h_seq (R, T,
// H) bf16 and, unless null, c_seq (R, T, H) and a_seq (R, T, F) float32.
// H a multiple of 32, E of 32, A of 8; rows 16-byte aligned.
extern "C" int cst_attlstm_fwd_bf16(
    const void* gx, const void* wcat_t, const void* att_wh_t,
    const void* lstm_s, const void* att_s, const void* att_v,
    const void* proj, const void* mask, const void* vals, void* c, void* q,
    void* ctx, void* h_seq, void* c_seq, void* a_seq, int R, int T, int H,
    int E, int A, int F, int rep, void* stream) {
  if (!cstk::shapes_ok(R, T, H, E, A, F, rep, cstk::att_fwd_smem(F, A)) ||
      H % 32 != 0 || E % 32 != 0)
    return (int)cudaErrorInvalidValue;
  return cstk::run_fwd_bf16(
      static_cast<const float*>(gx), static_cast<const bf16_t*>(wcat_t),
      static_cast<const bf16_t*>(att_wh_t), static_cast<const float*>(lstm_s),
      static_cast<const float*>(att_s), static_cast<const bf16_t*>(att_v),
      static_cast<const bf16_t*>(proj), static_cast<const float*>(mask),
      static_cast<const bf16_t*>(vals), static_cast<float*>(c),
      static_cast<bf16_t*>(q), static_cast<bf16_t*>(ctx),
      static_cast<bf16_t*>(h_seq), static_cast<float*>(c_seq),
      static_cast<float*>(a_seq), R, T, H, E, A, F, rep,
      static_cast<cudaStream_t>(stream));
}

// float32 backward.  Inputs: gx, wh (H, 4H), w_ctx (E, 4H), att_wh (H,
// A), att_v, att_proj (R / rep, F, A), att_vals (R / rep, F, E), the
// forward's h_seq, c_seq, a_seq and the float32 cotangent dh (R, T, H).
// Outputs (float32): dgx (R, T, 4H), dq_seq (R, T, A), dproj (R / rep, F,
// A), dvals (R / rep, F, E), dv (A).  Scratch: dv_part (R / rep *
// ceil(F / 32), A), q_all (R, T, A), ctx (R, E), dctx_seq (R, T, E),
// ds_seq (R, T, F), and dh_c, dc_c (R, H) zeroed by the caller.
extern "C" int cst_attlstm_bwd_f32(
    const void* gx, const void* wh, const void* w_ctx, const void* att_wh,
    const void* att_v, const void* proj, const void* vals, const void* h_seq,
    const void* c_seq, const void* a_seq, const void* dh, void* dgx,
    void* dq_seq, void* dproj, void* dvals, void* dv_part, void* dv,
    void* q_all, void* ctx, void* dctx_seq, void* ds_seq, void* dh_c,
    void* dc_c, int R, int T, int H, int E, int A, int F, int rep,
    void* stream) {
  if (!cstk::shapes_ok(R, T, H, E, A, F, rep, cstk::att_bwd_smem<float>(F, A, E)))
    return (int)cudaErrorInvalidValue;
#define F32(p) static_cast<const float*>(p)
#define OUT(p) static_cast<float*>(p)
  return cstk::run_bwd_f32(F32(gx), F32(wh), F32(w_ctx), F32(att_wh),
                           F32(att_v), F32(proj), F32(vals), F32(h_seq),
                           F32(c_seq), F32(a_seq), F32(dh), OUT(dgx),
                           OUT(dq_seq), OUT(dproj), OUT(dvals), OUT(dv_part),
                           OUT(dv), OUT(q_all), OUT(ctx), OUT(dctx_seq),
                           OUT(ds_seq), OUT(dh_c), OUT(dc_c), R, T, H, E, A,
                           F, rep, static_cast<cudaStream_t>(stream));
#undef F32
#undef OUT
}

// bfloat16 backward, the tensor-core path.  Inputs as the float32 one,
// bf16 where the forward's were, with the weights as wcat = [W_ctx ; W_h]
// (E + H, 4H), wcat_t its transpose, att_wh (H, A) and att_wh_t (A, H).
// Outputs and scratch as the float32 one, except q_all (R, T, A) bf16 and
// ctx_all (R, T, E) bf16, plus dgb (R, 4H) and dq_lo (R, A) bf16.
extern "C" int cst_attlstm_bwd_bf16(
    const void* gx, const void* wcat, const void* wcat_t, const void* att_wh,
    const void* att_wh_t, const void* att_v, const void* proj,
    const void* vals, const void* h_seq, const void* c_seq, const void* a_seq,
    const void* dh, void* dgx, void* dq_seq, void* dproj, void* dvals,
    void* dv_part, void* dv, void* q_all, void* ctx_all, void* dctx_seq,
    void* ds_seq, void* dgb, void* dq_lo, void* dh_c, void* dc_c, int R,
    int T, int H, int E, int A, int F, int rep, void* stream) {
  if (!cstk::shapes_ok(R, T, H, E, A, F, rep,
                       cstk::att_bwd_smem<bf16_t>(F, A, E)) ||
      H % 32 != 0 || E % 32 != 0)
    return (int)cudaErrorInvalidValue;
#define BF(p) static_cast<const bf16_t*>(p)
#define F32(p) static_cast<const float*>(p)
#define OUT(p) static_cast<float*>(p)
  return cstk::run_bwd_bf16(
      F32(gx), BF(wcat), BF(wcat_t), BF(att_wh), BF(att_wh_t), BF(att_v),
      BF(proj), BF(vals), BF(h_seq), F32(c_seq), F32(a_seq), F32(dh), OUT(dgx),
      OUT(dq_seq), OUT(dproj), OUT(dvals), OUT(dv_part), OUT(dv),
      static_cast<bf16_t*>(q_all), static_cast<bf16_t*>(ctx_all),
      OUT(dctx_seq), OUT(ds_seq), static_cast<bf16_t*>(dgb),
      static_cast<bf16_t*>(dq_lo), OUT(dh_c), OUT(dc_c), R, T, H, E, A, F, rep,
      static_cast<cudaStream_t>(stream));
#undef BF
#undef F32
#undef OUT
}

// Writes the tanh table's lookups and tanhf on all 65,536 bf16 values
// into out (131,072 floats; see tanh_table_check_kernel).
extern "C" int cst_attlstm_tanh_check(void* out, void* stream) {
  cstk::tanh_table_check_kernel<<<1, cstk::THREADS, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(out));
  return (int)cudaGetLastError();
}
