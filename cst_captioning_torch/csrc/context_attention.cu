// One Bahdanau attention step for Hopper (sm_90a): the per-step context
// of the unfused decoder (CaptionModel._context), which the continuous
// slot loop runs once per decode step under attention fusion, and which
// scheduled-sampling training runs at every teacher-forced step.
//
// Replaces the TPU kernel of the JAX package, ops/pallas_attention.py::
// fused_context_attention (forward: _fused_fwd_call -> pallas_call with
// _fwd_kernel).  Same function, per row r of R query rows:
//   th  = tanh(T(proj + q))      the argument rounded to T, tanh in f32
//   s_f = sum_a th * v           float32, -1e30 where the frame is masked
//   a   = softmax_f(s)           max-subtracted, float32 (attn output)
//   ctx = T(sum_f a_f * vals_f)  float32 mix of float32 weights, rounded
//                                once to the values' dtype T
// with q (R, A) already in T (the caller rounds the query, as the
// reference's _context does), proj (B, F, A) and vals (B, F, E) in T,
// mask (B, F) float32 and att_v (A,) in T.  A row whose frames are all
// masked gets uniform weights, as jax.nn.softmax gives.  Row r reads
// video r / rep: with rep = K a beam slot's K rows share one stored copy
// of the video's tensors (the reference's deduplicated slot cache read
// cache[row // K], without materialising the gather).
//
// Bound on the H100 at the slot loop's beam shape (64 slots x K = 5,
// F = 56, A = E = 512, bf16): the call must read 64 videos' proj and
// vals once (7.3 MB, 2.2 us at 3.35 TB/s) and evaluate R * F * A =
// 9.2 M tanh (2.2 us at 16 per SM per clock); both floors are
// microseconds, so what holds a kernel is how many SMs work and how much
// each one re-reads.
//
// Design: one video per thread-block cluster (context_common.cuh), all
// rep rows of it in the cluster, so each video's att_proj and att_vals
// are read from memory once.  Rank k of S stages its frames of att_proj
// and its 8-column chunks of att_vals with cp.async (under bf16 with the
// tanh table, filled once per device), 1,024 threads a CTA.
//   score: one warp per (frame, <= 4 rows) of the CTA's frames, lanes over
//     A from shared memory, one sum a row, then the warp's butterfly
//     (independent chains hide the adds' and lookups' latency), written
//     into every rank's score rows.  bf16: the lane's 16-byte chunks of A
//     in order (att_fwd_step_kernel's order, so this kernel's bf16 bits
//     are that step's), tanhf from the table of its bf16 arguments
//     (tanh_t, bitwise tanhf).  float32: one element a lane, strided by
//     32 (att_context_kernel's order, so the float32 path is bitwise the
//     decoders' attention step), tanhf.
//   softmax: after one cluster barrier every CTA holds every frame's
//     scores and runs the same warp softmax (softmax_warp) over all F
//     frames, so every CTA gets the same bits.
//   mix: one thread per (row, 8 columns) of the CTA's columns, in frame
//     order from shared memory (mix_context's float32 order).
// No tensor cores, on purpose: the score is not a product (the tanh is
// inside the sum), and the mix is a (rep x F) @ (F x E) product per
// video with float32 weights; rounding them to bf16 or TF32 would
// compute the dense fallback's function (dense_context_attention), not
// _fwd_kernel's, for 9.2 M multiply-adds at R = 320.  The kernel is bound
// by data movement, occupancy and the tanh.
// At rep = 1 over at least as many videos as the card has SMs (the slot
// loop's cache without deduplication, and the gathered layout) no row
// shares its video's tensors, so staging them only adds a pass through
// shared memory and holds one CTA an SM: the kernel then reads att_proj
// and att_vals where they lie (kStaged false), one video a CTA of 256
// threads, several CTAs an SM.  The layout and every order are the
// staged kernel's, so are the bits: chip_smoke.py holds rep = 5 and 20
// bitwise the gathered layout at rep = 1, which takes this path.
#include "context_common.cuh"

namespace cstk {

// Shared-memory layout of ctx_fwd_kernel (byte offsets).
struct FwdPlan {
  size_t q, v, proj, vals, mask, s, total;
};

// A CTA's shared memory at cluster size S (the table under bf16): the
// video's rep query rows, att_v, its frames of att_proj and its columns
// of att_vals (all T; none when they are streamed), the video's mask and
// every frame's scores, then weights, of the rep rows (float32).
template <typename T>
__host__ __device__ FwdPlan fwd_plan(int rep, int F, int A, int E, int S,
                                     bool staged = true) {
  const size_t sz = sizeof(T);
  FwdPlan p;
  p.q = table_bytes<T>();
  p.v = p.q + align16((size_t)rep * A * sz);
  p.proj = p.v + align16((size_t)A * sz);
  p.vals = p.proj + (staged ? align16((size_t)span_max(F, S) * A * sz) : 0);
  p.mask = p.vals +
           (staged ? align16((size_t)F * 8 * span_max(E / 8, S) * sz) : 0);
  p.s = p.mask + align16((size_t)F * 4);
  p.total = p.s + (size_t)rep * F * 4;
  return p;
}

// The scores of NR rows (q rows qr, row stride A) against one frame pr:
// lane-order sums into s (see the header).
template <typename T, int NR>
__device__ __forceinline__ void score_rows(const T* pr, const T* qr,
                                           const T* v_s, int A, int lane,
                                           const float* tab, float (&s)[NR]) {
  if constexpr (std::is_same<T, float>::value) {
    for (int a = lane; a < A; a += 32) {
      const float p = pr[a], va = v_s[a];
#pragma unroll
      for (int rr = 0; rr < NR; ++rr)
        s[rr] = __fadd_rn(s[rr], __fmul_rn(tanhf(__fadd_rn(p, qr[rr * A + a])), va));
    }
  } else {
    for (int c = lane; c < A / 8; c += 32) {
      float pv[8], vv[8];
      lds8(pr + 8 * c, pv);
      lds8(v_s + 8 * c, vv);
#pragma unroll
      for (int rr = 0; rr < NR; ++rr) {
        float qv[8];
        lds8(qr + rr * A + 8 * c, qv);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          s[rr] = __fadd_rn(
              s[rr], __fmul_rn(tanh_t<T>(__fadd_rn(pv[j], qv[j]), tab), vv[j]));
      }
    }
  }
}

// Score NR rows from r0 against frame f and write them, masked, into
// every rank's score rows (lane j < S writes rank j's).
template <typename T, int NR>
__device__ __forceinline__ void score_block(const T* pr, const T* q_s,
                                            const T* v_s, const float* tab,
                                            float* s_s, int r0, int f, int F,
                                            int A, int S, bool live, int lane) {
  float s[NR];
#pragma unroll
  for (int rr = 0; rr < NR; ++rr) s[rr] = 0.f;
  score_rows<T, NR>(pr, q_s + (size_t)r0 * A, v_s, A, lane, tab, s);
  float* dst = lane < S ? cooperative_groups::this_cluster().map_shared_rank(s_s, lane)
                        : nullptr;
#pragma unroll
  for (int rr = 0; rr < NR; ++rr) {
    const float t = warp_sum(s[rr]);
    if (dst != nullptr) dst[(r0 + rr) * F + f] = live ? t : NEG_INF;
  }
}

// One video per cluster of S CTAs (grid B x S); rank k = blockIdx.x % S.
// attn (R, F) may be null.  kStaged false (S = 1, CTX_STREAM_THREADS a
// CTA): att_proj and att_vals are read where they lie, in the same
// layout and order, so the bits are the staged kernel's.
template <typename T, bool kStaged>
__global__ void __launch_bounds__(kStaged ? CTX_THREADS : CTX_STREAM_THREADS,
                                  kStaged ? 1 : 4)
    ctx_fwd_kernel(const T* __restrict__ q, const T* __restrict__ att_v,
                   const T* __restrict__ proj, const float* __restrict__ mask,
                   const T* __restrict__ vals, int rep, int F, int A, int E,
                   int S, T* __restrict__ ctx, float* __restrict__ attn) {
  constexpr int kThreads = kStaged ? CTX_THREADS : CTX_STREAM_THREADS;
  constexpr int kWarps = kThreads / 32;
  extern __shared__ __align__(16) unsigned char smem[];
  cluster_arrive();  // this CTA has started
  const FwdPlan pl = fwd_plan<T>(rep, F, A, E, S, kStaged);
  const int b = blockIdx.x / S, k = blockIdx.x % S, r0 = b * rep;
  float* tab = reinterpret_cast<float*>(smem);
  T* q_s = reinterpret_cast<T*>(smem + pl.q);
  T* v_s = reinterpret_cast<T*>(smem + pl.v);
  const T* proj_s = kStaged ? reinterpret_cast<const T*>(smem + pl.proj)
                            : proj + (size_t)b * F * A;
  const T* vals_s = kStaged ? reinterpret_cast<const T*>(smem + pl.vals)
                            : vals + (size_t)b * F * E;
  float* m_s = reinterpret_cast<float*>(smem + pl.mask);
  float* s_s = reinterpret_cast<float*>(smem + pl.s);
  const int f0 = span(F, S, k), nf = span(F, S, k + 1) - f0;
  const int c0 = span(E / 8, S, k), nc = span(E / 8, S, k + 1) - c0;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int sz = (int)sizeof(T);

  // The table, the rows, att_v and the CTA's frames of att_proj (group
  // 0), then its columns of att_vals (group 1).
  if constexpr (table_bytes<T>() > 0)
    stage_rows(tab, 0, g_tanh_table, 0, 1, (int)TB_BYTES);
  stage_rows(q_s, 0, q + (size_t)r0 * A, 0, 1, rep * A * sz);
  stage_rows(v_s, 0, att_v, 0, 1, A * sz);
  if constexpr (kStaged)
    stage_rows(smem + pl.proj, 0, proj + ((size_t)b * F + f0) * A, 0, 1,
               nf * A * sz);
  cp_async_commit();
  if constexpr (kStaged)
    stage_rows(smem + pl.vals, (size_t)nc * 8 * sz,
               vals + (size_t)b * F * E + 8 * c0, (size_t)E * sz, F,
               nc * 8 * sz);
  cp_async_commit();
  for (int f = threadIdx.x; f < F; f += kThreads)
    m_s[f] = mask[(size_t)b * F + f];
  cp_async_wait<1>();
  __syncthreads();
  cluster_wait();  // every rank has started: their score rows take writes

  // A warp takes one frame for a block of up to CTX_ROWS rows (the
  // video's rows in even blocks): the frame's chunk read once, one
  // independent sum a row.
  const int nrb = row_blocks(rep);
  for (int i = warp; i < nf * nrb; i += kWarps) {
    const int f = f0 + i / nrb, j = i % nrb;
    const int ra = span(rep, nrb, j), nr = span(rep, nrb, j + 1) - ra;
    const T* pr = proj_s + (size_t)(f - f0) * A;
    const bool live = m_s[f] > 0.f;
#define CST_SCORE(NR)                                                     \
  score_block<T, NR>(pr, q_s, v_s, tab, s_s, ra, f, F, A, S, live, lane)
    if (nr == 4) CST_SCORE(4);
    else if (nr == 3) CST_SCORE(3);
    else if (nr == 2) CST_SCORE(2);
    else CST_SCORE(1);
#undef CST_SCORE
  }
  // Every rank's scores are in every rank's s_s after the barrier; no
  // CTA touches another's shared memory after it.
  __syncthreads();
  cluster_arrive();
  cluster_wait();

  for (int rr = warp; rr < rep; rr += kWarps) {
    float* sr = s_s + rr * F;
    softmax_warp(sr, F, lane);
    __syncwarp();
    if (attn != nullptr)
      for (int f = f0 + lane; f < f0 + nf; f += 32)
        attn[(size_t)(r0 + rr) * F + f] = sr[f];
  }
  cp_async_wait<0>();
  __syncthreads();

  for (int i = threadIdx.x; i < rep * nc; i += kThreads) {
    const int rr = i / nc, c = i - rr * nc;
    const float* a = s_s + rr * F;
    float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
    for (int f = 0; f < F; ++f) {
      float x[8];
      lds8(vals_s + ((size_t)f * nc + c) * 8, x);
      const float af = a[f];
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[j] = __fadd_rn(acc[j], __fmul_rn(af, x[j]));
    }
    st8(ctx + (size_t)(r0 + rr) * E + 8 * (c0 + c), acc);
  }
}

template <typename T>
static int run_context(const T* q, const T* att_v, const T* proj,
                       const float* mask, const T* vals, int rep, int R,
                       int F, int A, int E, T* ctx, float* attn,
                       cudaStream_t st) {
  const int B = R / rep;
  if (table_bytes<T>() > 0) {
    const cudaError_t e = tanh_table_ready(st);
    if (e != cudaSuccess) return (int)e;
  }
  if (rep == 1 && B >= device_sms()) {  // streamed: see the header
    const size_t smem = fwd_plan<T>(1, F, A, E, 1, false).total;
    if (smem > CTX_MAX_SMEM) return (int)cudaErrorInvalidValue;
    return (int)launch_clusters(ctx_fwd_kernel<T, false>, B, 1,
                                CTX_STREAM_THREADS, smem, st, q, att_v, proj,
                                mask, vals, rep, F, A, E, 1, ctx, attn);
  }
  const int S = cluster_size(
      B, [&](int s) { return fwd_plan<T>(rep, F, A, E, s).total; });
  if (S == 0) return (int)cudaErrorInvalidValue;
  return (int)launch_clusters(ctx_fwd_kernel<T, true>, B, S, CTX_THREADS,
                              fwd_plan<T>(rep, F, A, E, S).total, st, q,
                              att_v, proj, mask, vals, rep, F, A, E, S, ctx,
                              attn);
}

}  // namespace cstk

// dtype: 0 = float32, 1 = bfloat16 (q, att_v, proj, vals and ctx).  q is
// (R, A), att_v (A,), proj (R / rep, F, A), mask (R / rep, F) float32,
// vals (R / rep, F, E), ctx (R, E); attn (R, F) float32 or null.  All
// row-major, contiguous and 16-byte aligned; A and E multiples of 8.
// Returns 0 or the CUDA error code of a refused launch (invalid value
// for a shape whose CTA share does not fit in shared memory at 8 CTAs a
// cluster).
extern "C" int cst_context_attention(int dtype, const void* q,
                                     const void* att_v, const void* proj,
                                     const void* mask, const void* vals,
                                     int rep, int R, int F, int A, int E,
                                     void* ctx, void* attn, void* stream) {
  if (R < 1 || rep < 1 || R % rep != 0 || F < 1 || A < 8 || E < 8 ||
      A % 8 != 0 || E % 8 != 0)
    return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
#define CST_CTX_ARGS(CT)                                                    \
  static_cast<const CT*>(q), static_cast<const CT*>(att_v),                 \
      static_cast<const CT*>(proj), static_cast<const float*>(mask),        \
      static_cast<const CT*>(vals), rep, R, F, A, E, static_cast<CT*>(ctx), \
      static_cast<float*>(attn), st
  if (dtype == 0) return cstk::run_context<float>(CST_CTX_ARGS(float));
  if (dtype == 1)
    return cstk::run_context<__nv_bfloat16>(CST_CTX_ARGS(__nv_bfloat16));
#undef CST_CTX_ARGS
  return (int)cudaErrorInvalidValue;
}
