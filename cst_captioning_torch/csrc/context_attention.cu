// One Bahdanau attention step for Hopper (sm_90a): the per-step context
// of the unfused decoder (CaptionModel._context), which the continuous
// slot loop runs once per decode step under attention fusion.
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
// 9.2 M tanh (2.2 us at 16 per SM per clock); both floors are microseconds.
//
// Design (first, simple; PERF.md has its times): attention_common.cuh's
// att_context_kernel, which the decode kernels already run inside their
// steps: one block of 256 threads per row, the score one warp per frame,
// the softmax in one warp, the mix one thread per context column.  The K
// rows of a video re-read its tensors from L2 rather than from device
// memory; a kernel that keeps them in shared memory across the K rows
// is later work.
#include "attention_common.cuh"

namespace cstk {

template <typename T>
static int run_context(const void* q, const void* att_v, const void* proj,
                       const float* mask, const void* vals, int rep, int R,
                       int F, int A, int E, void* ctx, float* attn,
                       cudaStream_t st) {
  const size_t smem = (size_t)(2 * A + F) * sizeof(float);
  att_context_kernel<T, T, T><<<R, THREADS, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(att_v),
      static_cast<const T*>(proj), mask, static_cast<const T*>(vals), rep, F,
      A, E, static_cast<T*>(ctx), attn, (long long)F);
  return (int)cudaGetLastError();
}

}  // namespace cstk

// dtype: 0 = float32, 1 = bfloat16 (q, att_v, proj, vals and ctx).  q is
// (R, A), att_v (A,), proj (R / rep, F, A), mask (R / rep, F) float32,
// vals (R / rep, F, E), ctx (R, E); attn (R, F) float32 or null.  All
// row-major and contiguous.  Returns 0 or the CUDA error code of a
// refused launch.
extern "C" int cst_context_attention(int dtype, const void* q,
                                     const void* att_v, const void* proj,
                                     const void* mask, const void* vals,
                                     int rep, int R, int F, int A, int E,
                                     void* ctx, void* attn, void* stream) {
  if (R < 1 || rep < 1 || R % rep != 0 || F < 1 || A < 1 || E < 1 ||
      2 * A + F > 12000)
    return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
#define CST_CTX_ARGS                                                     \
  q, att_v, proj, static_cast<const float*>(mask), vals, rep, R, F, A, E, \
      ctx, static_cast<float*>(attn), st
  if (dtype == 0) return cstk::run_context<float>(CST_CTX_ARGS);
  if (dtype == 1) return cstk::run_context<__nv_bfloat16>(CST_CTX_ARGS);
#undef CST_CTX_ARGS
  return (int)cudaErrorInvalidValue;
}
