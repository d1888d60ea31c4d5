// The backward of one Bahdanau attention step for Hopper (sm_90a): the
// per-step context gradient of scheduled-sampling training, where every
// teacher-forced step runs CaptionModel._context under autograd.
//
// Replaces the TPU kernel of the JAX package's custom VJP, ops/
// pallas_attention.py::_fused_vjp_bwd (-> _fused_bwd_call -> pallas_call
// with _bwd_kernel).  Same function, per query row r of R rows (row r
// reads video r / rep, as the forward in context_attention.cu):
//   da_f    = sum_e dctx_e * vals_fe          float32
//   ds_f    = a_f * (da_f - sum_f a_f da_f)   float32, NOT masked: an
//             all-masked row (uniform a) gets a non-zero ds, as the TPU
//             kernel gives, although the dense math's gradient is zero
//   th      = tanh(T(proj + q))               the argument rounded to T,
//                                             the tanh in float32
//   dpre    = ds_f * v * (1 - th^2)           float32
//   d_q     = T(sum_f dpre)
//   d_v     = sum_{rows, f} th * ds_f         float32, then rounded to T
//   d_proj  = T(dpre),  d_vals = T(a_f * dctx_e)  per row
// with the rep rows of a video summed into that video's d_proj and
// d_vals in row order, each add rounded to T: what XLA does with the
// reference's rows (the VJP of _repeat_cache's jnp.repeat is a reduce in
// T, one rounded add per row, in order; tests/
// test_torch_context_attention_bwd.py pins it).
//
// Bound on the H100 at the training shape (R = 1280 rows over B = 64
// videos, rep = 20, F = 56, A = E = 512, bf16): the call must read q,
// dctx and attn (4.2 MB) and each video's proj and vals once (7.3 MB),
// and write d_q, d_proj and d_vals (9.5 MB): ~19 MB, 5.7 us at 3.35
// TB/s.  It evaluates R * F * A = 36.7 M tanh, 8.8 us at the SFU rate
// (16 per SM per clock): the tanh count bounds it.  Per-row cotangents
// written out and summed afterwards would move ~147 MB instead.
//
// Design (first, simple; PERF.md has the times).  The TPU kernel walks
// tiles of bt rows on one core and accumulates d_v across its sequential
// grid in a shared output block.  Here three launches, no float atomics,
// so results repeat from run to run:
//   1. ds: one block per row, one warp per frame for da over E.
//   2. one block per (video, 64-column chunk), walking the video's rep
//      rows in order: for a chunk of A, th / dpre recomputed once per
//      (row, frame, column), d_proj accumulated in shared memory, d_q per
//      row (4 frame groups summed in a fixed order), d_v per video; for a
//      chunk of E, d_vals accumulated in shared memory.  The video's proj
//      tile stays in shared memory across its rows.
//   3. d_v: the per-video partials summed in video order.
// The tanh is the precise tanhf (not the SFU's tanh.approx), so the
// kernel sits above the SFU floor; a tensor-core or approximate-tanh
// design is later work.
#include "attention_common.cuh"

namespace cstk {

constexpr int BWD_COLS = 64;                     // columns per block
constexpr int BWD_GROUPS = THREADS / BWD_COLS;   // frame groups per column

// Shared memory of ctx_bwd_video_kernel (its A role, the larger).
__host__ __device__ constexpr size_t ctx_bwd_smem(int F) {
  return (size_t)(2 * F * BWD_COLS + F + BWD_COLS + BWD_GROUPS * BWD_COLS) *
         sizeof(float);
}

// ds[r, f] for one row per block.  Dynamic shared memory: (E + F) floats.
template <typename T>
__global__ void __launch_bounds__(THREADS) ctx_bwd_ds_kernel(
    const T* __restrict__ dctx, const float* __restrict__ attn,
    const T* __restrict__ vals, int rep, int F, int E,
    float* __restrict__ ds) {
  extern __shared__ float sm[];
  float* dctx_s = sm;
  float* da_s = sm + E;
  const int r = blockIdx.x, vid = r / rep;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < E; i += THREADS)
    dctx_s[i] = to_f(dctx[(size_t)r * E + i]);
  __syncthreads();
  const T* vl = vals + (size_t)vid * F * E;
  for (int f = warp; f < F; f += THREADS / 32) {
    float s = 0.f;
    for (int e = lane; e < E; e += 32)
      s = __fadd_rn(s, __fmul_rn(dctx_s[e], to_f(vl[(size_t)f * E + e])));
    s = warp_sum(s);
    if (lane == 0) da_s[f] = s;
  }
  __syncthreads();
  if (warp == 0) {
    const float* a = attn + (size_t)r * F;
    float sad = 0.f;
    for (int f = lane; f < F; f += 32)
      sad = __fadd_rn(sad, __fmul_rn(a[f], da_s[f]));
    sad = warp_sum(sad);
    for (int f = lane; f < F; f += 32)
      ds[(size_t)r * F + f] = __fmul_rn(a[f], __fsub_rn(da_s[f], sad));
  }
}

// One block per (video b, column chunk).  blockIdx.y < nA: a chunk of A
// (d_proj, d_q, the video's d_v partial); else a chunk of E (d_vals).
// Thread (g, c) owns column c of the chunk and the frames f = g (mod
// BWD_GROUPS).  Dynamic shared memory: ctx_bwd_smem(F).
template <typename T>
__global__ void __launch_bounds__(THREADS) ctx_bwd_video_kernel(
    const T* __restrict__ q, const T* __restrict__ att_v,
    const T* __restrict__ proj, const float* __restrict__ attn,
    const T* __restrict__ dctx, const float* __restrict__ ds, int rep, int F,
    int A, int E, int nA, T* __restrict__ dq, T* __restrict__ dproj,
    T* __restrict__ dvals, float* __restrict__ dv_part) {
  extern __shared__ float sm[];
  const int b = blockIdx.x, r0 = b * rep;
  const int c = threadIdx.x % BWD_COLS, g = threadIdx.x / BWD_COLS;
  float* acc_s = sm;  // F x BWD_COLS: d_proj or d_vals of the chunk
  for (int i = threadIdx.x; i < F * BWD_COLS; i += THREADS) acc_s[i] = 0.f;

  if ((int)blockIdx.y >= nA) {  // ------------------------------ d_vals
    const int e0 = ((int)blockIdx.y - nA) * BWD_COLS;
    float* a_s = acc_s + F * BWD_COLS;  // F
    float* dc_s = a_s + F;              // BWD_COLS
    for (int r = r0; r < r0 + rep; ++r) {
      __syncthreads();
      for (int f = threadIdx.x; f < F; f += THREADS)
        a_s[f] = attn[(size_t)r * F + f];
      if (threadIdx.x < BWD_COLS)
        dc_s[threadIdx.x] = e0 + threadIdx.x < E
                                ? to_f(dctx[(size_t)r * E + e0 + threadIdx.x])
                                : 0.f;
      __syncthreads();
      for (int f = g; f < F; f += BWD_GROUPS) {
        float* o = acc_s + f * BWD_COLS + c;
        *o = round_cdt<T>(
            __fadd_rn(*o, round_cdt<T>(__fmul_rn(a_s[f], dc_s[c]))));
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < F * BWD_COLS; i += THREADS) {
      const int f = i / BWD_COLS, e = e0 + i % BWD_COLS;
      if (e < E) store_cdt<T>(dvals + ((size_t)b * F + f) * E + e, acc_s[i]);
    }
    return;
  }

  // --------------------------------------------- d_proj, d_q, d_v part
  const int a0 = (int)blockIdx.y * BWD_COLS, a = a0 + c;
  const bool live = a < A;
  float* proj_s = acc_s + F * BWD_COLS;    // F x BWD_COLS
  float* ds_s = proj_s + F * BWD_COLS;     // F
  float* q_s = ds_s + F;                   // BWD_COLS
  float* red = q_s + BWD_COLS;             // BWD_GROUPS x BWD_COLS
  for (int i = threadIdx.x; i < F * BWD_COLS; i += THREADS) {
    const int f = i / BWD_COLS, col = a0 + i % BWD_COLS;
    proj_s[i] = col < A ? to_f(proj[((size_t)b * F + f) * A + col]) : 0.f;
  }
  const float va = live ? to_f(att_v[a]) : 0.f;
  float dv_loc = 0.f;
  for (int r = r0; r < r0 + rep; ++r) {
    __syncthreads();  // the previous row is done with ds_s, q_s and red
    for (int f = threadIdx.x; f < F; f += THREADS)
      ds_s[f] = ds[(size_t)r * F + f];
    if (threadIdx.x < BWD_COLS)
      q_s[threadIdx.x] = a0 + threadIdx.x < A
                             ? to_f(q[(size_t)r * A + a0 + threadIdx.x])
                             : 0.f;
    __syncthreads();
    const float qa = q_s[c];
    float dq_loc = 0.f;
    for (int f = g; f < F; f += BWD_GROUPS) {
      const int o = f * BWD_COLS + c;
      const float th = tanhf(round_cdt<T>(__fadd_rn(proj_s[o], qa)));
      const float d = ds_s[f];
      dv_loc = __fadd_rn(dv_loc, __fmul_rn(th, d));
      const float dpre =
          __fmul_rn(__fmul_rn(d, va), __fsub_rn(1.f, __fmul_rn(th, th)));
      acc_s[o] = round_cdt<T>(__fadd_rn(acc_s[o], round_cdt<T>(dpre)));
      dq_loc = __fadd_rn(dq_loc, dpre);
    }
    red[g * BWD_COLS + c] = dq_loc;
    __syncthreads();
    if (g == 0 && live) {
      float s = red[c];
      for (int k = 1; k < BWD_GROUPS; ++k)
        s = __fadd_rn(s, red[k * BWD_COLS + c]);
      store_cdt<T>(dq + (size_t)r * A + a, s);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < F * BWD_COLS; i += THREADS) {
    const int f = i / BWD_COLS, col = a0 + i % BWD_COLS;
    if (col < A) store_cdt<T>(dproj + ((size_t)b * F + f) * A + col, acc_s[i]);
  }
  red[g * BWD_COLS + c] = dv_loc;
  __syncthreads();
  if (g == 0 && live) {
    float s = red[c];
    for (int k = 1; k < BWD_GROUPS; ++k) s = __fadd_rn(s, red[k * BWD_COLS + c]);
    dv_part[(size_t)b * A + a] = s;
  }
}

// d_v[a] = T(sum over videos of part[b, a]), in video order.
template <typename T>
__global__ void ctx_bwd_dv_kernel(const float* __restrict__ part, int B,
                                  int A, T* __restrict__ dv) {
  const int a = blockIdx.x * blockDim.x + threadIdx.x;
  if (a >= A) return;
  float s = 0.f;
  for (int b = 0; b < B; ++b) s = __fadd_rn(s, part[(size_t)b * A + a]);
  store_cdt<T>(dv + a, s);
}

template <typename T>
static int run_context_bwd(const T* q, const T* att_v, const T* proj,
                           const T* vals, const float* attn, const T* dctx,
                           int rep, int R, int F, int A, int E, float* ds,
                           float* dv_part, T* dq, T* dproj, T* dvals, T* dv,
                           cudaStream_t st) {
  const int B = R / rep;
  ctx_bwd_ds_kernel<T><<<R, THREADS, (size_t)(E + F) * sizeof(float), st>>>(
      dctx, attn, vals, rep, F, E, ds);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const size_t smem = ctx_bwd_smem(F);
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(ctx_bwd_video_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int nA = (A + BWD_COLS - 1) / BWD_COLS;
  const int nE = (E + BWD_COLS - 1) / BWD_COLS;
  ctx_bwd_video_kernel<T><<<dim3(B, nA + nE), THREADS, smem, st>>>(
      q, att_v, proj, attn, dctx, ds, rep, F, A, E, nA, dq, dproj, dvals,
      dv_part);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  ctx_bwd_dv_kernel<T><<<(A + THREADS - 1) / THREADS, THREADS, 0, st>>>(
      dv_part, B, A, dv);
  return (int)cudaGetLastError();
}

}  // namespace cstk

// dtype: 0 = float32, 1 = bfloat16 (q, att_v, proj, vals, dctx and the
// four cotangents).  q (R, A), att_v (A,), proj (R / rep, F, A), vals
// (R / rep, F, E), attn (R, F) float32 (the forward's softmax weights),
// dctx (R, E).  Scratch: ds (R, F) and dv_part (R / rep, A) float32.
// Outputs: dq (R, A), dproj (R / rep, F, A), dvals (R / rep, F, E), dv
// (A,).  All row-major and contiguous.  Returns 0 or the CUDA error code
// of a refused launch.
extern "C" int cst_context_attention_bwd(
    int dtype, const void* q, const void* att_v, const void* proj,
    const void* vals, const void* attn, const void* dctx, int rep, int R,
    int F, int A, int E, void* ds, void* dv_part, void* dq, void* dproj,
    void* dvals, void* dv, void* stream) {
  if (R < 1 || rep < 1 || R % rep != 0 || F < 1 || A < 1 || E < 1 ||
      E + F > 12000 || cstk::ctx_bwd_smem(F) > 232448)
    return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
#define CST_CTX_BWD(CT)                                                     \
  cstk::run_context_bwd<CT>(                                                \
      static_cast<const CT*>(q), static_cast<const CT*>(att_v),             \
      static_cast<const CT*>(proj), static_cast<const CT*>(vals),           \
      static_cast<const float*>(attn), static_cast<const CT*>(dctx), rep, R, \
      F, A, E, static_cast<float*>(ds), static_cast<float*>(dv_part),       \
      static_cast<CT*>(dq), static_cast<CT*>(dproj), static_cast<CT*>(dvals), \
      static_cast<CT*>(dv), st)
  if (dtype == 0) return CST_CTX_BWD(float);
  if (dtype == 1) return CST_CTX_BWD(__nv_bfloat16);
#undef CST_CTX_BWD
  return (int)cudaErrorInvalidValue;
}
