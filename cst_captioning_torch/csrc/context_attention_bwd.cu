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
// Design: two launches, no float atomics, so results repeat from run to
// run.  The first takes one video per thread-block cluster of S CTAs
// (context_common.cuh: S = 2 at 64 videos), 1,024 threads a CTA, every
// row of the video in the cluster; rank k stages its frames of att_vals,
// its columns of att_proj and of the queries, the video's context
// cotangents and (bf16) the tanh table, once, with cp.async:
//   1. da for the rank's frames, one warp per (frame, <= 4 rows), lanes
//      over 16-byte chunks of E in order, then the butterfly, written
//      into every rank's da rows; after one cluster barrier every rank
//      takes ds of every (row, frame) in the same order (a warp a row).
//   2. per 128 of the rank's columns of A, threads (g, c) own column c and
//      the frames f = g (mod 8); rows in blocks of four, frame by frame,
//      th evaluated once per (row, frame, column) (tanhf from the bf16
//      table, tanh_t, bitwise tanhf), and from it dpre, d_proj folded
//      over the rows in row order (in a register within a block of rows,
//      in shared memory between blocks), d_q per row (the eight frame
//      groups added in order through shared memory) and the video's d_v
//      partial (one sum per row of a block, added in order at the end).
//   3. d_vals for the rank's 8-column chunks of E, one thread per (frame,
//      chunk), folded over the rows in row order in registers (bf16: on
//      packed bf16x2 adds, the same bits).
// No sum crosses a CTA (da's frames are copied, not added), so each
// row's bits do not depend on S, rep or R.  The second launch adds the
// videos' d_v partials in video order.
#include "context_common.cuh"

namespace cstk {

constexpr int BWD_GROUPS = 8;                          // frame groups
constexpr int BWD_COLS = CTX_THREADS / BWD_GROUPS;     // columns a pass

// Shared-memory layout of ctx_bwd_kernel (byte offsets).
struct BwdPlan {
  size_t vals, proj, q, dctx, a, da, ds, acc, red, total;
};

// A CTA's shared memory at cluster size S (the table under bf16): its
// frames of att_vals (all of E), in phase 2 the d_proj carry of one pass
// of BWD_COLS columns and the reduction rows (float32) in the same place;
// its columns of att_proj (all frames) and of the rep query rows, the
// rows' dctx (all T); the rows' weights, da and ds (float32; ds four rows
// to a float4, rows padded to a multiple of four).
template <typename T>
__host__ __device__ BwdPlan bwd_plan(int rep, int F, int A, int E, int S) {
  const size_t sz = sizeof(T);
  const size_t ac = (size_t)8 * span_max(A / 8, S);
  const size_t rep4 = (size_t)(rep + 3) / 4 * 4;
  BwdPlan p;
  // att_vals (phase 1) and the d_proj carry with the reduction rows
  // (phase 2) share one region.
  const size_t acc = align16((size_t)F * BWD_COLS * 4);
  const size_t red = (size_t)BWD_GROUPS * 4 * BWD_COLS * 4;
  const size_t vals = align16((size_t)span_max(F, S) * E * sz);
  p.vals = p.acc = table_bytes<T>();
  p.red = p.acc + acc;
  p.proj = p.vals + align16(vals > acc + red ? vals : acc + red);
  p.q = p.proj + align16((size_t)F * ac * sz);
  p.dctx = p.q + align16((size_t)rep * ac * sz);
  p.a = p.dctx + align16((size_t)rep * E * sz);
  p.da = p.a + align16((size_t)rep * F * 4);
  p.ds = p.da + align16((size_t)rep * F * 4);
  p.total = p.ds + rep4 * F * 4;
  return p;
}

// The d_proj fold's carry: acc = T(acc + T(x)).  bf16: one bf16 add of
// the rounded term (a bf16 add rounds the exact sum once, which is what
// the float32 add of two bf16 values, rounded to bf16, gives: exact in
// float32 when their exponents are within 16, else the smaller is far
// under half an ulp of the larger and both give the larger).
template <typename T>
struct Fold {
  float v = 0.f;
  __device__ __forceinline__ void add(float x) { v = __fadd_rn(v, x); }
  __device__ __forceinline__ void set(float x) { v = x; }
  __device__ __forceinline__ float get() const { return v; }
};
template <>
struct Fold<__nv_bfloat16> {
  __nv_bfloat16 v = __float2bfloat16_rn(0.f);
  __device__ __forceinline__ void add(float x) {
    v = __hadd(v, __float2bfloat16_rn(x));
  }
  __device__ __forceinline__ void set(float x) { v = __float2bfloat16_rn(x); }
  __device__ __forceinline__ float get() const { return __bfloat162float(v); }
};

// One video per cluster of S CTAs (grid B x S); rank k = blockIdx.x % S.
// dv_part (B, A) float32 receives each video's d_v partial.
template <typename T>
__global__ void __launch_bounds__(CTX_THREADS) ctx_bwd_kernel(
    const T* __restrict__ q, const T* __restrict__ att_v,
    const T* __restrict__ proj, const T* __restrict__ vals,
    const float* __restrict__ attn, const T* __restrict__ dctx, int rep,
    int F, int A, int E, int S, T* __restrict__ dq, T* __restrict__ dproj,
    T* __restrict__ dvals, float* __restrict__ dv_part) {
  extern __shared__ __align__(16) unsigned char smem[];
  cluster_arrive();  // this CTA has started
  const BwdPlan pl = bwd_plan<T>(rep, F, A, E, S);
  float* tab = reinterpret_cast<float*>(smem);
  T* vals_s = reinterpret_cast<T*>(smem + pl.vals);
  T* proj_s = reinterpret_cast<T*>(smem + pl.proj);
  T* q_s = reinterpret_cast<T*>(smem + pl.q);
  T* dctx_s = reinterpret_cast<T*>(smem + pl.dctx);
  float* a_s = reinterpret_cast<float*>(smem + pl.a);
  float* da_s = reinterpret_cast<float*>(smem + pl.da);
  float* ds_s = reinterpret_cast<float*>(smem + pl.ds);
  float* acc_s = reinterpret_cast<float*>(smem + pl.acc);
  float* red = reinterpret_cast<float*>(smem + pl.red);
  const int b = blockIdx.x / S, k = blockIdx.x % S, r0 = b * rep;
  const int f0 = span(F, S, k), nf = span(F, S, k + 1) - f0;
  const int a0 = 8 * span(A / 8, S, k), ac = 8 * span(A / 8, S, k + 1) - a0;
  const int e0 = 8 * span(E / 8, S, k), ec = 8 * span(E / 8, S, k + 1) - e0;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int sz = (int)sizeof(T);

  // Group 0 (phase 1): the rank's frames of att_vals and the rows' dctx;
  // group 1 (phase 2): the table, its columns of att_proj and of the
  // queries.
  stage_rows(vals_s, 0, vals + ((size_t)b * F + f0) * E, 0, 1, nf * E * sz);
  stage_rows(dctx_s, 0, dctx + (size_t)r0 * E, 0, 1, rep * E * sz);
  cp_async_commit();
  if constexpr (table_bytes<T>() > 0)
    stage_rows(tab, 0, g_tanh_table, 0, 1, (int)TB_BYTES);
  stage_rows(proj_s, (size_t)ac * sz, proj + (size_t)b * F * A + a0,
             (size_t)A * sz, F, ac * sz);
  stage_rows(q_s, (size_t)ac * sz, q + (size_t)r0 * A + a0, (size_t)A * sz,
             rep, ac * sz);
  cp_async_commit();
  for (int i = threadIdx.x; i < rep * F; i += CTX_THREADS)
    a_s[i] = attn[(size_t)r0 * F + i];
  cp_async_wait<1>();
  __syncthreads();
  cluster_wait();  // every rank has started: their da rows take writes

  // 1. da of the rank's frames (a warp per frame and CTX_ROWS rows, one
  // sum a row), written into every rank's da rows (lane j < S writes
  // rank j's).
  const int nrb = row_blocks(rep);
  for (int i = warp; i < nf * nrb; i += CTX_WARPS) {
    const int f = f0 + i / nrb, r4 = span(rep, nrb, i % nrb);
    const int nr = span(rep, nrb, i % nrb + 1) - r4;
    const T* vr = vals_s + (size_t)(f - f0) * E;
    const T* dr[CTX_ROWS];
#pragma unroll
    for (int rr = 0; rr < CTX_ROWS; ++rr)
      dr[rr] = dctx_s + (size_t)(r4 + min(rr, nr - 1)) * E;
    float s[CTX_ROWS];
#pragma unroll
    for (int rr = 0; rr < CTX_ROWS; ++rr) s[rr] = 0.f;
    for (int c = lane; c < E / 8; c += 32) {
      float y[8];
      lds8(vr + 8 * c, y);
#pragma unroll
      for (int rr = 0; rr < CTX_ROWS; ++rr) {
        float x[8];
        lds8(dr[rr] + 8 * c, x);
#pragma unroll
        for (int j = 0; j < 8; ++j) s[rr] = __fadd_rn(s[rr], __fmul_rn(x[j], y[j]));
      }
    }
    float* dst = lane < S ? cooperative_groups::this_cluster().map_shared_rank(da_s, lane)
                          : nullptr;
#pragma unroll
    for (int rr = 0; rr < CTX_ROWS; ++rr) {
      const float t = warp_sum(s[rr]);
      if (dst != nullptr && rr < nr) dst[(r4 + rr) * F + f] = t;
    }
  }
  // Every rank's da is in every rank's da_s after the barrier; no CTA
  // touches another's shared memory after it.
  __syncthreads();
  cluster_arrive();
  cluster_wait();

  // ds[r, f] at ds_s[((r / 4) * F + f) * 4 + r % 4]; padded rows zero.
  for (int rr = warp; rr < rep; rr += CTX_WARPS) {
    const float* a = a_s + rr * F;
    const float* d = da_s + rr * F;
    float sad = 0.f;
    for (int f = lane; f < F; f += 32) sad = __fadd_rn(sad, __fmul_rn(a[f], d[f]));
    sad = warp_sum(sad);
    for (int f = lane; f < F; f += 32)
      ds_s[((rr / 4) * F + f) * 4 + rr % 4] = __fmul_rn(a[f], __fsub_rn(d[f], sad));
  }
  for (int i = threadIdx.x; i < ((4 - rep % 4) % 4) * F; i += CTX_THREADS) {
    const int rr = rep + i / F, f = i % F;
    ds_s[((rr / 4) * F + f) * 4 + rr % 4] = 0.f;
  }
  cp_async_wait<0>();
  __syncthreads();

  // 2. d_proj, d_q and the d_v partial, BWD_COLS of the rank's columns
  // a pass.  d_v keeps one sum per row of a block (rr), added in order
  // at the end of the pass.
  const int c = threadIdx.x % BWD_COLS, g = threadIdx.x / BWD_COLS;
  for (int t0 = 0; t0 < ac; t0 += BWD_COLS) {
    const int cl = t0 + c, a = a0 + cl;
    const bool live = cl < ac;
    const float va = live ? to_f(att_v[a]) : 0.f;
    float dv4[4] = {0.f, 0.f, 0.f, 0.f};
    for (int rb = 0; rb < rep; rb += 4) {
      const int nr = min(4, rep - rb);
      const bool last = rb + 4 >= rep;
      float qv[4], dq4[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int rr = 0; rr < 4; ++rr)
        qv[rr] = live && rr < nr ? to_f(q_s[(size_t)(rb + rr) * ac + cl]) : 0.f;
      if (live) {
#pragma unroll 2
        for (int f = g; f < F; f += BWD_GROUPS) {
          const float p = to_f(proj_s[(size_t)f * ac + cl]);
          Fold<T> acc;
          if (rb != 0) acc.set(acc_s[f * BWD_COLS + c]);
          const float4 d4 =
              reinterpret_cast<const float4*>(ds_s)[(rb / 4) * F + f];
          const float dd[4] = {d4.x, d4.y, d4.z, d4.w};
          // Rows past the block's end (rep % 4) have ds = 0: they add
          // zeros and change no sum.
#pragma unroll
          for (int rr = 0; rr < 4; ++rr) {
            const float th = tanh_t<T>(__fadd_rn(p, qv[rr]), tab);
            dv4[rr] = __fadd_rn(dv4[rr], __fmul_rn(th, dd[rr]));
            const float dpre = __fmul_rn(__fmul_rn(dd[rr], va),
                                         __fsub_rn(1.f, __fmul_rn(th, th)));
            acc.add(dpre);
            dq4[rr] = __fadd_rn(dq4[rr], dpre);
          }
          if (last)
            dproj[((size_t)b * F + f) * A + a] = acc.v;
          else
            acc_s[f * BWD_COLS + c] = acc.get();
        }
      }
#pragma unroll
      for (int rr = 0; rr < 4; ++rr) red[(g * 4 + rr) * BWD_COLS + c] = dq4[rr];
      __syncthreads();
      if (live && g < nr) {  // thread (g, c) sums row rb + g's groups
        float s = red[g * BWD_COLS + c];
        for (int j = 1; j < BWD_GROUPS; ++j)
          s = __fadd_rn(s, red[(j * 4 + g) * BWD_COLS + c]);
        store_cdt<T>(dq + (size_t)(r0 + rb + g) * A + a, s);
      }
      __syncthreads();
    }
    red[g * BWD_COLS + c] =
        __fadd_rn(__fadd_rn(__fadd_rn(dv4[0], dv4[1]), dv4[2]), dv4[3]);
    __syncthreads();
    if (g == 0 && live) {
      float s = red[c];
      for (int j = 1; j < BWD_GROUPS; ++j) s = __fadd_rn(s, red[j * BWD_COLS + c]);
      dv_part[(size_t)b * A + a] = s;
    }
    __syncthreads();
  }

  // 3. d_vals of the rank's columns of E, folded over the rows in order.
  // bf16: the products rounded in pairs and the fold's adds on bf16x2, the
  // same bits as Fold's.
  const int nce = ec / 8;
  for (int i = threadIdx.x; i < F * nce; i += CTX_THREADS) {
    const int f = i / nce, ch = i - f * nce;
    const T* dc = dctx_s + e0 + 8 * ch;
    T* out = dvals + ((size_t)b * F + f) * E + e0 + 8 * ch;
    if constexpr (std::is_same<T, float>::value) {
      float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
      for (int rr = 0; rr < rep; ++rr) {
        const float af = a_s[rr * F + f];
        float x[8];
        lds8(dc + (size_t)rr * E, x);
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[j] = __fadd_rn(acc[j], __fmul_rn(af, x[j]));
      }
      st8(out, acc);
    } else {
      __nv_bfloat162 acc[4];
#pragma unroll
      for (int h = 0; h < 4; ++h) acc[h] = __float2bfloat162_rn(0.f);
#pragma unroll 4
      for (int rr = 0; rr < rep; ++rr) {
        const float af = a_s[rr * F + f];
        float x[8];
        lds8(dc + (size_t)rr * E, x);
#pragma unroll
        for (int h = 0; h < 4; ++h)
          acc[h] = __hadd2(acc[h], __floats2bfloat162_rn(__fmul_rn(af, x[2 * h]),
                                                         __fmul_rn(af, x[2 * h + 1])));
      }
      *reinterpret_cast<uint4*>(out) = *reinterpret_cast<const uint4*>(acc);
    }
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
                           int rep, int R, int F, int A, int E,
                           float* dv_part, T* dq, T* dproj, T* dvals, T* dv,
                           cudaStream_t st) {
  const int B = R / rep;
  const int S = cluster_size(
      B, [&](int s) { return bwd_plan<T>(rep, F, A, E, s).total; });
  if (S == 0) return (int)cudaErrorInvalidValue;
  const size_t smem = bwd_plan<T>(rep, F, A, E, S).total;
  cudaError_t e = table_bytes<T>() > 0 ? tanh_table_ready(st) : cudaSuccess;
  if (e != cudaSuccess) return (int)e;
  e = launch_clusters(ctx_bwd_kernel<T>, B, S, CTX_THREADS, smem, st, q,
                      att_v, proj, vals, attn, dctx, rep, F, A, E, S, dq,
                      dproj, dvals, dv_part);
  if (e != cudaSuccess) return (int)e;
  ctx_bwd_dv_kernel<T><<<(A + THREADS - 1) / THREADS, THREADS, 0, st>>>(
      dv_part, B, A, dv);
  return (int)cudaGetLastError();
}

}  // namespace cstk

// dtype: 0 = float32, 1 = bfloat16 (q, att_v, proj, vals, dctx and the
// four cotangents).  q (R, A), att_v (A,), proj (R / rep, F, A), vals
// (R / rep, F, E), attn (R, F) float32 (the forward's softmax weights),
// dctx (R, E).  Scratch: dv_part (R / rep, A) float32.  Outputs: dq (R,
// A), dproj (R / rep, F, A), dvals (R / rep, F, E), dv (A,).  All
// row-major, contiguous and 16-byte aligned; A and E multiples of 8.
// Returns 0 or the CUDA error code of a refused launch (invalid value
// for a shape whose CTA share does not fit in shared memory at 8 CTAs a
// cluster).
extern "C" int cst_context_attention_bwd(
    int dtype, const void* q, const void* att_v, const void* proj,
    const void* vals, const void* attn, const void* dctx, int rep, int R,
    int F, int A, int E, void* dv_part, void* dq, void* dproj, void* dvals,
    void* dv, void* stream) {
  if (R < 1 || rep < 1 || R % rep != 0 || F < 1 || A < 8 || E < 8 ||
      A % 8 != 0 || E % 8 != 0)
    return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
#define CST_CTX_BWD(CT)                                                     \
  cstk::run_context_bwd<CT>(                                                \
      static_cast<const CT*>(q), static_cast<const CT*>(att_v),             \
      static_cast<const CT*>(proj), static_cast<const CT*>(vals),           \
      static_cast<const float*>(attn), static_cast<const CT*>(dctx), rep, R, \
      F, A, E, static_cast<float*>(dv_part), static_cast<CT*>(dq),          \
      static_cast<CT*>(dproj), static_cast<CT*>(dvals), static_cast<CT*>(dv), \
      st)
  if (dtype == 0) return CST_CTX_BWD(float);
  if (dtype == 1) return CST_CTX_BWD(__nv_bfloat16);
#undef CST_CTX_BWD
  return (int)cudaErrorInvalidValue;
}
