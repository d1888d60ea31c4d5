// Row-keyed Gumbel-max draw on JAX's threefry-2x32 stream for Hopper
// (sm_90a): one decode step's multinomial token per row, and its
// log-probability, in one launch.
//
// No TPU kernel of the JAX package is replaced: the reference leaves the
// per-step draw (decoding/core.py::decode_step, sample mode) to XLA, as
// jax.random.categorical.  The port replays that stream bit for bit
// (ops/threefry.py, whose plain version categorical_ref this kernel
// computes).  Per row g of the scaled logits x = logits / T (G, V):
//   key      row-keyed: fold_in(fold_in(base, row_id[g]), step[g]),
//              counter (0, v) (decoding/core.py::row_sample_fn);
//            batch: the one key, counter g*V + v as (hi, lo) words
//              (jax.random.categorical on the step's split of the carry)
//   bits     y0 ^ y1 of threefry2x32(key, counter)
//   u        max(tiny, f + tiny), f = bitcast((bits >> 9) | 0x3f800000) - 1
//   token    argmax_v(-log(-log(u)) + x[v]), the lowest v on a tie; rows
//              with is_sample[g] == 0 take argmax_v x[v] (greedy rows)
//   tok_lp   (x[token] - max) - log(sum_v exp(x[v] - max))
// log is logf, never __logf: the build has no fast-math flag, and the
// token depends on the noise's last bit only on a near-tie.  Masked
// columns (-1e30 / T) never win: u lies in [tiny, 1 - 2^-23], so the
// noise lies in [-4.48, 15.95] (the hash-Gumbel stream of lstm_sample.cu
// can draw u = 1 and needs its masked-draw guard; this one cannot).
//
// Bound on the H100: integer issue.  Each sampled element costs one
// threefry (20 rounds of add / funnel-shift / xor, 12 key adds) and a few
// bit operations, ~77 int32 operations, at 132 SMs x 64 int32 lanes x
// 1.98 GHz = 16.7 T/s; at the CST rollout's 320 slots x 10,496 columns
// that is 0.015 ms against 0.004 ms for reading the 13.4 MB of float32
// logits at 3.35 TB/s.  The two logf and the expf run on the float pipes
// beside it.
//
// Design: one block of 512 threads per row (at 320 rows one wave of 39
// warps an SM; the chains of a column are serial, so the warps hide
// each other's latency).  Thread t walks columns t, t + 512, ...
// (coalesced reads), keeps its best (value, index) with a
// strict > (so the lowest index on its ties) and an online max and sum of
// exp of x.  Warp shuffles, then one pass over the 16 warps' partials in
// shared memory, merge by (value desc, index asc) and rescale the sums.
// The row's key is derived by every thread (two threefry calls), so no
// barrier precedes the loop.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace cstk {

constexpr int TS_THREADS = 512;
constexpr int TS_WARPS = TS_THREADS / 32;

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

// threefry2x32 of the counter (x0, x1) under (k0, k1), in place.
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t& x0, uint32_t& x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
#define TF_ROUND(r) \
  x0 += x1;         \
  x1 = rotl32(x1, r); \
  x1 ^= x0;
#define TF_ROUNDS_A TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
#define TF_ROUNDS_B TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  x0 += k0;
  x1 += k1;
  TF_ROUNDS_A
  x0 += k1;
  x1 += k2 + 1u;
  TF_ROUNDS_B
  x0 += k2;
  x1 += k0 + 2u;
  TF_ROUNDS_A
  x0 += k0;
  x1 += k1 + 3u;
  TF_ROUNDS_B
  x0 += k1;
  x1 += k2 + 4u;
  TF_ROUNDS_A
  x0 += k2;
  x1 += k0 + 5u;
#undef TF_ROUNDS_A
#undef TF_ROUNDS_B
#undef TF_ROUND
}

// jax.random.gumbel (mode "low") from its 32 random bits.
__device__ __forceinline__ float gumbel_from_bits(uint32_t bits) {
  const float tiny = 1.17549435e-38f;  // float32 tiny (FLT_MIN)
  const float f = __uint_as_float((bits >> 9) | 0x3f800000u) - 1.0f;
  // f * (1 - tiny) + tiny, where 1 - tiny rounds to 1.0f; then the max.
  const float u = fmaxf(tiny, __fadd_rn(f, tiny));
  return -logf(-logf(u));
}

// (value desc, index asc): is (a, ia) the better candidate?
__device__ __forceinline__ bool better(float a, int ia, float b, int ib) {
  return a > b || (a == b && ia < ib);
}

// Online log-sum-exp: fold (m2, s2) into (m, s).
__device__ __forceinline__ void lse_merge(float& m, float& s, float m2,
                                          float s2) {
  if (m2 == -CUDART_INF_F) return;
  if (m == -CUDART_INF_F) {
    m = m2;
    s = s2;
  } else if (m2 > m) {
    s = s * expf(m - m2) + s2;
    m = m2;
  } else {
    s += s2 * expf(m2 - m);
  }
}

__global__ void __launch_bounds__(TS_THREADS) threefry_sample_kernel(
    const float* __restrict__ scaled, long long ld, int V, uint32_t k0,
    uint32_t k1, int row_keyed, const int* __restrict__ row_id,
    const int* __restrict__ step, const unsigned char* __restrict__ is_sample,
    long long* __restrict__ tok, float* __restrict__ tok_lp) {
  const int g = blockIdx.x;
  const float* x = scaled + (long long)g * ld;
  const bool sample = is_sample == nullptr || is_sample[g] != 0;
  uint32_t rk0 = k0, rk1 = k1;
  unsigned long long cbase = 0ull;
  if (row_keyed) {
    uint32_t a0 = 0u, a1 = (uint32_t)row_id[g];
    threefry2x32(k0, k1, a0, a1);
    uint32_t b0 = 0u, b1 = (uint32_t)step[g];
    threefry2x32(a0, a1, b0, b1);
    rk0 = b0;
    rk1 = b1;
  } else {
    cbase = (unsigned long long)g * (unsigned long long)V;
  }

  float best = -CUDART_INF_F;
  int best_i = 0x7fffffff;
  float m = -CUDART_INF_F, s = 0.0f;
  for (int v = threadIdx.x; v < V; v += TS_THREADS) {
    const float xv = x[v];
    float val = xv;
    if (sample) {
      const unsigned long long c = cbase + (unsigned long long)v;
      uint32_t c0 = (uint32_t)(c >> 32), c1 = (uint32_t)c;
      threefry2x32(rk0, rk1, c0, c1);
      val = gumbel_from_bits(c0 ^ c1) + xv;
    }
    if (val > best) {
      best = val;
      best_i = v;
    }
    lse_merge(m, s, xv, 1.0f);
  }

  for (int off = 16; off > 0; off >>= 1) {
    const float ob = __shfl_down_sync(0xffffffffu, best, off);
    const int oi = __shfl_down_sync(0xffffffffu, best_i, off);
    const float om = __shfl_down_sync(0xffffffffu, m, off);
    const float os = __shfl_down_sync(0xffffffffu, s, off);
    if (better(ob, oi, best, best_i)) {
      best = ob;
      best_i = oi;
    }
    lse_merge(m, s, om, os);
  }
  __shared__ float sh_best[TS_WARPS], sh_m[TS_WARPS], sh_s[TS_WARPS];
  __shared__ int sh_i[TS_WARPS];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    sh_best[warp] = best;
    sh_i[warp] = best_i;
    sh_m[warp] = m;
    sh_s[warp] = s;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < TS_WARPS; ++w) {
      if (better(sh_best[w], sh_i[w], best, best_i)) {
        best = sh_best[w];
        best_i = sh_i[w];
      }
      lse_merge(m, s, sh_m[w], sh_s[w]);
    }
    tok[g] = best_i;
    tok_lp[g] = (x[best_i] - m) - logf(s);
  }
}

}  // namespace cstk

extern "C" const char* cst_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" int cst_threefry_sample(const void* scaled, long long ld, int G,
                                   int V, unsigned k0, unsigned k1,
                                   int row_keyed, const void* row_id,
                                   const void* step, const void* is_sample,
                                   void* tok, void* tok_lp, void* stream) {
  if (G < 0 || V < 1 || ld < V ||
      (row_keyed && (row_id == nullptr || step == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (G == 0) return 0;
  cstk::threefry_sample_kernel<<<G, cstk::TS_THREADS, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(scaled), ld, V, k0, k1, row_keyed,
      static_cast<const int*>(row_id), static_cast<const int*>(step),
      static_cast<const unsigned char*>(is_sample),
      static_cast<long long*>(tok), static_cast<float*>(tok_lp));
  return (int)cudaGetLastError();
}
