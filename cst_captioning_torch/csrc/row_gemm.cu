// Row-invariant matrix product for Hopper (sm_90a): out = T(x) @ W with
// float32 accumulation, every output's k order fixed whatever the number
// of rows R.
//
// No TPU kernel of the JAX package is replaced: the reference leaves the
// per-step decoder's products (query, gates, vocab logits) and the
// admission encode's projections to XLA, and argues that slot geometry
// cannot change a token because every op is row-independent
// (serving/slots.py module doc).  cuBLAS does not promise that: for
// another row count it may choose another kernel or split K, and a row's
// bits change (PERF.md records the measurement).  The port's continuous
// slot loop holds S*K rows, its offline twin B*K: this kernel is what
// makes a served caption bit-for-bit the offline one.
//
// Bound on the H100: bytes.  At the slot loop's vocab product (R = 320,
// K = 512, N = 10,496, bf16) the call must read W (10.7 MB) and x and
// write the float32 out (13.4 MB): 0.0073 ms at 3.35 TB/s, against 3.4
// GFLOP, 0.0035 ms on the tensor cores.
//
// Design, bf16 compute (T = bf16: bf16 x; float32 x rounded to bf16, the
// encode's feature rows; int8 codes widened to bf16): tensor cores.  A
// block owns a 64-row x 128-column output tile; its 8 warps (2 x 4) each
// hold a 32 x 32 fragment tile of mma.sync m16n8k16.  K streams in
// 64-deep stages through a 3-stage cp.async ring (x from L2, W once from
// HBM per row tile); bf16 operands land in XOR-swizzled tiles that
// ldmatrix reads without bank conflicts.  Operands that are not bf16
// (float32 x, int8 W) land raw and each thread widens the chunks it
// copied into the bf16 tiles, so every instantiation runs the same mma
// sequence.  The k order is tc_common.cuh's rule: 32-deep chunks in
// ascending order, each summed by the tensor core from zero and added to
// the float32 accumulator once.  No split-K, and the tile shape, stage
// count and kernel do not depend on R, so a row's bits never do.
//
// Design, float32 compute: attention_common.cuh's SIMT row_gemm_kernel,
// unchanged (one FMA chain per output in ascending k; tensor cores would
// need TF32, which drops the float32 tier).
//
// int8w serving (serving.dtype = int8w): W holds int8 codes, read as
// int8 and widened in the kernel (T(code) exactly), the same sum, then
// one float32 multiply by the column scale in the epilogue: the
// reference's quant_matmul, (T(x) @ T(codes)) * scale.  With bf16
// compute it is bitwise the float path on the widened codes times the
// scale.
#include <type_traits>

#include "attention_common.cuh"
#include "tc_common.cuh"

namespace cstk {

constexpr int RG_BM = 64;   // rows per block
constexpr int RG_BN = 128;  // columns per block
constexpr int RG_BK = 64;   // k per stage
constexpr int RG_NS = 3;    // ring stages
constexpr int RG_THREADS = 256;

// Shared-memory plan of one instantiation: a ring of RG_NS raw stages
// (x and W as stored), plus one bf16 tile for each operand that must be
// widened first.  bf16 tiles: A (64 rows x 64 k, 8 chunks of 16 bytes a
// row), B (64 k x 128 columns, 16 chunks a row), chunk c of row r stored
// at c ^ (r & 7).
template <typename S, typename WT>
struct RgPlan {
  static constexpr bool kCvtA = !std::is_same<S, __nv_bfloat16>::value;
  static constexpr bool kCvtB = !std::is_same<WT, __nv_bfloat16>::value;
  static constexpr int A_RAW = RG_BM * RG_BK * (int)sizeof(S);
  static constexpr int B_RAW = RG_BK * RG_BN * (int)sizeof(WT);
  static constexpr int A_BF = RG_BM * RG_BK * 2;
  static constexpr int B_BF = RG_BK * RG_BN * 2;
  static constexpr int STAGE = A_RAW + B_RAW;
  static constexpr int SMEM =
      RG_NS * STAGE + (kCvtA ? A_BF : 0) + (kCvtB ? B_BF : 0);
};

__device__ __forceinline__ int swz_a(int row, int chunk) {
  return row * RG_BK + ((chunk ^ (row & 7)) << 3);
}
__device__ __forceinline__ int swz_b(int k, int chunk) {
  return k * RG_BN + ((chunk ^ (k & 7)) << 3);
}

template <typename T>
__device__ __forceinline__ T zero_val() {
  return T(0);
}
template <>
__device__ __forceinline__ __nv_bfloat16 zero_val<__nv_bfloat16>() {
  return __float2bfloat16_rn(0.f);
}

// Copy stage kt (k0 = kt * RG_BK) of x and W into the raw ring slot.
// Each thread owns two A units (row, 8 k) and two B units (k, 16
// columns) and widens the same units later.  Full, aligned units go by
// cp.async; rows >= R and k >= K are zero-filled; ragged or unaligned
// units are copied element by element.
template <typename S, typename WT>
__device__ __forceinline__ void rg_load_stage(
    unsigned char* slot, const S* __restrict__ x, long long ldx,
    const WT* __restrict__ w, int R, int Kd, int N, int m0, int n0, int k0,
    bool vec_a, bool vec_b) {
  using P = RgPlan<S, WT>;
  S* a_raw = reinterpret_cast<S*>(slot);
  WT* b_raw = reinterpret_cast<WT*>(slot + P::A_RAW);
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int i = threadIdx.x + j * RG_THREADS;
    const int row = i >> 3, c8 = i & 7;
    const int gr = m0 + row, gk = k0 + 8 * c8;
    // Unit dst: the bf16 tile itself (swizzled) or the raw row.
    S* dst = P::kCvtA ? a_raw + row * RG_BK + 8 * c8 : a_raw + swz_a(row, c8);
    const S* src = x + (size_t)gr * ldx + gk;
    constexpr int per16 = 16 / (int)sizeof(S);  // elements per 16 bytes
    if (gr >= R || gk >= Kd) {
#pragma unroll
      for (int q = 0; q < 8 / per16; ++q)
        *reinterpret_cast<uint4*>(dst + q * per16) = make_uint4(0, 0, 0, 0);
    } else if (vec_a && gk + 8 <= Kd) {
#pragma unroll
      for (int q = 0; q < 8 / per16; ++q)
        cp_async16(dst + q * per16, src + q * per16);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        dst[e] = gk + e < Kd ? src[e] : zero_val<S>();
    }
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int i = threadIdx.x + j * RG_THREADS;
    const int kr = i >> 3, c16 = i & 7;
    const int gk = k0 + kr, gn = n0 + 16 * c16;
    const WT* src = w + (size_t)gk * N + gn;
    constexpr int per16 = 16 / (int)sizeof(WT);
    WT* d[2];
    if (P::kCvtB) {
      d[0] = b_raw + kr * RG_BN + 16 * c16;
      d[1] = d[0] + 8;
    } else {
      d[0] = b_raw + swz_b(kr, 2 * c16);
      d[1] = b_raw + swz_b(kr, 2 * c16 + 1);
    }
    if (gk >= Kd || gn >= N) {
#pragma unroll
      for (int q = 0; q < 16 / per16; ++q)
        *reinterpret_cast<uint4*>(P::kCvtB ? d[0] + q * per16 : d[q]) =
            make_uint4(0, 0, 0, 0);
    } else if (vec_b && gn + 16 <= N) {
#pragma unroll
      for (int q = 0; q < 16 / per16; ++q)
        cp_async16(P::kCvtB ? d[0] + q * per16 : d[q], src + q * per16);
    } else {
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        WT v = gn + e < N ? src[e] : zero_val<WT>();
        d[e >> 3][e & 7] = v;
      }
    }
  }
}

// Widen this thread's raw units of a stage into the bf16 tiles.
template <typename S, typename WT>
__device__ __forceinline__ void rg_widen(const unsigned char* slot,
                                         __nv_bfloat16* a_bf,
                                         __nv_bfloat16* b_bf) {
  using P = RgPlan<S, WT>;
  if constexpr (P::kCvtA) {
    const S* a_raw = reinterpret_cast<const S*>(slot);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int i = threadIdx.x + j * RG_THREADS;
      const int row = i >> 3, c8 = i & 7;
      const S* s = a_raw + row * RG_BK + 8 * c8;
      uint4 v;
      v.x = pack_bf16(to_f(s[0]), to_f(s[1]));
      v.y = pack_bf16(to_f(s[2]), to_f(s[3]));
      v.z = pack_bf16(to_f(s[4]), to_f(s[5]));
      v.w = pack_bf16(to_f(s[6]), to_f(s[7]));
      *reinterpret_cast<uint4*>(a_bf + swz_a(row, c8)) = v;
    }
  }
  if constexpr (P::kCvtB) {
    const WT* b_raw = reinterpret_cast<const WT*>(slot + P::A_RAW);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int i = threadIdx.x + j * RG_THREADS;
      const int kr = i >> 3, c16 = i & 7;
      const WT* s = b_raw + kr * RG_BN + 16 * c16;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const WT* q = s + 8 * h;
        uint4 v;
        v.x = pack_bf16(to_f(q[0]), to_f(q[1]));
        v.y = pack_bf16(to_f(q[2]), to_f(q[3]));
        v.z = pack_bf16(to_f(q[4]), to_f(q[5]));
        v.w = pack_bf16(to_f(q[6]), to_f(q[7]));
        *reinterpret_cast<uint4*>(b_bf + swz_b(kr, 2 * c16 + h)) = v;
      }
    }
  }
}

// out[r, n] = sum_k T(x[r, k]) W[k, n] (* scale[n]) on the tensor cores;
// grid (ceil(N / 128), ceil(R / 64)), RG_THREADS threads, RgPlan::SMEM
// bytes of dynamic shared memory.  vec_a / vec_b: x rows / W rows start
// on 16-byte boundaries.
template <typename S, typename WT>
__global__ void __launch_bounds__(RG_THREADS) row_gemm_tc_kernel(
    const S* __restrict__ x, long long ldx, const WT* __restrict__ w,
    const float* __restrict__ scale, float* __restrict__ out, int R, int Kd,
    int N, bool vec_a, bool vec_b) {
  using P = RgPlan<S, WT>;
  extern __shared__ __align__(128) unsigned char rg_smem[];
  __nv_bfloat16* a_cvt =
      reinterpret_cast<__nv_bfloat16*>(rg_smem + RG_NS * P::STAGE);
  __nv_bfloat16* b_cvt = a_cvt + (P::kCvtA ? RG_BM * RG_BK : 0);
  const int n0 = blockIdx.x * RG_BN, m0 = blockIdx.y * RG_BM;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wr = warp >> 2, wc = warp & 3;
  const int nk = (Kd + RG_BK - 1) / RG_BK;

  float acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

#pragma unroll
  for (int s = 0; s < RG_NS - 1; ++s) {
    if (s < nk)
      rg_load_stage<S, WT>(rg_smem + s * P::STAGE, x, ldx, w, R, Kd, N, m0,
                           n0, s * RG_BK, vec_a, vec_b);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<RG_NS - 2>();
    __syncthreads();  // stage kt in; every warp done with stage kt - 1
    unsigned char* slot = rg_smem + (kt % RG_NS) * P::STAGE;
    if constexpr (P::kCvtA || P::kCvtB) {
      rg_widen<S, WT>(slot, a_cvt, b_cvt);
      __syncthreads();
    }
    const int nxt = kt + RG_NS - 1;
    if (nxt < nk)
      rg_load_stage<S, WT>(rg_smem + (nxt % RG_NS) * P::STAGE, x, ldx, w, R,
                           Kd, N, m0, n0, nxt * RG_BK, vec_a, vec_b);
    cp_async_commit();

    const __nv_bfloat16* As =
        P::kCvtA ? a_cvt : reinterpret_cast<const __nv_bfloat16*>(slot);
    const __nv_bfloat16* Bs =
        P::kCvtB ? b_cvt
                 : reinterpret_cast<const __nv_bfloat16*>(slot + P::A_RAW);
#pragma unroll
    for (int kc = 0; kc < RG_BK / TC_KCHUNK; ++kc) {
      float part[2][4][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) part[mi][ni][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < TC_KCHUNK / 16; ++kk) {
        const int k16 = kc * (TC_KCHUNK / 16) + kk;
        uint32_t a[2][4], b[4][2];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          const int row = 32 * wr + 16 * mi + (lane & 15);
          ldsm_x4(a[mi], smem_u32(As + swz_a(row, 2 * k16 + (lane >> 4))));
        }
#pragma unroll
        for (int nb = 0; nb < 2; ++nb) {
          const int kr = 16 * k16 + (lane & 7) + ((lane >> 3) & 1) * 8;
          uint32_t r[4];
          ldsm_x4_t(r, smem_u32(Bs + swz_b(kr, 4 * wc + 2 * nb + (lane >> 4))));
          b[2 * nb][0] = r[0];
          b[2 * nb][1] = r[1];
          b[2 * nb + 1][0] = r[2];
          b[2 * nb + 1][1] = r[3];
        }
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int ni = 0; ni < 4; ++ni)
            mma_bf16(part[mi][ni], a[mi], b[ni][0], b[ni][1]);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) add_chunk(acc[mi][ni], part[mi][ni]);
    }
  }
  cp_async_wait<0>();

  const int g = lane >> 2, t = lane & 3;
  const bool pair = (N & 1) == 0;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int n = n0 + 32 * wc + 8 * ni + 2 * t;
      if (n >= N) continue;
      float s0 = 1.f, s1 = 1.f;
      if (scale != nullptr) {
        s0 = scale[n];
        s1 = n + 1 < N ? scale[n + 1] : 1.f;
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + 32 * wr + 16 * mi + g + 8 * h;
        if (row >= R) continue;
        float v0 = acc[mi][ni][2 * h], v1 = acc[mi][ni][2 * h + 1];
        if (scale != nullptr) {
          v0 = __fmul_rn(v0, s0);
          v1 = __fmul_rn(v1, s1);
        }
        float* o = out + (size_t)row * N + n;
        if (pair) {
          *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
        } else {
          o[0] = v0;
          if (n + 1 < N) o[1] = v1;
        }
      }
    }
}

template <typename S, typename WT>
static int run_row_gemm_tc(const void* x, long long ldx, const void* w,
                           const float* scale, float* out, int R, int Kd,
                           int N, cudaStream_t st) {
  using P = RgPlan<S, WT>;
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        row_gemm_tc_kernel<S, WT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, P::SMEM);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const bool vec_a = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                     (ldx * (long long)sizeof(S)) % 16 == 0;
  const bool vec_b = reinterpret_cast<uintptr_t>(w) % 16 == 0 &&
                     ((long long)N * sizeof(WT)) % 16 == 0;
  const dim3 grid((N + RG_BN - 1) / RG_BN, (R + RG_BM - 1) / RG_BM);
  row_gemm_tc_kernel<S, WT><<<grid, RG_THREADS, P::SMEM, st>>>(
      static_cast<const S*>(x), ldx, static_cast<const WT*>(w), scale, out, R,
      Kd, N, vec_a, vec_b);
  return (int)cudaGetLastError();
}

// The float32 instantiation: the SIMT kernel of attention_common.cuh.
template <typename S, typename WT>
static int run_row_gemm_f32(const void* x, long long ldx, const void* w,
                            const float* scale, float* out, int R, int Kd,
                            int N, cudaStream_t st) {
  return (int)row_gemm<float, S, false, WT>(static_cast<const S*>(x), ldx,
                                            static_cast<const WT*>(w), out, N,
                                            R, Kd, N, kStore, st, scale);
}

template <typename S>
static int run_row_gemm_w(int dtype, int wq, const void* x, long long ldx,
                          const void* w, const float* scale, float* out,
                          int R, int Kd, int N, cudaStream_t st) {
  if (dtype == 0) {
    if (wq)
      return run_row_gemm_f32<S, int8_t>(x, ldx, w, scale, out, R, Kd, N, st);
    return run_row_gemm_f32<S, float>(x, ldx, w, nullptr, out, R, Kd, N, st);
  }
  if (wq)
    return run_row_gemm_tc<S, int8_t>(x, ldx, w, scale, out, R, Kd, N, st);
  return run_row_gemm_tc<S, __nv_bfloat16>(x, ldx, w, nullptr, out, R, Kd, N,
                                           st);
}

}  // namespace cstk

// dtype: 0 = float32, 1 = bfloat16 (the dtype x is rounded to, and W's
// unless wq); x_dtype: the element type of x, same codes; wq: 1 when W
// holds int8 codes with the (N,) float32 column scale `scale`, else 0
// (scale unused).  x is (R, K) with row stride ldx, W (K, N) contiguous,
// out (R, N) float32 contiguous.  float32 runs the SIMT kernel, bfloat16
// the tensor-core kernel.  Returns 0 or the CUDA error code of a refused
// launch.
extern "C" int cst_row_gemm(int dtype, int x_dtype, int wq, const void* x,
                            long long ldx, const void* w, const void* scale,
                            void* out, int R, int K, int N, void* stream) {
  if (R < 1 || K < 1 || N < 1 || ldx < K || (wq && scale == nullptr) ||
      (dtype != 0 && dtype != 1) || (x_dtype != 0 && x_dtype != 1))
    return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  const float* sc = wq ? static_cast<const float*>(scale) : nullptr;
  if (x_dtype == 0)
    return cstk::run_row_gemm_w<float>(dtype, wq, x, ldx, w, sc, o, R, K, N,
                                       st);
  return cstk::run_row_gemm_w<__nv_bfloat16>(dtype, wq, x, ldx, w, sc, o, R,
                                             K, N, st);
}
