// Row-invariant matrix product for Hopper (sm_90a): out = T(x) @ W with
// float32 accumulation, every output element summed over k in ascending
// order by one thread, whatever the number of rows R.
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
// Bound on the H100: operations.  At the beam slot loop's gate product
// (R = 320, K = 1536, N = 2048) it does 2.0 GFLOP, 0.030 ms at the f32
// rate outside the tensor cores (67 TFLOP/s); the vocab product (K = 512,
// N = 10,496) 3.4 GFLOP, 0.051 ms.
//
// Design (first, simple): attention_common.cuh's row_gemm_kernel (32 rows
// x 128 columns per block, K in chunks of 32 staged in shared memory, one
// FMA chain per output in ascending k).  Tensor cores are later work.
//
// int8w serving (serving.dtype = int8w): W holds int8 codes, read as
// int8 and widened in the kernel (T(code) exactly), the same ascending
// float32 sum, then one float32 multiply by the column scale in the
// epilogue: the reference's quant_matmul, (T(x) @ T(codes)) * scale,
// with the rows still independent of the row count.
#include "attention_common.cuh"

namespace cstk {

template <typename T, typename S, typename WT = T>
static int run_row_gemm(const void* x, long long ldx, const void* w,
                        const float* scale, float* out, int R, int Kd, int N,
                        cudaStream_t st) {
  return (int)row_gemm<T, S, false, WT>(static_cast<const S*>(x), ldx,
                                        static_cast<const WT*>(w), out, N, R,
                                        Kd, N, kStore, st, scale);
}

template <typename T, typename S>
static int run_row_gemm_w(int wq, const void* x, long long ldx,
                          const void* w, const float* scale, float* out,
                          int R, int Kd, int N, cudaStream_t st) {
  if (wq) return run_row_gemm<T, S, int8_t>(x, ldx, w, scale, out, R, Kd, N, st);
  return run_row_gemm<T, S>(x, ldx, w, nullptr, out, R, Kd, N, st);
}

}  // namespace cstk

// dtype: 0 = float32, 1 = bfloat16 (the dtype x is rounded to, and W's
// unless wq); x_dtype: the element type of x, same codes; wq: 1 when W
// holds int8 codes with the (N,) float32 column scale `scale`, else 0
// (scale unused).  x is (R, K) with row stride ldx, W (K, N) contiguous,
// out (R, N) float32 contiguous.  Returns 0 or the CUDA error code of a
// refused launch.
extern "C" int cst_row_gemm(int dtype, int x_dtype, int wq, const void* x,
                            long long ldx, const void* w, const void* scale,
                            void* out, int R, int K, int N, void* stream) {
  if (R < 1 || K < 1 || N < 1 || ldx < K || (wq && scale == nullptr))
    return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  const float* sc = static_cast<const float*>(scale);
  if (dtype == 0 && x_dtype == 0)
    return cstk::run_row_gemm_w<float, float>(wq, x, ldx, w, sc, o, R, K, N,
                                              st);
  if (dtype == 1 && x_dtype == 0)
    return cstk::run_row_gemm_w<__nv_bfloat16, float>(wq, x, ldx, w, sc, o, R,
                                                      K, N, st);
  if (dtype == 1 && x_dtype == 1)
    return cstk::run_row_gemm_w<__nv_bfloat16, __nv_bfloat16>(
        wq, x, ldx, w, sc, o, R, K, N, st);
  if (dtype == 0 && x_dtype == 1)
    return cstk::run_row_gemm_w<float, __nv_bfloat16>(wq, x, ldx, w, sc, o, R,
                                                      K, N, st);
  return (int)cudaErrorInvalidValue;
}
