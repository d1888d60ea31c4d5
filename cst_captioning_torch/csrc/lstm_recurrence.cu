// Teacher-forced LSTM recurrence for Hopper (sm_90a).
//
// Replaces the TPU kernel of the JAX package, ops/pallas_lstm.py::
// lstm_recurrence_pallas (pallas_call with _make_kernel(with_cell)), the
// forward of ops/pallas_lstm.py::lstm_recurrence.  Same function: R rows
// from zero state over T steps of precomputed input gates gx (R, T, 4H)
// float32.  Per step gates = gx[:, t] + T(h) @ W_h, with h rounded to the
// compute dtype T, products accumulated in float32 and ONE float32 add
// (the TPU kernel's association, not the decoders' three-term sum); then
// the i|f|g|o update with a float32 cell.  h_seq[:, t] is written in T
// and, with a cell output, c_seq[:, t] in float32 (the backward's
// residual).
//
// Bound on the H100: bytes.  At the XE shape (bf16, R = 1280, T = 29,
// H = 512) the call must read gx (304 MB) and W_h (2 MB) and write h_seq
// (38 MB) and c_seq (76 MB): 420 MB, 0.125 ms at 3.35 TB/s; its
// 77.8 GFLOP of recurrent products need 0.079 ms on the tensor cores.
//
// Design (first, simple; PERF.md has its times): the TPU kernel keeps
// W_h and the (h, c) carry in one core's VMEM across a sequential grid;
// here the host loops over T, one launch per step on the caller's
// stream, no host sync.  Each launch is the decoders' gate GEMM
// (decode_common.cuh gate_pass, the h-row pass) over a tile of 32 rows x
// 32 hidden units x 4 gates, then the gate update in registers.  The
// float32 h state ping-pongs between two buffers; the cell updates in
// place (each element is read and written by one thread).
#include "decode_common.cuh"

namespace cstk {

template <typename T>
__device__ __forceinline__ void store_cdt(T* p, float x);
template <>
__device__ __forceinline__ void store_cdt<float>(float* p, float x) {
  *p = x;
}
template <>
__device__ __forceinline__ void store_cdt<__nv_bfloat16>(__nv_bfloat16* p,
                                                         float x) {
  *p = __float2bfloat16_rn(x);
}

// One step t.  Grid (ceil(R/32), ceil(H/32)), 256 threads; thread (ty, tx)
// owns rows ty*4..ty*4+3 of hidden unit j0+tx, all four gates.  h_out
// must not alias h.  c_seq may be null (no cell output).
template <typename T>
__global__ void __launch_bounds__(THREADS) lstm_rec_step_kernel(
    const float* __restrict__ gx, const T* __restrict__ wh,
    const float* __restrict__ h, float* __restrict__ h_out, float* c,
    T* __restrict__ h_seq, float* __restrict__ c_seq, int R, int T_, int H,
    int t) {
  __shared__ float As[G_TM][G_KC + 1];
  __shared__ float Ws[G_KC][4 * G_TJ];
  const int r0 = blockIdx.x * G_TM, j0 = blockIdx.y * G_TJ;
  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int g = 0; g < 4; ++g) acc[r][g] = 0.f;
  gate_pass<T, false>(acc, As, Ws, wh, static_cast<const T*>(nullptr),
                      nullptr, h, R, H, H, r0, j0);

  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int j = j0 + tx;
  if (j >= H) return;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = r0 + ty * 4 + r;
    if (row >= R) continue;
    const size_t step = (size_t)row * T_ + t;
    const float* g = gx + step * 4 * H;
    float pre[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) pre[q] = __fadd_rn(g[q * H + j], acc[r][q]);
    const float ig = sigmoidf_(pre[0]);
    const float fg = sigmoidf_(pre[1]);
    const float gg = tanhf(pre[2]);
    const float og = sigmoidf_(pre[3]);
    const size_t o = (size_t)row * H + j;
    const float cn = __fadd_rn(__fmul_rn(fg, c[o]), __fmul_rn(ig, gg));
    const float hn = __fmul_rn(og, tanhf(cn));
    c[o] = cn;
    h_out[o] = hn;
    store_cdt<T>(h_seq + step * H + j, hn);
    if (c_seq != nullptr) c_seq[step * H + j] = cn;
  }
}

template <typename T>
static int run_recurrence(const float* gx, const void* wh, float* h_a,
                          float* h_b, float* c, void* h_seq, float* c_seq,
                          int R, int T_, int H, cudaStream_t st) {
  const dim3 grid((R + G_TM - 1) / G_TM, (H + G_TJ - 1) / G_TJ);
  float* h_in = h_a;
  float* h_out = h_b;
  for (int t = 0; t < T_; ++t) {
    lstm_rec_step_kernel<T><<<grid, THREADS, 0, st>>>(
        gx, static_cast<const T*>(wh), h_in, h_out, c,
        static_cast<T*>(h_seq), c_seq, R, T_, H, t);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    float* tmp = h_in;
    h_in = h_out;
    h_out = tmp;
  }
  return 0;
}

}  // namespace cstk

// dtype: 0 = float32, 1 = bfloat16 (W_h and h_seq).  The caller zeroes
// h_a and c; gx is (R, T, 4H) float32 row-major, W_h (H, 4H), h_seq
// (R, T, H), c_seq (R, T, H) float32 or null.  Returns 0 or the CUDA
// error code of the first refused launch.
extern "C" int cst_lstm_recurrence(int dtype, const void* gx, const void* wh,
                                   void* h_a, void* h_b, void* c,
                                   void* h_seq, void* c_seq, int R, int T,
                                   int H, void* stream) {
  if (R < 1 || T < 1 || H < 1) return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
#define CST_REC_ARGS                                                        \
  static_cast<const float*>(gx), wh, static_cast<float*>(h_a),              \
      static_cast<float*>(h_b), static_cast<float*>(c), h_seq,              \
      static_cast<float*>(c_seq), R, T, H, st
  if (dtype == 0) return cstk::run_recurrence<float>(CST_REC_ARGS);
  if (dtype == 1) return cstk::run_recurrence<__nv_bfloat16>(CST_REC_ARGS);
#undef CST_REC_ARGS
  return (int)cudaErrorInvalidValue;
}
