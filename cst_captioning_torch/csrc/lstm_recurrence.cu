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
// stream, no host sync.  Each launch is decode_common.cuh's
// lstm_rec_step_kernel (the decoders' gate GEMM, h term only) over a tile
// of 32 rows x 32 hidden units x 4 gates, then the gate update in
// registers.  The float32 h state ping-pongs between two buffers; the
// cell updates in place (each element is read and written by one
// thread).
//
// int8w (entry with wq = 1): also replaces pallas_lstm.py::
// lstm_recurrence_quant (the same pallas_call with _make_kernel(quant=
// True)).  W_h arrives as int8 codes with the (4H,) float32 column scale;
// the step kernel is instantiated with WT = int8_t, so gates = gx_t +
// (T(h) @ T(codes)) * scale, the scale applied once to the float32 sum.
// Forward only, no cell output.  Bound: bytes, as the float kernel (gx
// 304 MB + h_seq 38 MB + W_h 1 MB at the XE shape, 0.103 ms).
#include "decode_common.cuh"

namespace cstk {

template <typename T, typename WT = T>
static int run_recurrence(const float* gx, const void* wh, float* h_a,
                          float* h_b, float* c, void* h_seq, float* c_seq,
                          int R, int T_, int H, cudaStream_t st,
                          QScales qs) {
  const dim3 grid((R + G_TM - 1) / G_TM, (H + G_TJ - 1) / G_TJ);
  float* h_in = h_a;
  float* h_out = h_b;
  for (int t = 0; t < T_; ++t) {
    lstm_rec_step_kernel<T, false, WT><<<grid, THREADS, 0, st>>>(
        gx, nullptr, static_cast<const WT*>(wh), nullptr, h_in, h_out, c,
        static_cast<T*>(h_seq), c_seq, R, T_, 0, H, t, qs);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    float* tmp = h_in;
    h_in = h_out;
    h_out = tmp;
  }
  return 0;
}

}  // namespace cstk

// dtype: 0 = float32, 1 = bfloat16 (h_seq, and W_h unless wq).  wq: 1
// when W_h holds int8 codes with the (4H,) float32 column scale wh_s
// (int8w; then c_seq must be null), else 0 and wh_s null.  The caller
// zeroes h_a and c; gx is (R, T, 4H) float32 row-major, W_h (H, 4H),
// h_seq (R, T, H), c_seq (R, T, H) float32 or null.  Returns 0 or the
// CUDA error code of the first refused launch.
extern "C" int cst_lstm_recurrence(int dtype, int wq, const void* gx,
                                   const void* wh, const void* wh_s,
                                   void* h_a, void* h_b, void* c,
                                   void* h_seq, void* c_seq, int R, int T,
                                   int H, void* stream) {
  if (R < 1 || T < 1 || H < 1) return (int)cudaErrorInvalidValue;
  if (wq && (wh_s == nullptr || c_seq != nullptr))
    return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  const cstk::QScales qs{nullptr, static_cast<const float*>(wh_s), nullptr};
#define CST_REC_ARGS                                                        \
  static_cast<const float*>(gx), wh, static_cast<float*>(h_a),              \
      static_cast<float*>(h_b), static_cast<float*>(c), h_seq,              \
      static_cast<float*>(c_seq), R, T, H, st, qs
  if (dtype == 0 && !wq) return cstk::run_recurrence<float>(CST_REC_ARGS);
  if (dtype == 1 && !wq)
    return cstk::run_recurrence<__nv_bfloat16>(CST_REC_ARGS);
  if (dtype == 0 && wq)
    return cstk::run_recurrence<float, int8_t>(CST_REC_ARGS);
  if (dtype == 1 && wq)
    return cstk::run_recurrence<__nv_bfloat16, int8_t>(CST_REC_ARGS);
#undef CST_REC_ARGS
  return (int)cudaErrorInvalidValue;
}
