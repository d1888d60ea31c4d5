// The 16-bit decoders' per-step chain on the tensor cores (lstm_beam.cu,
// lstm_sample.cu; bf16 compute with float or int8 weights, f16 compute
// with float weights, each under meanpool and attention fusion):
// under attention the query and the per-video attention step of
// attention_tc.cuh; one gate GEMM with the LSTM update in its epilogue;
// and the vocab tile GEMM whose logits stay in shared memory for the
// callers' per-tile reductions.  Every product runs tc_common.cuh's
// mainloop, so each row's bits are the same whatever the row count.  T16
// (__nv_bfloat16 or __half) is the compute dtype: the operands, the h
// state and every rounding of the chain; the tiling and the order of sums
// are the same for both.
#pragma once

#include <cooperative_groups.h>

#include "attention_tc.cuh"

namespace cstk {

// The decoders' gates of one step over an operand of nsrc sources, A =
// [emb(tok) | T(h)] (meanpool: K0 = E, K = E + H) or [emb(tok) | T(ctx) |
// T(h)] (attention: K0 = E, K1 = 2E, K = 2E + H), op.a0 the staged (V, E)
// embedding table gathered by op.rows0 = the fed tokens; B^T = [W_x ;
// W_h]^T or [W_x ; W_ctx ; W_h]^T (4H, K) with the tile's columns in
// tt_gate_col order.  Each source's product is one float32 sum, and the
// sums are added in the reference's order (gx + e) [+ c] + h, each
// multiplied by the int8w gate column scale ls first when ls is not null
// (decode_common.cuh gate_preacts); then the i|f|g|o update: c_out
// (float32; may alias c_in, each element is read and written by one
// thread) and h_out (T16; must not alias op's h).  gx (R, 4H) float32.
// Grid (4H / 128, ceil(R / 64), nsplit): with nsplit = 1 a CTA walks all
// of K, folding each sum into the gate pre-activations as it completes;
// with nsplit = nsrc, launched as clusters of nsrc along z, rank z sums
// source z alone and rank 0 adds the others' sums, in source order, from
// its cluster's shared memory.  The same sums, added in the same order:
// the bits do not depend on nsplit.
template <typename T16>
__global__ void __launch_bounds__(TT_THREADS, 2) dec_gate_tc_kernel(
    TtOps<T16> op, const float* __restrict__ gx, const float* __restrict__ ls,
    const float* c_in, float* c_out, T16* __restrict__ h_out, int H) {
  extern __shared__ __align__(128) unsigned char tt_smem[];
  const int m0 = blockIdx.y * TT_BM, n0 = blockIdx.x * TT_BN;
  const int G = 4 * H;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wr = warp >> 2, wc = warp & 3;
  const int nsplit = gridDim.z;
  const bool split = nsplit > 1;
  const int z = blockIdx.z;  // split: the cluster rank, which source
  auto src_beg = [&](int src) {
    return src == 0 ? 0 : src == 1 ? op.K0 : op.K1;
  };
  const int kbeg = src_beg(z);
  const int kend = !split || z == nsplit - 1 ? op.K : src_beg(z + 1);
  // This thread's two neighbouring units; acc[mi][q][2 hh + e] is gate q
  // of unit u0 + e in row m0 + 32 wr + 16 mi + lane / 4 + 8 hh.
  const int u0 = 32 * blockIdx.x + 8 * wc + 2 * (lane & 3);
  float pre[2][4][4], acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = m0 + 32 * wr + 16 * mi + (lane >> 2) + 8 * hh;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float2 g2 = make_float2(0.f, 0.f);
        if (z == 0 && row < op.M)
          g2 = *reinterpret_cast<const float2*>(gx + (size_t)row * G + q * H +
                                                u0);
        pre[mi][q][2 * hh] = g2.x;
        pre[mi][q][2 * hh + 1] = g2.y;
        acc[mi][q][2 * hh] = acc[mi][q][2 * hh + 1] = 0.f;
      }
    }
  // pre += sum (times the scale): element i of a thread's 32 at s(i).
  auto fold = [&](auto s) {
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float v = s(mi * 16 + q * 4 + i);
          if (ls != nullptr) v = __fmul_rn(v, ls[q * H + u0 + (i & 1)]);
          pre[mi][q][i] = __fadd_rn(pre[mi][q][i], v);
        }
  };
  auto own = [&](int i) { return acc[i >> 4][(i >> 2) & 3][i & 3]; };
  TtOps<T16> o = op;
  o.K = kend;
  tt_mainloop_chunks(
      o, H, m0, n0, tt_smem,
      [&](int k, const float (&part)[2][4][4]) {
        if (k >= kend) return;  // a stage's zero-filled tail
        if (k != kbeg && (k == op.K0 || k == op.K1)) {  // a sum is done
          fold(own);
#pragma unroll
          for (int mi = 0; mi < 2; ++mi)
#pragma unroll
            for (int q = 0; q < 4; ++q)
#pragma unroll
              for (int i = 0; i < 4; ++i) acc[mi][q][i] = 0.f;
        }
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int q = 0; q < 4; ++q) add_chunk(acc[mi][q], part[mi][q]);
      },
      kbeg);
  if (split) {
    // Each rank's sum, element i of thread x at red[i * TT_THREADS + x].
    namespace cg = cooperative_groups;
    cg::cluster_group cluster = cg::this_cluster();
    __syncthreads();  // every warp is done with the ring
    float* red = reinterpret_cast<float*>(tt_smem);
#pragma unroll
    for (int i = 0; i < 32; ++i) red[i * TT_THREADS + threadIdx.x] = own(i);
    cluster.sync();
    if (z == 0) {
      fold(own);
      for (int src = 1; src < nsplit; ++src) {
        const float* red_s = cluster.map_shared_rank(red, src);
        fold([&](int i) { return red_s[i * TT_THREADS + threadIdx.x]; });
      }
    }
    cluster.sync();  // the other ranks stay until rank 0 has read their sums
    if (z != 0) return;
  } else {
    fold(own);
  }
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = m0 + 32 * wr + 16 * mi + (lane >> 2) + 8 * hh;
      if (row >= op.M) continue;
      const size_t o2 = (size_t)row * H + u0;
      float p[2][4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        p[0][q] = pre[mi][q][2 * hh];
        p[1][q] = pre[mi][q][2 * hh + 1];
      }
      float2 c2 = *reinterpret_cast<const float2*>(c_in + o2);
      const float h0 = lstm_cell(p[0], c2.x);
      const float h1 = lstm_cell(p[1], c2.y);
      *reinterpret_cast<float2*>(c_out + o2) = c2;
      *reinterpret_cast<typename Tc16<T16>::T2*>(h_out + o2) =
          Tc16<T16>::pair(h0, h1);
    }
}

// The logits of one TT_BM x TT_BN tile, T(h) @ W_out (op: A = h (R, H)
// T16, B^T = W_out^T (Vp, H) T16, the tile at rows m0, columns n0),
// into Ls (TT_BM rows of L_TV + 1 floats, over the ring's shared memory)
// with the reference's rounding: float weights T(T(acc) + T(bias)), int8
// codes acc * out_scale + bias in float32 (decode_common.cuh logit_tile).
// Rows >= R hold garbage and are never read.
template <typename T16>
__device__ __forceinline__ void logit_tile_tc(
    const TtOps<T16>& op, const float* __restrict__ bias,
    const float* __restrict__ out_scale, int m0, int n0, unsigned char* smem) {
  float acc[2][4][4], unused[2][4][4];
  tt_mainloop<false>(op, 0, m0, n0, smem, acc, unused);
  __syncthreads();  // every warp is done with the ring
  float(*Ls)[L_TV + 1] = reinterpret_cast<float(*)[L_TV + 1]>(smem);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wr = warp >> 2, wc = warp & 3;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int rr = 32 * wr + 16 * mi + (lane >> 2) + 8 * (i >> 1);
        const int cc = 32 * wc + 8 * ni + 2 * (lane & 3) + (i & 1);
        const int col = n0 + cc;
        const float v = acc[mi][ni][i];
        Ls[rr][cc] =
            out_scale != nullptr
                ? __fadd_rn(__fmul_rn(v, out_scale[col]), bias[col])
                : round_cdt<T16>(__fadd_rn(round_cdt<T16>(v),
                                           round_cdt<T16>(bias[col])));
      }
  __syncthreads();
}

static_assert(TT_BN == L_TV, "a vocab GEMM tile is one partial tile");
static_assert(TT_BM * (L_TV + 1) * 4 <= TT_SMEM, "the logits fit the ring");
static_assert(32 * TT_THREADS * 4 <= TT_SMEM, "a rank's sums fit the ring");

// The operands of the 16-bit decoders (float or int8 weights), as the
// wrappers stage them once per call: the weights as the tile GEMM's B^T
// in T16 (int8 codes widened to bf16, exact), the embedding table as
// T(code * row scale) under int8w; under attention also scratch q (R, A)
// and ctx (R, E).  Meanpool leaves the attention part null (A = F = 0).
template <typename T16>
struct DecTc {
  const float* gx;                 // (R, 4H) float32
  const T16* emb;                  // (V, E)
  const T16* wcat_t;               // (4H, K) [W_x ; (W_ctx ;) W_h]^T
  const T16* att_wh_t;             // (A, H)
  const T16* w_out_t;              // (Vp, H)
  const float* bias;               // (Vp,) the decode-policy bias
  const float* lstm_s;             // (4H,) int8w scales, or all null
  const float* att_s;              // (A,)
  const float* out_s;              // (Vp,)
  const T16* att_v;                // (A,)
  const T16* proj;                 // (B, F, A) per video
  const float* mask;               // (B, F)
  const T16* vals;                 // (B, F, E)
  T16* q;                          // (R, A) scratch
  T16* ctx;                        // (R, E) scratch
  int E, H, A, F;
  int sms;                         // the card's SMs (dec_tc_prepare)
};

// The widths the tensor-core chain takes (rows of whole 16-byte chunks,
// k splits on 32-deep chunks) and, under attention, its shared-memory
// plans.
static bool dec_tc_widths_ok(int E, int H) {
  return E >= 32 && H >= 32 && E % 32 == 0 && H % 32 == 0;
}
template <typename T16>
static bool dec_tc_shapes_ok(int E, int H, int A, int F) {
  return dec_tc_widths_ok(E, H) && A >= 32 && F >= 1 && A % 32 == 0 &&
         att_fwd_smem<T16>(F, A) <= 232448;
}

// The call's one-time work: the kernels' shared-memory limits and the SM
// count.
template <typename T16>
static cudaError_t dec_tc_prepare(DecTc<T16>& d) {
  int dev = 0;
  cudaError_t e;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&d.sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess ||
      (e = set_smem((const void*)dec_gate_tc_kernel<T16>, TT_SMEM)) !=
          cudaSuccess)
    return e;
  if (d.A == 0) return cudaSuccess;
  if ((e = set_smem((const void*)att_query_tc_kernel<T16>, TT_SMEM)) !=
          cudaSuccess ||
      (e = set_smem((const void*)att_fwd_step_kernel<T16, 1>,
                    att_fwd_smem<T16, 1>(d.F, d.A))) != cudaSuccess ||
      (e = set_smem((const void*)att_fwd_step_kernel<T16, AT_ROWS>,
                    att_fwd_smem<T16, AT_ROWS>(d.F, d.A))) != cudaSuccess)
    return e;
  return cudaSuccess;
}

// The gate GEMM with the update (dec_gate_tc_kernel) over gop, an operand
// of nsrc sources, R rows.  Split K by source (clusters of nsrc) only
// where even then the grid leaves SMs idle: for the attention operand at
// R = 64 it halves the step's gate time, at R = 320 and 1,280 it costs
// time.
template <typename T16>
static cudaError_t dec_gate_launch(const DecTc<T16>& d, const TtOps<T16>& gop,
                                   int nsrc, const float* c_in, float* c_out,
                                   T16* h_out, int R, cudaStream_t st) {
  const int H = d.H;
  const int mt = (R + TT_BM - 1) / TT_BM;
  const int tiles = 4 * H / TT_BN * mt;
  const int nsplit = nsrc * tiles <= d.sms ? nsrc : 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(4 * H / TT_BN, mt, nsplit);
  cfg.blockDim = dim3(TT_THREADS);
  cfg.dynamicSmemBytes = TT_SMEM;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = nsplit;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, dec_gate_tc_kernel<T16>, gop, d.gx,
                            d.lstm_s, c_in, c_out, h_out, H);
}

// The attention step of a 16-bit decode (dec_tc_step's three launches).
template <typename T16>
static cudaError_t dec_att_step(const DecTc<T16>& d, const T16* h,
                                const int* tok, const float* c_in,
                                float* c_out, T16* h_out, int R, int rep,
                                cudaStream_t st) {
  const int E = d.E, H = d.H, A = d.A;
  const int mt = (R + TT_BM - 1) / TT_BM;
  const TtOps<T16> qop{h, H, nullptr, 0, H, d.att_wh_t, H, R, A, H};
  att_query_tc_kernel<T16><<<dim3((A + TT_BN - 1) / TT_BN, mt), TT_THREADS,
                             TT_SMEM, st>>>(qop, d.att_s, d.q, A);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  if (rep == 1)
    att_fwd_step_kernel<T16, 1>
        <<<R, THREADS, att_fwd_smem<T16, 1>(d.F, A), st>>>(
            d.q, d.att_v, d.proj, d.mask, d.vals, 1, 1, d.F, A, E, d.ctx,
            nullptr, 0);
  else {
    const int groups = (rep + AT_ROWS - 1) / AT_ROWS;
    att_fwd_step_kernel<T16, AT_ROWS>
        <<<(R / rep) * groups, THREADS, att_fwd_smem<T16, AT_ROWS>(d.F, A),
           st>>>(d.q, d.att_v, d.proj, d.mask, d.vals, rep, groups, d.F, A,
                 E, d.ctx, nullptr, 0);
  }
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  TtOps<T16> gop{d.emb, E, d.ctx, E, E, d.wcat_t, 2 * E + H, R, 4 * H,
                 2 * E + H};
  gop.a2 = h;
  gop.lda2 = H;
  gop.K1 = 2 * E;
  gop.rows0 = tok;
  return dec_gate_launch(d, gop, 3, c_in, c_out, h_out, R, st);
}

// One decode step up to the new state.  Meanpool (d.A == 0): one
// launch, the gate GEMM with the update over [emb(tok) | T(h)] (the
// static context is in gx).  Attention: three launches, the
// query T(T(h) @ att_wh [* att_s]), the attention step per video (row r
// reads video r / rep; AT_ROWS rows a block, or one at rep = 1) and the
// gate GEMM over [emb(tok) | T(ctx) | T(h)].  h (R, H) T16 is the state,
// tok (R,) the fed tokens; c_in / c_out, h_out as dec_gate_tc_kernel.
template <typename T16>
static cudaError_t dec_tc_step(const DecTc<T16>& d, const T16* h,
                               const int* tok, const float* c_in,
                               float* c_out, T16* h_out, int R, int rep,
                               cudaStream_t st) {
  if (d.A == 0) {
    const int E = d.E, H = d.H;
    TtOps<T16> gop{d.emb, E, h, H, E, d.wcat_t, E + H, R, 4 * H, E + H};
    gop.rows0 = tok;
    return dec_gate_launch(d, gop, 2, c_in, c_out, h_out, R, st);
  }
  return dec_att_step(d, h, tok, c_in, c_out, h_out, R, rep, st);
}

// The vocab tile GEMM's operand for state h (R, H) T16.
template <typename T16>
static TtOps<T16> dec_vocab_op(const DecTc<T16>& d, const T16* h, int R,
                               int Vp) {
  return TtOps<T16>{h, d.H, nullptr, 0, d.H, d.w_out_t, d.H, R, Vp, d.H};
}

}  // namespace cstk
