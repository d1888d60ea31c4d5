// Teacher-forced LSTM recurrence for Hopper (sm_90a).
//
// Replaces the TPU kernel of the JAX package, ops/pallas_lstm.py::
// lstm_recurrence_pallas (pallas_call with _make_kernel(with_cell)), the
// forward of ops/pallas_lstm.py::lstm_recurrence.  Same function: R rows
// from zero state over T steps of precomputed input gates gx (R, T, 4H)
// float32.  Per step gates = gx[:, t] + T(h) @ W_h, with h rounded to the
// compute dtype T, products accumulated in float32 from zero and ONE
// float32 add of gx (the TPU kernel's association, not the decoders'
// three-term sum); then the i|f|g|o update with a float32 cell.  h_seq[:,
// t] is written in T and, with a cell output, c_seq[:, t] in float32 (the
// backward's residual).
//
// Bound on the H100: bytes.  At the XE shape (bf16, R = 1280, T = 29,
// H = 512) the call must read gx (304 MB) and W_h (2 MB) and write h_seq
// (38 MB) and c_seq (76 MB): 420 MB, 0.125 ms at 3.35 TB/s; its 77.8
// GFLOP of recurrent products need 0.079 ms on the tensor cores.  But
// every product here is one ascending-k fmaf chain per output, the plain
// version's own order (cuBLAS sgemm on the rounded operands): the float32
// and bf16 checks hold the kernel to it bitwise, and no other order stays
// inside the bf16 cell tolerance (PERF.md §6: even the exact product
// leaves it).  So the floor that binds is the float32 FMA rate: 1.16 ms
// on 132 SMs, 1.37 ms on the 112 that the clusters below hold.
//
// Design, bf16 compute: one persistent launch.  The recurrence never
// mixes rows, so the rows split into one block per thread-block cluster
// of H / 32 CTAs (16 at H = 512, a non-portable cluster size), and the
// clusters never talk to each other.  Each CTA of a cluster owns 32
// hidden units with all four gates (128 columns of W_h), so the gate
// update stays inside the CTA; its W_h slice is staged once, as bf16
// (128 KiB at H = 512), and stays in shared memory for all T steps.  The
// h each CTA needs is the bf16 h_seq[:, t-1] that its peers just wrote: a
// cluster barrier (release / acquire) per step makes the step's h_seq
// writes visible, and the next step reads them through L2 (ld.global.cg,
// never a stale L1 line).  Per step the CTA takes its cluster's rows in
// sub-tiles of 192 (one at R = 1,280: 7 clusters, up to 192 rows each);
// T(h_{t-1}) streams in 32-deep k chunks, widened to float32 as it is
// staged in a two-chunk ring (the next chunk's loads in flight while
// this one is multiplied).  Each of 12 warps takes 16 rows and each
// thread 8 rows x 2 units x 4 gates: per 4 k, 8 float4 loads of h, 8
// loads of W_h (4 bf16 each, unpacked) and 256 fmaf.  Then the update
// in registers: gx read once from global (prefetched into L2 before the
// product) and the cell from a float32 scratch (R, H) that the thread
// holding a (row, unit) reads and writes, all loads issued before the
// first store.  The cluster count is what the card holds at once
// (cudaOccupancyMaxActiveClusters: 7 clusters of 16, 112 SMs, on the
// H100) and changes no row's arithmetic.
//
// Design, f16 compute: the same persistent kernel instantiated at __half
// (entry dtype 2): W_h resident as f16 (the same 128 KiB), h_seq in f16,
// each f16 value widened to float32 exactly as it is staged; the cell and
// every sum stay float32 in the same ascending-k fmaf chain, so the plain
// version's order holds at f16 as it does at bf16 (an f16 x f16 product
// is exact in float32 too).  The same bound.
//
// Design, float32 compute: the first design, kept (its W_h slice, 256 KiB
// per 32 units, does not fit beside h): the host loops over T, one launch
// per step on the caller's stream, each decode_common.cuh's
// lstm_rec_step_kernel (the decoders' gate GEMM, h term only) over a tile
// of 32 rows x 32 hidden units x 4 gates, the same ascending-k fmaf chain;
// the float32 h state ping-pongs between two buffers and the cell updates
// in place.
//
// int8w (entry with wq = 1): also replaces pallas_lstm.py::
// lstm_recurrence_quant (the same pallas_call with _make_kernel(quant=
// True)).  W_h arrives as int8 codes with the (4H,) float32 column scale;
// the codes are widened to bf16 as the slice is staged (exact, |code| <=
// 127) and the scale multiplies the float32 sum once, before the gx add:
// gates = gx_t + (T(h) @ T(codes)) * scale.  Forward only, no cell
// output.  Bound: bytes, as the float kernel (gx 304 MB + h_seq 38 MB +
// W_h 1 MB at the XE shape, 0.103 ms).  With float32 compute it is the
// step kernel instantiated with WT = int8_t.
#include "decode_common.cuh"

namespace cstk {

// ---------------------------------------------------------------- float32

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

// ------------------------------------------- bf16 and f16, persistent

constexpr int RC_UNITS = 32;     // hidden units per CTA (x 4 gates)
constexpr int RC_TR = 8;         // rows per thread (x 2 units x 4 gates)
constexpr int RC_ROWS = 192;     // rows per sub-tile: 12 warps x 16 rows
constexpr int RC_THREADS = 2 * RC_ROWS;
constexpr int RC_MAX_H = 512;    // cluster of H / 32 <= 16 CTAs
constexpr int RC_KC = 32;        // k per staged chunk of h
constexpr int RC_ALD = RC_KC + 4;  // padded float row of a chunk
constexpr int RC_LOADS = RC_ROWS * RC_KC / 8 / RC_THREADS;  // 16 B each

// Dynamic shared memory of one CTA: the W_h slice in the compute dtype T16
// (bf16 or f16), 8 bytes (k..k+3) per (k / 4, gate, unit), then two
// float32 chunks of h (192 rows x RC_KC k).
__host__ __device__ constexpr int rc_smem_bytes(int H) {
  return H * 4 * RC_UNITS * 2 + 2 * RC_ROWS * RC_ALD * 4;
}

__device__ __forceinline__ void cluster_barrier() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Four T16 values (8 bytes, k ascending) as floats, exactly.
template <typename T16>
__device__ __forceinline__ void unpack4(uint2 v, float (&f)[4]);
template <>
__device__ __forceinline__ void unpack4<__nv_bfloat16>(uint2 v,
                                                       float (&f)[4]) {
  f[0] = __uint_as_float(v.x << 16);
  f[1] = __uint_as_float(v.x & 0xffff0000u);
  f[2] = __uint_as_float(v.y << 16);
  f[3] = __uint_as_float(v.y & 0xffff0000u);
}
template <>
__device__ __forceinline__ void unpack4<__half>(uint2 v, float (&f)[4]) {
  f[0] = __half2float(__ushort_as_half((unsigned short)(v.x & 0xffffu)));
  f[1] = __half2float(__ushort_as_half((unsigned short)(v.x >> 16)));
  f[2] = __half2float(__ushort_as_half((unsigned short)(v.y & 0xffffu)));
  f[3] = __half2float(__ushort_as_half((unsigned short)(v.y >> 16)));
}

// This thread's share of chunk c of T(h_{t-1}) for the sub-tile at r0:
// RC_LOADS 16-byte loads from L2 (rows past nr left zero).
template <typename T16>
__device__ __forceinline__ void load_chunk(uint4 (&raw)[RC_LOADS],
                                           const T16* h_prev,
                                           long long ld, int nr, int c) {
#pragma unroll
  for (int j = 0; j < RC_LOADS; ++j) {
    const int i = threadIdx.x + j * RC_THREADS;
    const int row = i / (RC_KC / 8), k = RC_KC * c + 8 * (i % (RC_KC / 8));
    raw[j] = row < nr ? __ldcg(reinterpret_cast<const uint4*>(
                            h_prev + row * ld + k))
                      : make_uint4(0, 0, 0, 0);
  }
}

// ... and its float32 values into a chunk buffer.
template <typename T16>
__device__ __forceinline__ void store_chunk(const uint4 (&raw)[RC_LOADS],
                                            float* a) {
#pragma unroll
  for (int j = 0; j < RC_LOADS; ++j) {
    const int i = threadIdx.x + j * RC_THREADS;
    float* d = a + (i / (RC_KC / 8)) * RC_ALD + 8 * (i % (RC_KC / 8));
    float f[4];
    unpack4<T16>(make_uint2(raw[j].x, raw[j].y), f);
    *reinterpret_cast<float4*>(d) = make_float4(f[0], f[1], f[2], f[3]);
    unpack4<T16>(make_uint2(raw[j].z, raw[j].w), f);
    *reinterpret_cast<float4*>(d + 4) = make_float4(f[0], f[1], f[2], f[3]);
  }
}

// CTA b of the grid is rank b % (H / 32) of cluster b / (H / 32): hidden
// units [32 rank, 32 rank + 32) of rows [cluster * rows_per_cluster, ...).
// Thread (warp w, lane l) holds rows 16w + l / 16 + 2r (r = 0..7) of the
// sub-tile, so the two half-warps read neighbouring rows (other banks),
// and units l % 16 and l % 16 + 16, four gates each.  c_state (R, H)
// float32 scratch, need not be zeroed; c_seq may be null.  T16: the
// compute dtype of W_h's slice and h_seq; WT: W_h as given (T16, or int8
// codes at bf16).
template <typename T16, typename WT>
__global__ void __launch_bounds__(RC_THREADS, 1) lstm_rec_cluster_kernel(
    const float* __restrict__ gx, const WT* __restrict__ wh,
    const float* __restrict__ wh_s, float* __restrict__ c_state,
    T16* h_seq, float* __restrict__ c_seq, int R, int T_, int H,
    int rows_per_cluster) {
  extern __shared__ __align__(16) unsigned char rc_smem[];
  T16* ws = reinterpret_cast<T16*>(rc_smem);
  float* abuf = reinterpret_cast<float*>(rc_smem + H * 4 * RC_UNITS * 2);
  const uint2* w8 = reinterpret_cast<const uint2*>(ws);

  const int ncta = H / RC_UNITS;
  const int j0 = (blockIdx.x % ncta) * RC_UNITS;
  const int rbeg = (blockIdx.x / ncta) * rows_per_cluster;
  const int rend = min(R, rbeg + rows_per_cluster);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int uh = lane & 15;
  const int rt = 16 * warp + (lane >> 4);  // this thread's rows: rt + 2r
  const int H4 = 4 * H;
  const int nch = H / RC_KC;

  // W_h slice, coalesced reads of 32 units of one gate per k.
  for (int i = tid; i < H * 4 * RC_UNITS; i += RC_THREADS) {
    const int k = i / (4 * RC_UNITS), cg = i % (4 * RC_UNITS);
    const int gate = cg / RC_UNITS, uu = cg % RC_UNITS;
    const float w = to_f(wh[(size_t)k * H4 + gate * H + j0 + uu]);
    store_cdt<T16>(ws + ((((k >> 2) * 4 + gate) * RC_UNITS + uu) << 2) +
                       (k & 3),
                   w);
  }
  float qsc[2][4];
#pragma unroll
  for (int e = 0; e < 2; ++e)
#pragma unroll
    for (int q = 0; q < 4; ++q)
      qsc[e][q] = kQuant<WT> ? wh_s[q * H + j0 + uh + 16 * e] : 1.f;
  __syncthreads();

  for (int t = 0; t < T_; ++t) {
    for (int r0 = rbeg; r0 < rend; r0 += RC_ROWS) {
      const int nr = min(RC_ROWS, rend - r0);
      // gx[:, t] of the sub-tile into L2 while the product runs.
      for (int i = tid; i < RC_ROWS * 4; i += RC_THREADS)
        if (i / 4 < nr)
          asm volatile("prefetch.global.L2 [%0];" ::"l"(
              gx + ((size_t)(r0 + i / 4) * T_ + t) * H4 + (i % 4) * H + j0));

      float acc[RC_TR][2][4];
#pragma unroll
      for (int r = 0; r < RC_TR; ++r)
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[r][e][q] = 0.f;
      if (t > 0) {
        // T(h_{t-1}) streams from L2 in RC_KC-deep chunks, widened to
        // float32 as it is staged: chunk c + 1 is loaded into registers
        // while chunk c is multiplied.
        const T16* h_prev = h_seq + ((size_t)r0 * T_ + t - 1) * H;
        const long long ld = (long long)T_ * H;
        const bool active = 16 * warp < nr;
        uint4 raw[RC_LOADS];
        load_chunk(raw, h_prev, ld, nr, 0);
        store_chunk<T16>(raw, abuf);
        __syncthreads();
        for (int c = 0; c < nch; ++c) {
          const float* a_s = abuf + (c & 1) * RC_ROWS * RC_ALD;
          if (c + 1 < nch) load_chunk(raw, h_prev, ld, nr, c + 1);
          if (active) {
#pragma unroll 2
            for (int kq = 0; kq < RC_KC / 4; ++kq) {
              const int k4 = c * (RC_KC / 4) + kq;
              float b[2][4][4], a[RC_TR][4];
#pragma unroll
              for (int e = 0; e < 2; ++e)
#pragma unroll
                for (int q = 0; q < 4; ++q)
                  unpack4<T16>(w8[(k4 * 4 + q) * RC_UNITS + uh + 16 * e],
                               b[e][q]);
#pragma unroll
              for (int r = 0; r < RC_TR; ++r) {
                const float4 v = *reinterpret_cast<const float4*>(
                    a_s + (rt + 2 * r) * RC_ALD + 4 * kq);
                a[r][0] = v.x;
                a[r][1] = v.y;
                a[r][2] = v.z;
                a[r][3] = v.w;
              }
              // Each output's k ascending: one fmaf chain, the plain order.
#pragma unroll
              for (int kk = 0; kk < 4; ++kk)
#pragma unroll
                for (int r = 0; r < RC_TR; ++r)
#pragma unroll
                  for (int e = 0; e < 2; ++e)
#pragma unroll
                    for (int q = 0; q < 4; ++q)
                      acc[r][e][q] =
                          fmaf(a[r][kk], b[e][q][kk], acc[r][e][q]);
            }
          }
          if (c + 1 < nch)
            store_chunk<T16>(raw, abuf + ((c + 1) & 1) * RC_ROWS * RC_ALD);
          __syncthreads();
        }
      }

      // The update: first every load (gx and the cell of each of the
      // thread's rows, so their latencies overlap), then the stores.
      float cv[RC_TR][2];
#pragma unroll
      for (int r = 0; r < RC_TR; ++r) {
        const int row = r0 + rt + 2 * r;
        const bool ok = row < rend;
        const float* gr = gx + ((size_t)(ok ? row : r0) * T_ + t) * H4 + j0;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int ul = uh + 16 * e;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            float v = acc[r][e][q];
            if constexpr (kQuant<WT>) v = __fmul_rn(v, qsc[e][q]);
            acc[r][e][q] = __fadd_rn(__ldg(gr + q * H + ul), v);
          }
          cv[r][e] = (t > 0 && ok) ? c_state[(size_t)row * H + j0 + ul] : 0.f;
        }
      }
#pragma unroll
      for (int r = 0; r < RC_TR; ++r) {
        const int row = r0 + rt + 2 * r;
        if (row >= rend) continue;
        const size_t step = (size_t)row * T_ + t;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int unit = j0 + uh + 16 * e;
          float c = cv[r][e];
          const float hn = lstm_cell(acc[r][e], c);
          c_state[(size_t)row * H + unit] = c;
          store_cdt<T16>(h_seq + step * H + unit, hn);
          if (c_seq != nullptr) c_seq[step * H + unit] = c;
        }
      }
    }
    cluster_barrier();  // h_seq[:, t] of every CTA visible to the cluster
  }
}

// The launch of R rows: clusters of H / 32 CTAs, as many as the card
// holds at once (at most one per 16 rows), rows_per_cluster a multiple
// of 16.  Fills cfg (grid included) and returns 0, or a CUDA error code.
template <typename T16, typename WT>
static int plan_recurrence_bf16(int R, int H, cudaStream_t st,
                                cudaLaunchConfig_t& cfg,
                                cudaLaunchAttribute* attr, int& clusters,
                                int& rows_per_cluster) {
  if (H % RC_UNITS != 0 || H > RC_MAX_H) return (int)cudaErrorInvalidValue;
  auto kern = lstm_rec_cluster_kernel<T16, WT>;
  const int ncta = H / RC_UNITS;
  const int smem = rc_smem_bytes(H);
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess && ncta > 8)
    e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return (int)e;

  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ncta;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg = {};
  cfg.gridDim = dim3(ncta);
  cfg.blockDim = dim3(RC_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int max_clusters = 0;
  e = cudaOccupancyMaxActiveClusters(&max_clusters, (void*)kern, &cfg);
  if (e != cudaSuccess) return (int)e;
  if (max_clusters < 1) return (int)cudaErrorLaunchOutOfResources;
  const int n_cl = min(max_clusters, (R + 15) / 16);
  rows_per_cluster = ((R + n_cl - 1) / n_cl + 15) / 16 * 16;
  clusters = (R + rows_per_cluster - 1) / rows_per_cluster;
  cfg.gridDim = dim3(clusters * ncta);
  return 0;
}

template <typename T16, typename WT>
static int run_recurrence_bf16(const float* gx, const void* wh,
                               const float* wh_s, float* c, void* h_seq,
                               float* c_seq, int R, int T_, int H,
                               cudaStream_t st) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  int clusters = 0, rows = 0;
  const int err =
      plan_recurrence_bf16<T16, WT>(R, H, st, cfg, attr, clusters, rows);
  if (err != 0) return err;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, lstm_rec_cluster_kernel<T16, WT>, gx, static_cast<const WT*>(wh),
      wh_s, c, static_cast<T16*>(h_seq), c_seq, R, T_, H, rows);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace cstk

// dtype: 0 = float32, 1 = bfloat16, 2 = float16 (h_seq, and W_h unless
// wq).  wq: 1 when W_h holds int8 codes with the (4H,) float32 column
// scale wh_s (int8w, float32 or bfloat16 only; then c_seq must be null),
// else 0 and wh_s null.  gx is (R, T,
// 4H) float32 row-major, W_h (H, 4H), h_seq (R, T, H), c_seq (R, T, H)
// float32 or null, c (R, H) float32 scratch.  float32 runs the per-step
// SIMT kernel (the caller zeroes h_a and c; h_b is scratch); bfloat16 and
// float16 run the persistent cluster kernel (H a multiple of 32, at most
// 512; h_a and h_b unused, c need not be zeroed, gx 16-byte aligned).
// Returns 0 or the CUDA error code of the first refused call.
extern "C" int cst_lstm_recurrence(int dtype, int wq, const void* gx,
                                   const void* wh, const void* wh_s,
                                   void* h_a, void* h_b, void* c,
                                   void* h_seq, void* c_seq, int R, int T,
                                   int H, void* stream) {
  if (R < 1 || T < 1 || H < 1) return (int)cudaErrorInvalidValue;
  if (wq && (wh_s == nullptr || c_seq != nullptr))
    return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  const float* gxf = static_cast<const float*>(gx);
  if (dtype == 1) {
    const float* ws = static_cast<const float*>(wh_s);
    float* cs = static_cast<float*>(c_seq);
    if (wq)
      return cstk::run_recurrence_bf16<__nv_bfloat16, int8_t>(
          gxf, wh, ws, static_cast<float*>(c), h_seq, cs, R, T, H, st);
    return cstk::run_recurrence_bf16<__nv_bfloat16, __nv_bfloat16>(
        gxf, wh, nullptr, static_cast<float*>(c), h_seq, cs, R, T, H, st);
  }
  if (dtype == 2) {
    if (wq) return (int)cudaErrorInvalidValue;
    return cstk::run_recurrence_bf16<__half, __half>(
        gxf, wh, nullptr, static_cast<float*>(c), h_seq,
        static_cast<float*>(c_seq), R, T, H, st);
  }
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  const cstk::QScales qs{nullptr, static_cast<const float*>(wh_s), nullptr};
#define CST_REC_ARGS                                                        \
  gxf, wh, static_cast<float*>(h_a), static_cast<float*>(h_b),              \
      static_cast<float*>(c), h_seq, static_cast<float*>(c_seq), R, T, H, st, \
      qs
  if (wq) return cstk::run_recurrence<float, int8_t>(CST_REC_ARGS);
  return cstk::run_recurrence<float>(CST_REC_ARGS);
#undef CST_REC_ARGS
}

// The 16-bit kernel's launch plan for R rows of width H (the same for
// bfloat16 and float16): out[0] clusters, out[1] CTAs per cluster, out[2]
// rows per cluster.  Returns 0 or a CUDA error code.
extern "C" int cst_lstm_recurrence_plan(int R, int H, int* out) {
  if (R < 1) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  out[1] = H / cstk::RC_UNITS;
  return cstk::plan_recurrence_bf16<__nv_bfloat16, __nv_bfloat16>(
      R, H, 0, cfg, attr, out[0], out[2]);
}
