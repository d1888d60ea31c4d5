// Pieces shared by the context attention step (context_attention.cu) and
// its backward (context_attention_bwd.cu): one video per thread-block
// cluster, its tensors staged once into the cluster's shared memory.
//
// A call over B videos launches B clusters of S CTAs (S at most 8, the
// portable cluster size).  Rank k of a video's cluster owns an even share
// of the video's frames and of its columns (span()), stages that share
// of att_proj / att_vals with 16-byte cp.async copies, and writes what
// crosses the split (the forward's scores, the backward's da) into every
// rank's shared memory (distributed shared memory), before one cluster
// barrier.  Every sum of a row is taken whole by one
// warp or one thread of one CTA in an order that does not depend on S,
// rep, R or which CTA holds it, so each row's bits are the same whatever
// the split: the property the slot loop's row invariance and "rep
// bitwise the gathered layout" hold.
//
// S: the smallest count at which B x S fills the card's SMs (2 at B = 64
// on 132 SMs, 8 at B <= 16), raised until a CTA's share of the video
// fits in shared memory (float32 at S = 1 does not: att_proj and
// att_vals alone are 229,376 bytes at F = 56, A = E = 512).
#pragma once

#include <cooperative_groups.h>
#include <mutex>

#include "attention_tc.cuh"

namespace cstk {

constexpr int CTX_MAX_CLUSTER = 8;
constexpr size_t CTX_MAX_SMEM = 232448;  // a block's shared memory, H100
// 32 warps a CTA: one CTA an SM at the main shapes, and its chains of
// dependent adds and table lookups need the warps to hide their latency
// (16 read no faster at 64 videos, and slower at 320 with two CTAs an SM).
constexpr int CTX_THREADS = 1024;
constexpr int CTX_WARPS = CTX_THREADS / 32;
// The forward at rep = 1 over at least as many videos as SMs streams its
// operands (context_attention.cu) in CTAs of 256 threads, several an SM.
constexpr int CTX_STREAM_THREADS = 256;
constexpr int CTX_ROWS = 4;  // rows a warp's score (or da) takes at once

// Start of part k of n items split into `parts` even parts.
__host__ __device__ __forceinline__ int span(int n, int parts, int k) {
  return (int)((long long)n * k / parts);
}
// The largest part of that split.
__host__ __device__ __forceinline__ int span_max(int n, int parts) {
  return (n + parts - 1) / parts;
}

__host__ __device__ __forceinline__ size_t align16(size_t x) {
  return (x + 15) & ~(size_t)15;
}

// Cluster barrier halves: arrive (release this CTA's shared-memory
// writes, its own and those into the other CTAs') and wait (acquire the
// other CTAs').  Every thread calls both, in turn.  A kernel arrives once
// at its start and waits before its first write into another CTA, which
// must have started (the CUDA programming guide's rule for distributed
// shared memory).
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// rows x row_bytes from global (row stride src_ld bytes) to shared (row
// stride dst_ld bytes), 16-byte cp.async chunks spread over the block.
// Every address and length is a multiple of 16.
__device__ __forceinline__ void stage_rows(void* dst, size_t dst_ld,
                                           const void* src, size_t src_ld,
                                           int rows, int row_bytes) {
  const int per_row = row_bytes / 16;
  for (int i = threadIdx.x; i < rows * per_row; i += blockDim.x) {
    const int r = i / per_row, c = i - r * per_row;
    cp_async16(static_cast<char*>(dst) + r * dst_ld + 16 * c,
               static_cast<const char*>(src) + r * src_ld + 16 * c);
  }
}

// Eight consecutive elements of T from shared memory (16-byte aligned),
// as floats.
__device__ __forceinline__ void lds8(const __nv_bfloat16* p, float (&x)[8]) {
  unpack8<__nv_bfloat16>(*reinterpret_cast<const uint4*>(p), x);
}
__device__ __forceinline__ void lds8(const __half* p, float (&x)[8]) {
  unpack8<__half>(*reinterpret_cast<const uint4*>(p), x);
}
__device__ __forceinline__ void lds8(const float* p, float (&x)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  x[0] = a.x;
  x[1] = a.y;
  x[2] = a.z;
  x[3] = a.w;
  x[4] = b.x;
  x[5] = b.y;
  x[6] = b.z;
  x[7] = b.w;
}

// Eight floats stored as T (rounded once under bf16 and f16) to global
// memory.
__device__ __forceinline__ void st8(__nv_bfloat16* p, const float (&x)[8]) {
  *reinterpret_cast<uint4*>(p) = pack8<__nv_bfloat16>(x);
}
__device__ __forceinline__ void st8(__half* p, const float (&x)[8]) {
  *reinterpret_cast<uint4*>(p) = pack8<__half>(x);
}
__device__ __forceinline__ void st8(float* p, const float (&x)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(x[0], x[1], x[2], x[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(x[4], x[5], x[6], x[7]);
}

// Row block j of a video's rep rows split into blocks of at most
// CTX_ROWS, even to within one row: [row_block(rep, j), row_block(rep,
// j + 1)).  A warp's score or da takes one block at once, one sum a row.
__host__ __device__ __forceinline__ int row_blocks(int rep) {
  return (rep + CTX_ROWS - 1) / CTX_ROWS;
}

// tanhf of the bf16 tanh arguments (f16 evaluates attention_tc.cuh's
// tanh_direct and holds no table): attention_tc.cuh's table
// (tanh_table_fill, looked up by tanh_t; attlstm_recurrence.cu's
// tanh_table_check_kernel holds it to tanhf on every bf16 value), filled
// once per device into g_tanh_table (tanh_table_ready).  Each CTA copies
// it into shared memory with its operands (cp.async, 22 KiB), so no CTA
// evaluates tanhf for it.
__device__ __align__(16) float g_tanh_table[2 * TB_SPAN];

__global__ void tanh_table_init_kernel() { tanh_table_fill(g_tanh_table); }

// Fill g_tanh_table on the current device, once, and wait for it (later
// calls may come on other streams).  Under a mutex: replica workers call
// from several host threads, and a caller that finds the flag set must
// find the fill finished, not merely launched.
static cudaError_t tanh_table_ready(cudaStream_t st) {
  static std::mutex mu;
  static bool ready[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || dev >= 64) return e == cudaSuccess ? cudaErrorInvalidDevice : e;
  std::lock_guard<std::mutex> lock(mu);
  if (ready[dev]) return cudaSuccess;
  tanh_table_init_kernel<<<1, CTX_THREADS, 0, st>>>();
  if ((e = cudaGetLastError()) == cudaSuccess &&
      (e = cudaStreamSynchronize(st)) == cudaSuccess)
    ready[dev] = true;
  return e;
}

// The SM count of the current device.
static int device_sms() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 132;
  return sms;
}

// The cluster size for B videos: see the header.  smem(S) is a CTA's
// shared memory at size S (non-increasing in S).  Returns 0 when even
// CTX_MAX_CLUSTER CTAs do not fit.
template <typename Smem>
static int cluster_size(int B, Smem smem) {
  int S = device_sms() / B;
  S = S < 1 ? 1 : (S > CTX_MAX_CLUSTER ? CTX_MAX_CLUSTER : S);
  while (S < CTX_MAX_CLUSTER && smem(S) > CTX_MAX_SMEM) ++S;
  return smem(S) > CTX_MAX_SMEM ? 0 : S;
}

// Launch `kern` over B clusters of S CTAs of `threads` threads.
template <typename... KArgs, typename... Args>
static cudaError_t launch_clusters(void (*kern)(KArgs...), int B, int S,
                                   int threads, size_t smem, cudaStream_t st,
                                   Args... args) {
  cudaError_t e = set_smem((const void*)kern, smem);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * S);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kern, args...);
}

}  // namespace cstk
