// Brute-force kNN graph for Hopper (sm_90a), float32.
//
// Replaces the TPU kernel `knn_pallas` (mlsp_tpu/ops/pallas/knn_pallas.py,
// body `_knn_kernel`): for x [B, N, C] float32 and a query range
// [q0, q0 + nq) (the whole cloud: q0 = 0, nq = N), the int64 [B, nq, k]
// indices of each query's k nearest points of the whole cloud, self
// included, ascending distance, equal distances ordered by the lower index.
// A range's rows are index-equal to the same rows of a whole launch: a
// points mesh (parallel/mesh.py) gives each rank its own rows. The
// selection itself is `knn_topk::select` (knn_topk.cuh), shared with
// knn_moments.cu.
//
// Bound: operations, B·nq·N·(2C + 4): the distance products in plain float32
// on the CUDA cores (TF32 tensor cores would round the products and
// reorder near ties, which downstream layers consume) and forming, clamping
// and comparing each distance. Bytes moved are tiny (x once, the indices
// once).
//
// Design: one block of 1-8 warps per (cloud, tile of 8 queries a warp of
// the range, 4 for the smallest grids, from q0), on one flat grid axis, so
// any batch launches (2^31 - 1 blocks); each warp forms its queries'
// distances in registers and filters them there against each query's
// threshold (the distance of its k-th key so far), so only the few
// candidates that pass reach shared memory, as 64-bit (distance bits,
// index) keys, and warp bitonic sorts merge them into each query's sorted
// list (knn_topk.cuh: the filter, its seed, the occupancy and the tiling,
// which the launcher takes from B, nq and C). The warp's lane i writes the i-th index. `mlsp_knn_stats` runs
// the same body with counters of the filter's passes and flushes: a second
// kernel (`knn_stats_kernel`), which the main path never launches.

#include "knn_topk.cuh"

namespace {

// The body of both kernels: the main path's and the counting one's.
template <bool COUNT>
__device__ __forceinline__ void knn_body(const float* __restrict__ x,
                                         int64_t* __restrict__ out, int N,
                                         int C, int k, int q0, int nq,
                                         int qw, unsigned long long* stats) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  // one flat grid axis: block = cloud * tiles + query tile (gridDim.x
  // takes 2^31 - 1 blocks, where gridDim.y would stop at 65535 clouds)
  const int qb = qw * (blockDim.x >> 5);
  const int tiles = (nq + qb - 1) / qb;
  const int64_t b = blockIdx.x / tiles;
  const int tile = blockIdx.x - (int)b * tiles;
  const float* xb = x + b * N * C;
  int64_t* ob = out + b * nq * k;
  auto emit = [&](int q, knn_topk::key_t key) {
    if (lane < k) ob[(size_t)(q - q0) * k + lane] = (int64_t)(uint32_t)key;
  };
  unsigned long long* st = COUNT ? stats + 2 * (size_t)blockIdx.x : nullptr;
  if (qw == knn_topk::QW)
    knn_topk::select<COUNT, knn_topk::QW>(xb, N, C, k, q0 + tile * qb,
                                          q0 + nq, smem, emit, st);
  else
    knn_topk::select<COUNT, knn_topk::QW / 2>(xb, N, C, k, q0 + tile * qb,
                                              q0 + nq, smem, emit, st);
}

__global__ void __launch_bounds__(knn_topk::MAX_THREADS, 2)
knn_kernel(const float* __restrict__ x, int64_t* __restrict__ out, int N,
           int C, int k, int q0, int nq, int qw) {
  knn_body<false>(x, out, N, C, k, q0, nq, qw, nullptr);
}

// The same body counting, per block, the candidates that passed the
// register filter and the buffer flushes: `mlsp_knn_stats` only.
__global__ void __launch_bounds__(knn_topk::MAX_THREADS, 2)
knn_stats_kernel(const float* __restrict__ x, int64_t* __restrict__ out,
                 int N, int C, int k, int q0, int nq,
                 unsigned long long* __restrict__ stats, int qw) {
  knn_body<true>(x, out, N, C, k, q0, nq, qw, stats);
}

template <class Kernel, class... Args>
int launch(Kernel kernel, int B, int N, int C, int k, int q0, int nq,
           cudaStream_t stream, Args... args) {
  if (B <= 0 || N <= 0 || C <= 0 || k <= 0 || k > N || k > 32 || q0 < 0 ||
      nq <= 0 || nq > N - q0)
    return (int)cudaErrorInvalidValue;
  const knn_topk::Shape s = knn_topk::shape(B, nq, C, knn_topk::sm_count());
  if (s.warps == 0) return (int)cudaErrorInvalidValue;
  if (s.blocks > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s.smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)s.blocks, 32 * s.warps, s.smem, stream>>>(args...,
                                                               s.qw);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory a launch needs for C channels at the least tiling
// (one warp a block): above the card's limit, C is refused.
size_t mlsp_knn_smem_bytes(int C) { return knn_topk::smem_bytes(C, 1); }

// Blocks of a launch for B clouds, nq queries each and C channels: the
// rows of `mlsp_knn_stats`'s counters.
long long mlsp_knn_blocks(int B, int nq, int C) {
  return knn_topk::shape(B, nq, C, knn_topk::sm_count()).blocks;
}

// x: [B, N, C] float32 contiguous; out: [B, nq, k] int64, the queries
// [q0, q0 + nq) of every cloud. Launches on `stream` and returns the
// launch status (0 = cudaSuccess).
int mlsp_knn(const float* x, int64_t* out, int B, int N, int C, int k,
             int q0, int nq, cudaStream_t stream) {
  return launch(knn_kernel, B, N, C, k, q0, nq, stream, x, out, N, C, k, q0,
                nq);
}

// The same indices, and per block (mlsp_knn_blocks rows) the candidates
// that passed the register filter and the flushes, added to stats [blocks,
// 2], which the caller zeroes.
int mlsp_knn_stats(const float* x, int64_t* out, unsigned long long* stats,
                   int B, int N, int C, int k, int q0, int nq,
                   cudaStream_t stream) {
  return launch(knn_stats_kernel, B, N, C, k, q0, nq, stream, x, out, N, C,
                k, q0, nq, stats);
}

const char* mlsp_knn_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}

}  // extern "C"
