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
// Design: one block of 8 warps per (cloud, tile of 32 queries of the
// range, from q0), on one flat grid axis, so any batch launches (2^31 - 1
// blocks); register-
// tiled distances into a shared-memory tile, then a warp per query selects
// by a threshold, a ballot compaction and warp bitonic sorts on 64-bit
// (distance bits, index) keys, so a candidate costs a compare rather than
// an insertion (knn_topk.cuh). The warp's lane i writes the i-th index.

#include "knn_topk.cuh"

namespace {

using knn_topk::THREADS;

__global__ void __launch_bounds__(THREADS, 2)
knn_kernel(const float* __restrict__ x, int64_t* __restrict__ out, int N,
           int C, int k, int q0, int nq) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  // one flat grid axis: block = cloud * tiles + query tile (gridDim.x
  // takes 2^31 - 1 blocks, where gridDim.y would stop at 65535 clouds)
  const int tiles = (nq + knn_topk::QB - 1) / knn_topk::QB;
  const int64_t b = blockIdx.x / tiles;
  const int tile = blockIdx.x - (int)b * tiles;
  const float* xb = x + b * N * C;
  int64_t* ob = out + b * nq * k;
  knn_topk::select(xb, N, C, k, q0 + tile * knn_topk::QB, q0 + nq, smem,
                   [&](int q, knn_topk::key_t key) {
                     if (lane < k)
                       ob[(size_t)(q - q0) * k + lane] =
                           (int64_t)(uint32_t)key;
                   });
}

}  // namespace

extern "C" {

// Dynamic shared memory a launch needs for C channels.
size_t mlsp_knn_smem_bytes(int C) { return knn_topk::smem_bytes(C); }

// x: [B, N, C] float32 contiguous; out: [B, nq, k] int64, the queries
// [q0, q0 + nq) of every cloud. Launches on `stream` and returns the
// launch status (0 = cudaSuccess).
int mlsp_knn(const float* x, int64_t* out, int B, int N, int C, int k,
             int q0, int nq, cudaStream_t stream) {
  if (B <= 0 || N <= 0 || C <= 0 || k <= 0 || k > N || k > 32 || q0 < 0 ||
      nq <= 0 || nq > N - q0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = knn_topk::smem_bytes(C);
  cudaError_t err = cudaFuncSetAttribute(
      knn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int64_t blocks = (int64_t)B * ((nq + knn_topk::QB - 1) / knn_topk::QB);
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  knn_kernel<<<(unsigned)blocks, THREADS, smem, stream>>>(x, out, N, C, k, q0,
                                                          nq);
  return (int)cudaGetLastError();
}

const char* mlsp_knn_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}

}  // extern "C"
