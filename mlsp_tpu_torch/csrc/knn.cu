// Brute-force kNN graph for Hopper (sm_90a), float32.
//
// Replaces the TPU kernel `knn_pallas` (mlsp_tpu/ops/pallas/knn_pallas.py,
// body `_knn_kernel`): for x [B, N, C] float32, the int64 [B, N, k]
// indices of each point's k nearest points of the same cloud, self
// included, equal distances ordered by the lower index. The selection
// itself is `knn_topk::select` (knn_topk.cuh), shared with knn_moments.cu.
//
// Bound: the distance products, B·N²·C fused multiply-adds, in plain
// float32 on the CUDA cores (TF32 tensor cores would round the products
// and reorder near ties, which downstream layers consume). Bytes moved
// are tiny (x once, the indices once), so the kernel is bound by
// operations: float32 FMAs plus the compare of each distance against the
// current k-th best.
//
// Design (simple first; wgmma/TMA are later work): one block per (cloud,
// tile of 64 queries), one thread per query with a register top-k; see
// knn_topk.cuh.

#include "knn_topk.cuh"

namespace {

using knn_topk::QT;

template <int KMAX>
__global__ void __launch_bounds__(QT)
knn_kernel(const float* __restrict__ x, int64_t* __restrict__ out,
           int N, int C, int k) {
  extern __shared__ float smem[];
  const int t = threadIdx.x;
  const int q0 = blockIdx.x * QT;
  const int nq = min(QT, N - q0);
  const float* xb = x + (size_t)blockIdx.y * N * C;

  float best_d[KMAX];
  int best_i[KMAX];
  knn_topk::select<KMAX>(xb, N, C, q0, nq, smem, best_d, best_i);

  if (t < nq) {
    int64_t* o = out + ((size_t)blockIdx.y * N + q0 + t) * k;
#pragma unroll
    for (int i = 0; i < KMAX; ++i)
      if (i < k) o[i] = best_i[i];
  }
}

template <int KMAX>
cudaError_t launch(const float* x, int64_t* out, int B, int N, int C, int k,
                   cudaStream_t stream) {
  const size_t smem = knn_topk::smem_bytes(C);
  cudaError_t err = cudaFuncSetAttribute(
      knn_kernel<KMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + QT - 1) / QT, B);
  knn_kernel<KMAX><<<grid, QT, smem, stream>>>(x, out, N, C, k);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory a launch needs for C channels.
size_t mlsp_knn_smem_bytes(int C) { return knn_topk::smem_bytes(C); }

// x: [B, N, C] float32 contiguous; out: [B, N, k] int64. Launches on
// `stream` and returns the launch status (0 = cudaSuccess).
int mlsp_knn(const float* x, int64_t* out, int B, int N, int C, int k,
             cudaStream_t stream) {
  if (B <= 0 || N <= 0 || C <= 0 || k <= 0 || k > N || k > 32)
    return (int)cudaErrorInvalidValue;
  return (int)KNN_TOPK_DISPATCH(k, launch, x, out, B, N, C, k, stream);
}

const char* mlsp_knn_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}

}  // extern "C"
