// kNN neighbourhood moments of a point cloud for Hopper (sm_90a), float32.
//
// Replaces the TPU kernel `knn_moments_pallas`
// (mlsp_tpu/ops/pallas/normals_pallas.py, body `_moments_kernel`): for
// points x [B, N, 3], over each point's k nearest points (self included,
// K1's selection and tie rule),
//     s1 = Σ_j x_j           [B, N, 3]
//     s2 = Σ_j x_j x_jᵀ      [B, N, 9], row-major 3x3,
// from which `estimate_normals` forms the covariance s2/k − μμᵀ.
//
// Bound: operations. The selection is K1's brute force over all pairs,
// B·N²·(2·3 + 4) float32 operations; the bytes are x once and the twelve
// sums once. The sums themselves are 12·k FMAs per point.
//
// Design: the TPU kernel built a {0,1} selection mask and reduced with two
// mask matmuls because Mosaic has no in-kernel gather. Here the selection
// is `knn_topk::select` (knn_topk.cuh), included from knn.cu's own body,
// so the neighbour SET is exactly K1's; afterwards each thread reads the
// coordinates of its k neighbours (L1/L2-resident: a cloud is 12 KB) and
// accumulates the twelve sums in ascending-distance order. The indices
// never reach device memory unless the caller asks for them (`idx_out`,
// for checking).

#include "knn_topk.cuh"

namespace {

using knn_topk::QT;

template <int KMAX>
__global__ void __launch_bounds__(QT)
knn_moments_kernel(const float* __restrict__ x, float* __restrict__ s1,
                   float* __restrict__ s2, int64_t* __restrict__ idx_out,
                   int N, int k) {
  extern __shared__ float smem[];
  const int t = threadIdx.x;
  const int q0 = blockIdx.x * QT;
  const int nq = min(QT, N - q0);
  const float* xb = x + (size_t)blockIdx.y * N * 3;

  float best_d[KMAX];
  int best_i[KMAX];
  knn_topk::select<KMAX>(xb, N, 3, q0, nq, smem, best_d, best_i);
  if (t >= nq) return;

  const size_t row = (size_t)blockIdx.y * N + q0 + t;
  float a0 = 0.f, a1 = 0.f, a2 = 0.f;
  float m00 = 0.f, m01 = 0.f, m02 = 0.f, m11 = 0.f, m12 = 0.f, m22 = 0.f;
#pragma unroll
  for (int i = 0; i < KMAX; ++i) {
    if (i < k) {
      const float* p = xb + (size_t)best_i[i] * 3;
      const float p0 = p[0], p1 = p[1], p2 = p[2];
      a0 += p0;
      a1 += p1;
      a2 += p2;
      m00 = fmaf(p0, p0, m00);
      m01 = fmaf(p0, p1, m01);
      m02 = fmaf(p0, p2, m02);
      m11 = fmaf(p1, p1, m11);
      m12 = fmaf(p1, p2, m12);
      m22 = fmaf(p2, p2, m22);
      if (idx_out != nullptr) idx_out[row * k + i] = best_i[i];
    }
  }
  float* o1 = s1 + row * 3;
  o1[0] = a0;
  o1[1] = a1;
  o1[2] = a2;
  float* o2 = s2 + row * 9;  // symmetric: the lower triangle repeats
  o2[0] = m00;
  o2[1] = m01;
  o2[2] = m02;
  o2[3] = m01;
  o2[4] = m11;
  o2[5] = m12;
  o2[6] = m02;
  o2[7] = m12;
  o2[8] = m22;
}

template <int KMAX>
cudaError_t launch(const float* x, float* s1, float* s2, int64_t* idx_out,
                   int B, int N, int k, cudaStream_t stream) {
  const size_t smem = knn_topk::smem_bytes(3);
  cudaError_t err = cudaFuncSetAttribute(
      knn_moments_kernel<KMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + QT - 1) / QT, B);
  knn_moments_kernel<KMAX><<<grid, QT, smem, stream>>>(x, s1, s2, idx_out,
                                                       N, k);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x: [B, N, 3] float32; s1: [B, N, 3], s2: [B, N, 9] float32; idx_out:
// [B, N, k] int64 or null. All contiguous. Launches on `stream` and
// returns the launch status (0 = cudaSuccess).
int mlsp_knn_moments(const float* x, float* s1, float* s2, int64_t* idx_out,
                     int B, int N, int k, cudaStream_t stream) {
  if (B <= 0 || N <= 0 || k <= 0 || k > N || k > 32)
    return (int)cudaErrorInvalidValue;
  return (int)KNN_TOPK_DISPATCH(k, launch, x, s1, s2, idx_out, B, N, k,
                                stream);
}

const char* mlsp_knn_moments_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}

}  // extern "C"
