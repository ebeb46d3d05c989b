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
// is `knn_topk::select` (knn_topk.cuh), the body K1 runs, so the neighbour
// SET and its order are exactly K1's; afterwards the warp that owns a
// query holds its k neighbours' keys one per lane, each lane loads its
// neighbour's coordinates (L1/L2-resident: a cloud is 12 KB), and lanes
// 0..8 each accumulate one of the nine distinct sums (three coordinate
// sums, six products; s2's lower triangle repeats) over the neighbours in
// ascending-distance order, each neighbour broadcast by shuffles: the same
// additions and FMAs, in the same order, as one thread summing them all.
// The indices never reach device memory unless the caller asks for them
// (`idx_out`, for checking).

#include "knn_topk.cuh"

namespace {

__global__ void __launch_bounds__(knn_topk::MAX_THREADS, 2)
knn_moments_kernel(const float* __restrict__ x, float* __restrict__ s1,
                   float* __restrict__ s2, int64_t* __restrict__ idx_out,
                   int N, int k, int qw) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  // one flat grid axis, as in knn.cu: block = cloud * tiles + query tile
  const int qb = qw * (blockDim.x >> 5);
  const int tiles = (N + qb - 1) / qb;
  const int64_t b = blockIdx.x / tiles;
  const int tile = blockIdx.x - (int)b * tiles;
  const float* xb = x + b * N * 3;
  // lane m < 9 sums term m: a0 a1 a2 (sums), then m00 m01 m02 m11 m12 m22
  // (FMAs of coordinates u and v); the other lanes' sums are dropped
  const int u = lane < 3 ? lane : lane < 6 ? 0 : lane < 8 ? 1 : 2;
  const int v = lane < 3 ? lane : lane < 6 ? lane - 3 : lane < 8 ? lane - 5 : 2;
  auto emit = [&](int q, knn_topk::key_t key) {
    const size_t row = (size_t)b * N + q;
    const int j = (int)(uint32_t)key;
    float p[3] = {0.f, 0.f, 0.f};
    if (lane < k) {
      p[0] = xb[3 * j];
      p[1] = xb[3 * j + 1];
      p[2] = xb[3 * j + 2];
      if (idx_out != nullptr) idx_out[row * k + lane] = j;
    }
    float acc = 0.f;
    for (int i = 0; i < k; ++i) {
      const float c0 = __shfl_sync(knn_topk::FULL, p[0], i);
      const float c1 = __shfl_sync(knn_topk::FULL, p[1], i);
      const float c2 = __shfl_sync(knn_topk::FULL, p[2], i);
      const float pu = u == 0 ? c0 : u == 1 ? c1 : c2;
      const float pv = v == 0 ? c0 : v == 1 ? c1 : c2;
      acc = lane < 3 ? acc + pu : fmaf(pu, pv, acc);
    }
    if (lane < 3) s1[row * 3 + lane] = acc;
    // s2 is symmetric, row-major 3x3: the off-diagonal terms twice
    float* o2 = s2 + row * 9;
    if (lane >= 3 && lane < 9) {
      o2[3 * u + v] = acc;
      if (u != v) o2[3 * v + u] = acc;
    }
  };
  if (qw == knn_topk::QW)
    knn_topk::select<false, knn_topk::QW>(xb, N, 3, k, tile * qb, N, smem,
                                          emit);
  else
    knn_topk::select<false, knn_topk::QW / 2>(xb, N, 3, k, tile * qb, N,
                                              smem, emit);
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
  const knn_topk::Shape sh = knn_topk::shape(B, N, 3, knn_topk::sm_count());
  if (sh.blocks > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  cudaError_t err = cudaFuncSetAttribute(
      knn_moments_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)sh.smem);
  if (err != cudaSuccess) return (int)err;
  knn_moments_kernel<<<(unsigned)sh.blocks, 32 * sh.warps, sh.smem, stream>>>(
      x, s1, s2, idx_out, N, k, sh.qw);
  return (int)cudaGetLastError();
}

const char* mlsp_knn_moments_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}

}  // extern "C"
