// Brute-force kNN graph for Hopper (sm_90a), float32.
//
// Replaces the TPU kernel `knn_pallas` (mlsp_tpu/ops/pallas/knn_pallas.py,
// body `_knn_kernel`): for x [B, N, C] float32, the int64 [B, N, k]
// indices of each point's k nearest points of the same cloud by
//     d = max(‖q‖² − 2 q·x + ‖x‖², 0)
// (the formula and clamp of mlsp_tpu/ops/pairwise.py), self included,
// equal distances ordered by the lower index (as `lax.top_k` orders them).
//
// Bound: the distance products, B·N²·C fused multiply-adds, in plain
// float32 on the CUDA cores (TF32 tensor cores would round the products
// and reorder near ties, which downstream layers consume). Bytes moved
// are tiny (x once, the indices once), so the kernel is bound by
// operations: float32 FMAs plus the compare of each distance against the
// current k-th best.
//
// Design (simple first; wgmma/TMA are later work):
//   * one block per (cloud, tile of QT queries), one thread per query;
//   * the query tile sits in shared memory, transposed and padded so that
//     each thread reads its own column without bank conflicts;
//   * the cloud is streamed through shared memory in chunks of JT points,
//     transposed so that one 16-byte broadcast load feeds four FMAs;
//   * each thread keeps a sorted top-k list in registers (fully unrolled
//     insertion, template KMAX >= k). Candidates arrive in ascending index
//     and enter only on a strict `<`, so ties keep the lower index;
//   * a ragged last query tile or database chunk is masked, so N need not
//     be a multiple of either tile (the TPU kernel shrank its tile instead).
//
// The squared norms are summed in the same FMA order as the dot products,
// so a point's distance to itself is exactly 0.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int QT = 64;         // queries per block, one thread each
constexpr int QTP = QT + 1;    // padded row of the transposed query tile
constexpr int JT = 32;         // database points per shared-memory chunk
constexpr int JTP = JT + 4;    // padded row, keeps 16-byte alignment

template <int KMAX>
__global__ void __launch_bounds__(QT)
knn_kernel(const float* __restrict__ x, int64_t* __restrict__ out,
           int N, int C, int k) {
  extern __shared__ float smem[];
  float* qs = smem;              // [C][QTP] query tile, transposed
  float* dbs = smem + C * QTP;   // [C][JTP] database chunk, transposed
  __shared__ float dds[JT];      // squared norms of the chunk

  const int t = threadIdx.x;
  const int q0 = blockIdx.x * QT;
  const int nq = min(QT, N - q0);
  const float* xb = x + (size_t)blockIdx.y * N * C;

  // dbs must start on a 16-byte boundary for the float4 loads below.
  dbs = reinterpret_cast<float*>(
      (reinterpret_cast<uintptr_t>(dbs) + 15) & ~uintptr_t(15));

  for (int i = t; i < QT * C; i += QT) {
    const int r = i / C, c = i - r * C;
    qs[c * QTP + r] = r < nq ? xb[(size_t)(q0 + r) * C + c] : 0.f;
  }
  __syncthreads();
  float qq = 0.f;
  for (int c = 0; c < C; ++c) {
    const float v = qs[c * QTP + t];
    qq = fmaf(v, v, qq);
  }

  float best_d[KMAX];
  int best_i[KMAX];
#pragma unroll
  for (int i = 0; i < KMAX; ++i) {
    best_d[i] = INFINITY;
    best_i[i] = 0;
  }

  for (int j0 = 0; j0 < N; j0 += JT) {
    const int nj = min(JT, N - j0);
    __syncthreads();  // the previous chunk has been consumed
    for (int i = t; i < JT * C; i += QT) {
      const int r = i / C, c = i - r * C;
      dbs[c * JTP + r] = r < nj ? xb[(size_t)(j0 + r) * C + c] : 0.f;
    }
    __syncthreads();
    if (t < JT) {
      float s = 0.f;
      for (int c = 0; c < C; ++c) {
        const float v = dbs[c * JTP + t];
        s = fmaf(v, v, s);
      }
      dds[t] = s;
    }
    __syncthreads();

    float acc[JT];
#pragma unroll
    for (int r = 0; r < JT; ++r) acc[r] = 0.f;
    for (int c = 0; c < C; ++c) {
      const float qc = qs[c * QTP + t];
      const float4* row = reinterpret_cast<const float4*>(dbs + c * JTP);
#pragma unroll
      for (int r4 = 0; r4 < JT / 4; ++r4) {
        const float4 v = row[r4];
        acc[4 * r4 + 0] = fmaf(qc, v.x, acc[4 * r4 + 0]);
        acc[4 * r4 + 1] = fmaf(qc, v.y, acc[4 * r4 + 1]);
        acc[4 * r4 + 2] = fmaf(qc, v.z, acc[4 * r4 + 2]);
        acc[4 * r4 + 3] = fmaf(qc, v.w, acc[4 * r4 + 3]);
      }
    }

#pragma unroll
    for (int r = 0; r < JT; ++r) {
      const float d = fmaxf(qq - 2.f * acc[r] + dds[r], 0.f);
      if (r < nj && d < best_d[KMAX - 1]) {
        const int j = j0 + r;
        // Insert (d, j) after every entry with distance <= d; entries
        // behind it move down one place and the last one drops out.
#pragma unroll
        for (int i = KMAX - 1; i >= 0; --i) {
          if (d < best_d[i]) {
            if (i > 0 && d < best_d[i - 1]) {
              best_d[i] = best_d[i - 1];
              best_i[i] = best_i[i - 1];
            } else {
              best_d[i] = d;
              best_i[i] = j;
            }
          }
        }
      }
    }
  }

  if (t < nq) {
    int64_t* o = out + ((size_t)blockIdx.y * N + q0 + t) * k;
#pragma unroll
    for (int i = 0; i < KMAX; ++i)
      if (i < k) o[i] = best_i[i];
  }
}

size_t smem_bytes(int C) {
  // + 16 bytes of slack for aligning the database chunk
  return sizeof(float) * (size_t)C * (QTP + JTP) + 16;
}

template <int KMAX>
cudaError_t launch(const float* x, int64_t* out, int B, int N, int C, int k,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(C);
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
size_t mlsp_knn_smem_bytes(int C) { return smem_bytes(C); }

// x: [B, N, C] float32 contiguous; out: [B, N, k] int64. Launches on
// `stream` and returns the launch status (0 = cudaSuccess).
int mlsp_knn(const float* x, int64_t* out, int B, int N, int C, int k,
             cudaStream_t stream) {
  if (B <= 0 || N <= 0 || C <= 0 || k <= 0 || k > N || k > 32)
    return (int)cudaErrorInvalidValue;
  if (k <= 4) return (int)launch<4>(x, out, B, N, C, k, stream);
  if (k <= 8) return (int)launch<8>(x, out, B, N, C, k, stream);
  if (k <= 16) return (int)launch<16>(x, out, B, N, C, k, stream);
  if (k <= 20) return (int)launch<20>(x, out, B, N, C, k, stream);
  return (int)launch<32>(x, out, B, N, C, k, stream);
}

const char* mlsp_knn_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}

}  // extern "C"
