// The kNN selection shared by the kNN kernel (knn.cu, K1) and the kNN
// normal-moments kernel (knn_moments.cu, K3), for Hopper (sm_90a), float32.
//
// One block per (cloud, tile of QT queries), one thread per query. For each
// query it keeps the k nearest points of the same cloud by
//     d = max(‖q‖² − 2 q·x + ‖x‖², 0)
// (the formula and clamp of mlsp_tpu/ops/pairwise.py), self included, in a
// sorted register list; equal distances keep the lower index (as
// `lax.top_k` orders them). Both kernels include this one body, so K3
// selects exactly K1's neighbour set.
//
//   * the query tile sits in shared memory, transposed and padded so that
//     each thread reads its own column without bank conflicts;
//   * the cloud is streamed through shared memory in chunks of JT points,
//     transposed so that one 16-byte broadcast load feeds four FMAs;
//   * the top-k list is a fully unrolled insertion (template KMAX >= k).
//     Candidates arrive in ascending index and enter only on a strict `<`,
//     so ties keep the lower index;
//   * a ragged last query tile or database chunk is masked, so N need not
//     be a multiple of either tile.
//
// The squared norms are summed in the same FMA order as the dot products,
// so a point's distance to itself is exactly 0.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace knn_topk {

constexpr int QT = 64;         // queries per block, one thread each
constexpr int QTP = QT + 1;    // padded row of the transposed query tile
constexpr int JT = 32;         // database points per shared-memory chunk
constexpr int JTP = JT + 4;    // padded row, keeps 16-byte alignment

// Dynamic shared memory `select` needs for C channels (+ 16 bytes of
// slack for aligning the database chunk).
inline size_t smem_bytes(int C) {
  return sizeof(float) * (size_t)C * (QTP + JTP) + 16;
}

// Fills best_d/best_i (ascending distance) with the KMAX nearest points of
// the cloud xb [N, C] to query q0 + threadIdx.x, for a block whose tile
// holds nq <= QT queries. Every thread of the block must call it (it
// synchronises the block); rows of threads >= nq are meaningless.
template <int KMAX>
__device__ __forceinline__ void select(const float* __restrict__ xb, int N,
                                       int C, int q0, int nq, float* smem,
                                       float (&best_d)[KMAX],
                                       int (&best_i)[KMAX]) {
  float* qs = smem;              // [C][QTP] query tile, transposed
  float* dbs = smem + C * QTP;   // [C][JTP] database chunk, transposed
  __shared__ float dds[JT];      // squared norms of the chunk

  const int t = threadIdx.x;

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
}

// Instantiates `LAUNCH<KMAX>(args...)` for the smallest supported KMAX >= k
// (k in [1, 32]).
#define KNN_TOPK_DISPATCH(k, LAUNCH, ...)                            \
  ((k) <= 4 ? LAUNCH<4>(__VA_ARGS__)                                 \
   : (k) <= 8 ? LAUNCH<8>(__VA_ARGS__)                               \
   : (k) <= 16 ? LAUNCH<16>(__VA_ARGS__)                             \
   : (k) <= 20 ? LAUNCH<20>(__VA_ARGS__)                             \
               : LAUNCH<32>(__VA_ARGS__))

}  // namespace knn_topk
