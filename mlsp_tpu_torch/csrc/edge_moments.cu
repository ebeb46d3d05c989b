// EdgeConv neighbourhood statistics for Hopper (sm_90a), float32: the
// forward (K2-fwd) and, further below, its backward (K2-bwd).
//
// Replaces the forward of the TPU kernel `edge_moments`
// (mlsp_tpu/ops/pallas/edge_pallas.py, `_edge_moments_impl`, bodies
// `_fwd_kernel` and `_fill_selT`): for u [B, N, C] and the kNN graph idx
// [B, N, k] (int64, from knn.cu), each point's max and min of u over its k
// neighbours and, on request, their sum and sum of squares.
//
// The TPU kernel rebuilt the graph as a {0,1} mask and reduced with mask
// matmuls because Mosaic has no in-kernel gather. Hopper gathers, so this
// kernel reads the neighbour rows directly.
//
// Bound: bytes. Each output element needs k loads and 2-4 operations, so
// the least time is u and idx read once plus the outputs written once over
// the memory rate; the k-fold re-reads of u rows are served by L2 (u is at
// most a few MB on the serving path).
//
// Design: one thread per (b, n, channel). Neighbouring threads take
// neighbouring channels of one point, so each neighbour row of u is read
// as one coalesced segment and the k indices are broadcast within a warp.
// max/min select values without arithmetic, so they are bit-equal to
// any other max/min of the same set; the sums run in neighbour order.
// An index outside [0, N) yields NaN in every output of that point.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

template <bool MOMENTS>
__global__ void __launch_bounds__(THREADS)
edge_moments_kernel(const float* __restrict__ u,
                    const int64_t* __restrict__ idx,
                    float* __restrict__ mx, float* __restrict__ mn,
                    float* __restrict__ s1, float* __restrict__ s2,
                    int N, int C, int k, int64_t total) {
  const int64_t e = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (e >= total) return;
  const int64_t bn = e / C;             // b * N + n
  const int c = (int)(e - bn * C);
  const int64_t* nb = idx + bn * k;
  const float* ub = u + (bn / N) * N * (int64_t)C + c;

  float hi = -INFINITY, lo = INFINITY, s = 0.f, ss = 0.f;
  bool bad = false;
  for (int j = 0; j < k; ++j) {
    const int64_t m = nb[j];
    if (m < 0 || m >= N) {
      bad = true;
      break;
    }
    const float v = ub[m * C];
    hi = v > hi ? v : hi;
    lo = v < lo ? v : lo;
    if (MOMENTS) {
      s += v;
      ss = fmaf(v, v, ss);
    }
  }
  if (bad) hi = lo = s = ss = NAN;
  mx[e] = hi;
  mn[e] = lo;
  if (MOMENTS) {
    s1[e] = s;
    s2[e] = ss;
  }
}

// Backward (K2-bwd). Replaces the TPU kernel `_edge_moments_bwd`
// (mlsp_tpu/ops/pallas/edge_pallas.py, body `_bwd_kernel`): given the
// cotangents of (mx, mn, s1, s2), the gradient with respect to u,
//     du_j = Σ_{i: j ∈ nbr(i)} ds1_i + 2 u_j ds2_i
//            + [u_j == mx_i] dmx_i / #ties_max_i
//            + [u_j == mn_i] dmn_i / #ties_min_i,
// the max and min cotangents shared equally among the neighbours tied at
// the extreme (the semantics of the gradient of jnp.max and torch.amax).
// The graph features get no gradient.
//
// Bound: bytes. u, idx, mx, mn and the four cotangents are read once and
// du written once; each edge costs a few operations. The k-fold re-reads
// of u rows come from L2, as in the forward.
//
// Design: the TPU kernel accumulated du in VMEM across a sequential grid.
// Here one thread per (b, i, channel), coalesced over channels, pushes its
// point's contribution to each of its k neighbours with a float atomicAdd
// into du (zeroed by the wrapper). A first pass over the k neighbours
// counts the ties with the saved mx and mn (float ==, as the plain
// version's amax backward compares; it differs from a bitwise compare
// only at ±0), the second scatters. A null cotangent pointer (an unused
// output) skips its term. The atomics add in an order that changes from
// run to run, so du is reproducible only to rounding. An index outside
// [0, N) contributes nothing.
__global__ void __launch_bounds__(THREADS)
edge_moments_bwd_kernel(const float* __restrict__ u,
                        const int64_t* __restrict__ idx,
                        const float* __restrict__ mx,
                        const float* __restrict__ mn,
                        const float* __restrict__ dmx,
                        const float* __restrict__ dmn,
                        const float* __restrict__ ds1,
                        const float* __restrict__ ds2,
                        float* __restrict__ du,
                        int N, int C, int k, int64_t total) {
  const int64_t e = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (e >= total) return;
  const int64_t bn = e / C;             // b * N + n
  const int c = (int)(e - bn * C);
  const int64_t* nb = idx + bn * k;
  const int64_t base = (bn / N) * N * (int64_t)C + c;
  const float* ub = u + base;
  float* dub = du + base;

  const float hi = mx[e], lo = mn[e];
  int n_hi = 0, n_lo = 0;
  for (int j = 0; j < k; ++j) {
    const int64_t m = nb[j];
    if (m < 0 || m >= N) continue;
    const float v = ub[m * C];
    n_hi += v == hi;
    n_lo += v == lo;
  }
  const float w_hi = dmx != nullptr ? dmx[e] / (float)max(n_hi, 1) : 0.f;
  const float w_lo = dmn != nullptr ? dmn[e] / (float)max(n_lo, 1) : 0.f;
  const float g1 = ds1 != nullptr ? ds1[e] : 0.f;
  const float g2 = ds2 != nullptr ? 2.f * ds2[e] : 0.f;
  for (int j = 0; j < k; ++j) {
    const int64_t m = nb[j];
    if (m < 0 || m >= N) continue;
    const float v = ub[m * C];
    float g = fmaf(g2, v, g1);
    if (v == hi) g += w_hi;
    if (v == lo) g += w_lo;
    atomicAdd(dub + m * C, g);
  }
}

}  // namespace

extern "C" {

// u: [B, N, C] float32; idx: [B, N, k] int64; mx, mn (and s1, s2 when
// `moments` is nonzero): [B, N, C] float32, all contiguous. Launches on
// `stream` and returns the launch status (0 = cudaSuccess).
int mlsp_edge_moments(const float* u, const int64_t* idx, float* mx,
                      float* mn, float* s1, float* s2, int B, int N, int C,
                      int k, int moments, cudaStream_t stream) {
  if (B <= 0 || N <= 0 || C <= 0 || k <= 0)
    return (int)cudaErrorInvalidValue;
  const int64_t total = (int64_t)B * N * C;
  const unsigned blocks = (unsigned)((total + THREADS - 1) / THREADS);
  if (moments)
    edge_moments_kernel<true><<<blocks, THREADS, 0, stream>>>(
        u, idx, mx, mn, s1, s2, N, C, k, total);
  else
    edge_moments_kernel<false><<<blocks, THREADS, 0, stream>>>(
        u, idx, mx, mn, s1, s2, N, C, k, total);
  return (int)cudaGetLastError();
}

// u, mx, mn: [B, N, C] float32; idx: [B, N, k] int64; dmx, dmn, ds1, ds2:
// [B, N, C] float32 or null (no cotangent); du: [B, N, C] float32, zeroed
// by the caller. All contiguous. Launches on `stream` and returns the
// launch status (0 = cudaSuccess).
int mlsp_edge_moments_bwd(const float* u, const int64_t* idx, const float* mx,
                          const float* mn, const float* dmx, const float* dmn,
                          const float* ds1, const float* ds2, float* du,
                          int B, int N, int C, int k, cudaStream_t stream) {
  if (B <= 0 || N <= 0 || C <= 0 || k <= 0)
    return (int)cudaErrorInvalidValue;
  const int64_t total = (int64_t)B * N * C;
  const unsigned blocks = (unsigned)((total + THREADS - 1) / THREADS);
  edge_moments_bwd_kernel<<<blocks, THREADS, 0, stream>>>(
      u, idx, mx, mn, dmx, dmn, ds1, ds2, du, N, C, k, total);
  return (int)cudaGetLastError();
}

const char* mlsp_edge_moments_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}

}  // extern "C"
