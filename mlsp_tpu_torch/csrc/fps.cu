// Greedy farthest-point sampling for Hopper (sm_90a), float32.
//
// Replaces the TPU kernel `fps_pallas` (mlsp_tpu/ops/pallas/fps_pallas.py,
// body `_fps_kernel`): for points x [B, N, 3] and a start index per cloud,
// the int64 [B, npoint] greedy max-min order. Column 0 is the start; each
// next point maximises its squared distance to the nearest point already
// chosen, ties to the lowest index.
//
// Bound: neither bytes (x read once, the indices written once) nor
// operations (8·B·N·npoint FLOPs, microseconds at the float32 rate). FPS
// is a chain of npoint dependent steps: each needs the previous step's
// argmax over the whole cloud. The floor is npoint times one step from
// barrier to barrier, so the design shortens the step and runs many
// clouds at once (PCM sends both of its batches in one launch, 2B blocks).
//
// Design: one block of 256 threads per cloud; each thread keeps PT =
// ceil(N/256) points (t, t + 256, ...), their coordinates and min-distances
// in registers (N up to 2048, PointSegDA's clouds). One step:
//   1. update the min-distances against the last chosen point, whose
//      coordinates every thread already holds, and take the thread's
//      argmax (ascending index, strict >: the lowest index among ties);
//   2. warp argmax in three instructions: __reduce_max_sync of the
//      order-preserving key bits(min-distance) + 1 (padding is key 0),
//      then __reduce_min_sync of the indices at that key (the lowest
//      index among ties, whatever the lane order);
//   3. the winning lane writes (key, index, x, y, z) to its warp's slot
//      in one of two buffers, and the block meets at its only barrier;
//   4. every warp reduces the 8 winners itself (the same two reductions)
//      and reads the winner's coordinates from its slot: no second
//      barrier, no dependent load of the centroid from a cloud in shared
//      memory. The buffers alternate by step, so a warp that runs ahead
//      never overwrites winners a slower warp is still reading.
//
// Exact indices: the plain version (`ops/fps.py::fps_torch`) computes the
// distance as dx*dx + dy*dy + dz*dz left to right with one rounding per
// operation, so this kernel uses __fsub_rn/__fmul_rn/__fadd_rn, which nvcc
// never contracts into FMAs. Both routes then agree bit for bit. A start
// index outside [0, N) yields -1 in that whole row.
//
// Larger clouds (the data pipeline FPS-reduces clouds padded to a power of
// two, up to 16384 points, to 1024): `fps_wide_kernel`, the same step with
// 1024 threads a cloud (32 warps, so the second-level reduction reads one
// winner per lane) and PT up to 16 points a thread. Up to N = 8192 (PT <=
// 8) the coordinates stay in registers; above that they move to dynamic
// shared memory (3 x 4 B x N, 192 KB at N = 16384, one block per SM), and
// only the PT min-distances stay in registers. The N <= 2048 path above is
// untouched.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_PT = 8;
constexpr unsigned FULL = 0xffffffffu;

struct Winner {
  unsigned key;
  unsigned idx;
  float x, y, z;
};

template <int PT>
__global__ void __launch_bounds__(THREADS)
fps_kernel(const float* __restrict__ x, const int64_t* __restrict__ start,
           int64_t* __restrict__ out, int N, int npoint) {
  __shared__ Winner win[2][WARPS];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const float* xb = x + (size_t)blockIdx.x * N * 3;
  int64_t* ob = out + (size_t)blockIdx.x * npoint;

  const int64_t s = start[blockIdx.x];
  if (s < 0 || s >= N) {  // uniform over the block
    for (int i = t; i < npoint; i += THREADS) ob[i] = -1;
    return;
  }

  float px[PT], py[PT], pz[PT], md[PT];
#pragma unroll
  for (int j = 0; j < PT; ++j) {
    const int p = t + j * THREADS;
    const bool in = p < N;
    px[j] = in ? xb[3 * p] : 0.f;
    py[j] = in ? xb[3 * p + 1] : 0.f;
    pz[j] = in ? xb[3 * p + 2] : 0.f;
    md[j] = INFINITY;
  }

  float cx = xb[3 * s], cy = xb[3 * s + 1], cz = xb[3 * s + 2];
  if (t == 0) ob[0] = s;
  for (int it = 1; it < npoint; ++it) {
    unsigned bk = 0, bi = UINT_MAX;
    float bx = 0.f, by = 0.f, bz = 0.f;
#pragma unroll
    for (int j = 0; j < PT; ++j) {
      const float dx = __fsub_rn(px[j], cx);
      const float dy = __fsub_rn(py[j], cy);
      const float dz = __fsub_rn(pz[j], cz);
      const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                __fmul_rn(dz, dz));
      md[j] = fminf(md[j], d);
      // min-distances are >= +0, so their bits order them; +1 keeps every
      // real point above the padding's key 0
      const unsigned key =
          t + j * THREADS < N ? __float_as_uint(md[j]) + 1u : 0u;
      if (key > bk) {
        bk = key;
        bi = t + j * THREADS;
        bx = px[j];
        by = py[j];
        bz = pz[j];
      }
    }
    const unsigned wk = __reduce_max_sync(FULL, bk);
    const unsigned wi = __reduce_min_sync(FULL, bk == wk ? bi : UINT_MAX);
    Winner* slot = win[it & 1];
    if (bi == wi) slot[warp] = Winner{wk, wi, bx, by, bz};
    __syncthreads();
    const unsigned ok = lane < WARPS ? slot[lane].key : 0u;
    const unsigned oi = lane < WARPS ? slot[lane].idx : UINT_MAX;
    const unsigned mk = __reduce_max_sync(FULL, ok);
    const unsigned mi = __reduce_min_sync(FULL, ok == mk ? oi : UINT_MAX);
    const int src = __ffs(__ballot_sync(FULL, ok == mk && oi == mi)) - 1;
    cx = slot[src].x;
    cy = slot[src].y;
    cz = slot[src].z;
    if (t == 0) ob[it] = mi;
  }
}

template <int PT>
cudaError_t launch(const float* x, const int64_t* start, int64_t* out, int B,
                   int N, int npoint, cudaStream_t stream) {
  fps_kernel<PT><<<B, THREADS, 0, stream>>>(x, start, out, N, npoint);
  return cudaGetLastError();
}

constexpr int WIDE_THREADS = 1024;
constexpr int WIDE_WARPS = WIDE_THREADS / 32;  // one winner per lane
constexpr int WIDE_MAX_PT = 16;

// One cloud per block of 1024 threads, PT points a thread (t, t + 1024,
// ...). SMEM: the coordinates in dynamic shared memory (x, y, z planes of
// N floats each) instead of registers. Same step as `fps_kernel`.
template <int PT, bool SMEM>
__global__ void __launch_bounds__(WIDE_THREADS)
fps_wide_kernel(const float* __restrict__ x, const int64_t* __restrict__ start,
                int64_t* __restrict__ out, int N, int npoint) {
  extern __shared__ float planes[];  // SMEM only: [3][N]
  __shared__ Winner win[2][WIDE_WARPS];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const float* xb = x + (size_t)blockIdx.x * N * 3;
  int64_t* ob = out + (size_t)blockIdx.x * npoint;

  const int64_t s = start[blockIdx.x];
  if (s < 0 || s >= N) {  // uniform over the block
    for (int i = t; i < npoint; i += WIDE_THREADS) ob[i] = -1;
    return;
  }

  float px[SMEM ? 1 : PT], py[SMEM ? 1 : PT], pz[SMEM ? 1 : PT], md[PT];
  if constexpr (SMEM) {
    for (int p = t; p < N; p += WIDE_THREADS) {
      planes[p] = xb[3 * p];
      planes[N + p] = xb[3 * p + 1];
      planes[2 * N + p] = xb[3 * p + 2];
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < PT; ++j) {
    if constexpr (!SMEM) {
      const int p = t + j * WIDE_THREADS;
      const bool in = p < N;
      px[j] = in ? xb[3 * p] : 0.f;
      py[j] = in ? xb[3 * p + 1] : 0.f;
      pz[j] = in ? xb[3 * p + 2] : 0.f;
    }
    md[j] = INFINITY;
  }

  float cx = xb[3 * s], cy = xb[3 * s + 1], cz = xb[3 * s + 2];
  if (t == 0) ob[0] = s;
  for (int it = 1; it < npoint; ++it) {
    unsigned bk = 0, bi = UINT_MAX;
    float bx = 0.f, by = 0.f, bz = 0.f;
#pragma unroll
    for (int j = 0; j < PT; ++j) {
      const int p = t + j * WIDE_THREADS;
      const bool in = p < N;
      float qx, qy, qz;
      if constexpr (SMEM) {
        qx = in ? planes[p] : 0.f;
        qy = in ? planes[N + p] : 0.f;
        qz = in ? planes[2 * N + p] : 0.f;
      } else {
        qx = px[j];
        qy = py[j];
        qz = pz[j];
      }
      const float dx = __fsub_rn(qx, cx);
      const float dy = __fsub_rn(qy, cy);
      const float dz = __fsub_rn(qz, cz);
      const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                __fmul_rn(dz, dz));
      md[j] = fminf(md[j], d);
      const unsigned key = in ? __float_as_uint(md[j]) + 1u : 0u;
      if (key > bk) {
        bk = key;
        bi = p;
        bx = qx;
        by = qy;
        bz = qz;
      }
    }
    const unsigned wk = __reduce_max_sync(FULL, bk);
    const unsigned wi = __reduce_min_sync(FULL, bk == wk ? bi : UINT_MAX);
    Winner* slot = win[it & 1];
    if (bi == wi) slot[warp] = Winner{wk, wi, bx, by, bz};
    __syncthreads();
    const unsigned ok = slot[lane].key;
    const unsigned oi = slot[lane].idx;
    const unsigned mk = __reduce_max_sync(FULL, ok);
    const unsigned mi = __reduce_min_sync(FULL, ok == mk ? oi : UINT_MAX);
    const int src = __ffs(__ballot_sync(FULL, ok == mk && oi == mi)) - 1;
    cx = slot[src].x;
    cy = slot[src].y;
    cz = slot[src].z;
    if (t == 0) ob[it] = mi;
  }
}

template <int PT, bool SMEM>
cudaError_t launch_wide(const float* x, const int64_t* start, int64_t* out,
                        int B, int N, int npoint, cudaStream_t stream) {
  const size_t smem = SMEM ? 3 * sizeof(float) * (size_t)N : 0;
  if constexpr (SMEM) {
    const cudaError_t e = cudaFuncSetAttribute(
        fps_wide_kernel<PT, SMEM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  fps_wide_kernel<PT, SMEM><<<B, WIDE_THREADS, smem, stream>>>(x, start, out,
                                                                N, npoint);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Largest cloud a launch takes.
int mlsp_fps_max_points() { return WIDE_MAX_PT * WIDE_THREADS; }

// x: [B, N, 3] float32; start: [B] int64; out: [B, npoint] int64; all
// contiguous, npoint <= N <= mlsp_fps_max_points(). Launches on `stream`
// and returns the launch status (0 = cudaSuccess).
int mlsp_fps(const float* x, const int64_t* start, int64_t* out, int B, int N,
             int npoint, cudaStream_t stream) {
  if (B <= 0 || N <= 0 || npoint <= 0 || npoint > N ||
      N > WIDE_MAX_PT * WIDE_THREADS)
    return (int)cudaErrorInvalidValue;
  if (N <= THREADS) return (int)launch<1>(x, start, out, B, N, npoint, stream);
  if (N <= 2 * THREADS)
    return (int)launch<2>(x, start, out, B, N, npoint, stream);
  if (N <= 4 * THREADS)
    return (int)launch<4>(x, start, out, B, N, npoint, stream);
  if (N <= MAX_PT * THREADS)
    return (int)launch<8>(x, start, out, B, N, npoint, stream);
  if (N <= 4 * WIDE_THREADS)
    return (int)launch_wide<4, false>(x, start, out, B, N, npoint, stream);
  if (N <= 8 * WIDE_THREADS)
    return (int)launch_wide<8, false>(x, start, out, B, N, npoint, stream);
  return (int)launch_wide<16, true>(x, start, out, B, N, npoint, stream);
}

const char* mlsp_fps_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}

}  // extern "C"
