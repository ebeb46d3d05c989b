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
// barrier to barrier.
//
// Design: one block of 1024 threads per cloud. The cloud sits in shared
// memory (for the centroid read); each thread keeps its PT = ceil(N/1024)
// points (t, t + 1024, ...) and their min-distances in registers, so N up
// to 2048 (PointSegDA's clouds) works. Per step:
//   1. every thread reads the chosen centroid from shared memory and
//      updates its min-distances;
//   2. a warp-shuffle argmax over (value, index), lower index on ties;
//   3. a second argmax over the 32 warp winners in shared memory;
//   4. thread 0 writes out[b, i] and publishes the winner.
// The indices are written directly: the TPU kernel's ordinal-then-argsort
// detour worked around Mosaic's lack of dynamic stores.
//
// Exact indices: the plain version (`ops/fps.py::fps_torch`) computes the
// distance as dx*dx + dy*dy + dz*dz left to right with one rounding per
// operation, so this kernel uses __fsub_rn/__fmul_rn/__fadd_rn, which nvcc
// never contracts into FMAs. Both routes then agree bit for bit.
//
// Only B blocks run (32 on the PCM path, of 132 SMs): filling the card is
// later work. A start index outside [0, N) yields -1 in that whole row.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;

__device__ __forceinline__ void argmax_step(float& v, int& i, float ov,
                                            int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

__device__ __forceinline__ void warp_argmax(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, v, off);
    const int oi = __shfl_down_sync(0xffffffffu, i, off);
    argmax_step(v, i, ov, oi);
  }
}

template <int PT>
__global__ void __launch_bounds__(THREADS)
fps_kernel(const float* __restrict__ x, const int64_t* __restrict__ start,
           int64_t* __restrict__ out, int N, int npoint) {
  extern __shared__ float smem[];  // the cloud, [3][N]
  float* sx = smem;
  float* sy = smem + N;
  float* sz = smem + 2 * N;
  __shared__ float warp_v[WARPS];
  __shared__ int warp_i[WARPS];
  __shared__ int chosen;

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const float* xb = x + (size_t)blockIdx.x * N * 3;
  int64_t* ob = out + (size_t)blockIdx.x * npoint;

  const int64_t s = start[blockIdx.x];
  if (s < 0 || s >= N) {  // uniform over the block
    for (int i = t; i < npoint; i += THREADS) ob[i] = -1;
    return;
  }
  for (int i = t; i < N; i += THREADS) {
    sx[i] = xb[3 * i];
    sy[i] = xb[3 * i + 1];
    sz[i] = xb[3 * i + 2];
  }
  __syncthreads();

  float px[PT], py[PT], pz[PT], md[PT];
#pragma unroll
  for (int j = 0; j < PT; ++j) {
    const int p = t + j * THREADS;
    const bool in = p < N;
    px[j] = in ? sx[p] : 0.f;
    py[j] = in ? sy[p] : 0.f;
    pz[j] = in ? sz[p] : 0.f;
    md[j] = in ? INFINITY : -INFINITY;  // padding never wins
  }

  int far = (int)s;
  if (t == 0) ob[0] = far;
  for (int it = 1; it < npoint; ++it) {
    const float cx = sx[far], cy = sy[far], cz = sz[far];
    float bv = -INFINITY;
    int bi = INT_MAX;
#pragma unroll
    for (int j = 0; j < PT; ++j) {
      const float dx = __fsub_rn(px[j], cx);
      const float dy = __fsub_rn(py[j], cy);
      const float dz = __fsub_rn(pz[j], cz);
      const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                __fmul_rn(dz, dz));
      if (t + j * THREADS < N) md[j] = fminf(md[j], d);
      // ascending index within the thread: strict > keeps the lowest
      if (md[j] > bv) {
        bv = md[j];
        bi = t + j * THREADS;
      }
    }
    warp_argmax(bv, bi);
    if (lane == 0) {
      warp_v[warp] = bv;
      warp_i[warp] = bi;
    }
    __syncthreads();
    if (warp == 0) {
      bv = warp_v[lane];
      bi = warp_i[lane];
      warp_argmax(bv, bi);
      if (lane == 0) {
        chosen = bi;
        ob[it] = bi;
      }
    }
    __syncthreads();
    far = chosen;
  }
}

template <int PT>
cudaError_t launch(const float* x, const int64_t* start, int64_t* out, int B,
                   int N, int npoint, cudaStream_t stream) {
  const size_t smem = sizeof(float) * 3 * (size_t)N;
  cudaError_t err = cudaFuncSetAttribute(
      fps_kernel<PT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  fps_kernel<PT><<<B, THREADS, smem, stream>>>(x, start, out, N, npoint);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Largest cloud a launch takes.
int mlsp_fps_max_points() { return 2 * THREADS; }

// x: [B, N, 3] float32; start: [B] int64; out: [B, npoint] int64; all
// contiguous, npoint <= N <= mlsp_fps_max_points(). Launches on `stream`
// and returns the launch status (0 = cudaSuccess).
int mlsp_fps(const float* x, const int64_t* start, int64_t* out, int B, int N,
             int npoint, cudaStream_t stream) {
  if (B <= 0 || N <= 0 || npoint <= 0 || npoint > N || N > 2 * THREADS)
    return (int)cudaErrorInvalidValue;
  if (N <= THREADS) return (int)launch<1>(x, start, out, B, N, npoint, stream);
  return (int)launch<2>(x, start, out, B, N, npoint, stream);
}

const char* mlsp_fps_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}

}  // extern "C"
