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

}  // namespace

extern "C" {

// Largest cloud a launch takes.
int mlsp_fps_max_points() { return MAX_PT * THREADS; }

// x: [B, N, 3] float32; start: [B] int64; out: [B, npoint] int64; all
// contiguous, npoint <= N <= mlsp_fps_max_points(). Launches on `stream`
// and returns the launch status (0 = cudaSuccess).
int mlsp_fps(const float* x, const int64_t* start, int64_t* out, int B, int N,
             int npoint, cudaStream_t stream) {
  if (B <= 0 || N <= 0 || npoint <= 0 || npoint > N ||
      N > MAX_PT * THREADS)
    return (int)cudaErrorInvalidValue;
  if (N <= THREADS) return (int)launch<1>(x, start, out, B, N, npoint, stream);
  if (N <= 2 * THREADS)
    return (int)launch<2>(x, start, out, B, N, npoint, stream);
  if (N <= 4 * THREADS)
    return (int)launch<4>(x, start, out, B, N, npoint, stream);
  return (int)launch<8>(x, start, out, B, N, npoint, stream);
}

const char* mlsp_fps_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}

}  // extern "C"
