// The kNN selection shared by the kNN kernel (knn.cu, K1) and the kNN
// normal-moments kernel (knn_moments.cu, K3), for Hopper (sm_90a), float32.
//
// For each query of a block's tile it finds the k nearest points of the
// same cloud by
//     d = max(‖q‖² − 2 q·x + ‖x‖², 0)
// (the formula and clamp of mlsp_tpu/ops/pairwise.py), self included,
// ascending d, equal d to the lower index (as `lax.top_k` orders them).
// Both kernels include this one body, so K3 selects exactly K1's set.
//
// Exact order. d >= +0 after the clamp, so its float32 bits read as an
// unsigned integer are monotone in d, and the 64-bit key
//     (bits(d) << 32) | j
// orders by distance, then by lower index: every key is distinct, and any
// exact selection of the k smallest keys returns the same indices. The
// three sums ‖q‖², ‖x‖² and q·x are each one float32 FMA chain over the
// channels in ascending order from 0, whatever the tiling (channels padded
// to a multiple of 4 are zeros, and fmaf(0, 0, s) = s for the sums' s >= +0
// or any s != -0, which an FMA chain from +0 never yields), and d is then
// (‖q‖² − 2 q·x) + ‖x‖², clamped, so the distances are bit for bit those of
// every earlier design of this kernel (the one-thread-per-query one and the
// one that staged them in a shared-memory tile), and a point's distance to
// itself is exactly 0.
//
// Bound: operations, B·N²·(2C + 4) (the distance products in plain float32
// on the CUDA cores; TF32 would round them and reorder near ties, which
// downstream layers consume) plus the selection, which is data-dependent:
// what the filter below lets through. Bytes are x once and the indices
// once.
//
// Design. A block of W warps (1 <= W <= 8) owns QB = Q W queries of one
// cloud, Q = 8 (4 where even one-warp blocks would leave SMs empty; the
// launcher's choices, below). Warp w owns queries Qw .. Qw + Q - 1 from
// their distances to their sorted lists, so distances and selection share
// no barrier, and no distance is ever stored.
//   1. Distances. The query tile is copied into shared memory once. The
//      cloud follows point-major in slices of up to 64 channels: 64
//      points, or, when every channel fits one slice, as many 64-point
//      sub-tiles as 2 x 64 x 68 floats hold (2048 points at C <= 4, 128
//      at C = 64), with cp.async into two buffers: the next slice is in
//      flight while one is consumed, one barrier a slice. Each lane holds
//      a Q x 2 register micro-tile: the warp's Q queries x points lane and
//      lane + 32 of a sub-tile. Per 4 channels (Q = 8) 2 conflict-free
//      16-byte loads of the points and 8 broadcast loads of the queries
//      feed 64 FMAs, and 8 more carry the lane's own points' squared norms
//      (every warp forms them again, so no barrier waits for them).
//   2. The register filter. In the epilogue every distance is compared,
//      still in its register, with its query's threshold tau, as one float
//      compare d < tau; only a distance that passes becomes a 64-bit key.
//      A query's candidates reach the filter in increasing index, so one
//      at d == tau has a larger index than the k-th key of the query's
//      list and could not enter: the strict compare is exact. A query past
//      the block's range has tau = 0: nothing passes.
//   3. The seed. Before the first distances are filtered, each lane takes,
//      per query, the least distance among its candidates of the first
//      slice when that holds several sub-tiles (a pass of its own; those
//      distances are formed again for the filter), else of the first
//      sub-tile. The k-th smallest of the 32 lanes' minima is the distance
//      of the k-th of k distinct candidates, at least the true k-th: tau
//      starts just above it (the next float up, so that a tie passes).
//      After that tau only falls: to the k-th key of the list after each
//      flush.
//   4. Survivors. Two ballots a query (its candidates in the lane's two
//      registers) compact the survivors into the query's 32-key buffer in
//      shared memory. When a buffer would overflow, the warp sorts it
//      (bitonic, 64-bit keys, out of line) and merges it into the query's
//      sorted list of 32 keys, one per lane in registers, and tau
//      tightens. At the end of the cloud the rest of every buffer is
//      flushed, the warp's Q queries interleaved. Lane i then holds the
//      i-th nearest, and the caller's `emit` reads the keys off the lanes.
// What bounds it. Against the B·N²·(2C + 4) bound: at C = 3 the selection
// (the filter's ballots, ~1.2 flushes a query after the seed over up to
// 2048 points), at C >= 64 the FMAs, then ~4 flushes a query (the seed
// covers 64-128 points), the barriers' waits for the warp that flushed
// most and 16 warps an SM (PERF.md §6). Occupancy: <= 128 registers a
// thread and, with 8 warps, 84 KB of shared memory at C = 3, 104 KB at C
// = 64 and 86 KB at C = 128 (the earlier design's distance tile alone was
// 65 KB), so 2 blocks of 8 warps an SM at the port's widths. The launcher
// (`shape`) takes 8 warps unless the grid would then leave SMs empty (a
// small batch, a points mesh rank's few rows) or the query tile would not
// fit (C in the hundreds), halving them down to 1, and never more warps
// than a one-tile cloud has groups of Q queries (N <= 32); where one-warp
// blocks of 8 queries still leave SMs empty (B = 1), Q = 4: the tiling
// follows B, N and C, nothing else. A ragged last query tile, slice or
// sub-tile is masked (cp.async zero-fills what lies past the cloud), so N
// need not be a multiple of any tile.
//
// Counting. `select<true>` also adds, per block, the candidates that
// passed the filter and the flushes the block's queries took to a pair of
// counters the caller gives; `select<false>`, the main path, compiles
// neither.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace knn_topk {

constexpr int QW = 8;              // queries a warp owns
constexpr int R = 2;               // points a lane holds of a sub-tile
constexpr int PT = 32 * R;         // points of a sub-tile
constexpr int MAX_WARPS = 8;
constexpr int MAX_THREADS = 32 * MAX_WARPS;
constexpr int CC = 64;             // channels per slice
constexpr int GMAX = 32;           // sub-tiles per slice when C is small
constexpr int SLICE = 2 * PT * (CC + 4);  // floats of a slice buffer, at most
constexpr size_t SMEM_MAX = 227 * 1024;  // a block's shared memory, Hopper
constexpr unsigned FULL = 0xffffffffu;

using key_t = unsigned long long;
constexpr key_t NONE = ~0ull;

// Row pitch, in floats, of a point-major tile of c channels: c rounded up
// to 4, plus 4 if that is an even number of 16-byte units, so that 8
// consecutive rows' 16-byte loads hit 8 distinct bank groups.
__host__ __device__ inline int pitch(int c) {
  const int c4 = (c + 3) & ~3;
  return (c4 & 4) ? c4 : c4 + 4;
}
static_assert((CC + 4) % 8 == 4 && GMAX * PT * 4 <= SLICE,
              "a slice row of CC channels has pitch CC + 4, and a slice "
              "holds GMAX sub-tiles of up to 4 channels");

// Sub-tiles a slice holds for C channels: all that fit one buffer when
// the slice takes every channel, else one.
__host__ __device__ inline int slice_tiles(int C) {
  if (C > CC) return 1;
  const int g = SLICE / (PT * pitch(C));
  return g < GMAX ? g : GMAX;
}

// Dynamic shared memory `select` needs for C channels and W warps of qw
// queries: each query's survivor buffer (32 keys) and seeded threshold,
// the two slice buffers, the query tile and the queries' squared norms.
inline size_t smem_bytes(int C, int warps, int qw = QW) {
  const size_t qb = (size_t)qw * warps;
  const size_t slice = (size_t)slice_tiles(C) * PT * pitch(C < CC ? C : CC);
  return sizeof(key_t) * qb * 32 +
         sizeof(float) * (qb + 2 * slice + qb * pitch(C) + qb);
}

// A launch's tiling: warps a block, queries a warp, blocks (B clouds x
// query tiles) and shared memory, from the batch, the queries of a cloud,
// the channels and the card's SM count (see the header). warps = 0: C does
// not fit.
struct Shape {
  int warps, qw;  // qw: queries a warp owns, QW or, for small grids, QW / 2
  long long blocks;
  size_t smem;
};

inline Shape shape(int B, int nq, int C, int sms) {
  for (int qw = QW;; qw /= 2) {
    int w = MAX_WARPS < (nq + qw - 1) / qw ? MAX_WARPS : (nq + qw - 1) / qw;
    auto blocks = [&](int v) {
      return (long long)B * ((nq + qw * v - 1) / (qw * v));
    };
    while (w > 1 &&
           (blocks(w) < sms || smem_bytes(C, w, qw) > SMEM_MAX))
      w /= 2;
    if (qw == QW && w == 1 && blocks(1) < sms) continue;  // a small grid
    if (smem_bytes(C, w, qw) > SMEM_MAX) return {0, 0, 0, 0};
    return {w, qw, blocks(w), smem_bytes(C, w, qw)};
  }
}

// The current device's SM count, for `shape`.
inline int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 132;  // an H100 SXM's
  return sms;
}

__device__ __forceinline__ key_t make_key(float d, int j) {
  // d >= +0; the mask only guards the sign bit of a -0.
  return ((key_t)(__float_as_uint(d) & 0x7fffffffu) << 32) | (unsigned)j;
}

template <class T>
__device__ __forceinline__ T kmin(T a, T b) { return a < b ? a : b; }
template <class T>
__device__ __forceinline__ T kmax(T a, T b) { return a < b ? b : a; }

// The distance of the k-th key of a sorted lane list: NaN (the bits of
// NONE) while it holds fewer than k keys.
__device__ __forceinline__ float kth_dist(key_t run, int k) {
  return __uint_as_float((unsigned)(__shfl_sync(FULL, run, k - 1) >> 32));
}

// Ascending bitonic sorts of M lists, one value per lane each, across the
// warp; the M lists go through each step together.
template <int M, class T>
__device__ __forceinline__ void warp_sort(T (&v)[M], int lane) {
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const bool keep_min = ((lane & stride) == 0) == ((lane & size) == 0);
      T o[M];
#pragma unroll
      for (int i = 0; i < M; ++i) o[i] = __shfl_xor_sync(FULL, v[i], stride);
#pragma unroll
      for (int i = 0; i < M; ++i)
        v[i] = keep_min ? kmin(v[i], o[i]) : kmax(v[i], o[i]);
    }
  }
}

// a[i] <- the 32 smallest of the ascending lane lists a[i] and b[i].
template <int M>
__device__ __forceinline__ void warp_merge(key_t (&a)[M], const key_t (&b)[M],
                                           int lane) {
#pragma unroll
  for (int i = 0; i < M; ++i)  // a bitonic sequence
    a[i] = kmin(a[i], __shfl_sync(FULL, b[i], 31 - lane));
#pragma unroll
  for (int stride = 16; stride > 0; stride >>= 1) {
    key_t o[M];
#pragma unroll
    for (int i = 0; i < M; ++i) o[i] = __shfl_xor_sync(FULL, a[i], stride);
#pragma unroll
    for (int i = 0; i < M; ++i)
      a[i] = (lane & stride) == 0 ? kmin(a[i], o[i]) : kmax(a[i], o[i]);
  }
}

// Sorts the first cnt[i] keys of buffer i (32 keys each) into run[i].
template <int M>
__device__ __forceinline__ void flush(const key_t* buf, const int (&cnt)[M],
                                      key_t (&run)[M], int lane) {
  __syncwarp();
  key_t v[M];
#pragma unroll
  for (int i = 0; i < M; ++i) v[i] = lane < cnt[i] ? buf[32 * i + lane] : NONE;
  __syncwarp();
  warp_sort(v, lane);
  warp_merge(run, v, lane);
}

// The same for one list; out of line, since the filter calls it only when
// a buffer overflows.
__device__ __noinline__ key_t flush_one(const key_t* buf, int cnt, key_t run,
                                        int lane) {
  key_t r[1] = {run};
  const int c[1] = {cnt};
  flush(buf, c, r, lane);
  return r[0];
}

// The seed of the filter. The k-th smallest of the 32 lanes' minima lm[i]
// is the distance of the k-th of k distinct candidates, so no candidate
// farther than it can be among query i's k nearest (one at that distance
// may be). As a strict bound, d < tau passes: the next float up, or NaN
// (everything passes) when it is infinite.
template <int M>
__device__ __forceinline__ void seed(float (&lm)[M], float* tau, int nvalid,
                                     int k, int lane) {
  warp_sort(lm, lane);
#pragma unroll
  for (int i = 0; i < M; ++i) {
    const float dk = __shfl_sync(FULL, lm[i], k - 1);
    if (i < nvalid)
      tau[i] = dk < INFINITY ? nextafterf(dk, INFINITY)
                             : __uint_as_float(0xffffffffu);
  }
  __syncwarp();
}

// acc[i][r] += the dot products of the warp's queries (rows qrow + i·qp)
// with the lane's points (rows xrow + 32r·xp), and xx[r] += the points'
// squared norms, over channels [0, cc) of the rows: one FMA chain each in
// ascending channel order (cc is padded to 4 with zeros in both tiles).
template <int Q>
__device__ __forceinline__ void dots(float (&acc)[Q][R], float (&xx)[R],
                                     const float* qrow, int qp,
                                     const float* xrow, int xp, int cc) {
#pragma unroll 2
  for (int c = 0; c < cc; c += 4) {
    float4 xv[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      xv[r] = *reinterpret_cast<const float4*>(xrow + 32 * r * xp + c);
      xx[r] = fmaf(xv[r].x, xv[r].x, xx[r]);
      xx[r] = fmaf(xv[r].y, xv[r].y, xx[r]);
      xx[r] = fmaf(xv[r].z, xv[r].z, xx[r]);
      xx[r] = fmaf(xv[r].w, xv[r].w, xx[r]);
    }
#pragma unroll
    for (int i = 0; i < Q; ++i) {
      const float4 qv = *reinterpret_cast<const float4*>(qrow + i * qp + c);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        acc[i][r] = fmaf(qv.x, xv[r].x, acc[i][r]);
        acc[i][r] = fmaf(qv.y, xv[r].y, acc[i][r]);
        acc[i][r] = fmaf(qv.z, xv[r].z, acc[i][r]);
        acc[i][r] = fmaf(qv.w, xv[r].w, acc[i][r]);
      }
    }
  }
}

// acc[i][r] <- the clamped distance of query i to the lane's point r from
// their dot product (d = (‖q‖² − 2 q·x) + ‖x‖², the earlier designs'
// expression), and with LM lm[i] <- min(lm[i], those of points r with 32r
// < lim).
template <bool LM, int Q>
__device__ __forceinline__ void distances(float (&acc)[Q][R],
                                          float (&lm)[Q], const float* qq,
                                          const float (&xx)[R], int lim) {
#pragma unroll
  for (int i = 0; i < Q; ++i) {
    const float q = qq[i];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      acc[i][r] = fmaxf(q - 2.f * acc[i][r] + xx[r], 0.f);
      if (LM && 32 * r < lim) lm[i] = fminf(lm[i], acc[i][r]);
    }
  }
}

template <int Q>
__device__ __forceinline__ void zero(float (&acc)[Q][R], float (&xx)[R]) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    xx[r] = 0.f;
#pragma unroll
    for (int i = 0; i < Q; ++i) acc[i][r] = 0.f;
  }
}

// A slice: the cloud's points [s0, s0 + ps) x channels [c0, c0 + cc).
struct Slice {
  int s0, ps, c0, cc;
};

__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         bool valid, int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  const int n = valid ? bytes : 0;  // 0: zero-fill, src not read
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(n));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                 "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// Starts copying slice s of the cloud xb [N, C] into dst (np points x
// pitch xp, point-major) as one committed group: 16-byte copies when C is a
// multiple of 4, else 4-byte ones. Points past ps and channels past cc (up
// to a multiple of 4) are zero-filled.
__device__ __forceinline__ void fetch_slice(float* dst,
                                            const float* __restrict__ xb,
                                            int C, const Slice& s, int np,
                                            int xp) {
  const int c4 = (s.cc + 3) & ~3;
  const float* src = xb + (size_t)s.s0 * C + s.c0;
  // the thread's copies walk (row, unit) by blockDim.x units at a time
  const bool wide = (C & 3) == 0;
  const int width = wide ? c4 >> 2 : c4;  // units a row: 16 or 4 bytes
  const int dr = blockDim.x / width, du = blockDim.x - dr * width;
  int r = threadIdx.x / width, u = threadIdx.x - r * width;
  for (; r < np; r += dr, u += du) {
    if (u >= width) {
      u -= width;
      ++r;
      if (r >= np) break;
    }
    if (wide) {
      const bool ok = r < s.ps;
      cp_async(dst + r * xp + 4 * u, ok ? src + (size_t)r * C + 4 * u : xb,
               ok, 16);
    } else {
      const bool ok = r < s.ps && u < s.cc;
      cp_async(dst + r * xp + u, ok ? src + (size_t)r * C + u : xb, ok, 4);
    }
  }
  cp_async_commit();
}

// Selects the k (1 <= k <= 32) nearest points of cloud xb [N, C] for the
// block's queries q0 .. min(q0 + QB, qend) - 1 (QB = QW x the block's warps;
// qend <= N: the end of the caller's query range, N for a whole cloud)
// and, for each, calls
//     emit(q, key)
// on all 32 lanes of the warp that owns query q, lane i holding the key of
// the i-th nearest point (lanes >= k hold larger keys or NONE). The index
// is the key's low 32 bits. A query's work does not depend on q0 or on
// which other queries share its block, so a range's keys are those of the
// same queries in a whole-cloud launch. Every thread of the block must
// call it (it synchronises the block); smem holds smem_bytes(C, warps)
// bytes, 16-aligned. With COUNT, lane 0 of each warp adds the candidates
// its queries let through the filter to stats[0] and their flushes to
// stats[1].
template <bool COUNT, int QW, class Emit>
__device__ __forceinline__ void select(const float* __restrict__ xb, int N,
                                       int C, int k, int q0, int qend,
                                       unsigned char* smem, Emit emit,
                                       unsigned long long* stats = nullptr) {
  const int T = blockDim.x, t = threadIdx.x, lane = t & 31, w = t >> 5;
  const int QB = QW * (T >> 5);
  const int nq = min(QB, qend - q0);
  const int qp = pitch(C);
  const int qw0 = QW * w;  // the warp's first query in the tile
  const int nvalid = min(QW, nq - qw0);  // its queries in the range
  // the warp's buffers [QW][32], then its queries' seeded thresholds
  key_t* buf = reinterpret_cast<key_t*>(smem) + w * QW * 32;
  float* taus = reinterpret_cast<float*>(
                    reinterpret_cast<key_t*>(smem) + QB * 32) + qw0;
  // Slices: CC channels of PT points, or, when all C channels fit one
  // slice, all of them for G sub-tiles at once. Slice z holds points
  // (z / ncc)·PS.. and channels (z % ncc)·CC..
  const int cs = min(CC, C);
  const int xp = pitch(cs);
  const int ncc = (C + CC - 1) / CC;
  const int G = slice_tiles(C);
  const int PS = G * PT;
  const int nz = (N + PS - 1) / PS * ncc;
  float* slices = taus - qw0 + QB;                             // 2 x [PS][xp]
  float* qs = slices + 2 * PS * xp;                            // [QB][qp]
  float* qqs = qs + QB * qp;                                   // [QB]

  unsigned long long passed = 0, flushes = 0;
  auto fetch = [&](int z) {
    if (z >= nz) return;
    const int s0 = z / ncc * PS, c0 = z % ncc * CC;
    const int ps = min(PS, N - s0);
    fetch_slice(slices + (z & 1) * PS * xp, xb, C,
                Slice{s0, ps, c0, min(CC, C - c0)}, (ps + PT - 1) / PT * PT,
                xp);
  };
  // the query tile, point-major, channels zero-padded to a multiple of
  // 4 (the dot products read no further), with the first slice
  fetch_slice(qs, xb, C, Slice{q0, nq, 0, C}, QB, qp);
  fetch(0);
  if (lane < QW)  // nothing passes a query past the range: tau = 0
    taus[lane] = lane < nvalid ? __uint_as_float(0xffffffffu) : 0.f;
  cp_async_wait_all();
  __syncthreads();
  if (lane < QW) {  // the warp's queries' squared norms
    const float* q = qs + (qw0 + lane) * qp;
    float s = 0.f;
#pragma unroll 4
    for (int c = 0; c < C; c += 4) {
      const float4 v = *reinterpret_cast<const float4*>(q + c);
      s = fmaf(v.x, v.x, s);
      s = fmaf(v.y, v.y, s);
      s = fmaf(v.z, v.z, s);
      s = fmaf(v.w, v.w, s);
    }
    qqs[qw0 + lane] = s;
  }

  key_t run[QW];
  float tau[QW];
  int cnt[QW];
#pragma unroll
  for (int i = 0; i < QW; ++i) {
    run[i] = NONE;
    cnt[i] = 0;
  }
  float acc[QW][R], xx[R], lm[QW];
  const unsigned below = (1u << lane) - 1u;
  for (int z = 0; z < nz; ++z) {
    const int j0 = z / ncc * PS, s = z % ncc, c0 = s * CC;
    const int ps = min(PS, N - j0), cc = min(CC, C - c0);
    const bool last = s == ncc - 1;  // the points' last channels
    const float* xs = slices + (z & 1) * PS * xp;
    const float* qrow = qs + qw0 * qp + c0;
    cp_async_wait_all();
    __syncthreads();  // slice z is in; slice z - 1's buffer is free
    fetch(z + 1);

    // The seed. When the first slice holds several sub-tiles (small C),
    // a pass of its own takes the lane minima over all of them, and their
    // distances are formed again below; else the first sub-tile's own.
    const bool prepass = j0 == 0 && ps > PT;
#pragma unroll
    for (int i = 0; i < QW; ++i) lm[i] = INFINITY;
    if (prepass) {
      for (int sub = 0; sub < ps; sub += PT) {
        zero(acc, xx);
        dots(acc, xx, qrow, qp, xs + (sub + lane) * xp, xp, cc);
        distances<true>(acc, lm, qqs + qw0, xx, ps - sub - lane);
      }
      seed(lm, taus, nvalid, k, lane);
#pragma unroll
      for (int i = 0; i < QW; ++i) tau[i] = taus[i];
    }

    for (int sub = 0; sub < ps; sub += PT) {
      if (s == 0) zero(acc, xx);
      dots(acc, xx, qrow, qp, xs + (sub + lane) * xp, xp, cc);
      if (!last) continue;

      // The epilogue: distances, the register filter, the survivors.
      const int lim = ps - sub - lane;  // this lane's points: 32r < lim
      if (j0 == 0 && sub == 0 && !prepass) {
        distances<true>(acc, lm, qqs + qw0, xx, lim);
        seed(lm, taus, nvalid, k, lane);
#pragma unroll
        for (int i = 0; i < QW; ++i) tau[i] = taus[i];
      } else {
        distances<false>(acc, lm, qqs + qw0, xx, lim);
      }
      const int jb = j0 + sub + lane;
      // A query's ballots together: its buffer takes all their survivors
      // (the common case) or, when it would overflow, they go in ballot by
      // ballot, with a flush where one would overflow it.
#pragma unroll
      for (int i = 0; i < QW; ++i) {
        unsigned ball[R];
        int n = 0;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          ball[r] =
              __ballot_sync(FULL, 32 * r < lim && !(acc[i][r] >= tau[i]));
          n += __popc(ball[r]);
        }
        if (n == 0) continue;  // uniform
        if (cnt[i] + n <= 32) {
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const int slot = cnt[i] + __popc(ball[r] & below);
            const key_t key = make_key(acc[i][r], jb + 32 * r);
            if ((ball[r] >> lane) & 1u) buf[32 * i + slot] = key;
            cnt[i] += __popc(ball[r]);
          }
          if (COUNT) passed += n;
        } else {
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const float d = acc[i][r];
            bool pass = 32 * r < lim && !(d >= tau[i]);
            unsigned b = __ballot_sync(FULL, pass);
            if (b == 0) continue;
            if (cnt[i] + __popc(b) > 32) {  // flush, refilter
              run[i] = flush_one(buf + 32 * i, cnt[i], run[i], lane);
              tau[i] = fminf(tau[i], kth_dist(run[i], k));
              cnt[i] = 0;
              if (COUNT) ++flushes;
              pass = pass && !(d >= tau[i]);
              b = __ballot_sync(FULL, pass);
            }
            if (pass)
              buf[32 * i + cnt[i] + __popc(b & below)] =
                  make_key(d, jb + 32 * r);
            cnt[i] += __popc(b);
            if (COUNT) passed += __popc(b);
          }
        }
      }
    }
  }

  if (COUNT) {
#pragma unroll
    for (int i = 0; i < QW; ++i) flushes += cnt[i] > 0;
  }
  flush(buf, cnt, run, lane);
#pragma unroll
  for (int i = 0; i < QW; ++i)
    if (i < nvalid) emit(q0 + qw0 + i, run[i]);
  if (COUNT && lane == 0) {
    atomicAdd(stats, passed);
    atomicAdd(stats + 1, flushes);
  }
}

}  // namespace knn_topk
