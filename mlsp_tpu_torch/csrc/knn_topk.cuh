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
// or any s != -0, which an FMA chain from +0 never yields), so the
// distances are bit for bit those of the earlier one-thread-per-query
// design (and a point's distance to itself is exactly 0).
//
// Bound: operations, B·N²·(2C + 4) (the distance products in plain float32
// on the CUDA cores; TF32 would round them and reorder near ties, which
// downstream layers consume) plus the selection, which is data-dependent
// but a few operations per candidate. Bytes are x once and the indices once.
// Its measured times against this bound: PERF.md §6 (at C = 3 the
// selection, not the distances, is the work).
//
// Design. A block of 8 warps owns QB = 32 queries of one cloud and walks
// the cloud in chunks of NC = 512 points; two blocks fit an SM (<= 128
// registers a thread, <= 106 KB of shared memory for C <= 128).
//   1. Distances. The chunk is copied into shared memory point-major, in
//      slices of 128 points x up to 16 channels (the whole chunk at once
//      when C <= 4), with cp.async into two buffers: the next slice is in
//      flight while one is consumed, one barrier a slice. The
//      8 warps tile 32 queries x 128 points as 2 x 4 warp tiles of
//      16 x 32; each lane holds a 4x4 register micro-tile (queries strided
//      by 4, points by 8, so that each 16-byte load of 4 channels is
//      conflict-free): per 4 channels 8 such loads feed 64 FMAs a lane.
//      The squared norms of the points are one FMA chain per point, taken
//      by the two halves of the block in turn. The distances go to a
//      [32][NC] tile in shared memory.
//   2. A threshold per query. While writing its distances each lane keeps,
//      per query of its micro-tile, the smallest key it produced; a query
//      has 32 such "lane minima" (4 warps x 8 lanes), keys of 32 distinct
//      candidates, so their k-th smallest is >= the true k-th key.
//      Together with the k-th key of the running list from earlier chunks
//      it bounds which candidates can still make the top k: on typical
//      clouds a few more than k.
//   3. Selection without divergence. Warp w selects for queries 4w..4w+3,
//      all four interleaved so that their shuffle and load latencies
//      overlap. It reads the rows 32 candidates at a time, compares each
//      key against its query's threshold and compacts the survivors into a
//      32-key buffer per query with a ballot prefix. When a buffer would
//      overflow (more than 32 survivors in a chunk, or exact ties; out of
//      line) or at the end of the chunk, it is sorted
//      (warp bitonic sort on the 64-bit keys) and merged into the running
//      sorted list (reverse-min + bitonic merge), and the threshold
//      tightens. Lane i then holds the i-th nearest key. The common
//      candidate costs a load and a compare, not an insertion.
//   4. The caller's `emit` reads the sorted keys off the lanes.
// A ragged last query tile, chunk or slice is masked (cp.async zero-fills
// what lies past the cloud), so N need not be a multiple of any tile.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace knn_topk {

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int QB = 32;             // queries per block
constexpr int QPW = QB / WARPS;    // queries a warp selects for
constexpr int WC = 4;              // warp columns of the distance tile
constexpr int PT = WC * 32;        // points per sub-tile (4 per lane)
constexpr int NC = 512;            // points per chunk
constexpr int DP = NC + 8;         // distance row pitch: conflict-free stores
constexpr int CC = 16;             // channels per slice
constexpr int SLICE = PT * (CC + 4);  // floats of one of the 2 slice buffers
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

// Dynamic shared memory `select` needs for C channels: the distance tile,
// the slice buffers (which the selection reuses for the lane minima and a
// 32-key buffer per query), the query tile and the squared norms.
inline size_t smem_bytes(int C) {
  return sizeof(float) *
         ((size_t)QB * DP + 2 * SLICE + (size_t)QB * pitch(C) + NC + QB);
}
static_assert(sizeof(key_t) * QB * 32 * 2 <= sizeof(float) * 2 * SLICE,
              "the selection's keys must fit the slice buffers");

__device__ __forceinline__ key_t make_key(float d, int j) {
  // d >= +0; the mask only guards the sign bit of a -0.
  return ((key_t)(__float_as_uint(d) & 0x7fffffffu) << 32) | (unsigned)j;
}

__device__ __forceinline__ key_t kmin(key_t a, key_t b) { return a < b ? a : b; }
__device__ __forceinline__ key_t kmax(key_t a, key_t b) { return a < b ? b : a; }

// Ascending bitonic sorts of M lists, one key per lane each, across the
// warp; the M lists go through each step together.
template <int M>
__device__ __forceinline__ void warp_sort(key_t (&v)[M], int lane) {
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const bool keep_min = ((lane & stride) == 0) == ((lane & size) == 0);
      key_t o[M];
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

// The same for one list; out of line, since the selection calls it only
// when a buffer overflows (the inlined copies cost more than the call).
__device__ __noinline__ key_t flush_one(const key_t* buf, int cnt, key_t run,
                                        int lane) {
  key_t r[1] = {run};
  const int c[1] = {cnt};
  flush(buf, c, r, lane);
  return r[0];
}

// A slice: the chunk's points [s0, s0 + ps) x channels [c0, c0 + cc).
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

// Starts copying slice s of the chunk at j0 into dst (np points x pitch
// xp, point-major) as one committed group: 16-byte copies when C is a
// multiple of 4, else 4-byte ones. Points past ps and channels past cc (up
// to a multiple of 4) are zero-filled.
__device__ __forceinline__ void fetch_slice(float* dst,
                                            const float* __restrict__ xb,
                                            int C, int j0, const Slice& s,
                                            int np, int xp) {
  const int c4 = (s.cc + 3) & ~3;
  const float* src = xb + (size_t)(j0 + s.s0) * C + s.c0;
  if ((C & 3) == 0) {
    const int nq4 = c4 >> 2;
    for (int i = threadIdx.x; i < np * nq4; i += THREADS) {
      const int r = i / nq4, q = i - r * nq4;
      const bool ok = r < s.ps;
      cp_async(dst + r * xp + 4 * q, ok ? src + (size_t)r * C + 4 * q : xb,
               ok, 16);
    }
  } else {
    for (int i = threadIdx.x; i < np * c4; i += THREADS) {
      const int r = i / c4, c = i - r * c4;
      const bool ok = r < s.ps && c < s.cc;
      cp_async(dst + r * xp + c, ok ? src + (size_t)r * C + c : xb, ok, 4);
    }
  }
  cp_async_commit();
}

// Selects the k (1 <= k <= 32) nearest points of cloud xb [N, C] for the
// block's queries q0 .. min(q0 + QB, qend) - 1 (qend <= N: the end of the
// caller's query range, N for a whole cloud) and, for each, calls
//     emit(q, key)
// on all 32 lanes of the warp that owns query q, lane i holding the key of
// the i-th nearest point (lanes >= k hold larger keys or NONE). The index
// is the key's low 32 bits. A query's work does not depend on q0 or on
// which other queries share its block, so a range's keys are those of the
// same queries in a whole-cloud launch. Every thread of the block must
// call it (it synchronises the block); smem holds smem_bytes(C) bytes,
// 16-aligned.
template <class Emit>
__device__ __forceinline__ void select(const float* __restrict__ xb, int N,
                                       int C, int k, int q0, int qend,
                                       unsigned char* smem, Emit emit) {
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  const int nq = min(QB, qend - q0);
  const int qp = pitch(C);
  float* dist = reinterpret_cast<float*>(smem);  // [QB][DP]
  float* slices = dist + QB * DP;                // 2 x [np][xp]
  float* qs = slices + 2 * SLICE;                // [QB][qp] queries
  float* dds = qs + QB * qp;                     // [NC] norms of a slice
  float* qqs = dds + NC;                         // [QB]
  // between the last distances of a chunk and the first slice of the
  // next: the lane minima [QB][32] and the warp's buffers [QPW][32]
  key_t* lmins = reinterpret_cast<key_t*>(slices);
  key_t* buf = lmins + QB * 32 + w * QPW * 32;

  // the query tile, point-major, channels zero-padded to qp
  for (int i = t; i < QB * qp; i += THREADS) {
    const int r = i / qp, c = i - r * qp;
    qs[i] = r < nq && c < C ? xb[(size_t)(q0 + r) * C + c] : 0.f;
  }
  __syncthreads();
  if (t < QB) {
    float s = 0.f;
    for (int c = 0; c < C; ++c) {
      const float v = qs[t * qp + c];
      s = fmaf(v, v, s);
    }
    qqs[t] = s;
  }
  __syncthreads();

  // This lane's distance micro-tile: queries qd + 4i (warp row w / WC,
  // lane row lane / 8) x points pd + 8r of each sub-tile (warp column
  // w % WC, lane column lane % 8); `slot` numbers the lane's share of a
  // query row, 0..31.
  const int qd = 16 * (w / WC) + (lane >> 3);
  const int pd = 32 * (w % WC) + (lane & 7);
  const int slot = 8 * (w % WC) + (lane & 7);
  float qq[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) qq[i] = qqs[qd + 4 * i];

  // Slices: 16 channels of 128 points, or, for C <= 4, all channels of
  // G sub-tiles at once.
  const int cs = min(CC, C);
  const int xp = pitch(cs);
  const int G = max(1, min(NC / PT, SLICE / (PT * xp)));
  const int PS = G * PT;
  const int ncc = (C + CC - 1) / CC;  // slices per G sub-tiles

  key_t run[QPW];
#pragma unroll
  for (int i = 0; i < QPW; ++i) run[i] = NONE;

  for (int j0 = 0; j0 < N; j0 += NC) {
    const int nc = min(NC, N - j0);
    float lmin_d[4];
    int lmin_j[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      lmin_d[i] = INFINITY;
      lmin_j[i] = -1;
    }
    // slice z of the chunk: points (z / ncc)·PS.., channels (z % ncc)·CC..
    const int nz = (nc + PS - 1) / PS * ncc;
    auto fetch = [&](int z) {
      if (z >= nz) return;
      const int s0 = z / ncc * PS, c0 = z % ncc * CC;
      fetch_slice(slices + (z & 1) * SLICE, xb, C, j0,
                  Slice{s0, min(PS, nc - s0), c0, min(CC, C - c0)}, PS, xp);
    };
    __syncthreads();  // the previous chunk's selection is done with smem
    fetch(0);
    int z = 0;

    for (int s0 = 0; s0 < nc; s0 += PS) {
      const int ps = min(PS, nc - s0);
      for (int sub = 0; sub < ps; sub += PT) {
        float acc[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[i][r] = 0.f;

        for (int c0 = 0, m = 0; c0 < C; c0 += CC, ++m) {
          const int cc = min(CC, C - c0);
          const float* xs = slices + (z & 1) * SLICE;
          if (sub == 0) {
            cp_async_wait_all();
            __syncthreads();  // slice z is in; slice z - 1's buffer is free
            fetch(z + 1);
            // squared norms, one FMA chain per point over ascending c;
            // the block's halves take the slices in turn
            for (int p = t ^ ((m & 1) * PT); p < ps; p += THREADS) {
              float s = c0 == 0 ? 0.f : dds[p];
              for (int c = 0; c < cc; c += 4) {
                const float4 v = *reinterpret_cast<const float4*>(xs + p * xp + c);
                s = fmaf(v.x, v.x, s);
                s = fmaf(v.y, v.y, s);
                s = fmaf(v.z, v.z, s);
                s = fmaf(v.w, v.w, s);
              }
              dds[p] = s;
            }
          }
          const float* qrow = qs + qd * qp + c0;
          const float* xrow = xs + (sub + pd) * xp;
#pragma unroll 2
          for (int c = 0; c < cc; c += 4) {
            float4 qv[4], xv[4];
#pragma unroll
            for (int i = 0; i < 4; ++i)
              qv[i] = *reinterpret_cast<const float4*>(qrow + 4 * i * qp + c);
#pragma unroll
            for (int r = 0; r < 4; ++r)
              xv[r] = *reinterpret_cast<const float4*>(xrow + 8 * r * xp + c);
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int r = 0; r < 4; ++r) {
                acc[i][r] = fmaf(qv[i].x, xv[r].x, acc[i][r]);
                acc[i][r] = fmaf(qv[i].y, xv[r].y, acc[i][r]);
                acc[i][r] = fmaf(qv[i].z, xv[r].z, acc[i][r]);
                acc[i][r] = fmaf(qv[i].w, xv[r].w, acc[i][r]);
              }
          }
          if (sub + PT >= ps) ++z;  // the slice's last sub-tile
        }
        __syncthreads();  // the norms are complete

        const int p = s0 + sub + pd;  // the lane's first point in the chunk
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float dd = dds[sub + pd + 8 * r];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float d = fmaxf(qq[i] - 2.f * acc[i][r] + dd, 0.f);
            // ascending index within the lane: strict < keeps the lowest
            if (p + 8 * r < nc && d < lmin_d[i]) {
              lmin_d[i] = d;
              lmin_j[i] = j0 + p + 8 * r;
            }
            dist[(qd + 4 * i) * DP + p + 8 * r] = d;
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
      lmins[(qd + 4 * i) * 32 + slot] =
          lmin_j[i] < 0 ? NONE : make_key(lmin_d[i], lmin_j[i]);
    __syncthreads();  // every warp's distances and lane minima are in

    // Selection for queries QPW*w .. QPW*w + 3, interleaved.
    const int qs0 = QPW * w;
    key_t tau[QPW];
#pragma unroll
    for (int i = 0; i < QPW; ++i) tau[i] = lmins[(qs0 + i) * 32 + lane];
    warp_sort(tau, lane);
    int cnt[QPW];
#pragma unroll
    for (int i = 0; i < QPW; ++i) {
      tau[i] = kmin(__shfl_sync(FULL, tau[i], k - 1),
                    __shfl_sync(FULL, run[i], k - 1));
      cnt[i] = 0;
    }
    const float* row = dist + qs0 * DP;
    const unsigned below = (1u << lane) - 1u;
    for (int pb = 0; pb < nc; pb += 32) {
      const int p = pb + lane;
      key_t key[QPW];
      bool pass[QPW];
      unsigned ball[QPW];
#pragma unroll
      for (int i = 0; i < QPW; ++i) {
        key[i] = make_key(row[i * DP + p], j0 + p);
        pass[i] = p < nc && qs0 + i < nq && key[i] <= tau[i];
        ball[i] = __ballot_sync(FULL, pass[i]);
      }
#pragma unroll
      for (int i = 0; i < QPW; ++i) {
        if (cnt[i] + __popc(ball[i]) > 32) {  // uniform: flush, refilter
          run[i] = flush_one(buf + 32 * i, cnt[i], run[i], lane);
          cnt[i] = 0;
          tau[i] = kmin(tau[i], __shfl_sync(FULL, run[i], k - 1));
          pass[i] = pass[i] && key[i] <= tau[i];
          ball[i] = __ballot_sync(FULL, pass[i]);
        }
        if (pass[i]) buf[32 * i + cnt[i] + __popc(ball[i] & below)] = key[i];
        cnt[i] += __popc(ball[i]);
      }
    }
    flush(buf, cnt, run, lane);
  }

#pragma unroll
  for (int i = 0; i < QPW; ++i)
    if (QPW * w + i < nq) emit(q0 + QPW * w + i, run[i]);
}

}  // namespace knn_topk
