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
// matmuls because Mosaic has no in-kernel gather, and it kept a whole
// cloud's u in VMEM. Hopper gathers, but has no VMEM of that size: a block
// keeps a channel slice of one cloud's u in shared memory instead.
//
// Bound: bytes. Each output element needs k gathered values and 2-4
// operations on each, so the least time is u and idx read once plus the
// outputs written once over the memory rate. What a design adds to that
// is the gathers' traffic: read from L2 per edge, it is k times u.
//
// Design (both kernels): a block owns one cloud b and one slice of cs
// channels (cs a power of two <= 32; `ops/kernels/edge.py::plan` picks it,
// narrower for larger N) and copies u[b, :, slice], N x cs floats, into
// shared memory with cp.async (16 bytes a thread where the rows allow).
// Every gather of a neighbour's value is then a shared-memory load. The
// block also stages its queries' k indices, int64 from K1, in shared
// memory as int32 offsets of tile rows, after a range check, so that no
// load waits on another load from memory.
//
// The forward splits each (cloud, slice) into `split` ranges of queries,
// one block each, so that enough blocks fill the SMs: u is copied once per
// range and the indices once per slice. A thread's item is W channels of
// one query (W = 4 where the rows allow 16-byte loads, else 1): the cs / W
// lanes of a query read one row of the tile, so at cs = 32 each quarter
// warp reads one 128-byte row, free of bank conflicts. max/min select
// values without arithmetic (fmaxf/fminf), so they equal any other max/min
// of the same set; the sums run in neighbour order with s += v and
// ss = fmaf(v, v, ss). An index outside [0, N) yields NaN in every output
// of that point (a per-query flag set while staging).

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

#include <mutex>
#include <set>
#include <type_traits>
#include <utility>

namespace {

constexpr int MAX_THREADS = 1024;
constexpr int64_t SMEM_LIMIT = 232448;  // shared memory one block may use

// Bytes of one [rows][cs] float tile, rounded up to 16.
__host__ __device__ inline int64_t tile_bytes(int rows, int cs) {
  return ((int64_t)rows * cs * 4 + 15) / 16 * 16;
}

// Row stride of the staged indices: odd, so that the rows of up to 32
// queries read together start on distinct banks.
__host__ __device__ inline int idx_stride(int kc) { return kc | 1; }

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Start copying u[b, :, c0:c0+cw] (`ub` points at u[b, 0, c0]) into
// tile[n * cs + c]: 16 bytes a thread when `vec` (C and cs multiples of 4
// and u 16-byte aligned), else 4. Consecutive threads take consecutive
// pieces of a row, so the reads are coalesced along the rows.
__device__ void stage_tile(float* tile, const float* __restrict__ ub, int N,
                           int C, int cs, int cw, bool vec) {
  if (vec) {
    const int per_row = cw >> 2;
    for (int e = threadIdx.x; e < N * per_row; e += blockDim.x) {
      const int n = e / per_row, v = e - n * per_row;
      cp_async16(tile + n * cs + 4 * v, ub + (int64_t)n * C + 4 * v);
    }
  } else {
    for (int e = threadIdx.x; e < N * cw; e += blockDim.x) {
      const int n = e / cw, c = e - n * cw;
      cp_async4(tile + n * cs + c, ub + (int64_t)n * C + c);
    }
  }
}

// idx_s[q * ks + j] = (rows[q * k + j] << cs_log2), the offset of that
// row in a tile, for q < nq, j < kn. An index outside [0, N) stages as
// `bad_off` and, when `flags` is given, sets flags[q].
__device__ void stage_idx(int* idx_s, int* flags,
                          const int64_t* __restrict__ rows, int nq, int k,
                          int kn, int ks, int N, int cs_log2, int bad_off) {
#pragma unroll 16
  for (int e = threadIdx.x; e < nq * kn; e += blockDim.x) {
    const int q = e / kn, j = e - q * kn;
    const int64_t m = rows[(int64_t)q * k + j];
    const bool ok = m >= 0 && m < N;
    idx_s[q * ks + j] = ok ? (int)m << cs_log2 : bad_off;
    if (!ok && flags != nullptr) flags[q] = 1;
  }
}

// Shared memory: the u tile, then the index chunk of qc rows of kc at
// stride idx_stride(kc), then qc per-query flags.
//
// Grid: x = B * split (cloud b = x / split, query range x % split of
// `qr` queries), y = channel slices. The range's indices are staged in
// chunks of qc queries and kc neighbours; when kc >= k (always for k up
// to a few thousand) each chunk is staged once, else per item wave.
template <bool MOMENTS, int W>
__global__ void __launch_bounds__(MAX_THREADS, 1)
edge_moments_kernel(const float* __restrict__ u,
                    const int64_t* __restrict__ idx,
                    float* __restrict__ mx, float* __restrict__ mn,
                    float* __restrict__ s1, float* __restrict__ s2,
                    int N, int C, int k, int cs_log2, int split, int qr,
                    int qc, int kc) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int cs = 1 << cs_log2;
  const int ks = idx_stride(kc);
  float* tile = reinterpret_cast<float*>(smem);
  int* idx_s = reinterpret_cast<int*>(smem + tile_bytes(N, cs));
  int* bad = idx_s + qc * ks;
  const int b = blockIdx.x / split;
  const int qa = (blockIdx.x - b * split) * qr, qb = min(N, qa + qr);
  const int c0 = blockIdx.y << cs_log2, cw = min(cs, C - c0);
  const int64_t cloud = (int64_t)b * N;
  const bool one_pass = kc >= k;
  const int lanes_log2 = cs_log2 - (W == 4 ? 2 : 0);  // lanes per query

  stage_tile(tile, u + cloud * C + c0, N, C, cs, cw, W == 4);
  for (int q0 = qa; q0 < qb; q0 += qc) {
    const int nq = min(qc, qb - q0);
    const int64_t* rows = idx + (cloud + q0) * k;
    __syncthreads();  // the previous chunk's readers are done
    for (int q = threadIdx.x; q < nq; q += blockDim.x) bad[q] = 0;
    __syncthreads();
    if (one_pass) {
      stage_idx(idx_s, bad, rows, nq, k, k, ks, N, cs_log2, 0);
      cp_async_wait_all();
      __syncthreads();
    }
    for (int w0 = 0; w0 < nq << lanes_log2; w0 += blockDim.x) {
      const int e = w0 + threadIdx.x;
      const int ql = e >> lanes_log2;
      const int c = (e & ((1 << lanes_log2) - 1)) * W;
      const bool live = ql < nq && c < cw;
      const int* nb = idx_s + ql * ks;
      const float* tc = tile + c;
      float hi[W], lo[W], s[W], ss[W];
#pragma unroll
      for (int w = 0; w < W; ++w) {
        hi[w] = -INFINITY;
        lo[w] = INFINITY;
        s[w] = ss[w] = 0.f;
      }
      for (int j0 = 0; j0 < k; j0 += kc) {
        const int kn = min(kc, k - j0);
        if (!one_pass) {
          __syncthreads();
          stage_idx(idx_s, bad, rows + j0, nq, k, kn, ks, N, cs_log2, 0);
          cp_async_wait_all();
          __syncthreads();
        }
        if (!live) continue;
#pragma unroll 4
        for (int j = 0; j < kn; ++j) {
          float v[W];
          if (W == 4) {
            const float4 t = *reinterpret_cast<const float4*>(tc + nb[j]);
            v[0] = t.x;
            v[1] = t.y;
            v[2] = t.z;
            v[3] = t.w;
          } else {
            v[0] = tc[nb[j]];
          }
#pragma unroll
          for (int w = 0; w < W; ++w) {
            hi[w] = fmaxf(hi[w], v[w]);
            lo[w] = fminf(lo[w], v[w]);
            if (MOMENTS) {
              s[w] += v[w];
              ss[w] = fmaf(v[w], v[w], ss[w]);
            }
          }
        }
      }
      if (!live) continue;
      if (bad[ql]) {
#pragma unroll
        for (int w = 0; w < W; ++w) hi[w] = lo[w] = s[w] = ss[w] = NAN;
      }
      const int64_t o = (cloud + q0 + ql) * C + c0 + c;
      if (W == 4) {
        *reinterpret_cast<float4*>(mx + o) = make_float4(hi[0], hi[1], hi[2], hi[3]);
        *reinterpret_cast<float4*>(mn + o) = make_float4(lo[0], lo[1], lo[2], lo[3]);
        if (MOMENTS) {
          *reinterpret_cast<float4*>(s1 + o) = make_float4(s[0], s[1], s[2], s[3]);
          *reinterpret_cast<float4*>(s2 + o) = make_float4(ss[0], ss[1], ss[2], ss[3]);
        }
      } else {
        mx[o] = hi[0];
        mn[o] = lo[0];
        if (MOMENTS) {
          s1[o] = s[0];
          s2[o] = ss[0];
        }
      }
    }
  }
  cp_async_wait_all();  // a block without queries leaves no copy in flight
}

// Backward (K2-bwd). Replaces the TPU kernel `_edge_moments_bwd`
// (mlsp_tpu/ops/pallas/edge_pallas.py, body `_bwd_kernel`): given the
// cotangents of (mx, mn, s1, s2), the gradient with respect to u,
//     du_j = Σ_{i: j ∈ nbr(i)} ds1_i + 2 u_j ds2_i
//            + [u_j == mx_i] dmx_i / #ties_max_i
//            + [u_j == mn_i] dmn_i / #ties_min_i,
// the max and min cotangents shared equally among the neighbours tied at
// the extreme (the semantics of the gradient of jnp.max and torch.amax).
// The graph features get no gradient. The TPU kernel sums in a fixed
// order (its grid revisits one du block in sequence), so the same inputs
// give the same du on every run; so does this kernel.
//
// Bound: bytes. u, idx, mx, mn and the four cotangents are read once and
// du written once; each edge costs a few operations.
//
// Design: a block owns one cloud and one channel slice: it holds
// u[b, :, slice] and a du accumulator of the same shape in shared memory
// and walks the cloud's queries, reading each query's slice of mx, mn and
// the cotangents once from memory, the next wave's while this one runs.
// One pass over the k neighbours adds ds1_i + 2 u_j ds2_i into the
// accumulator and counts the ties with the saved mx and mn (float ==, as
// the plain version's amax backward compares; it differs from a bitwise
// compare only at ±0), remembering the last tied row. A single tie (the
// usual case) takes its whole cotangent with one more add; several ties
// share it equally in a second pass over the neighbours.
//
// The adds are in fixed point, so that their order does not matter. Each
// term becomes an integer q in units of 2^-s, split as q = h 2^L + l with
// 0 <= l < 2^L, and h and l go to two 32-bit integer accumulators by
// native shared-memory atomics (ATOMS.ADD). Integer addition is
// associative, so du is the same on every launch whatever order the warps
// add in. (Hopper has no native float or 64-bit add in shared memory:
// atomicAdd there is a compare-and-swap loop, ATOMS.CAST.SPIN, and a float
// one adds in an order that changes from run to run.) A sum term is
// round(ds1_i 2^s) + round(fl(2 ds2_i 2^s · u_j)), the first once a
// (query, channel), so an edge costs one float product and one conversion;
// a tie's share is round(w 2^s). du = (Σh 2^L + Σl) 2^-s, exactly the sum
// of the rounded terms. A pre-pass picks L and s: with D the cloud's
// largest in-degree (`edge_in_degree_kernel`, launched first), an element
// takes at most 3D adds, so L = 32 - bits(3D) keeps Σl below 2^32; with M
// the largest of |ds1_i| + 2 |ds2_i| U + |dmx_i| + |dmn_i| over the
// block's queries and channels (U the largest |u| of its tile; non-finite
// values left out), no element's terms sum to more than D M in magnitude,
// and s is the largest integer with D M 2^s < 2^(30 + L), which keeps
// |Σh| below 2^31. A term is off its float value (the product rounded once,
// as the plain version's float arithmetic rounds) by at most 2^-s < 2 D M
// 2^-(30+L): an element of d <= D terms by less than 2 D² M 2^-(30+L) <
// 12 D³ M 2^-62 (at D = 50, 4e-13 M; at D = 1024, every point one, 3e-9
// M), then rounded once to float. The launcher refuses N k > 2^28, so that
// 3D < 2^30 and Σh, at most 2^30 + 3D in magnitude, stays below 2^31.
// `ops/kernels/edge.py::fixed_point_split` is the pre-pass in plain
// PyTorch. A non-finite term (a NaN or inf in u or a cotangent) is not
// added: it sets the block's flag, and once du is written a second walk
// adds those terms alone to du with float atomics, whose result (NaN,
// +inf or -inf) does not depend on their order either.
//
// du is written once, coalesced: no global atomics (but the non-finite
// walk's) and no zero fill. A null cotangent pointer (an unused output)
// skips its term, and with neither ds1 nor ds2 no sum term is added. An
// index outside [0, N) points at a spare row N whose u is NaN: it ties
// with nothing, and what is added to the spare row is never written.
//
// Slower on an H100 in the paper train step, and not kept (profiled, ms
// of K2-bwd a step, against this kernel's 2.31): each term converted
// through double and the in-degrees counted in every slice's block 2.46;
// one 64-bit integer accumulator 2.63 (its shared atomicAdd is a
// compare-and-swap loop). 8-channel slices with the whole index at once
// took 2.26 there but 10.22 against 9.48 in the all-branch step.
// Alone, converting the terms in float or by integer operations on their
// bits was 2% and 17% slower than through double. Faster, and not kept:
// the earlier kernel, which added in float with shared-memory atomicAdd
// (1.52; not reproducible). Also slower, measured earlier: a cluster of
// blocks per (cloud, slice) summing du partials through distributed shared
// memory (the blocks already fill the SMs); 2 or 4 channels a thread added
// by one 8- or 16-byte compare-and-swap loop; and gathering du over
// in-neighbour lists built per call, which turns the scatter around but
// pays for the build and for the uneven in-degrees of kNN graphs.
//
// Shared memory: the u tile (float), the accumulators' l and h words
// (32-bit), each of N + 1 rows (row N is the spare), 8 ints of block
// scratch (the pre-pass's maxima, the non-finite flag), then the index
// chunk of qc rows of kc at stride idx_stride(kc).
//
// Grid: x = clouds, y = channel slices. One thread per (query,
// channel): a warp's lanes are cs channels of 32 / cs queries.
constexpr int BWD_SCRATCH = 8;  // ints of block scratch
constexpr int64_t BWD_MAX_EDGES = 1ll << 28;  // N k of one cloud
constexpr int MAX_U = 4, NONFINITE = 5;

// |x| if x is finite, else 0.
__device__ __forceinline__ float finite_abs(float x) {
  const float a = fabsf(x);
  return a <= FLT_MAX ? a : 0.f;
}

// red[slot] = max over the block of the non-negative v: as ints, so that
// floats >= 0 compare as their bit patterns do; exact in any order.
__device__ __forceinline__ void block_max(int* red, int slot, unsigned v) {
  const unsigned w = __reduce_max_sync(0xffffffffu, v);
  if ((threadIdx.x & 31) == 0) atomicMax(red + slot, (int)w);
}

// degree[b] = the largest in-degree of cloud b's graph (indices outside
// [0, N) not counted), for K2-bwd's pre-pass: one block a cloud, N
// counters in shared memory.
__global__ void __launch_bounds__(MAX_THREADS)
edge_in_degree_kernel(const int64_t* __restrict__ idx, int* degree, int N,
                      int k) {
  extern __shared__ unsigned count[];
  for (int n = threadIdx.x; n < N; n += blockDim.x) count[n] = 0u;
  if (threadIdx.x == 0) count[N] = 0u;  // the block's maximum
  __syncthreads();
  const int64_t* edges = idx + (int64_t)blockIdx.x * N * k;
#pragma unroll 8
  for (int e = threadIdx.x; e < N * k; e += blockDim.x) {
    const int64_t m = edges[e];
    if (m >= 0 && m < N) atomicAdd(count + m, 1u);
  }
  __syncthreads();
  unsigned most = 0u;
  for (int n = threadIdx.x; n < N; n += blockDim.x) most = max(most, count[n]);
  most = __reduce_max_sync(0xffffffffu, most);
  if ((threadIdx.x & 31) == 0) atomicMax(count + N, most);
  __syncthreads();
  if (threadIdx.x == 0) degree[blockIdx.x] = (int)count[N];
}

__global__ void __launch_bounds__(MAX_THREADS, 1)
edge_moments_bwd_kernel(const float* __restrict__ u,
                        const int64_t* __restrict__ idx,
                        const float* __restrict__ mx,
                        const float* __restrict__ mn,
                        const float* __restrict__ dmx,
                        const float* __restrict__ dmn,
                        const float* __restrict__ ds1,
                        const float* __restrict__ ds2,
                        const int* __restrict__ degree,
                        float* __restrict__ du,
                        int N, int C, int k, int cs_log2, int qc, int kc,
                        int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int cs = 1 << cs_log2;
  const int64_t tb = tile_bytes(N + 1, cs);
  float* tile = reinterpret_cast<float*>(smem);
  unsigned* acc_l = reinterpret_cast<unsigned*>(smem + tb);
  int* acc_h = reinterpret_cast<int*>(smem + 2 * tb);
  int* red = reinterpret_cast<int*>(smem + 3 * tb);
  int* idx_s = red + BWD_SCRATCH;
  const int ks = idx_stride(kc);
  const int c0 = blockIdx.y << cs_log2, cw = min(cs, C - c0);
  const int64_t cloud = (int64_t)blockIdx.x * N;
  const bool one_pass = kc >= k;
  const bool has_hi = dmx != nullptr, has_lo = dmn != nullptr;
  const bool has_s = ds1 != nullptr || ds2 != nullptr;
  const int spare = N << cs_log2;

  stage_tile(tile, u + cloud * C + c0, N, C, cs, cw, vec);
  for (int e = threadIdx.x; e < (N + 1) << cs_log2; e += blockDim.x) {
    acc_l[e] = 0u;
    acc_h[e] = 0;
    if (e >= spare) tile[e] = NAN;
  }
  if (threadIdx.x < BWD_SCRATCH) red[threadIdx.x] = 0;

  // Pre-pass: the largest |ds1|, |2 ds2|, |dmx|, |dmn| of the block's
  // queries and the largest |u| of its tile; with the cloud's largest
  // in-degree (`edge_in_degree_kernel`), L and s.
  float m[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
  for (int e = threadIdx.x; e < N << cs_log2; e += blockDim.x) {
    const int n = e >> cs_log2, c = e & (cs - 1);
    if (c >= cw) continue;
    const int64_t o = (cloud + n) * C + c0 + c;
    if (ds1 != nullptr) m[0] = fmaxf(m[0], finite_abs(ds1[o]));
    if (ds2 != nullptr) m[1] = fmaxf(m[1], finite_abs(2.f * ds2[o]));
    if (has_hi) m[2] = fmaxf(m[2], finite_abs(dmx[o]));
    if (has_lo) m[3] = fmaxf(m[3], finite_abs(dmn[o]));
  }
  cp_async_wait_all();
  __syncthreads();  // the tile has landed
  float mu = 0.f;
  for (int e = threadIdx.x; e < N << cs_log2; e += blockDim.x)
    if ((e & (cs - 1)) < cw) mu = fmaxf(mu, finite_abs(tile[e]));
#pragma unroll
  for (int s = 0; s < 4; ++s) block_max(red, s, __float_as_uint(m[s]));
  block_max(red, MAX_U, __float_as_uint(mu));
  __syncthreads();
  int lbits;
  double scale, unscale;
  float scale_a, scale_b;  // 2^s as two floats: each in float's range
  {
    const float* mm = reinterpret_cast<const float*>(red);
    const int d = max(degree[blockIdx.x], 1);
    lbits = __clz(3u * (unsigned)d);  // 32 - bits(3D): 3D 2^L < 2^32
    const double most = (double)d *
        ((double)mm[0] + (double)mm[1] * mm[MAX_U] + mm[2] + mm[3]);
    int e2 = 0;
    if (most > 0.0) frexp(most, &e2);  // most < 2^e2
    const int shift = 30 + lbits - e2;
    scale = ldexp(1.0, shift);
    unscale = ldexp(1.0, -shift);
    scale_a = ldexpf(1.f, shift / 2);
    scale_b = ldexpf(1.f, shift - shift / 2);
  }
  const long long lmask = (1ll << lbits) - 1;

  // (hi, lo, dmx, dmn, ds1, 2 ds2) of item e of the chunk at q0
  auto operands = [&](int q0, int nq, int e, float (&x)[6]) {
    const int ql = e >> cs_log2, c = e & (cs - 1);
    const int64_t o = (cloud + q0 + ql) * C + c0 + c;
    const bool live = ql < nq && c < cw;
    x[0] = live ? mx[o] : 0.f;
    x[1] = live ? mn[o] : 0.f;
    x[2] = live && has_hi ? dmx[o] : 0.f;
    x[3] = live && has_lo ? dmn[o] : 0.f;
    x[4] = live && ds1 != nullptr ? ds1[o] : 0.f;
    x[5] = live && ds2 != nullptr ? 2.f * ds2[o] : 0.f;
  };
  // Walks every edge of the cloud once (twice for a row with several
  // ties). The first walk adds the finite terms to the accumulators and
  // flags a non-finite one; the second (`nonfinite`) adds only those to
  // du, after it has been written.
  auto walk = [&](auto nonfinite) {
    constexpr bool NONFINITE_WALK = decltype(nonfinite)::value;
    // adds q, in units of 2^-s, to channel c of the row at tile offset off
    auto add_q = [&](int off, int c, long long q) {
      const int h = (int)(q >> lbits);
      atomicAdd(acc_l + off + c, (unsigned)(q & lmask));
      if (h != 0) atomicAdd(acc_h + off + c, h);
    };
    // adds term t to channel c of the row at tile offset off
    auto put = [&](int off, int c, float t) {
      if (fabsf(t) <= FLT_MAX) {
        if (!NONFINITE_WALK) add_q(off, c, __double2ll_rn((double)t * scale));
      } else if (off != spare) {
        if (NONFINITE_WALK)
          atomicAdd(du + (cloud + (off >> cs_log2)) * C + c0 + c, t);
        else
          red[NONFINITE] = 1;
      }
    };
    for (int q0 = 0; q0 < N; q0 += qc) {
      const int nq = min(qc, N - q0);
      const int64_t* rows = idx + (cloud + q0) * k;
      float next[6];
      operands(q0, nq, threadIdx.x, next);
      if (one_pass) {
        __syncthreads();
        stage_idx(idx_s, nullptr, rows, nq, k, k, ks, N, cs_log2, spare);
        cp_async_wait_all();
        __syncthreads();
      }
      for (int w0 = 0; w0 < nq << cs_log2; w0 += blockDim.x) {
        const int e = w0 + threadIdx.x;
        const int ql = e >> cs_log2, c = e & (cs - 1);
        const bool live = ql < nq && c < cw;
        const int* nb = idx_s + ql * ks;
        const float* tc = tile + c;
        const float hi = next[0], lo = next[1], g1 = next[4], g2 = next[5];
        float w_hi = next[2], w_lo = next[3];
        operands(q0, nq, e + blockDim.x, next);
        // a sum term as round(g1 2^s) + round((2 ds2 2^s) u_j): one
        // product and one conversion an edge
        const bool g1_fixed = fabsf(g1) <= FLT_MAX;
        const long long q1 =
            g1_fixed ? __float2ll_rn((g1 * scale_a) * scale_b) : 0;
        const float g2s = (g2 * scale_a) * scale_b;
        // the sum terms, and the ties with the saved max and min
        int n_hi = 0, n_lo = 0, at_hi = 0, at_lo = 0;
        for (int j0 = 0; j0 < k; j0 += kc) {
          const int kn = min(kc, k - j0);
          if (!one_pass) {
            __syncthreads();
            stage_idx(idx_s, nullptr, rows + j0, nq, k, kn, ks, N, cs_log2,
                      spare);
            cp_async_wait_all();
            __syncthreads();
          }
          if (!live) continue;
#pragma unroll 4
          for (int j = 0; j < kn; ++j) {
            const int off = nb[j];
            const float v = tc[off];
            if (has_s) {
              const float p = g2s * v;
              if (g1_fixed && fabsf(p) <= FLT_MAX) {
                if (!NONFINITE_WALK) add_q(off, c, q1 + __float2ll_rn(p));
              } else {  // a non-finite operand: the term as a float
                put(off, c, ds2 != nullptr ? fmaf(g2, v, g1) : g1);
              }
            }
            if (v == hi) {
              ++n_hi;
              at_hi = off;
            }
            if (v == lo) {
              ++n_lo;
              at_lo = off;
            }
          }
        }
        // the max and min cotangents: whole to a single tie, else shared
        const bool many_hi = has_hi && n_hi > 1, many_lo = has_lo && n_lo > 1;
        if (live) {
          if (has_hi && n_hi == 1) put(at_hi, c, w_hi);
          if (has_lo && n_lo == 1) put(at_lo, c, w_lo);
        }
        const bool rescan = live && (many_hi || many_lo);
        if (many_hi) w_hi /= (float)n_hi;
        if (many_lo) w_lo /= (float)n_lo;
        for (int j0 = 0; j0 < k && (rescan || !one_pass); j0 += kc) {
          const int kn = min(kc, k - j0);
          if (!one_pass) {
            __syncthreads();
            stage_idx(idx_s, nullptr, rows + j0, nq, k, kn, ks, N, cs_log2,
                      spare);
            cp_async_wait_all();
            __syncthreads();
          }
          if (!rescan) continue;
          for (int j = 0; j < kn; ++j) {
            const int off = nb[j];
            const float v = tc[off];
            if (many_hi && v == hi) put(off, c, w_hi);
            if (many_lo && v == lo) put(off, c, w_lo);
          }
        }
      }
    }
  };

  walk(std::false_type{});
  __syncthreads();
  for (int e = threadIdx.x; e < N << cs_log2; e += blockDim.x) {
    const int n = e >> cs_log2, c = e & (cs - 1);
    if (c < cw) {
      const long long q = (long long)acc_h[e] * (1ll << lbits) + acc_l[e];
      du[(cloud + n) * C + c0 + c] = (float)((double)q * unscale);
    }
  }
  if (red[NONFINITE]) {  // uniform: read after the walk's last barrier
    __syncthreads();  // du is written before the non-finite terms add to it
    walk(std::true_type{});
  }
}

// Common checks of a plan; 0 or cudaErrorInvalidValue. The plan's `smem`
// (`ops/kernels/edge.py::plan` sizes the layouts described above each
// kernel) must fit in SMEM_LIMIT.
int check_plan(int B, int N, int C, int k, int cs_log2, int split, int qc,
               int kc, int threads, int smem) {
  const bool ok = B > 0 && N > 0 && C > 0 && k > 0 && cs_log2 >= 0 &&
                  cs_log2 <= 5 && split >= 1 && split <= N && qc >= 1 &&
                  kc >= 1 && threads >= 32 && threads <= MAX_THREADS &&
                  threads % 32 == 0 && smem > 0 && smem <= SMEM_LIMIT &&
                  (int64_t)B * split <= INT32_MAX &&
                  ((C - 1) >> cs_log2) < 65535;  // slices: grid y
  return ok ? 0 : (int)cudaErrorInvalidValue;
}

// Lets `kernel` take up to SMEM_LIMIT of dynamic shared memory on the
// current device, once per (device, kernel).
template <typename Kernel>
int allow_smem(Kernel kernel, int smem) {
  static std::mutex lock;
  static std::set<std::pair<int, const void*>> done;
  if (smem <= 48 * 1024) return 0;
  int device = 0;
  int st = (int)cudaGetDevice(&device);
  if (st != 0) return st;
  std::lock_guard<std::mutex> hold(lock);
  if (done.count({device, (const void*)kernel})) return 0;
  st = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_LIMIT);
  if (st == 0) done.insert({device, (const void*)kernel});
  return st;
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

}  // namespace

extern "C" {

// u: [B, N, C] float32; idx: [B, N, k] int64; mx, mn (and s1, s2 when
// `moments` is nonzero): [B, N, C] float32, all contiguous. The plan
// (`ops/kernels/edge.py::plan`): slices of 2^cs_log2 channels, `split`
// query ranges of ceil(N / split) per (cloud, slice), index chunks of qc
// queries by kc neighbours, `threads` a block, `smem` bytes of shared
// memory a block. Launches on `stream` and returns the launch status
// (0 = cudaSuccess).
int mlsp_edge_moments(const float* u, const int64_t* idx, float* mx,
                      float* mn, float* s1, float* s2, int B, int N, int C,
                      int k, int moments, int cs_log2, int split, int qc,
                      int kc, int threads, int smem, cudaStream_t stream) {
  const int cs = 1 << (cs_log2 & 31);
  int st = check_plan(B, N, C, k, cs_log2, split, qc, kc, threads, smem);
  if (st != 0) return st;
  const int qr = (N + split - 1) / split;
  const bool vec = C % 4 == 0 && cs % 4 == 0 && aligned16(u) &&
                   aligned16(mx) && aligned16(mn) &&
                   (!moments || (aligned16(s1) && aligned16(s2)));
  const dim3 grid(B * split, (C + cs - 1) / cs);
  auto launch = [&](auto kernel) {
    const int status = allow_smem(kernel, smem);
    if (status != 0) return status;
    kernel<<<grid, threads, smem, stream>>>(u, idx, mx, mn, s1, s2, N, C, k,
                                            cs_log2, split, qr, qc, kc);
    return 0;
  };
  if (moments)
    st = vec ? launch(edge_moments_kernel<true, 4>)
             : launch(edge_moments_kernel<true, 1>);
  else
    st = vec ? launch(edge_moments_kernel<false, 4>)
             : launch(edge_moments_kernel<false, 1>);
  if (st != 0) return st;
  return (int)cudaGetLastError();
}

// u, mx, mn: [B, N, C] float32; idx: [B, N, k] int64; dmx, dmn, ds1, ds2:
// [B, N, C] float32 or null (no cotangent); degree: [B] int32 scratch
// (the in-degree pass writes it); du: [B, N, C] float32, written whole (no
// zero fill needed). All contiguous; N k at most 2^28. Launches the
// in-degree pass, then K2-bwd with the plan as above, without query ranges
// (one block per (cloud, slice)), on `stream`, and returns the launch
// status (0 = cudaSuccess). The same inputs give bit-equal du on every
// launch.
int mlsp_edge_moments_bwd(const float* u, const int64_t* idx, const float* mx,
                          const float* mn, const float* dmx, const float* dmn,
                          const float* ds1, const float* ds2, int* degree,
                          float* du, int B, int N, int C, int k, int cs_log2,
                          int qc, int kc, int threads, int smem,
                          cudaStream_t stream) {
  const int cs = 1 << (cs_log2 & 31);
  int st = check_plan(B, N, C, k, cs_log2, 1, qc, kc, threads, smem);
  if (st != 0) return st;
  if ((int64_t)N * k > BWD_MAX_EDGES) return (int)cudaErrorInvalidValue;
  if ((st = allow_smem(edge_moments_bwd_kernel, smem)) != 0) return st;
  edge_in_degree_kernel<<<B, MAX_THREADS, (N + 1) * sizeof(unsigned),
                          stream>>>(idx, degree, N, k);
  if ((st = (int)cudaGetLastError()) != 0) return st;
  const int vec = C % 4 == 0 && cs % 4 == 0 && aligned16(u);
  const dim3 grid(B, (C + cs - 1) / cs);
  edge_moments_bwd_kernel<<<grid, threads, smem, stream>>>(
      u, idx, mx, mn, dmx, dmn, ds1, ds2, degree, du, N, C, k, cs_log2, qc,
      kc, vec);
  return (int)cudaGetLastError();
}

const char* mlsp_edge_moments_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}

}  // extern "C"
