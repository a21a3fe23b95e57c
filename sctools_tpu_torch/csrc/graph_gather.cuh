// Row-gather core of graph_matvec.cu and graph_rmatvec.cu, for Hopper
// (sm_90a).
//
// Both kernels compute, for each output row o of y (n, d),
//   y[o, :] = sum over o's pairs (s, w) in list order of w * x[s, :]
// with one fmaf per pair and column, from 0, in list order: matvec's
// list is row o's k slots (ids outside x skipped), rmatvec's the
// incoming edges of destination o in ascending (r, t) order.  Every
// output element is therefore one fmaf chain whose order depends on the
// list alone, never on which path below computes it: the result is the
// same bit for bit whatever the path, vector width, lane group or slab,
// and a column slice of x gives that slice of y.  The lists of
// consecutive rows are consecutive runs of one numbering of the pairs.
//
// What bounds it on an H100: the gathers.  Each pair reads a d-wide row
// of x named by an id that is random in the kNN graph's natural order
// (and nearly so after an RCM reorder of clustered cells), so the
// gathers move e * d * 4 bytes (3.8 GB at 1.03M edges and d = 914)
// against the (x rows + n) * d * 4 bytes that the bound counts.  Once x
// outgrows the 50 MB L2 those gathers fall on HBM.  At small d the
// latency of dependent loads bounds it instead, and rmatvec's lists are
// as long as a destination's in-degree (far above k at a kNN graph's
// hubs).
//
// Design.
// * d <= 4 (narrow_kernel): one lane per output row, all columns.  A
//   warp stages the pairs of its 32 rows, one window of 256 or 512
//   consecutive pairs at a time, all 32 lanes loading (source, weight,
//   x values) of any row's pairs, so a hub's pairs are loaded 32 wide;
//   then each lane sums its own row's pairs from shared memory.
// * d > 4 (gather_kernel): a group of G lanes owns one output row (G =
//   2 .. 32, the smallest that covers a narrow row, a warp for a wide
//   one).  Columns are read as float4 when d % 4 == 0, float2 when d is
//   even, floats otherwise, if x's and y's pointers allow it.  A lane
//   keeps R vector accumulators (register blocking), so one walk over
//   the staged pairs serves a tile of G * R * VEC = TILE_COLS columns,
//   and puts the loads of U pairs (16 floats a lane) in flight before
//   their fmafs.
// * L2 slabs (gather_kernel): the grid runs slab-major.  A slab is the
//   widest run of column tiles whose slice of x (x rows * slab columns *
//   4 bytes) fits SLAB_BYTES; every output row sweeps slab 0, then slab
//   1, ..., so the random gathers of one slab hit L2 once its slice is
//   resident, and HBM sees x about once.  A group stages its pairs
//   (CHUNK at a time: an in-degree is unbounded) in shared memory once
//   per slab and walks them once per tile.
//
// TILE_COLS and SLAB_BYTES are compile-time sizes, set in each kernel's
// source, chosen by measurement on an H100 80GB HBM3 at 700 W
// (graph_kernel_sweep.py: 68,579 rows, k = 15, d = 914 and 2000).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace sct_gather {

constexpr int THREADS = 128;

// pairs a warp stages at a time in narrow_kernel: a hub's run in few
// windows, within 32 KB of shared memory a block
__host__ __device__ constexpr int window_for(int d) {
  return d <= 2 ? 512 : 256;
}

// staged pairs per group: two per lane, at least 16
__host__ __device__ constexpr int chunk_for(int g) {
  return 2 * g > 16 ? 2 * g : 16;
}

// A row's pair list: pairs first .. first + count - 1 of the kernel's own
// numbering.
struct List {
  int64_t first;
  int count;
};

template <int VEC> struct Vec;
template <> struct Vec<1> { using T = float; };
template <> struct Vec<2> { using T = float2; };
template <> struct Vec<4> { using T = float4; };

__device__ __forceinline__ void zero(float& a) { a = 0.f; }
__device__ __forceinline__ void zero(float2& a) { a = make_float2(0.f, 0.f); }
__device__ __forceinline__ void zero(float4& a) {
  a = make_float4(0.f, 0.f, 0.f, 0.f);
}
__device__ __forceinline__ void fma_into(float w, float v, float& a) {
  a = fmaf(w, v, a);
}
__device__ __forceinline__ void fma_into(float w, float2 v, float2& a) {
  a.x = fmaf(w, v.x, a.x);
  a.y = fmaf(w, v.y, a.y);
}
__device__ __forceinline__ void fma_into(float w, float4 v, float4& a) {
  a.x = fmaf(w, v.x, a.x);
  a.y = fmaf(w, v.y, a.y);
  a.z = fmaf(w, v.z, a.z);
  a.w = fmaf(w, v.w, a.w);
}

// ----------------------------------------------------------------------
// d <= 4: one lane per row, a warp staging 32 rows' pairs
// ----------------------------------------------------------------------

// Rows 32 * (blockIdx.x * THREADS / 32 + warp) + lane; x and y (rows, D).
template <int D, class Pairs>
__global__ void __launch_bounds__(THREADS)
    narrow_kernel(Pairs pairs, const float* __restrict__ x,
                  float* __restrict__ y, int n) {
  constexpr int WARPS = THREADS / 32;
  constexpr int WINDOW = window_for(D);
  constexpr int PER = WINDOW / 32;  // pairs a lane stages per window
  __shared__ int s_src[WARPS][WINDOW];
  __shared__ float s_w[WARPS][WINDOW];
  __shared__ float s_x[WARPS][WINDOW * D];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t o0 = ((int64_t)blockIdx.x * WARPS + warp) * 32;
  if (o0 >= n) return;  // the whole warp leaves together
  const int64_t o = o0 + lane;
  const List list = o < n ? pairs.range(o) : List{0, 0};
  // the warp's window: from its first row's first pair to its last
  // row's end, the rows' lists being consecutive runs
  const int last = (int)(n - 1 - o0 < 31 ? n - 1 - o0 : 31);
  const long long w0 = __shfl_sync(0xffffffffu, (long long)list.first, 0);
  const long long w1 = __shfl_sync(
      0xffffffffu, (long long)(list.first + list.count), last);
  const long long end = list.first + list.count;
  float acc[D];
#pragma unroll
  for (int c = 0; c < D; ++c) acc[c] = 0.f;
  for (long long b = w0; b < w1; b += WINDOW) {
    const int cnt = (int)(w1 - b < WINDOW ? w1 - b : WINDOW);
    int s[PER];
    float wt[PER], v[PER][D];
#pragma unroll
    for (int p = 0; p < PER; ++p) {
      s[p] = -1;
      wt[p] = 0.f;
      if (lane + p * 32 < cnt) pairs.load(b + lane + p * 32, s[p], wt[p]);
    }
#pragma unroll
    for (int p = 0; p < PER; ++p)
#pragma unroll
      for (int c = 0; c < D; ++c)
        v[p][c] = s[p] >= 0 ? x[(int64_t)s[p] * D + c] : 0.f;
    __syncwarp();  // every lane is done with the previous window
#pragma unroll
    for (int p = 0; p < PER; ++p) {
      const int j = lane + p * 32;
      if (j < cnt) {
        s_src[warp][j] = s[p];
        s_w[warp][j] = wt[p];
#pragma unroll
        for (int c = 0; c < D; ++c) s_x[warp][j * D + c] = v[p][c];
      }
    }
    __syncwarp();
    const long long lo = list.first > b ? list.first : b;
    const long long hi = end < b + cnt ? end : b + cnt;
#pragma unroll 4
    for (long long j = lo; j < hi; ++j) {
      const int jj = (int)(j - b);
      if (s_src[warp][jj] < 0) continue;
      const float wj = s_w[warp][jj];
#pragma unroll
      for (int c = 0; c < D; ++c)
        acc[c] = fmaf(wj, s_x[warp][jj * D + c], acc[c]);
    }
  }
  if (o < n) {
#pragma unroll
    for (int c = 0; c < D; ++c) y[o * D + c] = acc[c];
  }
}

// ----------------------------------------------------------------------
// d > 4: a lane group per row, column tiles, L2 slabs
// ----------------------------------------------------------------------

// Stages pairs first .. first + cnt - 1 (cnt <= chunk_for(G)) into src
// and ws; each lane loads its chunk_for(G) / G pairs together.
template <int G, class Pairs>
__device__ __forceinline__ void stage(const Pairs& pairs, int64_t first,
                                      int cnt, int lane, int* src,
                                      float* ws) {
  constexpr int PER = chunk_for(G) / G;
  int s[PER];
  float w[PER];
#pragma unroll
  for (int p = 0; p < PER; ++p)
    if (lane + p * G < cnt) pairs.load(first + lane + p * G, s[p], w[p]);
#pragma unroll
  for (int p = 0; p < PER; ++p) {
    const int j = lane + p * G;
    if (j < cnt) {
      src[j] = s[p];
      ws[j] = w[p];
    }
  }
}

// acc[i] = fmaf(ws[j], x[src[j], col[i]], acc[i]) for j = 0 .. cnt-1 in
// order, skipping pairs whose source is negative; x is in vectors, dv a
// row.  The loads of U pairs go out before their fmafs.
template <int VEC, int R>
__device__ __forceinline__ void sum_chunk(
    const int* src, const float* ws, int cnt,
    const typename Vec<VEC>::T* __restrict__ x, int64_t dv,
    const int (&col)[R], const bool (&act)[R],
    typename Vec<VEC>::T (&acc)[R]) {
  using V = typename Vec<VEC>::T;
  constexpr int U = 16 / (R * VEC) < 2 ? 2 : 16 / (R * VEC);
  for (int j = 0; j < cnt; j += U) {
    V v[U][R];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (j + u >= cnt) break;
      const int s = src[j + u];
      const V* row = x + (int64_t)(s < 0 ? 0 : s) * dv;
#pragma unroll
      for (int i = 0; i < R; ++i)
        if (act[i]) v[u][i] = row[col[i]];
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (j + u >= cnt) break;
      if (src[j + u] < 0) continue;
      const float wt = ws[j + u];
#pragma unroll
      for (int i = 0; i < R; ++i)
        if (act[i]) fma_into(wt, v[u][i], acc[i]);
    }
  }
}

// One group of G lanes per output row; block b covers rows
// (b % nb) * (THREADS / G) ... of slab b / nb, whose column tiles are
// [slab * tps, min(slab * tps + tps, n_tiles)), a tile being G * R
// vectors.  Pairs: `pairs.range(o)` is row o's List, `pairs.load(first
// + j, src, w)` stages its j-th pair (src < 0: a pair that adds nothing).
template <int VEC, int G, int R, class Pairs>
__global__ void __launch_bounds__(THREADS)
    gather_kernel(Pairs pairs, const float* __restrict__ x,
                  float* __restrict__ y, int n, int dv, int n_tiles,
                  int tps, int nb) {
  using V = typename Vec<VEC>::T;
  constexpr int CHUNK = chunk_for(G);
  __shared__ int s_src[THREADS / G * CHUNK];
  __shared__ float s_w[THREADS / G * CHUNK];
  const int grp = threadIdx.x / G, lane = threadIdx.x % G;
  const int slab = blockIdx.x / nb;
  const int64_t o = (int64_t)(blockIdx.x % nb) * (THREADS / G) + grp;
  if (o >= n) return;  // the whole group leaves together
  const unsigned gmask = (unsigned)((1ull << G) - 1ull)
                        << (threadIdx.x % 32 / G * G);
  int* src = s_src + grp * CHUNK;
  float* ws = s_w + grp * CHUNK;
  const List list = pairs.range(o);
  const int t0 = slab * tps;
  const int t1 = min(t0 + tps, n_tiles);
  const bool one_chunk = list.count <= CHUNK;  // staged once for every tile

  if (one_chunk) {
    stage<G>(pairs, list.first, list.count, lane, src, ws);
    __syncwarp(gmask);
  }
  const V* xv = reinterpret_cast<const V*>(x);
  V* yv = reinterpret_cast<V*>(y) + o * dv;
  for (int t = t0; t < t1; ++t) {
    int col[R];
    bool act[R];
    V acc[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      col[i] = t * (G * R) + i * G + lane;
      act[i] = col[i] < dv;
      zero(acc[i]);
    }
    for (int base = 0; base < list.count; base += CHUNK) {
      const int cnt = min(CHUNK, list.count - base);
      if (!one_chunk) {
        __syncwarp(gmask);  // the group is done with the previous chunk
        stage<G>(pairs, list.first + base, cnt, lane, src, ws);
        __syncwarp(gmask);
      }
      sum_chunk<VEC, R>(src, ws, cnt, xv, dv, col, act, acc);
    }
#pragma unroll
    for (int i = 0; i < R; ++i)
      if (act[i]) yv[col[i]] = acc[i];
  }
}

// ----------------------------------------------------------------------
// host side
// ----------------------------------------------------------------------

// gather_kernel's launch shape for n output rows of width d > 4
// gathered from an x of x_rows rows.
struct Plan {
  int vec, g, r;   // vector width, lanes per row, vectors per lane
  int dv;          // vectors per row
  int n_tiles;     // column tiles of g * r vectors
  int tps;         // tiles per slab
  int nb;          // blocks per slab
  int64_t grid;
};

inline int pow2_at_least(int v) {
  int p = 1;
  while (p < v) p *= 2;
  return p;
}

inline Plan plan(int n, int64_t x_rows, int d, const void* x, const void* y,
                 int tile_cols, int64_t slab_bytes) {
  Plan p;
  const uintptr_t xa = (uintptr_t)x, ya = (uintptr_t)y;
  p.vec = d % 4 == 0 && xa % 16 == 0 && ya % 16 == 0   ? 4
          : d % 2 == 0 && xa % 8 == 0 && ya % 8 == 0 ? 2
                                                      : 1;
  p.dv = d / p.vec;
  if (p.dv <= 32) {  // one tile: the smallest group that covers the row
    p.g = pow2_at_least(p.dv);
    p.r = 1;
  } else {  // tiles of tile_cols columns, 32 lanes where they fill them
    p.g = tile_cols / p.vec >= 32 ? 32 : tile_cols / p.vec;
    p.r = tile_cols / (p.vec * p.g);
  }
  const int tile = p.g * p.r;
  p.n_tiles = (p.dv + tile - 1) / tile;
  const int64_t tile_bytes = x_rows * tile * p.vec * 4;
  int64_t tps = tile_bytes > 0 ? slab_bytes / tile_bytes : p.n_tiles;
  p.tps = (int)(tps < 1 ? 1 : tps > p.n_tiles ? p.n_tiles : tps);
  const int rows_per_block = THREADS / p.g;
  p.nb = (int)(((int64_t)n + rows_per_block - 1) / rows_per_block);
  p.grid = (int64_t)p.nb * ((p.n_tiles + p.tps - 1) / p.tps);
  return p;
}

template <int VEC, int G, int R, class Pairs>
void launch_as(const Plan& p, const Pairs& pairs, const float* x, float* y,
               int n, cudaStream_t s) {
  gather_kernel<VEC, G, R, Pairs><<<(unsigned)p.grid, THREADS, 0, s>>>(
      pairs, x, y, n, p.dv, p.n_tiles, p.tps, p.nb);
}

template <int VEC, class Pairs>
int launch_vec(const Plan& p, const Pairs& pairs, const float* x, float* y,
               int n, cudaStream_t s) {
  switch (p.g * 8 + p.r) {
    case 2 * 8 + 1: launch_as<VEC, 2, 1>(p, pairs, x, y, n, s); break;
    case 4 * 8 + 1: launch_as<VEC, 4, 1>(p, pairs, x, y, n, s); break;
    case 8 * 8 + 1: launch_as<VEC, 8, 1>(p, pairs, x, y, n, s); break;
    case 16 * 8 + 1: launch_as<VEC, 16, 1>(p, pairs, x, y, n, s); break;
    case 32 * 8 + 1: launch_as<VEC, 32, 1>(p, pairs, x, y, n, s); break;
    case 32 * 8 + 2: launch_as<VEC, 32, 2>(p, pairs, x, y, n, s); break;
    case 32 * 8 + 4: launch_as<VEC, 32, 4>(p, pairs, x, y, n, s); break;
    default: return (int)cudaErrorInvalidConfiguration;
  }
  return (int)cudaGetLastError();
}

template <int D, class Pairs>
int launch_narrow(const Pairs& pairs, const float* x, float* y, int n,
                  cudaStream_t s) {
  const unsigned grid = (unsigned)(((int64_t)n + THREADS - 1) / THREADS);
  narrow_kernel<D, Pairs><<<grid, THREADS, 0, s>>>(pairs, x, y, n);
  return (int)cudaGetLastError();
}

// Launches the gather of n rows of width d from an x of x_rows rows:
// returns a CUDA error code (0 on success).
template <class Pairs>
int launch(const Pairs& pairs, const float* x, float* y, int n,
           int64_t x_rows, int d, int tile_cols, int64_t slab_bytes,
           cudaStream_t s) {
  switch (d) {  // one lane per row
    case 1: return launch_narrow<1>(pairs, x, y, n, s);
    case 2: return launch_narrow<2>(pairs, x, y, n, s);
    case 3: return launch_narrow<3>(pairs, x, y, n, s);
    case 4: return launch_narrow<4>(pairs, x, y, n, s);
  }
  const Plan p = plan(n, x_rows, d, x, y, tile_cols, slab_bytes);
  if (p.grid > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  if (p.vec == 4) return launch_vec<4>(p, pairs, x, y, n, s);
  if (p.vec == 2) return launch_vec<2>(p, pairs, x, y, n, s);
  return launch_vec<1>(p, pairs, x, y, n, s);
}

}  // namespace sct_gather
