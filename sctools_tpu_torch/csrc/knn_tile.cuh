// The score tile and the per-thread top-k lists of the binned kNN kernel,
// csrc/knn_binned.cu: the counterpart of _score_tile and _select_topk in
// sctools_tpu/ops/pallas_knn.py.  csrc/knn_select.cu (exact merge)
// scores in the same arithmetic with its own pre-packed, register-blocked
// core and warp-wide lists.
//
// Layout.  One block of THREADS threads owns a tile of QB queries and
// walks candidate tiles of CB rows.  Both tiles are staged transposed in
// shared memory as f32; thread (tx, ty) = (tid % 16, tid / 16) scores the
// 4x4 cells at rows ty*4 + i, columns tx*4 + j of the (QB, CB) tile with
// plain f32 FMAs.  For the selection, SUBS threads share one query: thread
// (r, sub) = (tid / SUBS, tid % SUBS) owns columns [sub*CPT, sub*CPT +
// CPT) of every tile and keeps a sorted top-K list in registers.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace sct_knn {

constexpr int QB = 64;              // queries per block
constexpr int CB = 64;              // candidates per tile
constexpr int THREADS = 256;
constexpr int SUBS = THREADS / QB;  // threads sharing one query's list
constexpr int CPT = CB / SUBS;      // tile columns scanned by each
constexpr int TS = 64 + 4;  // row stride of the staged tiles: float4-
                            // aligned, transposed stores spread on banks
constexpr int SS = CB + 4;  // row stride of the score tile
static_assert(QB == 64 && CB == 64, "stage() stages 64 rows per tile");
constexpr int D_MAX = 256;
constexpr int K_MAX = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Insert (s, c) into the list sorted by value descending; the caller
// has checked s > v[K - 1].  The entry lands after every entry with a
// value >= s, so equal values keep their insertion order.  Every index
// is a compile-time constant after unrolling, so the list stays in
// registers for small K.
template <int K>
__device__ __forceinline__ void insert(float (&v)[K], int (&id)[K], float s,
                                       int c) {
#pragma unroll
  for (int t = K - 1; t > 0; --t) {
    if (v[t - 1] < s) {
      v[t] = v[t - 1];
      id[t] = id[t - 1];
    } else if (v[t] < s) {
      v[t] = s;
      id[t] = c;
    }
  }
  if (v[0] < s) {
    v[0] = s;
    id[0] = c;
  }
}

template <int K>
__device__ __forceinline__ void pop_front(float (&v)[K], int (&id)[K]) {
#pragma unroll
  for (int t = 0; t < K - 1; ++t) {
    v[t] = v[t + 1];
    id[t] = id[t + 1];
  }
  v[K - 1] = -CUDART_INF_F;
  id[K - 1] = -1;
}

// An empty list of length k: K - k leading +inf entries that never move,
// then -inf entries with id -1.
template <int K>
__device__ __forceinline__ void init_list(float (&v)[K], int (&id)[K],
                                          int k) {
  const int pad = K - k;
#pragma unroll
  for (int t = 0; t < K; ++t) {
    v[t] = t < pad ? CUDART_INF_F : -CUDART_INF_F;
    id[t] = -1;
  }
}

// Stage rows [r0, r0 + 64) of x (n, d) into dst[kk * TS + r] as f32,
// zero past row n.  The rows are contiguous in x, so the reads are
// coalesced.
template <typename T>
__device__ __forceinline__ void stage(float* dst, const T* __restrict__ x,
                                      int r0, int n, int d) {
  const int64_t base = (int64_t)r0 * d;
  const int64_t avail = (int64_t)(n - r0) * d;
  for (int e = threadIdx.x; e < 64 * d; e += THREADS) {
    const int r = e / d;
    const int kk = e - r * d;
    dst[kk * TS + r] = e < avail ? to_f32(x[base + e]) : 0.f;
  }
}

// Stage the query tile at q0 into qs and, for euclidean, its squared
// norms into qn.  The first stage_candidates call makes qn visible.
template <typename T>
__device__ __forceinline__ void stage_queries(float* qs, float* qn,
                                              const T* __restrict__ q,
                                              int q0, int nq, int d,
                                              int euclid) {
  stage(qs, q, q0, nq, d);
  __syncthreads();
  if (euclid && threadIdx.x < QB) {
    float a = 0.f;
    for (int kk = 0; kk < d; ++kk)
      a += qs[kk * TS + threadIdx.x] * qs[kk * TS + threadIdx.x];
    qn[threadIdx.x] = a;
  }
}

// Stage the candidate tile at c0 into cs and, for euclidean, its squared
// norms into cn, after every reader of the previous tile is done.
template <typename T>
__device__ __forceinline__ void stage_candidates(float* cs, float* cn,
                                                 const T* __restrict__ c,
                                                 int c0, int nc, int d,
                                                 int euclid) {
  __syncthreads();  // the previous tile's readers are done
  stage(cs, c, c0, nc, d);
  __syncthreads();
  if (euclid) {
    if (threadIdx.x < CB) {
      float a = 0.f;
      for (int kk = 0; kk < d; ++kk)
        a += cs[kk * TS + threadIdx.x] * cs[kk * TS + threadIdx.x];
      cn[threadIdx.x] = a;
    }
    __syncthreads();
  }
}

// The scores of this thread's 4x4 cells of the tile (queries q0.., the
// staged candidates c0..):
//   s = q . c                                  (cosine; rows normalised
//                                               by the caller)
//   s = -((|q|^2 - 2 q . c) + |c|^2)          (euclidean)
//   s = -inf for columns >= nc, and for the self pair under
//   exclude_self.
__device__ __forceinline__ void score_cells(const float* qs, const float* cs,
                                            const float* qn, const float* cn,
                                            int d, int q0, int c0, int nc,
                                            int euclid, int exclude_self,
                                            float (&s)[4][4]) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int kk = 0; kk < d; ++kk) {
    const float4 a = *reinterpret_cast<const float4*>(qs + kk * TS + ty * 4);
    const float4 b = *reinterpret_cast<const float4*>(cs + kk * TS + tx * 4);
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = ty * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = tx * 4 + j;
      const int gcol = c0 + col;
      float v = acc[i][j];
      if (euclid) v = -((qn[row] - 2.f * v) + cn[col]);
      if (gcol >= nc || (exclude_self && gcol == q0 + row)) v = -CUDART_INF_F;
      s[i][j] = v;
    }
  }
}

// Merge the SUBS lists of query r (adjacent lanes of one warp) under
// (value descending, key ascending) and write its top k.  The key is the
// id, or id % key_mod when key_mod > 0 (the binned merge orders ties by
// bin).  A slot with no finite value gets id -1.
template <int K>
__device__ __forceinline__ void merge_write(float (&v)[K], int (&id)[K],
                                            int k, int qrow, int nq, int sub,
                                            int key_mod,
                                            float* __restrict__ out_v,
                                            int* __restrict__ out_i) {
  for (int p = 0; p < K - k; ++p) pop_front<K>(v, id);
  for (int t = 0; t < k; ++t) {
    float bv = v[0];
    int bi = id[0];
    int bs = sub;
#pragma unroll
    for (int off = 1; off < SUBS; off <<= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
      const int os = __shfl_xor_sync(0xffffffffu, bs, off);
      const int okey = key_mod > 0 ? oi % key_mod : oi;
      const int bkey = key_mod > 0 ? bi % key_mod : bi;
      const bool take =
          ov > bv || (ov == bv && (okey < bkey || (okey == bkey && os < bs)));
      if (take) {
        bv = ov;
        bi = oi;
        bs = os;
      }
    }
    if (bs == sub) pop_front<K>(v, id);
    if (sub == 0 && qrow < nq) {
      out_v[(int64_t)qrow * k + t] = bv;
      out_i[(int64_t)qrow * k + t] = isfinite(bv) ? bi : -1;
    }
  }
}

// Bytes of dynamic shared memory of a kernel with the two staged tiles,
// the score tile, `int_tiles` int tiles of the score tile's shape and the
// two norm vectors.
inline size_t smem_bytes(int d, int int_tiles) {
  return sizeof(float) *
         ((size_t)2 * d * TS + (size_t)(1 + int_tiles) * QB * SS + QB + CB);
}

}  // namespace sct_knn
