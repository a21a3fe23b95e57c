// Fused distance + exact top-k for neighbors.knn, for Hopper (sm_90a).
//
// Replaces the TPU kernel sctools_tpu/ops/pallas_knn.py:_knn_kernel
// (its pallas_call at :209, helpers _score_tile and _select_topk).
//
// What it computes, per query row i of q (nq, d) against the candidate
// rows j of c (nc, d), both float or bf16 (bf16 inputs, f32 products
// and accumulation):
//   s_ij = q_i . c_j                                  (cosine; the rows
//          were normalised by the caller, as knn._prep does)
//   s_ij = -((|q_i|^2 - 2 q_i . c_j) + |c_j|^2)       (euclidean)
//   s_ij = -inf where j == i and exclude_self is set.
// It writes the top k of each row by (value descending, candidate id
// ascending) -- the order the reference's k-step "max, first-argmax,
// suppress" selection produces -- as f32 values and int32 ids; a slot
// with no finite candidate holds -inf and id -1.
//
// Design.  The TPU kernel sweeps a sequential grid axis over candidate
// blocks and keeps the running top-k in VMEM scratch between steps;
// blocks on the GPU run in no order, so here one block owns a tile of
// QB queries and walks every candidate tile itself, in ascending id
// order:
//   * the query tile is staged once in shared memory, transposed, as
//     f32; each candidate tile is staged the same way;
//   * 256 threads compute the (QB, CB) score tile, 4x4 scores each with
//     plain f32 FMAs from float4 shared-memory reads, apply the metric
//     and the masks, and write the tile to shared memory;
//   * 4 threads share one query: each scans its 16 columns of the tile
//     in ascending order and keeps a sorted top-K list in registers.  A
//     score enters only when it is strictly above the list's last
//     entry, and lands after every entry with a value >= it, so equal
//     values keep ascending ids.  K is a template bound (16..256); the
//     list is held at length k by K - k leading +inf entries that never
//     move;
//   * at the end the 4 lists of a query are merged by warp shuffles
//     under the same (value, id) order.
// wgmma, TMA, warp specialisation and splitting the candidate sweep
// across blocks are left for later work.
//
// Bound on an H100: 2*nq*nc*d FLOPs on the CUDA cores in f32 (67 TFLOP/s
// peak), against the bytes of one pass over the candidates for each
// query tile (nc*d*elt per block, from L2 after the first).  With
// d = 50 the kernel is bound by operations, not bytes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

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
// has checked s > v[K - 1].  Every index is a compile-time constant
// after unrolling, so the list stays in registers for small K.
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

template <typename T, int K>
__global__ void __launch_bounds__(THREADS)
    knn_select_kernel(const T* __restrict__ q, const T* __restrict__ c,
                      int nq, int nc, int d, int k, int euclid,
                      int exclude_self, float* __restrict__ out_v,
                      int* __restrict__ out_i) {
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;            // [d][TS], query tile, transposed
  float* cs = qs + d * TS;     // [d][TS], candidate tile, transposed
  float* st = cs + d * TS;     // [QB][SS], score tile
  float* qn = st + QB * SS;    // [QB], |q|^2
  float* cn = qn + QB;         // [CB], |c|^2

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * QB;
  const int tx = tid % 16, ty = tid / 16;  // score tile: 4x4 per thread
  const int r = tid / SUBS, sub = tid % SUBS;  // selection: query, part

  stage(qs, q, q0, nq, d);
  __syncthreads();
  if (euclid && tid < QB) {
    float a = 0.f;
    for (int kk = 0; kk < d; ++kk) a += qs[kk * TS + tid] * qs[kk * TS + tid];
    qn[tid] = a;
  }

  float v[K];
  int id[K];
  const int pad = K - k;
#pragma unroll
  for (int t = 0; t < K; ++t) {
    v[t] = t < pad ? CUDART_INF_F : -CUDART_INF_F;
    id[t] = -1;
  }

  for (int c0 = 0; c0 < nc; c0 += CB) {
    __syncthreads();  // the previous tile's readers are done
    stage(cs, c, c0, nc, d);
    __syncthreads();
    if (euclid) {
      if (tid < CB) {
        float a = 0.f;
        for (int kk = 0; kk < d; ++kk)
          a += cs[kk * TS + tid] * cs[kk * TS + tid];
        cn[tid] = a;
      }
      __syncthreads();
    }

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
      float s4[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = tx * 4 + j;
        const int gcol = c0 + col;
        float s = acc[i][j];
        if (euclid) s = -((qn[row] - 2.f * s) + cn[col]);
        if (gcol >= nc || (exclude_self && gcol == q0 + row)) s = -CUDART_INF_F;
        s4[j] = s;
      }
      *reinterpret_cast<float4*>(st + row * SS + tx * 4) =
          make_float4(s4[0], s4[1], s4[2], s4[3]);
    }
    __syncthreads();

    // One insertion site (no unrolling): the unrolled insert is O(K)
    // instructions.
    const float* srow = st + r * SS + sub * CPT;
    const int cbase = c0 + sub * CPT;
#pragma unroll 1
    for (int jj = 0; jj < CPT; ++jj) {
      const float s = srow[jj];
      if (s > v[K - 1]) insert<K>(v, id, s, cbase + jj);
    }
  }

  // Merge the SUBS lists of each query (adjacent lanes of one warp).
  for (int p = 0; p < pad; ++p) pop_front<K>(v, id);
  const int qrow = q0 + r;
  for (int t = 0; t < k; ++t) {
    float bv = v[0];
    int bi = id[0];
    int bs = sub;
#pragma unroll
    for (int off = 1; off < SUBS; off <<= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
      const int os = __shfl_xor_sync(0xffffffffu, bs, off);
      const bool take =
          ov > bv || (ov == bv && (oi < bi || (oi == bi && os < bs)));
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

template <typename T, int K>
cudaError_t launch(const void* q, const void* c, int nq, int nc, int d,
                   int k, int euclid, int exclude_self, float* out_v,
                   int* out_i, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)2 * d * TS + QB * SS + QB + CB);
  auto kern = knn_select_kernel<T, K>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((nq + QB - 1) / QB);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(c), nq, nc, d, k,
      euclid, exclude_self, out_v, out_i);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_k(const void* q, const void* c, int nq, int nc, int d,
                     int k, int euclid, int exclude_self, float* out_v,
                     int* out_i, cudaStream_t stream) {
  if (k <= 16)
    return launch<T, 16>(q, c, nq, nc, d, k, euclid, exclude_self, out_v,
                         out_i, stream);
  if (k <= 32)
    return launch<T, 32>(q, c, nq, nc, d, k, euclid, exclude_self, out_v,
                         out_i, stream);
  if (k <= 64)
    return launch<T, 64>(q, c, nq, nc, d, k, euclid, exclude_self, out_v,
                         out_i, stream);
  if (k <= 128)
    return launch<T, 128>(q, c, nq, nc, d, k, euclid, exclude_self, out_v,
                          out_i, stream);
  return launch<T, 256>(q, c, nq, nc, d, k, euclid, exclude_self, out_v,
                        out_i, stream);
}

}  // namespace

extern "C" {

// q (nq, d) and c (nc, d) row-major, float (is_bf16 == 0) or bf16;
// out_v (nq, k) float and out_i (nq, k) int32.  Launches on `stream`
// and returns cudaGetLastError() (0 on success).
int sct_knn_select(const void* q, const void* c, int nq, int nc, int d,
                   int k, int is_bf16, int euclid, int exclude_self,
                   void* out_v, void* out_i, void* stream) {
  if (nq < 0 || nc < 0 || d < 1 || d > D_MAX || k < 1 || k > K_MAX)
    return (int)cudaErrorInvalidValue;
  if (nq == 0) return 0;
  float* ov = static_cast<float*>(out_v);
  int* oi = static_cast<int*>(out_i);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return (int)launch_k<__nv_bfloat16>(q, c, nq, nc, d, k, euclid,
                                        exclude_self, ov, oi, s);
  return (int)launch_k<float>(q, c, nq, nc, d, k, euclid, exclude_self, ov,
                              oi, s);
}

const char* sct_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
