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

#include "knn_tile.cuh"

namespace {

using namespace sct_knn;

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

  stage_queries(qs, qn, q, q0, nq, d, euclid);
  float v[K];
  int id[K];
  init_list<K>(v, id, k);

  for (int c0 = 0; c0 < nc; c0 += CB) {
    stage_candidates(cs, cn, c, c0, nc, d, euclid);
    float s[4][4];
    score_cells(qs, cs, qn, cn, d, q0, c0, nc, euclid, exclude_self, s);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<float4*>(st + (ty * 4 + i) * SS + tx * 4) =
          make_float4(s[i][0], s[i][1], s[i][2], s[i][3]);
    __syncthreads();

    // One insertion site (no unrolling): the unrolled insert is O(K)
    // instructions.
    const float* srow = st + r * SS + sub * CPT;
    const int cbase = c0 + sub * CPT;
#pragma unroll 1
    for (int jj = 0; jj < CPT; ++jj) {
      const float sv = srow[jj];
      if (sv > v[K - 1]) insert<K>(v, id, sv, cbase + jj);
    }
  }

  // Merge the SUBS lists of each query, ties to the lower id.
  merge_write<K>(v, id, k, q0 + r, nq, sub, 0, out_v, out_i);
}

template <typename T, int K>
cudaError_t launch(const void* q, const void* c, int nq, int nc, int d,
                   int k, int euclid, int exclude_self, float* out_v,
                   int* out_i, cudaStream_t stream) {
  const size_t smem = smem_bytes(d, 0);
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
