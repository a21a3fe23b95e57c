// Fused distance + binned top-k for neighbors.knn under
// knn_impl="pallas_binned", for Hopper (sm_90a).
//
// Replaces the TPU kernel sctools_tpu/ops/pallas_knn.py:_knn_kernel_binned
// (its pallas_call at :209, helpers _score_tile and _select_topk).
//
// What it computes, per query row i of q (nq, d) against the candidate
// rows j of c (nc, d), f32 or bf16 (f32 products and accumulation):
// the scores of csrc/knn_select.cu (cosine q . c, or euclidean
// -((|q|^2 - 2 q . c) + |c|^2); -inf past nc and for the self pair under
// exclude_self), then
//   * one survivor per bin b in [0, n_bins): the highest score among the
//     columns j = b (mod n_bins), ties to the lowest column; a bin whose
//     scores are all -inf keeps id -1;
//   * the top k of the n_bins survivors by value descending, ties to the
//     lowest bin (not the lowest id: ids 1025 and 2 with equal scores
//     come out as 1025 first at n_bins = 1024); a slot with no finite
//     value holds -inf and id -1.
// When nc <= n_bins every candidate owns its bin, and the output is the
// exact kernel's.  Otherwise two of a query's true top k that share a bin
// lose the weaker one: about k^2 / (2 n_bins) neighbours per query.
//
// Design.  The Pallas kernel folds each (qb, cb) score tile into an
// (qb, n_bins) accumulator held in VMEM across the candidate sweep, and
// selects once at the end.  An (64, 1024) accumulator of (value, id)
// pairs is 512 KB, more than a block's shared memory, so here the sweep
// is reordered by bin: n_bins is a multiple of 64 (the wrapper rounds it
// to 128), so the 64-column candidate tile at c0 covers the 64 bins
// [c0 mod n_bins, +64) without wrapping.  For each such chunk of 64 bins
// the block visits its tiles c0 = b0, b0 + n_bins, b0 + 2 n_bins, ... in
// ascending order, and each thread keeps the running maximum of its own
// 4x4 cells in registers (a strictly greater score replaces it, so ties
// keep the lower column).  When a chunk is done its survivors are final:
// they go through the score tile in shared memory into the per-thread
// sorted top-k lists of knn_select.cu, whose threads scan their bins in
// ascending order; the lists are merged by warp shuffles with ties to
// the lower bin.  Every candidate tile is staged and scored once, by the
// score loop that csrc/knn_tile.cuh shares with the exact kernel.
//
// Bound on an H100: 2*nq*nc*d FLOPs on the CUDA cores in f32 (67 TFLOP/s
// peak), as for knn_select.cu; the merge adds one compare per score and
// one insertion check per survivor instead of one per score.

#include "knn_tile.cuh"

namespace {

using namespace sct_knn;

template <typename T, int K>
__global__ void __launch_bounds__(THREADS)
    knn_binned_kernel(const T* __restrict__ q, const T* __restrict__ c,
                      int nq, int nc, int d, int k, int n_bins, int euclid,
                      int exclude_self, float* __restrict__ out_v,
                      int* __restrict__ out_i) {
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                                   // [d][TS]
  float* cs = qs + d * TS;                            // [d][TS]
  float* st = cs + d * TS;                            // [QB][SS] values
  int* sid = reinterpret_cast<int*>(st + QB * SS);    // [QB][SS] ids
  float* qn = reinterpret_cast<float*>(sid + QB * SS);  // [QB]
  float* cn = qn + QB;                                // [CB]

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * QB;
  const int tx = tid % 16, ty = tid / 16;  // score cells: 4x4 per thread
  const int r = tid / SUBS, sub = tid % SUBS;  // selection: query, part

  stage_queries(qs, qn, q, q0, nq, d, euclid);
  float v[K];
  int id[K];
  init_list<K>(v, id, k);

  for (int b0 = 0; b0 < n_bins && b0 < nc; b0 += CB) {
    // survivors of this thread's cells of the bin chunk [b0, b0 + 64)
    float best[4][4];
    int bid[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        best[i][j] = -CUDART_INF_F;
        bid[i][j] = -1;
      }
    for (int c0 = b0; c0 < nc; c0 += n_bins) {
      stage_candidates(cs, cn, c, c0, nc, d, euclid);
      float s[4][4];
      score_cells(qs, cs, qn, cn, d, q0, c0, nc, euclid, exclude_self, s);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (s[i][j] > best[i][j]) {
            best[i][j] = s[i][j];
            bid[i][j] = c0 + tx * 4 + j;
          }
    }

    __syncthreads();  // the previous chunk's scan is done with st, sid
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = ty * 4 + i;
      *reinterpret_cast<float4*>(st + row * SS + tx * 4) =
          make_float4(best[i][0], best[i][1], best[i][2], best[i][3]);
      *reinterpret_cast<int4*>(sid + row * SS + tx * 4) =
          make_int4(bid[i][0], bid[i][1], bid[i][2], bid[i][3]);
    }
    __syncthreads();

    // bins b0 + sub*CPT + jj, in ascending order: equal values keep the
    // lower bin first
    const float* srow = st + r * SS + sub * CPT;
    const int* irow = sid + r * SS + sub * CPT;
#pragma unroll 1
    for (int jj = 0; jj < CPT; ++jj) {
      const float sv = srow[jj];
      if (sv > v[K - 1]) insert<K>(v, id, sv, irow[jj]);
    }
  }

  // Merge the SUBS lists of each query, ties to the lower bin.
  merge_write<K>(v, id, k, q0 + r, nq, sub, n_bins, out_v, out_i);
}

template <typename T, int K>
cudaError_t launch(const void* q, const void* c, int nq, int nc, int d,
                   int k, int n_bins, int euclid, int exclude_self,
                   float* out_v, int* out_i, cudaStream_t stream) {
  const size_t smem = smem_bytes(d, 1);
  auto kern = knn_binned_kernel<T, K>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((nq + QB - 1) / QB);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(c), nq, nc, d, k,
      n_bins, euclid, exclude_self, out_v, out_i);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_k(const void* q, const void* c, int nq, int nc, int d,
                     int k, int n_bins, int euclid, int exclude_self,
                     float* out_v, int* out_i, cudaStream_t stream) {
  if (k <= 16)
    return launch<T, 16>(q, c, nq, nc, d, k, n_bins, euclid, exclude_self,
                         out_v, out_i, stream);
  if (k <= 32)
    return launch<T, 32>(q, c, nq, nc, d, k, n_bins, euclid, exclude_self,
                         out_v, out_i, stream);
  if (k <= 64)
    return launch<T, 64>(q, c, nq, nc, d, k, n_bins, euclid, exclude_self,
                         out_v, out_i, stream);
  if (k <= 128)
    return launch<T, 128>(q, c, nq, nc, d, k, n_bins, euclid, exclude_self,
                          out_v, out_i, stream);
  return launch<T, 256>(q, c, nq, nc, d, k, n_bins, euclid, exclude_self,
                        out_v, out_i, stream);
}

}  // namespace

extern "C" {

// q (nq, d) and c (nc, d) row-major, float (is_bf16 == 0) or bf16;
// n_bins a positive multiple of 64 and >= k; out_v (nq, k) float and
// out_i (nq, k) int32.  Launches on `stream` and returns
// cudaGetLastError() (0 on success).
int sct_knn_binned(const void* q, const void* c, int nq, int nc, int d,
                   int k, int n_bins, int is_bf16, int euclid,
                   int exclude_self, void* out_v, void* out_i,
                   void* stream) {
  if (nq < 0 || nc < 0 || d < 1 || d > D_MAX || k < 1 || k > K_MAX ||
      n_bins < k || n_bins % CB != 0)
    return (int)cudaErrorInvalidValue;
  if (nq == 0) return 0;
  float* ov = static_cast<float*>(out_v);
  int* oi = static_cast<int*>(out_i);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return (int)launch_k<__nv_bfloat16>(q, c, nq, nc, d, k, n_bins, euclid,
                                        exclude_self, ov, oi, s);
  return (int)launch_k<float>(q, c, nq, nc, d, k, n_bins, euclid,
                              exclude_self, ov, oi, s);
}

}  // extern "C"
