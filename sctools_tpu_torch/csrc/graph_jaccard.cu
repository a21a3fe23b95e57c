// Per-edge Jaccard weights of a kNN graph, for Hopper (sm_90a).
//
// Replaces the TPU kernel sctools_tpu/ops/pallas_graph.py:_jaccard_kernel
// (its pallas_call at :482, reached from jaccard at :505).
//
// What it computes, for each row i of idx (n, k) int32 (-1 = padding)
// and each slot t with j = idx[i, t] in [0, n):
//   inter = #{(s, u) : idx[j, s] == idx[i, u]}, counting duplicates,
//           with idx[j, s] < 0 read as -2 and idx[i, u] < 0 as -3 so
//           that padding never matches;
//   vi    = #{u : idx[i, u] >= 0},  vj = #{s : idx[j, s] >= 0};
//   out[i, t] = inter / max(vi + vj - inter, 1)     (IEEE division)
// and out[i, t] = 0 where j is padding (or outside [0, n)).  These are
// the reference's counts (pallas_graph.py:153-163, graph.py:172-178),
// which differ from a set intersection when a list repeats an id.
//
// Design.  The TPU kernel gathers neighbour lists by one-hot matmuls
// over a band of windows, which limits it to ids below 2^24 (exact in
// float32).  Here ids are compared as int32, so no such limit applies.
// One warp owns one row: its lanes stage the row's own list in shared
// memory and count vi with a shuffle reduction; then lane l takes slots
// l, l + 32, ...: it reads j's list from device memory and compares
// each entry with every entry of the own list (k^2 compares, own-list
// reads broadcast from shared memory).  Counts are exact integers and
// the division is IEEE (the build never uses --use_fast_math), so the
// results equal the reference's bit for bit.
//
// Bound on an H100: bytes against operations.  idx read once and out
// written once is n*k*8 bytes; the compares are n*k*k^2 integer
// operations, far below the peak; the gathered neighbour lists are
// re-read from L2 (n*k*k*4 bytes).  The kernel is bound by the gather
// latency of those reads.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int K_MAX = 256;

__global__ void __launch_bounds__(THREADS)
    jaccard_kernel(const int* __restrict__ idx, int n, int k,
                   float* __restrict__ out) {
  __shared__ int own_s[WARPS][K_MAX];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int64_t row = (int64_t)blockIdx.x * WARPS + warp;
  if (row >= n) return;  // uniform across the warp; no block barrier below
  int* own = own_s[warp];
  const int* ri = idx + row * k;
  int vi = 0;
  for (int u = lane; u < k; u += 32) {
    const int id = ri[u];
    own[u] = id < 0 ? -3 : id;
    vi += id >= 0;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    vi += __shfl_xor_sync(0xffffffffu, vi, off);
  __syncwarp();
  for (int t = lane; t < k; t += 32) {
    const int j = ri[t];
    float res = 0.f;
    if (j >= 0 && j < n) {
      const int* rj = idx + (int64_t)j * k;
      int inter = 0, vj = 0;
      for (int s = 0; s < k; ++s) {
        int v = rj[s];
        if (v < 0) v = -2;
        vj += v >= 0;
        for (int u = 0; u < k; ++u) inter += v == own[u];
      }
      res = (float)inter / fmaxf((float)(vi + vj - inter), 1.f);
    }
    out[row * k + t] = res;
  }
}

}  // namespace

extern "C" {

// idx (n, k) int32 row-major, out (n, k) float.  Launches on `stream`
// and returns cudaGetLastError() (0 on success).
int sct_graph_jaccard(const void* idx, int n, int k, void* out,
                      void* stream) {
  if (n < 0 || k < 1 || k > K_MAX) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const int blocks = (n + WARPS - 1) / WARPS;
  jaccard_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(idx), n, k, static_cast<float*>(out));
  return (int)cudaGetLastError();
}

}  // extern "C"
