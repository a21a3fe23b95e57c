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
// The work is k^2 compares an edge, each against a neighbour list
// gathered from device memory (L2), so what matters is keeping lanes
// busy and the gathers' latency off the compare chains:
//   * k <= 16 (the path's k = 15): two rows a warp, a half-warp a row
//     and a lane a slot.  Lane l reads slot l's id (coalesced), gets the
//     row's list into registers by shuffles within the half-warp and
//     counts vi from them; then it loads all of j's entries before its
//     first compare (unrolled), and compares each with every own entry
//     into four independent counters.
//   * 16 < k <= K_SHARED: a warp a row, the row's list in shared memory
//     (read as broadcast int4), a lane a slot (l, l + 32, ...); the lane
//     loads j's entries 16 at a time, all issued before their compares,
//     into four independent counters.
//   * k > K_SHARED (any k): the same warp a row and lane a slot, the
//     row's own list read where it lies (every lane of the warp reads the
//     same entry, one cached broadcast), so no shared memory bounds k.
// In both, padding and entries past k are masked to values that never
// match (-2 in j's list, -3 in the row's own).
// Counts are exact integers and the division is IEEE (the build never
// uses --use_fast_math), so the results equal the reference's bit for
// bit.
//
// Bound on an H100: bytes against operations.  idx read once and out
// written once is n*k*8 bytes; the work is e*k^2 integer compares and as
// many adds (e valid edges).  The compares (ISETP) run only on Hopper's
// INT32 lanes, 64 an SM a clock; the adds compile to IMAD/VIADD on the
// FP32 lanes.  So the least time is e*k^2 compares at the INT32 rate,
// which outweighs the bytes at k = 15.  What holds the
// kernel is the latency of its two dependent loads (the row's ids, then
// j's list, re-read from L2: e*k*4 bytes): fewer compares and coalesced
// loads through shared memory both left its time as it was (PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int K_SHARED = 256;  // most entries of a row staged in shared memory
constexpr int SEG = 16;  // entries of j's list loaded before their compares
constexpr unsigned FULL = 0xffffffffu;

// Entries [s0, s0 + SEG) of j's list rj (k entries), padding and entries
// past k as -2: they never match an own entry (>= 0, or -3).  Adds the
// valid ones to vj.
__device__ __forceinline__ void load_seg(int (&v)[SEG], const int* rj,
                                         int s0, int k, int& vj) {
#pragma unroll
  for (int s = 0; s < SEG; ++s) v[s] = s0 + s < k ? rj[s0 + s] : -2;
#pragma unroll
  for (int s = 0; s < SEG; ++s) {
    v[s] = v[s] < 0 ? -2 : v[s];
    vj += v[s] >= 0;
  }
}

__device__ __forceinline__ float jaccard_of(int inter, int vi, int vj) {
  return (float)inter / fmaxf((float)(vi + vj - inter), 1.f);
}

// k <= 16: half-warp h of a warp owns row 2 * warp + h, lane l of it
// slot l.
__global__ void __launch_bounds__(THREADS)
    jaccard_half_kernel(const int* __restrict__ idx, int n, int k,
                        float* __restrict__ out) {
  const int l = threadIdx.x & 15;
  const int64_t row = ((int64_t)blockIdx.x * THREADS + threadIdx.x) >> 4;
  const bool slot = row < n && l < k;
  const int my = slot ? idx[row * k + l] : -1;
  // the row's own list, padding and slots past k as -3
  int own[SEG];
#pragma unroll
  for (int u = 0; u < SEG; ++u)
    own[u] = __shfl_sync(FULL, my < 0 ? -3 : my, u, 16);
  if (!slot) return;  // no shuffle follows
  float res = 0.f;
  if (my >= 0 && my < n) {
    int vi = 0;
#pragma unroll
    for (int u = 0; u < SEG; ++u) vi += own[u] >= 0;
    int v[SEG], vj = 0;
    load_seg(v, idx + (int64_t)my * k, 0, k, vj);
    int c0 = 0, c1 = 0, c2 = 0, c3 = 0;
#pragma unroll
    for (int s = 0; s < SEG; ++s)
#pragma unroll
      for (int u = 0; u < SEG; u += 4) {
        c0 += v[s] == own[u];
        c1 += v[s] == own[u + 1];
        c2 += v[s] == own[u + 2];
        c3 += v[s] == own[u + 3];
      }
    res = jaccard_of(c0 + c1 + c2 + c3, vi, vj);
  }
  out[row * k + l] = res;
}

// k > 16 (k <= K): warp w of the block owns row blockIdx.x * WARPS + w.
template <int K>
__global__ void __launch_bounds__(THREADS)
    jaccard_warp_kernel(const int* __restrict__ idx, int n, int k,
                        float* __restrict__ out) {
  __shared__ __align__(16) int own_s[WARPS][K];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int64_t row = (int64_t)blockIdx.x * WARPS + warp;
  if (row >= n) return;  // uniform across the warp; no block barrier below
  int* own = own_s[warp];
  const int* ri = idx + row * k;
  int vi = 0;
  for (int u = lane; u < K; u += 32) {
    const int id = u < k ? ri[u] : -1;
    own[u] = id < 0 ? -3 : id;
    vi += id >= 0;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    vi += __shfl_xor_sync(FULL, vi, off);
  __syncwarp();
  for (int t = lane; t < k; t += 32) {
    const int j = ri[t];
    float res = 0.f;
    if (j >= 0 && j < n) {
      const int* rj = idx + (int64_t)j * k;
      int c0 = 0, c1 = 0, c2 = 0, c3 = 0, vj = 0;
      for (int s0 = 0; s0 < k; s0 += SEG) {
        int v[SEG];
        load_seg(v, rj, s0, k, vj);
#pragma unroll 2
        for (int u = 0; u < K; u += 4) {
          const int4 o = *reinterpret_cast<const int4*>(own + u);
#pragma unroll
          for (int s = 0; s < SEG; ++s) {
            c0 += v[s] == o.x;
            c1 += v[s] == o.y;
            c2 += v[s] == o.z;
            c3 += v[s] == o.w;
          }
        }
      }
      res = jaccard_of(c0 + c1 + c2 + c3, vi, vj);
    }
    out[row * k + t] = res;
  }
}

// k > K_SHARED: warp w of the block owns row blockIdx.x * WARPS + w, its
// own list read from idx (masked on the fly: padding as -3).
__global__ void __launch_bounds__(THREADS)
    jaccard_long_kernel(const int* __restrict__ idx, int n, int k,
                        float* __restrict__ out) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int64_t row = (int64_t)blockIdx.x * WARPS + warp;
  if (row >= n) return;  // uniform across the warp
  const int* ri = idx + row * k;
  int vi = 0;
  for (int u = lane; u < k; u += 32) vi += ri[u] >= 0;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    vi += __shfl_xor_sync(FULL, vi, off);
  for (int t = lane; t < k; t += 32) {
    const int j = ri[t];
    float res = 0.f;
    if (j >= 0 && j < n) {
      const int* rj = idx + (int64_t)j * k;
      int c0 = 0, c1 = 0, c2 = 0, c3 = 0, vj = 0;
      for (int s0 = 0; s0 < k; s0 += SEG) {
        int v[SEG];
        load_seg(v, rj, s0, k, vj);
        for (int u = 0; u < k; ++u) {
          const int o = ri[u] < 0 ? -3 : ri[u];
#pragma unroll
          for (int s = 0; s < SEG; s += 4) {
            c0 += v[s] == o;
            c1 += v[s + 1] == o;
            c2 += v[s + 2] == o;
            c3 += v[s + 3] == o;
          }
        }
      }
      res = jaccard_of(c0 + c1 + c2 + c3, vi, vj);
    }
    out[row * k + t] = res;
  }
}

template <int K>
void launch_warp(const int* idx, int n, int k, float* out,
                 cudaStream_t stream) {
  jaccard_warp_kernel<K><<<(n + WARPS - 1) / WARPS, THREADS, 0, stream>>>(
      idx, n, k, out);
}

}  // namespace

extern "C" {

// idx (n, k) int32 row-major, out (n, k) float, any k >= 1.  Launches on
// `stream` and returns cudaGetLastError() (0 on success).
int sct_graph_jaccard(const void* idx, int n, int k, void* out,
                      void* stream) {
  if (n < 0 || k < 1) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const int* ix = static_cast<const int*>(idx);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k <= 16) {
    const int64_t rows_a_block = THREADS / 16;
    jaccard_half_kernel<<<(int)((n + rows_a_block - 1) / rows_a_block),
                          THREADS, 0, s>>>(ix, n, k, o);
  } else if (k <= 32) {
    launch_warp<32>(ix, n, k, o, s);
  } else if (k <= 64) {
    launch_warp<64>(ix, n, k, o, s);
  } else if (k <= 128) {
    launch_warp<128>(ix, n, k, o, s);
  } else if (k <= K_SHARED) {
    launch_warp<K_SHARED>(ix, n, k, o, s);
  } else {
    jaccard_long_kernel<<<(n + WARPS - 1) / WARPS, THREADS, 0, s>>>(ix, n, k,
                                                                   o);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
