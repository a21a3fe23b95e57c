// P^T @ x over the padded (rows, k) kNN edge list, for Hopper (sm_90a).
//
// Replaces the TPU kernel sctools_tpu/ops/pallas_graph.py:_rmatvec_kernel
// (its pallas_call at :263, reached from rmatvec at :346).
//
// What it computes: for idx (rows, k) int32, w (rows, k) float and
// x (rows, d) float row-major,
//   y[c, :] = sum over the edges (r, t) with idx[r, t] == c, in
//             ascending (r, t) order, of w[r, t] * x[r, :]
// for every c in [0, n); ids outside [0, n) (-1 is the padding id) add
// nothing, and a destination without edges gets zeros.  n may differ
// from rows.
//
// Design.  The Pallas kernel builds a one-hot (rb, cb) tile per band
// window and multiplies its transpose into the output block, the
// segment sum as the adjoint of a matrix-unit product.  On Hopper the
// scatter is done without atomics: the wrapper puts the valid edges in
// destination order once per graph (their flat slot ids r*k + t, stably
// sorted by destination, so ascending within one destination, and the
// offsets of each destination's run), and this kernel gathers.  One warp
// owns one destination: its lanes stage up to CHUNK incoming (source
// row, weight) pairs in shared memory, then stride over the d columns
// (float4 when d % 4 == 0 and the pointers allow it), summing the pairs
// in order with fmaf.  In-degree is not bounded by k (a hub can have
// thousands of incoming edges), so a long run is staged chunk by chunk.
// The result depends only on the order, never on scheduling: it is the
// same bit for bit from run to run.
//
// Bound on an H100: bytes.  Each x row read once, y written once, the
// edges read once: (rows + n)*d*4 + e*8 bytes; 2*e*d flops are far below
// the f32 peak.  The gathers read each x row once per out-edge, from L2
// where the sources of nearby destinations are nearby rows.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int CHUNK = 64;  // incoming pairs staged per warp at a time

template <bool VEC4>
__global__ void __launch_bounds__(THREADS)
    rmatvec_kernel(const int* __restrict__ edges,
                   const int* __restrict__ offsets,
                   const float* __restrict__ w, const float* __restrict__ x,
                   int k, int n, int d, float* __restrict__ y) {
  __shared__ int s_src[WARPS][CHUNK];
  __shared__ float s_w[WARPS][CHUNK];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t dest = (int64_t)blockIdx.x * WARPS + warp;
  if (dest >= n) return;  // the whole warp leaves together
  const int beg = offsets[dest];
  const int deg = offsets[dest + 1] - beg;
  int* src = s_src[warp];
  float* ws = s_w[warp];
  const int dv = VEC4 ? d / 4 : d;  // columns, in float4 when VEC4
  float* yc = y + dest * d;
  const bool one_chunk = deg <= CHUNK;  // stage once for every column pass

  if (one_chunk) {
    for (int j = lane; j < deg; j += 32) {
      const int e = edges[beg + j];
      src[j] = e / k;
      ws[j] = w[e];
    }
    __syncwarp();
  }
  for (int c0 = 0; c0 < dv; c0 += 32) {
    const int col = c0 + lane;
    const bool active = col < dv;
    float4 acc4 = make_float4(0.f, 0.f, 0.f, 0.f);
    float acc = 0.f;
    for (int base = 0; base < deg; base += CHUNK) {
      const int cnt = min(CHUNK, deg - base);
      if (!one_chunk) {
        __syncwarp();  // every lane is done with the previous chunk
        for (int j = lane; j < cnt; j += 32) {
          const int e = edges[beg + base + j];
          src[j] = e / k;
          ws[j] = w[e];
        }
        __syncwarp();
      }
      if (!active) continue;
      for (int j = 0; j < cnt; ++j) {
        const float wt = ws[j];
        const int64_t row = src[j];
        if (VEC4) {
          const float4 v = reinterpret_cast<const float4*>(x + row * d)[col];
          acc4.x = fmaf(wt, v.x, acc4.x);
          acc4.y = fmaf(wt, v.y, acc4.y);
          acc4.z = fmaf(wt, v.z, acc4.z);
          acc4.w = fmaf(wt, v.w, acc4.w);
        } else {
          acc = fmaf(wt, x[row * d + col], acc);
        }
      }
    }
    if (active) {
      if (VEC4)
        reinterpret_cast<float4*>(yc)[col] = acc4;
      else
        yc[col] = acc;
    }
  }
}

}  // namespace

extern "C" {

// edges (e,) int32 flat slot ids r*k + t in destination order, offsets
// (n + 1,) int32 (destination c owns edges[offsets[c] : offsets[c+1]]),
// w (rows, k) float, x (rows, d) float, y (n, d) float, all row-major.
// Launches on `stream` and returns cudaGetLastError() (0 on success).
int sct_graph_rmatvec(const void* edges, const void* offsets, const void* w,
                      const void* x, int k, int n, int d, void* y,
                      void* stream) {
  if (n < 0 || d < 0 || k < 1) return (int)cudaErrorInvalidValue;
  if (n == 0 || d == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec4 = d % 4 == 0 && (uintptr_t)x % 16 == 0 &&
                    (uintptr_t)y % 16 == 0;
  const int* ep = static_cast<const int*>(edges);
  const int* op = static_cast<const int*>(offsets);
  const float* wp = static_cast<const float*>(w);
  const float* xp = static_cast<const float*>(x);
  float* yp = static_cast<float*>(y);
  const dim3 grid((unsigned)(((int64_t)n + WARPS - 1) / WARPS));
  if (vec4)
    rmatvec_kernel<true><<<grid, THREADS, 0, s>>>(ep, op, wp, xp, k, n, d,
                                                  yp);
  else
    rmatvec_kernel<false><<<grid, THREADS, 0, s>>>(ep, op, wp, xp, k, n, d,
                                                   yp);
  return (int)cudaGetLastError();
}

}  // extern "C"
