// P @ x over the padded (n, k) kNN edge list, for Hopper (sm_90a).
//
// Replaces the TPU kernel sctools_tpu/ops/pallas_graph.py:_matvec_kernel
// (its pallas_call at :263, reached from matvec at :310).
//
// What it computes: for each row r of idx (n, k) int32 and w (n, k)
// float, and x (nx, d) float row-major,
//   y[r, c] = sum over slots t in order of w[r, t] * x[idx[r, t], c],
// skipping slots whose id lies outside [0, nx) (-1 is the padding id).
// The reference multiplies a -1 slot's weight 0 by x[0]; skipping it
// differs only where x[0] holds a NaN or an inf.
//
// Design.  The TPU kernel builds a dense one-hot (rb, cb) weight tile
// per window of columns and feeds the matrix unit, sweeping a band of
// windows around the diagonal.  On Hopper a direct gather is the
// natural form: one block per row stages the row's k (id, weight) pairs
// in shared memory once, and its threads stride over the d columns, so
// each read of x[id] is one coalesced row segment (float4 when d % 4 ==
// 0 and the pointers allow it).  Each output is summed in slot order
// with fmaf, so a row's result depends only on its own ids, weights and
// the rows they name: permuting the rows (and remapping the ids) gives
// the permuted result bit for bit.
//
// Bound on an H100: bytes.  Each x row read once, y written once, idx
// and w read once: (nx*d + n*d)*4 + n*k*8 bytes; 2*n*k*d flops are far
// below the f32 peak.  Without graph.reorder the gathers hit x at
// random and the kernel reads each x row about k times from HBM once x
// outgrows the 50 MB L2; after the reorder the neighbours of nearby
// rows are nearby rows, and L2 serves most of the reuse.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int K_MAX = 256;

template <bool VEC4>
__global__ void __launch_bounds__(THREADS)
    matvec_kernel(const int* __restrict__ idx, const float* __restrict__ w,
                  const float* __restrict__ x, int k, int nx, int d,
                  float* __restrict__ y) {
  __shared__ int s_id[K_MAX];
  __shared__ float s_w[K_MAX];
  const int64_t r = blockIdx.x;
  for (int t = threadIdx.x; t < k; t += THREADS) {
    const int id = idx[r * k + t];
    s_id[t] = (id >= 0 && id < nx) ? id : -1;
    s_w[t] = w[r * k + t];
  }
  __syncthreads();
  float* yr = y + r * d;
  if (VEC4) {
    const int d4 = d / 4;
    for (int c = threadIdx.x; c < d4; c += THREADS) {
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int t = 0; t < k; ++t) {
        const int id = s_id[t];
        if (id < 0) continue;
        const float wt = s_w[t];
        const float4 v =
            reinterpret_cast<const float4*>(x + (int64_t)id * d)[c];
        acc.x = fmaf(wt, v.x, acc.x);
        acc.y = fmaf(wt, v.y, acc.y);
        acc.z = fmaf(wt, v.z, acc.z);
        acc.w = fmaf(wt, v.w, acc.w);
      }
      reinterpret_cast<float4*>(yr)[c] = acc;
    }
  } else {
    for (int c = threadIdx.x; c < d; c += THREADS) {
      float acc = 0.f;
      for (int t = 0; t < k; ++t) {
        const int id = s_id[t];
        if (id < 0) continue;
        acc = fmaf(s_w[t], x[(int64_t)id * d + c], acc);
      }
      yr[c] = acc;
    }
  }
}

}  // namespace

extern "C" {

// idx (n, k) int32, w (n, k) float, x (nx, d) float, y (n, d) float, all
// row-major.  Launches on `stream` and returns cudaGetLastError() (0 on
// success).
int sct_graph_matvec(const void* idx, const void* w, const void* x, int n,
                     int k, int nx, int d, void* y, void* stream) {
  if (n < 0 || nx < 0 || d < 0 || k < 1 || k > K_MAX)
    return (int)cudaErrorInvalidValue;
  if (n == 0 || d == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec4 = d % 4 == 0 && (uintptr_t)x % 16 == 0 &&
                    (uintptr_t)y % 16 == 0;
  const int* ip = static_cast<const int*>(idx);
  const float* wp = static_cast<const float*>(w);
  const float* xp = static_cast<const float*>(x);
  float* yp = static_cast<float*>(y);
  if (vec4)
    matvec_kernel<true><<<n, THREADS, 0, s>>>(ip, wp, xp, k, nx, d, yp);
  else
    matvec_kernel<false><<<n, THREADS, 0, s>>>(ip, wp, xp, k, nx, d, yp);
  return (int)cudaGetLastError();
}

}  // extern "C"
