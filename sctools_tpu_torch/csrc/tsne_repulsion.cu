// Exact all-pairs t-SNE repulsion, for Hopper (sm_90a).
//
// Replaces the TPU kernel sctools_tpu/ops/pallas_graph.py:_tsne_rep_kernel
// (its pallas_call at :587, reached from tsne_repulsion at :607).
//
// What it computes, for y (n, D) float row-major with D <= D_MAX and
// every pair i != j of its rows:
//   d2_ij = max((|y_i|^2 - 2 y_i.y_j) + |y_j|^2, 0)   (the reference's
//           form, pallas_graph.py:556-559, not |y_i - y_j|^2)
//   w_ij  = 1 / (1 + d2_ij)                            (IEEE division)
//   forces[i] = y_i * sum_j w_ij^2 - sum_j w_ij^2 y_j
//   zrow[i]   = sum_j w_ij
// The caller sums zrow into Z; no atomics, so results repeat exactly.
//
// Design.  The TPU kernel spends two matrix-unit products per tile
// (the cross term and w^2 . Y) with K = D = 2, where a matrix unit
// gains nothing; Hopper's tensor cores gain nothing either.  So one
// thread owns one query row, held in registers, and the block stages
// tiles of TILE candidate rows and their squared norms in shared memory
// (each read is a broadcast).  Each thread sums a tile's terms in
// registers and adds the tile's partial sums to its running totals:
// two-level summation keeps the f32 error near that of a blocked sum,
// not of one sequential sum over n terms.
//
// Bound on an H100: operations on the CUDA cores.  Per pair: D fmas
// for the dot product, 3 for d2 (mul, sub, add), 1 max, 1 add and a
// division (counted as 1) for w, 1 select for the self mask, 1 mul for
// w^2, 2 adds for the sums and D fmas for sum w^2 y_j; with fmas
// counted as 2 operations that is 4D + 10 = 18 for D = 2.  The bytes
// (y read once, forces and zrow written once) are negligible.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int TILE = THREADS;  // one candidate row staged per thread
constexpr int D_MAX = 4;

template <int D>
__global__ void __launch_bounds__(THREADS)
    tsne_rep_kernel(const float* __restrict__ y, int n,
                    float* __restrict__ forces, float* __restrict__ zrow) {
  __shared__ float cy[TILE * D];
  __shared__ float cn[TILE];
  const int i = blockIdx.x * THREADS + threadIdx.x;
  float q[D];
  float qn = 0.f;
#pragma unroll
  for (int dd = 0; dd < D; ++dd) {
    q[dd] = i < n ? y[(int64_t)i * D + dd] : 0.f;
    qn += q[dd] * q[dd];
  }
  float z = 0.f, s2 = 0.f, acc[D];
#pragma unroll
  for (int dd = 0; dd < D; ++dd) acc[dd] = 0.f;

  for (int c0 = 0; c0 < n; c0 += TILE) {
    __syncthreads();  // the previous tile's readers are done
    {
      const int r = c0 + threadIdx.x;
      float a = 0.f;
#pragma unroll
      for (int dd = 0; dd < D; ++dd) {
        const float v = r < n ? y[(int64_t)r * D + dd] : 0.f;
        cy[threadIdx.x * D + dd] = v;
        a += v * v;
      }
      cn[threadIdx.x] = a;
    }
    __syncthreads();
    const int cend = min(TILE, n - c0);
    float tz = 0.f, ts2 = 0.f, tacc[D];
#pragma unroll
    for (int dd = 0; dd < D; ++dd) tacc[dd] = 0.f;
    for (int jj = 0; jj < cend; ++jj) {
      float dot = 0.f;
#pragma unroll
      for (int dd = 0; dd < D; ++dd) dot = fmaf(q[dd], cy[jj * D + dd], dot);
      const float d2 = fmaxf((qn - 2.f * dot) + cn[jj], 0.f);
      float w = 1.f / (1.f + d2);
      if (c0 + jj == i) w = 0.f;
      const float w2 = w * w;
      tz += w;
      ts2 += w2;
#pragma unroll
      for (int dd = 0; dd < D; ++dd)
        tacc[dd] = fmaf(w2, cy[jj * D + dd], tacc[dd]);
    }
    z += tz;
    s2 += ts2;
#pragma unroll
    for (int dd = 0; dd < D; ++dd) acc[dd] += tacc[dd];
  }
  if (i < n) {
#pragma unroll
    for (int dd = 0; dd < D; ++dd)
      forces[(int64_t)i * D + dd] = q[dd] * s2 - acc[dd];
    zrow[i] = z;
  }
}

template <int D>
cudaError_t launch(const float* y, int n, float* forces, float* zrow,
                   cudaStream_t stream) {
  const int blocks = (n + THREADS - 1) / THREADS;
  tsne_rep_kernel<D><<<blocks, THREADS, 0, stream>>>(y, n, forces, zrow);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// y (n, dim) float row-major, forces (n, dim) float, zrow (n,) float.
// Launches on `stream` and returns cudaGetLastError() (0 on success).
int sct_tsne_repulsion(const void* y, int n, int dim, void* forces,
                       void* zrow, void* stream) {
  if (n < 0 || dim < 1 || dim > D_MAX) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const float* yp = static_cast<const float*>(y);
  float* fp = static_cast<float*>(forces);
  float* zp = static_cast<float*>(zrow);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dim) {
    case 1: return (int)launch<1>(yp, n, fp, zp, s);
    case 2: return (int)launch<2>(yp, n, fp, zp, s);
    case 3: return (int)launch<3>(yp, n, fp, zp, s);
    default: return (int)launch<4>(yp, n, fp, zp, s);
  }
}

}  // extern "C"
