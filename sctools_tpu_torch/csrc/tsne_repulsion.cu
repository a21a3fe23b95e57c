// Exact all-pairs t-SNE repulsion, for Hopper (sm_90a).
//
// Replaces the TPU kernel sctools_tpu/ops/pallas_graph.py:_tsne_rep_kernel
// (its pallas_call at :587, reached from tsne_repulsion at :607).
//
// What it computes, for y (n, D) float row-major with D <= D_MAX and
// every pair i != j of its rows:
//   w_ij      = 1 / (1 + |y_i - y_j|^2)
//   forces[i] = sum_j w_ij^2 (y_i - y_j)
//   zrow[i]   = sum_j w_ij
// The caller sums zrow into Z.  No atomics anywhere, so forces and zrow
// repeat bit for bit from run to run.
//
// Rounding.  The reference expands |y_i - y_j|^2 into |y_i|^2 -
// 2 y_i.y_j + |y_j|^2, clamps it at 0, and writes the force as y_i *
// sum_j w^2 - sum_j w^2 y_j (pallas_graph.py:556-569; so does the plain
// version).  This kernel keeps neither form: it takes the differences
// dx = y_i - y_j, den = fma(dx_{D-1}, dx_{D-1}, ... fma(dx_0, dx_0, 1)),
// which is >= 1 by construction (no clamp), and sums w^2 dx directly,
// so no two large sums cancel.  w = rcp.approx(den), the hardware
// reciprocal (within 1 ulp; den >= 1 holds no zero, denormal or NaN,
// and the padding's +inf gives +0).  The kernel is held to the plain
// version under the tolerances of the card checks (chip_smoke.py).
//
// Design.  K = D = 2 gives tensor cores nothing, so the pairs run on the
// CUDA cores, and the bound is their issue rate.
// - The grid is query tiles x SPLITS candidate splits: each block owns
//   THREADS * QPT query rows and one contiguous span of candidates (a
//   multiple of TILE rows), so the block count is a multiple of SPLITS
//   and many waves fill all 132 SMs evenly.  Each block writes its
//   partial sums (the D sums of w^2 dx and z = sum w) to a scratch
//   buffer (SPLITS, D + 1, n); a second launch adds them split 0 first,
//   so the order of every addition is fixed.
// - Each thread holds QPT queries in registers, so each staged
//   candidate, one broadcast shared-memory vector load, feeds QPT pairs.
// - Per pair: D subs, D fmas (den), one MUFU reciprocal, one mul (w^2),
//   one add (z) and D fmas (the force): 3D + 2 FP32 instructions and
//   one SFU instruction.
// - Only the candidate tile that holds a query tile's diagonal takes the
//   path that masks the self pair; every other tile runs unmasked with
//   a compile-time trip count.  Candidates past the span are staged at
//   1e30 in every coordinate: dx^2 overflows to +inf for any |y_i| <
//   1e29, so w = +0 and they add nothing, and ragged tiles need no mask.
// - Two-level summation inside a block (each tile's partial sums, then
//   running totals), and the fixed-order combine across splits as a
//   third level, keep the f32 error near that of a blocked sum, not of
//   one sequential sum over n terms.
//
// Bound on an H100, as the repository counts it: the operations the
// function needs on the CUDA cores, 5D + 3 per pair with an fma as 2 (D
// subs, D fmas for den, the reciprocal, w^2, the z add, D fmas for the
// force); the bytes (y read once, forces and zrow written once) are
// negligible.
//
// THREADS, QPT, TILE and SPLITS were chosen with tsne_kernel_sweep.py
// at 68,579 x 2 (PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int D_MAX = 4;
constexpr int THREADS = 128;  // threads a block
constexpr int QPT = 3;        // query rows a thread
constexpr int TILE = 256;     // candidate rows staged a tile
constexpr int SPLITS = 24;    // candidate spans, each its own block
constexpr int COMBINE_THREADS = 256;
constexpr float PAD = 1e30f;  // a staged padding row's coordinates

// floats a staged candidate takes: one float2 or float4 load
__host__ __device__ constexpr int stride_for(int d) { return d <= 2 ? 2 : 4; }

__device__ __forceinline__ float rcp_approx(float x) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

template <int D>
__device__ __forceinline__ void load_cand(const float* cand, int jj,
                                          float (&c)[D]) {
  if constexpr (stride_for(D) == 2) {
    const float2 t = reinterpret_cast<const float2*>(cand)[jj];
    c[0] = t.x;
    if constexpr (D > 1) c[1] = t.y;
  } else {
    const float4 t = reinterpret_cast<const float4*>(cand)[jj];
    c[0] = t.x;
    c[1] = t.y;
    c[2] = t.z;
    if constexpr (D > 3) c[3] = t.w;
  }
}

// The sums of one staged tile into the tile partials of a thread's Q
// queries.  MASK: the tile holds the diagonal, and query k's self pair
// is candidate self[k] of the tile.
template <int D, int Q, int TILE_ROWS, bool MASK>
__device__ __forceinline__ void tile_sums(const float* __restrict__ cand,
                                          const float (&q)[Q][D],
                                          const int (&self)[Q],
                                          float (&tz)[Q],
                                          float (&tacc)[Q][D]) {
#pragma unroll 4
  for (int jj = 0; jj < TILE_ROWS; ++jj) {
    float c[D];
    load_cand<D>(cand, jj, c);
#pragma unroll
    for (int k = 0; k < Q; ++k) {
      float dx[D];
      float den = 1.f;
#pragma unroll
      for (int dd = 0; dd < D; ++dd) {
        dx[dd] = q[k][dd] - c[dd];
        den = fmaf(dx[dd], dx[dd], den);
      }
      float w = rcp_approx(den);
      if (MASK && jj == self[k]) w = 0.f;
      const float w2 = w * w;
      tz[k] += w;
#pragma unroll
      for (int dd = 0; dd < D; ++dd)
        tacc[k][dd] = fmaf(w2, dx[dd], tacc[k][dd]);
    }
  }
}

// Block (bx, s): query rows bx*QT + k*BLOCK + threadIdx.x (k < Q, QT =
// BLOCK*Q) against candidates [s*span, min((s+1)*span, n)); writes the
// partial sums of split s to part (splits, D + 1, n).
template <int D, int BLOCK, int Q, int TILE_ROWS>
__global__ void __launch_bounds__(BLOCK)
    tsne_split_kernel(const float* __restrict__ y, int n, int span,
                 float* __restrict__ part) {
  constexpr int STRIDE = stride_for(D);
  constexpr int QT = BLOCK * Q;
  __shared__ __align__(16) float cand[TILE_ROWS * STRIDE];
  const int q_base = blockIdx.x * QT;
  const int64_t begin64 = (int64_t)blockIdx.y * span;
  const int c_begin = (int)(begin64 < n ? begin64 : n);
  const int c_end = (int)(begin64 + span < n ? begin64 + span : n);

  float q[Q][D], z[Q], acc[Q][D];
#pragma unroll
  for (int k = 0; k < Q; ++k) {
    const int i = q_base + k * BLOCK + threadIdx.x;
#pragma unroll
    for (int dd = 0; dd < D; ++dd) {
      q[k][dd] = i < n ? y[(int64_t)i * D + dd] : 0.f;
      acc[k][dd] = 0.f;
    }
    z[k] = 0.f;
  }

  for (int c0 = c_begin; c0 < c_end; c0 += TILE_ROWS) {
    __syncthreads();  // the previous tile's readers are done
    for (int r = threadIdx.x; r < TILE_ROWS; r += BLOCK) {
      const int j = c0 + r;
#pragma unroll
      for (int e = 0; e < STRIDE; ++e)
        cand[r * STRIDE + e] =
            e >= D ? 0.f : j < c_end ? y[(int64_t)j * D + e] : PAD;
    }
    __syncthreads();

    float tz[Q], tacc[Q][D];
    int self[Q];
#pragma unroll
    for (int k = 0; k < Q; ++k) {
      tz[k] = 0.f;
#pragma unroll
      for (int dd = 0; dd < D; ++dd) tacc[k][dd] = 0.f;
      self[k] = q_base + k * BLOCK + (int)threadIdx.x - c0;
    }
    if (c0 < q_base + QT && q_base < c0 + TILE_ROWS)  // block-uniform
      tile_sums<D, Q, TILE_ROWS, true>(cand, q, self, tz, tacc);
    else
      tile_sums<D, Q, TILE_ROWS, false>(cand, q, self, tz, tacc);
#pragma unroll
    for (int k = 0; k < Q; ++k) {
      z[k] += tz[k];
#pragma unroll
      for (int dd = 0; dd < D; ++dd) acc[k][dd] += tacc[k][dd];
    }
  }

  float* p = part + (int64_t)blockIdx.y * (D + 1) * n;
#pragma unroll
  for (int k = 0; k < Q; ++k) {
    const int i = q_base + k * BLOCK + threadIdx.x;
    if (i < n) {
#pragma unroll
      for (int dd = 0; dd < D; ++dd) p[(int64_t)dd * n + i] = acc[k][dd];
      p[(int64_t)D * n + i] = z[k];
    }
  }
}

// forces and zrow from the partial sums, split 0 first.
template <int D>
__global__ void __launch_bounds__(COMBINE_THREADS)
    tsne_combine_kernel(const float* __restrict__ part, int n, int splits,
                   float* __restrict__ forces, float* __restrict__ zrow) {
  const int i = blockIdx.x * COMBINE_THREADS + threadIdx.x;
  if (i >= n) return;
  float z = 0.f, acc[D];
#pragma unroll
  for (int dd = 0; dd < D; ++dd) acc[dd] = 0.f;
  for (int s = 0; s < splits; ++s) {
    const float* p = part + (int64_t)s * (D + 1) * n + i;
#pragma unroll
    for (int dd = 0; dd < D; ++dd) acc[dd] += p[(int64_t)dd * n];
    z += p[(int64_t)D * n];
  }
#pragma unroll
  for (int dd = 0; dd < D; ++dd) forces[(int64_t)i * D + dd] = acc[dd];
  zrow[i] = z;
}

// Both launches at the given sizes; `part` holds splits * (D + 1) * n
// floats.  The shipped entry point passes the constants above;
// tsne_kernel_sweep.py instantiates others.
template <int D, int BLOCK, int Q, int TILE_ROWS>
cudaError_t launch_sized(const float* y, int n, int splits, float* part,
                         float* forces, float* zrow, cudaStream_t stream) {
  const int per_split = (n + splits - 1) / splits;
  const int span = (per_split + TILE_ROWS - 1) / TILE_ROWS * TILE_ROWS;
  const dim3 grid((n + BLOCK * Q - 1) / (BLOCK * Q), splits);
  tsne_split_kernel<D, BLOCK, Q, TILE_ROWS><<<grid, BLOCK, 0, stream>>>(
      y, n, span, part);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  tsne_combine_kernel<D><<<(n + COMBINE_THREADS - 1) / COMBINE_THREADS,
                      COMBINE_THREADS, 0, stream>>>(part, n, splits, forces,
                                                    zrow);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The kernel's compile-time sizes, for the wrapper (scratch) and the
// card checks: out[0] query rows a block, out[1] candidate rows a tile,
// out[2] splits, out[3] query rows a thread.  Returns 0.
int sct_tsne_repulsion_layout(void* out) {
  int* o = static_cast<int*>(out);
  o[0] = THREADS * QPT;
  o[1] = TILE;
  o[2] = SPLITS;
  o[3] = QPT;
  return 0;
}

// y (n, dim) float row-major, forces (n, dim) float, zrow (n,) float,
// scratch (SPLITS, dim + 1, n) float.  Launches on `stream` and returns
// cudaGetLastError() (0 on success).
int sct_tsne_repulsion(const void* y, int n, int dim, void* forces,
                       void* zrow, void* scratch, void* stream) {
  if (n < 0 || dim < 1 || dim > D_MAX) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const float* yp = static_cast<const float*>(y);
  float* fp = static_cast<float*>(forces);
  float* zp = static_cast<float*>(zrow);
  float* sp = static_cast<float*>(scratch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dim) {
    case 1:
      return (int)launch_sized<1, THREADS, QPT, TILE>(yp, n, SPLITS, sp, fp,
                                                      zp, s);
    case 2:
      return (int)launch_sized<2, THREADS, QPT, TILE>(yp, n, SPLITS, sp, fp,
                                                      zp, s);
    case 3:
      return (int)launch_sized<3, THREADS, QPT, TILE>(yp, n, SPLITS, sp, fp,
                                                      zp, s);
    default:
      return (int)launch_sized<4, THREADS, QPT, TILE>(yp, n, SPLITS, sp, fp,
                                                      zp, s);
  }
}

}  // extern "C"
