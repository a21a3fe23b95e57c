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
// natural form: the pairs of row r are its k slots (idx[r, t], w[r, t]),
// an id outside x staged as -1 and skipped, and graph_gather.cuh sums
// them: a lane per row where d <= 4, else a lane group per row (2 to 16
// lanes where d is narrow, so few lanes idle at Palantir's d = 10, 16
// or 32 where it is wide), float2/float4 columns with register blocking,
// and a slab-major grid that keeps the gathered slice of x in L2.  Each
// output is summed in slot order with fmaf, so a row's result depends
// only on its own ids, weights and the rows they name: permuting the
// rows (and remapping the ids) gives the permuted result bit for bit,
// and so does any column slice of x.
//
// Bound on an H100: bytes.  Each x row read once, y written once, idx
// and w read once: (nx*d + n*d)*4 + n*k*8 bytes; 2*n*k*d flops are far
// below the f32 peak.  The gathers move n*k*d*4 bytes (8.2 GB at MAGIC's
// d = 2000), from L2 once a slab's slice of x is resident.

#include "graph_gather.cuh"

namespace {

constexpr int K_MAX = 256;
// Column tile and L2 slab of the gather (graph_gather.cuh), chosen by
// graph_kernel_sweep.py on an H100 80GB HBM3 at 700 W, on a random
// 68,579 x 15 graph: at d = 2000 (MAGIC's width) 64-column tiles with
// one 17.5 MB tile a slab took 1.20 ms, 32 columns 1.19, 128 columns
// 1.40, no slabs 2.72; at d = 914 0.77, 0.75, 0.80 and 1.32.  The same
// sizes as graph_rmatvec's, where 64 columns won clearly at d = 2000.
constexpr int TILE_COLS = 64;
constexpr int64_t SLAB_BYTES = 24ll << 20;

struct SlotPairs {
  const int* __restrict__ idx;
  const float* __restrict__ w;
  int k, nx;
  __device__ sct_gather::List range(int64_t r) const { return {r * k, k}; }
  __device__ void load(int64_t j, int& src, float& wt) const {
    const int id = idx[j];
    src = id >= 0 && id < nx ? id : -1;
    wt = w[j];
  }
};

}  // namespace

// The launch at a given tile and slab size (the entry point below uses
// TILE_COLS and SLAB_BYTES; a measurement may try others).
static int graph_matvec_launch(const void* idx, const void* w,
                               const void* x, int n, int k, int nx, int d,
                               void* y, void* stream, int tile_cols,
                               int64_t slab_bytes) {
  if (n < 0 || nx < 0 || d < 0 || k < 1 || k > K_MAX)
    return (int)cudaErrorInvalidValue;
  if (n == 0 || d == 0) return 0;
  const SlotPairs pairs{static_cast<const int*>(idx),
                        static_cast<const float*>(w), k, nx};
  return sct_gather::launch(pairs, static_cast<const float*>(x),
                            static_cast<float*>(y), n, nx, d, tile_cols,
                            slab_bytes, static_cast<cudaStream_t>(stream));
}

extern "C" {

// idx (n, k) int32, w (n, k) float, x (nx, d) float, y (n, d) float, all
// row-major.  Launches on `stream` and returns cudaGetLastError() (0 on
// success).
int sct_graph_matvec(const void* idx, const void* w, const void* x, int n,
                     int k, int nx, int d, void* y, void* stream) {
  return graph_matvec_launch(idx, w, x, n, k, nx, d, y, stream, TILE_COLS,
                             SLAB_BYTES);
}

}  // extern "C"
