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
// offsets of each destination's run), and this kernel gathers: the
// pairs of destination c are (e / k, w[e]) for the slot ids e of its
// run.  The gather itself is graph_gather.cuh's: a lane group per
// destination (one lane at d = 1), float2/float4 columns with register
// blocking, and a slab-major grid that keeps the gathered slice of x in
// L2.  In-degree is not bounded by k (a hub can have thousands of
// incoming edges), so a long run is staged chunk by chunk.  The result
// depends only on the order, never on scheduling or on the path: it is
// the same bit for bit from run to run and at every width.
//
// Bound on an H100: bytes.  Each x row read once, y written once, the
// edges read once: (rows + n)*d*4 + e*8 bytes; 2*e*d flops are far below
// the f32 peak.  The gathers move e*d*4 bytes, from L2 once a slab's
// slice of x is resident (graph_gather.cuh).

#include "graph_gather.cuh"

namespace {

// Column tile and L2 slab of the gather (graph_gather.cuh), chosen by
// graph_kernel_sweep.py on an H100 80GB HBM3 at 700 W, on a random
// graph of the SEACells shape (68,579 x 914, 1.03M edges): 64 columns
// a tile and one 17.5 MB tile a slab took 0.92 ms, 128 columns 0.96,
// two tiles a slab (35 MB) 1.04, no slabs 1.43-1.48.
constexpr int TILE_COLS = 64;
constexpr int64_t SLAB_BYTES = 24ll << 20;

struct RunPairs {
  const int* __restrict__ edges;
  const int* __restrict__ offsets;
  const float* __restrict__ w;
  int k;
  __device__ sct_gather::List range(int64_t c) const {
    const int beg = offsets[c];
    return {beg, offsets[c + 1] - beg};
  }
  __device__ void load(int64_t j, int& src, float& wt) const {
    const int e = edges[j];
    src = e / k;
    wt = w[e];
  }
};

}  // namespace

// The launch at a given tile and slab size (the entry point below uses
// TILE_COLS and SLAB_BYTES; a measurement may try others).
static int graph_rmatvec_launch(const void* edges, const void* offsets,
                                const void* w, const void* x, int k, int n,
                                int d, void* y, void* stream, int tile_cols,
                                int64_t slab_bytes) {
  if (n < 0 || d < 0 || k < 1) return (int)cudaErrorInvalidValue;
  if (n == 0 || d == 0) return 0;
  const RunPairs pairs{static_cast<const int*>(edges),
                       static_cast<const int*>(offsets),
                       static_cast<const float*>(w), k};
  // x has rows of its own, not passed here; the slab is sized by n, the
  // rows of the square graphs the paths run
  return sct_gather::launch(pairs, static_cast<const float*>(x),
                            static_cast<float*>(y), n, n, d, tile_cols,
                            slab_bytes, static_cast<cudaStream_t>(stream));
}

extern "C" {

// edges (e,) int32 flat slot ids r*k + t in destination order, offsets
// (n + 1,) int32 (destination c owns edges[offsets[c] : offsets[c+1]]),
// w (rows, k) float, x (rows, d) float, y (n, d) float, all row-major.
// Launches on `stream` and returns cudaGetLastError() (0 on success).
int sct_graph_rmatvec(const void* edges, const void* offsets, const void* w,
                      const void* x, int k, int n, int d, void* y,
                      void* stream) {
  return graph_rmatvec_launch(edges, offsets, w, x, k, n, d, y, stream,
                              TILE_COLS, SLAB_BYTES);
}

}  // extern "C"
