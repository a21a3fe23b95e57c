// Fused distance + binned top-k for neighbors.knn under
// knn_impl="pallas_binned", for Hopper (sm_90a).
//
// Replaces the TPU kernel sctools_tpu/ops/pallas_knn.py:_knn_kernel_binned
// (its pallas_call at :209, helpers _score_tile and _select_topk).
//
// What it computes, per query row i of q (nq, d) against the candidate
// rows j of c (nc, d) (float32 values; bf16 inputs were widened to
// float32 exactly by the wrapper): the scores of csrc/knn_select.cu
// (cosine q . c, or euclidean -((|q|^2 - 2 q . c) + |c|^2); -inf past nc
// and for the self pair under exclude_self), then
//   * one survivor per bin b in [0, n_bins): the highest score among the
//     columns j = b (mod n_bins), ties to the lowest column; a bin whose
//     scores are all -inf keeps id -1;
//   * the top k of the n_bins survivors by value descending, ties to the
//     lowest bin (not the lowest id: ids 1025 and 2 with equal scores
//     come out as 1025 first at n_bins = 1024); a slot with no finite
//     value holds -inf and id -1.
// When nc <= n_bins every candidate owns its bin, and the output is the
// exact kernel's, bit for bit.  Otherwise two of a query's true top k
// that share a bin lose the weaker one: about k^2 / (2 n_bins)
// neighbours per query.
//
// Design.  The Pallas kernel folds each (qb, cb) score tile into a (qb,
// n_bins) accumulator held in VMEM across the candidate sweep, and
// selects once at the end.  A (64, 1024) accumulator of (value, id)
// pairs is 512 KB, more than a block's shared memory, so here the sweep
// is reordered by bin, on the exact kernel's core (knn_core.cuh: packed
// operands, the cp.async.bulk ring, the register tile, the lists and
// their merges, the norms launch and the split merge):
//   * n_bins is a multiple of CB = 128 (the wrapper rounds it), so the
//     packed candidate tile at c0 covers the CB bins [c0 mod n_bins,
//     + CB) without wrapping: one chunk of bins.  For each chunk, in
//     ascending order, the block visits its tiles c0 = b0, b0 + n_bins,
//     b0 + 2 n_bins, ... (rounds 0, 1, 2, ...): only the tile the ring's
//     `issue` maps a stage to differs from the exact kernel.
//   * After each tile, each lane folds its TM x TN cells (masked and, for
//     euclidean, transformed as in knn_select.cu) into a running maximum
//     in registers.  A strictly greater score replaces the kept one, so
//     ties keep the lower round, the lower column.  The round of each
//     kept maximum goes to shared memory, stored only on a replacement
//     (TM * TN * 4 bytes a thread, 64 KB a block): 64 more registers
//     would pass the 255 a thread allows.
//   * When a chunk is done its survivors are final.  They go through the
//     exact kernel's register filter, row buffers and bitonic merges
//     (take_cells, merge_row) under (value descending, key ascending),
//     with key = bin * R + round and R = ceil(nc / n_bins): a bijection
//     onto the id round * n_bins + bin that orders by bin first, and the
//     id itself when n_bins >= nc (R = 1).  Between chunks a warp's lists
//     wait in the split's slice of the output, in device memory, read
//     back by the lanes that wrote them, so that they hold no registers
//     during the sweep; the last chunk writes the ids.  Each row's
//     threshold and buffer count stay in shared memory (RowState), so
//     that a chunk's survivors are tested and appended to the row
//     buffers as in knn_select.cu.  A row pair's lists make the round
//     trip (pair_trip: load, merge, store) only when a buffer would
//     overflow, and at the split's last chunk; a round trip merges the
//     buffers whole, so the thresholds kept are the lists' own.  (Merging
//     and storing every list at every chunk end made n_bins of 16384 and
//     more slower than the earlier kernel; PERF.md.)
//   * The chunk end takes a warp's 8 row pairs in a rolled loop, pair c's
//     cells shifted into best[0] by register moves, so that its code
//     stays small: unrolled, it was fetched anew at every chunk end and
//     cost more than its merges (PERF.md).
//   * Above K_REG entries (the K_MEM build, any k) a round trip leaves
//     the lists where they wait and merges them there slot by slot
//     (knn_core.cuh MemList), so no list is held in registers; at the
//     last chunk their keys become ids in place.
//   * Rows of more than D_RESIDENT features take the WIDE builds of the
//     core: each stage carries the query tile's feature rows beside the
//     candidates', so any d fits, and each score is the same fmaf chain.
//   * Splits go over bin chunks, not candidate ranges: S = min(SPLITS,
//     chunks) blocks a query tile, each over a contiguous range of
//     chunks, so one block holds each bin whole (a bin split over two
//     blocks would need a max per bin before the top k, which no list
//     merge gives).  knn_merge_kernel then merges the S lists, the lower
//     split first on equal values: the lower bins.
//
// Bound on an H100: 2*nq*nc*d FLOPs on the CUDA cores in f32 (67 TFLOP/s
// peak), as for knn_select.cu.  The fold adds about three instructions a
// cell and tile (compare, select, predicated store) to the score loop's
// d * (TM * TN + TM / 4 + TN / 4 + a few) (FFMA and loads); the
// selection sees one survivor per bin and chunk, n_bins / nc of the
// candidates the exact kernel's filter sees.  Since the selection needs
// little hiding, the sizes differ from knn_select.cu's: 8 x 8 cells a
// lane (64 FFMA per 4 shared loads) in 128-query blocks, one an SM,
// beat 4 x 8 at two an SM; 8 splits (one 128-bin chunk each at 1024
// bins), a ring of 3 whole-tile stages and 10 feature rows a turn of the
// score loop (knn_kernel_sweep.py --binned, PERF.md).

#ifndef KNN_TM
#define KNN_TM 8
#endif
#ifndef KNN_TN
#define KNN_TN 8
#endif
#ifndef KNN_SPLITS
#define KNN_SPLITS 8
#endif
#ifndef KNN_RING
#define KNN_RING 3
#endif
#ifndef KNN_MINB
#define KNN_MINB 1
#endif
#ifndef KNN_UNROLL
#define KNN_UNROLL 10
#endif

#include <type_traits>

#include "knn_core.cuh"

namespace {

// The rounds of the kept maxima: cell (i, e) of thread t at
// [(i * TN + e) * THREADS + t].
constexpr size_t ROUND_BYTES = sizeof(int) * TM * TN * THREADS;

// A query row's selection between chunks: the threshold of its list as
// stored (entry k - 1; -inf and NO_ID until the list holds k), and the
// entries waiting in its row buffer, plus STORED once the list was
// stored.  12 bytes a row, so that d = D_RESIDENT still fits.
constexpr int STORED = 1 << 8;
struct RowState {
  float tv;
  int ti;
  int n;
};
// The kernel's own shared memory, after the core's: the rounds, then a
// RowState a query row.
constexpr size_t EXTRA_BYTES = ROUND_BYTES + sizeof(RowState) * QB;

// Fold a scored tile (its first column c0, round r) into the running
// maxima, and clear the cells.  EDGE: the tile reaches past nc or holds
// a self pair under exclude_self, so its cells are masked.
template <bool EDGE>
__device__ __forceinline__ void fold(float (&acc)[TM][TN],
                                     float (&best)[TM][TN], int* kept, int r,
                                     int c0, int row0, int c0l, int nc,
                                     int exclude_self,
                                     const float* __restrict__ qn,
                                     const float* __restrict__ cn) {
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = row0 + 8 * (i / 4) + i % 4;
#pragma unroll
    for (int e = 0; e < TN; ++e) {
      const int gcol = c0 + c0l + 64 * (e / 4) + e % 4;
      float val = acc[i][e];
      if (qn != nullptr) val = -((qn[row] - 2.f * val) + cn[gcol]);
      if (EDGE && (gcol >= nc || (exclude_self && gcol == row)))
        val = -CUDART_INF_F;
      acc[i][e] = 0.f;
      if (val > best[i][e]) {
        best[i][e] = val;
        kept[(i * TN + e) * THREADS] = r;
      }
    }
  }
}

// The list a round trip works on, by type: a List<SL> in registers or a
// MemList left in device memory.
template <class L>
struct Tag {};

// A row's list as the lanes left it in device memory at the last chunk's
// end (v, id: the row's k entries), or empty when `fresh`.
template <int SL>
__device__ __forceinline__ List<SL> load_list(const float* v, const int* id,
                                              int k, int lane, bool fresh) {
  List<SL> l;
  float last = -CUDART_INF_F;
  int last_i = NO_ID;
#pragma unroll
  for (int w = 0; w < SL; ++w) {
    const int jj = w * 32 + lane;
    const bool have = !fresh && jj < k;
    l.v[w] = have ? v[jj] : -CUDART_INF_F;
    l.id[w] = have ? id[jj] : NO_ID;
    if (w == (k - 1) / 32) last = l.v[w], last_i = l.id[w];
  }
  l.tv = __shfl_sync(FULL, last, (k - 1) % 32);
  l.ti = __shfl_sync(FULL, last_i, (k - 1) % 32);
  return l;
}

// Store a row's list: its keys, or at the split's `last` chunk the ids
// they code (round * n_bins + bin), -1 where no finite value is.
template <int SL>
__device__ __forceinline__ void store_list(const List<SL>& l, float* v,
                                           int* id, int k, int lane,
                                           bool last, int R, int n_bins) {
#pragma unroll
  for (int w = 0; w < SL; ++w) {
    const int jj = w * 32 + lane;
    if (jj >= k) continue;
    const int key = l.id[w];
    v[jj] = l.v[w];
    id[jj] = !last ? key
                   : isfinite(l.v[w]) ? key % R * n_bins + key / R : -1;
  }
}

// A round trip's list of a row: loaded into registers (empty when
// `fresh`), or left in device memory (MemList: cleared there when
// `fresh`; a row past nq gets a threshold nothing passes and is never
// read or written).
template <int SL>
__device__ __forceinline__ List<SL> open_list(Tag<List<SL>>, float* v,
                                              int* id, int k, int lane,
                                              bool fresh, bool row_ok) {
  return load_list<SL>(v, id, k, lane, fresh || !row_ok);
}
template <int SL>
__device__ __forceinline__ MemList open_list(Tag<MemList>, float* v, int* id,
                                             int k, int lane, bool fresh,
                                             bool row_ok) {
  if (!row_ok) return MemList{v, id, CUDART_INF_F, -1};
  if (!fresh) return MemList{v, id, v[k - 1], id[k - 1]};
  for (int jj = lane; jj < k; jj += 32) v[jj] = -CUDART_INF_F, id[jj] = NO_ID;
  __syncwarp();
  return MemList{v, id, -CUDART_INF_F, NO_ID};
}

// Store a round trip's list (List) or, at the `last` chunk, turn a
// MemList's keys into ids in place.
template <int SL>
__device__ __forceinline__ void close_list(const List<SL>& l, float* v,
                                           int* id, int k, int lane,
                                           bool last, int R, int n_bins) {
  store_list<SL>(l, v, id, k, lane, last, R, n_bins);
}
template <int SL>
__device__ __forceinline__ void close_list(const MemList& l, float*, int*,
                                           int k, int lane, bool last, int R,
                                           int n_bins) {
  if (!last) return;
  for (int jj = lane; jj < k; jj += 32) {
    const int key = l.id[jj];
    l.id[jj] = isfinite(l.v[jj]) ? key % R * n_bins + key / R : -1;
  }
}

// What a chunk end needs besides a row pair's cells: the split's lists
// (row q's at lv + q * k and li + q * k) and the block's row states and
// row buffers (block row r's at rs + r, bv + r * CAP, bi + r * CAP).
struct Sink {
  float* lv;
  int* li;
  RowState* rs;
  float* bv;
  int* bi;
  int q0, nq, k, R, n_bins;
};

// A row pair's survivors of a chunk, the lane's TN cells: the kept
// maxima `best` of the bins bin0 + 64 (e / 4) + e % 4, keyed bin * R +
// round (the rounds at kept[e * THREADS]); masked (-inf, NO_ID) for a row
// past nq.
__device__ __forceinline__ Cells<true> survivors(const float (&best)[TN],
                                                 const int* kept, int bin0,
                                                 int R, bool row_ok) {
  Cells<true> cl;
#pragma unroll
  for (int e = 0; e < TN; ++e) {
    const float v = row_ok ? best[e] : -CUDART_INF_F;
    cl.v[e] = v;
    cl.key[e] = v > -CUDART_INF_F
                    ? (bin0 + 64 * (e / 4) + e % 4) * R + kept[e * THREADS]
                    : NO_ID;
  }
  return cl;
}

// The round trip of the row pair A, A + 4 (block rows; lanes 0-15 hold
// row A's cells, 16-31 row B's) at a chunk end where its buffers would
// overflow, or at the split's `last` chunk: load the lists (empty until
// first stored), merge a buffer that would overflow, append the cells
// that pass, merge the buffers whole, store the lists (at the last chunk
// the ids) and their thresholds.  Out of line, like take_cells and
// merge_row: one copy serves every pair.  L is List<SL> or MemList.
template <int SL, class L>
__device__ __noinline__ void pair_trip(Cells<true> cl, Sink s, int A,
                                       bool last, int lane) {
  __syncwarp();  // converged: the warp intrinsics below take their fast form
  const int B = A + 4, qa = s.q0 + A, qb = s.q0 + B, k = s.k;
  RowState* sa = s.rs + A;
  RowState* sb = s.rs + B;
  const int fa = sa->n, fb = sb->n;  // buffer counts | STORED
  float *bva = s.bv + A * CAP, *bvb = s.bv + B * CAP;
  int *bia = s.bi + A * CAP, *bib = s.bi + B * CAP;
  float* va = s.lv + (int64_t)qa * k;
  float* vb = s.lv + (int64_t)qb * k;
  int* ia = s.li + (int64_t)qa * k;
  int* ib = s.li + (int64_t)qb * k;
  Pair<L> p;
  p.a = open_list<SL>(Tag<L>{}, va, ia, k, lane, fa < STORED, qa < s.nq);
  p.b = open_list<SL>(Tag<L>{}, vb, ib, k, lane, fb < STORED, qb < s.nq);
  p.na = fa % STORED, p.nb = fb % STORED;
  if (p.na + p.nb > 0) {
    // a buffer that would overflow is merged first, so that the cells
    // meet the merged list's threshold and the appends fit
    const Passing ps = passing(cl, 0, lane < 16 ? sa->tv : sb->tv,
                               lane < 16 ? sa->ti : sb->ti);
    if (p.na > 0 && p.na + ps.na > CAP)
      p.a = merge_row<SL>(p.a, bva, bia, p.na, k, lane), p.na = 0;
    if (p.nb > 0 && p.nb + ps.nb > CAP)
      p.b = merge_row<SL>(p.b, bvb, bib, p.nb, k, lane), p.nb = 0;
  }
  if (k < 16 && (p.a.tv == -CUDART_INF_F || p.b.tv == -CUDART_INF_F)) {
    // A list short of k entries passes every finite cell.  But the latest
    // of the 16 lanes' best cells of a row comes after 15 of the row's
    // cells, so none after it is in the row's top k: it serves as the
    // threshold until the next merge (at a split's first chunk, about
    // half the merges).
    float lv = -CUDART_INF_F;
    int lk = NO_ID;
#pragma unroll
    for (int e = 0; e < TN; ++e)
      if (before(cl.v[e], cl.key[e], lv, lk)) lv = cl.v[e], lk = cl.key[e];
#pragma unroll
    for (int o = 1; o < 16; o <<= 1) {
      const float ov = __shfl_xor_sync(FULL, lv, o);
      const int ok = __shfl_xor_sync(FULL, lk, o);
      if (before(lv, lk, ov, ok)) lv = ov, lk = ok;
    }
    const float av = __shfl_sync(FULL, lv, 0), bv = __shfl_sync(FULL, lv, 16);
    const int ak = __shfl_sync(FULL, lk, 0), bk = __shfl_sync(FULL, lk, 16);
    if (before(av, ak, p.a.tv, p.a.ti)) p.a.tv = av, p.a.ti = ak;
    if (before(bv, bk, p.b.tv, p.b.ti)) p.b.tv = bv, p.b.ti = bk;
  }
  p = take_cells<SL, true>(p, cl, 0, bva, bia, bvb, bib, k, lane);
  // the buffers are merged whole: the thresholds stored are the lists'
  // own, so that fewer of the next chunks' cells pass them
  if (p.na > 0) p.a = merge_row<SL>(p.a, bva, bia, p.na, k, lane);
  if (p.nb > 0) p.b = merge_row<SL>(p.b, bvb, bib, p.nb, k, lane);
  if (qa < s.nq) close_list<SL>(p.a, va, ia, k, lane, last, s.R, s.n_bins);
  if (qb < s.nq) close_list<SL>(p.b, vb, ib, k, lane, last, s.R, s.n_bins);
  __syncwarp();  // every lane has read the states
  if (lane == 0) {
    *sa = RowState{p.a.tv, p.a.ti, STORED};
    *sb = RowState{p.b.tv, p.b.ti, STORED};
  }
  __syncwarp();
}

template <int K, bool WIDE>
__global__ void __launch_bounds__(THREADS, KNN_MINB)
    knn_binned_kernel(const float* __restrict__ qP,
                      const float* __restrict__ cP,
                      const float* __restrict__ qn,
                      const float* __restrict__ cn, int nq, int nc, int d,
                      int kc, int nring, int k, int n_bins, int R,
                      int nchunks, int full_chunks, int exclude_self,
                      float* __restrict__ out_v, int* __restrict__ out_i) {
  constexpr int SL = (K + 31) / 32;  // list slots a lane
  // a round trip's lists: in registers, or above K_REG in device memory
  using L = std::conditional_t<(K > K_REG), MemList, List<SL>>;
  extern __shared__ __align__(128) unsigned char smem[];
  const Smem m = carve(smem, query_rows(d, kc, nring, WIDE), kc, nring);
  int* kept = reinterpret_cast<int*>(m.end) + threadIdx.x;
  RowState* rs = reinterpret_cast<RowState*>(m.end + ROUND_BYTES);

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * QB;
  // This split's chunks [ch0, ch1): the first nfull take R rounds, the
  // rest R - 1 (their last round would start past nc).
  const int ch0 = (int)((int64_t)nchunks * blockIdx.y / gridDim.y);
  const int ch1 = (int)((int64_t)nchunks * (blockIdx.y + 1) / gridDim.y);
  const int nfull = min(max(full_chunks - ch0, 0), ch1 - ch0);
  const int chunks = (d + kc - 1) / kc;  // stages a tile
  const int stages = (nfull * R + (ch1 - ch0 - nfull) * (R - 1)) * chunks;
  const int step = n_bins / CB;  // tiles from one round of a chunk to the next

  const int warp = tid >> 5, lane = tid & 31;
  const float* qtile = qP + (int64_t)blockIdx.x * d * QB;
  // Stage s of the sweep: visit v = s / chunks -- chunk by chunk, rounds
  // ascending -- feature rows from (s % chunks) * kc, into ring buffer
  // s % nring.
  auto issue = [&](int st) {
    const int v = st / chunks;
    int ch, r;
    if (v < nfull * R) {
      ch = ch0 + v / R, r = v % R;
    } else {
      const int u = v - nfull * R;
      ch = ch0 + nfull + u / (R - 1), r = u % (R - 1);
    }
    const int k0 = st % chunks * kc;
    load_stage<WIDE>(m, st % nring, kc, qtile + (int64_t)k0 * QB,
                     cP + ((int64_t)(ch + r * step) * d + k0) * CB,
                     min(kc, d - k0));
  };
  ring_start(m, WIDE ? nullptr : qtile, d, nring, stages, issue);
  if (tid < QB) rs[tid] = RowState{-CUDART_INF_F, NO_ID, 0};
  __syncthreads();
  const int g = lane >> 4;                     // which row of each pair
  const int r0 = warp * RW + 4 * g;            // rows r0 + 8h + i
  const int c0l = 4 * (lane & 15);             // columns c0l + 64h + j
  const int64_t slice = (int64_t)blockIdx.y * nq * k;
  const Sink sink{out_v + slice, out_i + slice, rs, m.buf_v, m.buf_i,
                  q0, nq, k, R, n_bins};

  float acc[TM][TN], best[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f, best[i][j] = -CUDART_INF_F;
  // the stage being scored: chunk ch (of `rounds` rounds), round r, stage j
  // of the tile
  int ch = ch0, rounds = nfull > 0 ? R : R - 1, r = 0, j = 0;

  if (stages > 0 && !WIDE) bar_wait(m.qbar, 0);
  for (int s = 0; s < stages; ++s) {
    const int b = s % nring;
    bar_wait(m.full + b, (s / nring) & 1);  // stage s is in
    const int k0 = j * kc;
    score_stage(acc, stage_queries<WIDE>(m, b, kc, k0), m.ring + b * kc * CB,
                min(kc, d - k0), r0, c0l);
    release(m.done, b, s, nring, stages, lane, issue);
    if (++j < chunks) continue;
    j = 0;

    const int c0 = (ch + r * step) * CB;
    if (c0 + CB > nc || (exclude_self && c0 < q0 + QB && q0 < c0 + CB))
      fold<true>(acc, best, kept, r, c0, q0 + r0, c0l, nc, exclude_self, qn,
                 cn);
    else
      fold<false>(acc, best, kept, r, c0, q0 + r0, c0l, nc, exclude_self, qn,
                  cn);
    if (++r < rounds) continue;

    // Chunk ch is done: its survivors, bins ch * CB + c0l + 64h + j, go
    // to the row buffers of the warp's rows, pair by pair (pair c: rows A
    // = 8 (c / 4) + c % 4 of lanes 0-15 and B = A + 4 of lanes 16-31, as
    // in knn_select.cu), tested against the thresholds of the lists in
    // memory; a pair whose buffers would overflow, and every pair at the
    // split's last chunk, makes the round trip (pair_trip).  A rolled
    // loop, so that the chunk end's code stays small: pair c's cells are
    // best[0] at turn c, the rows moving down one a turn (register moves,
    // where an index into best would put it in local memory), and -inf
    // fills in from the top, ready for the next chunk.
    const bool last = ch + 1 == ch1;
#pragma unroll 1
    for (int c = 0; c < TM; ++c) {
      const int A = warp * RW + 8 * (c / 4) + c % 4;
      const Cells<true> cl = survivors(best[0], kept + c * TN * THREADS,
                                       ch * CB + c0l, R, q0 + A + 4 * g < nq);
      bool trip = last;
      if (!last) {
        const int fa = rs[A].n, fb = rs[A + 4].n;  // buffer counts | STORED
        const Passing ps =
            passing(cl, 0, rs[A + 4 * g].tv, rs[A + 4 * g].ti);
        trip = fa % STORED + ps.na > CAP || fb % STORED + ps.nb > CAP;
        if (!trip && ps.na + ps.nb > 0) {  // the buffers take the cells
          append_cells(cl, 0, ps, fa % STORED, fb % STORED,
                       m.buf_v + A * CAP, m.buf_i + A * CAP,
                       m.buf_v + (A + 4) * CAP, m.buf_i + (A + 4) * CAP,
                       lane);
          if (lane == 0) rs[A].n = fa + ps.na, rs[A + 4].n = fb + ps.nb;
        }
      }
      if (trip) pair_trip<SL, L>(cl, sink, A, last, lane);
#pragma unroll
      for (int h = 0; h + 1 < TM; ++h)
#pragma unroll
        for (int e = 0; e < TN; ++e) best[h][e] = best[h + 1][e];
#pragma unroll
      for (int e = 0; e < TN; ++e) best[TM - 1][e] = -CUDART_INF_F;
    }
    r = 0;
    ++ch;
    rounds = ch - ch0 < nfull ? R : R - 1;
  }

  if (ch0 == ch1) {  // no candidates: every slot empty
    for (int q = 0; q < RW; ++q) {
      const int qrow = q0 + warp * RW + q;
      if (qrow >= nq) continue;
      for (int jj = lane; jj < k; jj += 32) {
        out_v[slice + (int64_t)qrow * k + jj] = -CUDART_INF_F;
        out_i[slice + (int64_t)qrow * k + jj] = -1;
      }
    }
  }
}

template <int K, bool WIDE>
cudaError_t launch(const float* qP, const float* cP, int nq, int nc, int d,
                   int k, int n_bins, int euclid, int exclude_self,
                   float* out_v, int* out_i, float* scratch,
                   cudaStream_t stream) {
  int kc, nring;
  stage_shape(d, EXTRA_BYTES, WIDE, &kc, &nring);
  const size_t smem =
      smem_bytes(query_rows(d, kc, nring, WIDE), kc, nring, EXTRA_BYTES);
  auto kern = knn_binned_kernel<K, WIDE>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess)  // about 200 KB a block at d = 50
    e = cudaFuncSetAttribute(kern,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return e;
  // rounds a chunk at most; chunks that hold a column; chunks whose
  // round R - 1 still starts below nc
  const int R = nc > n_bins ? (nc - 1) / n_bins + 1 : 1;
  const int nchunks = (min(nc, n_bins) + CB - 1) / CB;
  const int full_chunks =
      min(nchunks, (nc - (R - 1) * n_bins + CB - 1) / CB);
  const int splits = max(1, min(SPLITS, nchunks));
  Scratch sc;
  e = scratch_and_norms(qP, cP, nq, nc, d, k, splits, euclid, out_v, out_i,
                        scratch, stream, &sc);
  if (e != cudaSuccess) return e;
  const dim3 grid((nq + QB - 1) / QB, splits);
  kern<<<grid, THREADS, smem, stream>>>(qP, cP, sc.qn, sc.cn, nq, nc, d, kc,
                                        nring, k, n_bins, R, nchunks,
                                        full_chunks, exclude_self, sc.sv,
                                        sc.si);
  return merge_splits(sc, nq, k, splits, out_v, out_i, stream);
}

}  // namespace

extern "C" {

// The binned kernel's sizes and registers, as sct_knn_select_layout gives
// the exact kernel's: out[0] queries a block, out[1] candidates a tile,
// out[2] most splits, out[3] stages in flight at most, out[4] / out[5]
// rows and columns a lane, out[6] / out[7] registers and local bytes a
// thread at K = 16, out[8] / out[9] at K = 32.
int sct_knn_binned_layout(void* out) {
  return layout(static_cast<int*>(out), knn_binned_kernel<16, false>,
                knn_binned_kernel<32, false>);
}

// q and c packed tile-major as float (pack_tiles in ops/knn_kernel.py),
// as sct_knn_select takes them; n_bins a positive multiple of CB, >= k,
// with nc + n_bins < 2^31; out_v (nq, k) float and out_i (nq, k) int32;
// scratch as sct_knn_select's (2 * SPLITS * nq * k floats when SPLITS > 1,
// then for euclid round_up(nq, QB) + round_up(nc, CB)).  Launches on
// `stream` and returns cudaGetLastError() (0 on success).
int sct_knn_binned(const void* q, const void* c, int nq, int nc, int d,
                   int k, int n_bins, int euclid, int exclude_self,
                   void* out_v, void* out_i, void* scratch, void* stream) {
  if (nq < 0 || nc < 0 || d < 1 || k < 1 || n_bins < k || n_bins % CB != 0 ||
      (int64_t)nc + n_bins > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  if (nq == 0) return 0;
  const float* qP = static_cast<const float*>(q);
  const float* cP = static_cast<const float*>(c);
  float* ov = static_cast<float*>(out_v);
  int* oi = static_cast<int*>(out_i);
  float* sc = static_cast<float*>(scratch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)by_shape(k, d, [&](auto K, auto WIDE) {
    return launch<decltype(K)::value, decltype(WIDE)::value>(
        qP, cP, nq, nc, d, k, n_bins, euclid, exclude_self, ov, oi, sc, s);
  });
}

// The build a search at (k, d) launches, as sct_knn_select_build gives
// the exact kernel's: out[0] list size, out[1] WIDE, out[2] / out[3]
// registers and local bytes a thread.
int sct_knn_binned_build(int k, int d, void* out) {
  if (d < 1 || k < 1) return (int)cudaErrorInvalidValue;
  int* o = static_cast<int*>(out);
  return (int)by_shape(k, d, [&](auto K, auto WIDE) {
    return build_of(o, knn_binned_kernel<decltype(K)::value,
                                         decltype(WIDE)::value>,
                    K, WIDE);
  });
}

}  // extern "C"
