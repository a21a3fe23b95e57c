// Fused distance + exact top-k for neighbors.knn, for Hopper (sm_90a).
//
// Replaces the TPU kernel sctools_tpu/ops/pallas_knn.py:_knn_kernel
// (its pallas_call at :209, helpers _score_tile and _select_topk).
//
// What it computes, per query row i of q (nq, d) against the candidate
// rows j of c (nc, d) (float32 values; bf16 inputs were widened to
// float32 exactly by the wrapper):
//   s_ij = q_i . c_j                                  (cosine; the rows
//          were normalised by the caller, as knn._prep does)
//   s_ij = -((|q_i|^2 - 2 q_i . c_j) + |c_j|^2)       (euclidean)
//   s_ij = -inf where j == i and exclude_self is set.
// Each dot product is one fmaf chain over kk = 0 .. d - 1 from 0.f, each
// squared norm the chain a += x * x in the same order (euclidean norms
// by knn_norms_kernel, launched first).  It writes the top
// k of each row by (value descending, candidate id ascending) -- the
// order the reference's k-step "max, first-argmax, suppress" selection
// produces -- as f32 values and int32 ids; a slot with no finite
// candidate holds -inf and id -1.
//
// Bound on an H100: 2*nq*nc*d FLOPs on the CUDA cores in f32 (67 TFLOP/s
// peak); the bytes (each row read once, the top k written once) are far
// below it at d = 50.  So the design keeps the FMA pipe busy:
//   * Pre-packed operands.  The wrapper lays q and c out as f32 tiles,
//     tile-major and feature-major inside, (tiles, d, W) with W = QB or
//     CB, zero past the last row.  So a stage -- a tile's feature rows
//     [k0, k0 + kc) -- is one contiguous block, copied by one
//     cp.async.bulk that completes on an mbarrier.
//   * The grid is query tiles x SPLITS candidate splits.  Block (x, y)
//     keeps QB queries resident in shared memory and sweeps the
//     contiguous candidate tiles of split y, CB candidates a tile, in
//     ascending order, in stages of up to kc feature rows (the whole
//     tile when it fits), through a ring of up to RING_MAX stages.  Each
//     stage's copy completes on its "full" mbarrier, which the warps
//     wait on; the last warp done with a buffer (a shared-memory counter)
//     issues the copy of the stage that refills it.  No block-wide
//     barrier follows the start, so warps drift apart by up to a ring of
//     stages, and one warp's selection (latency-bound) overlaps another's
//     FMAs (issue-bound).  (With a barrier a stage, the warps selected in
//     lockstep and the block waited for the slowest; a ninth, producer
//     warp cost registers: PERF.md.)
//   * Register blocking.  Warp w owns the RW = QB / 8 query rows
//     [w*RW, w*RW + RW) of the tile, whole: lane (g, cg) = (lane / 16,
//     lane % 16) holds the TM x TN scores at rows w*RW + 8h + 4g + i and
//     columns 64h + 4cg + j, fed by TM/4 + TN/4 float4 shared-memory loads
//     a feature row: 32 FFMA per 3 loads at the shipped 4 x 8 (64 per 4
//     at 8 x 8).
//   * Two blocks an SM.  The selection below is latency-bound; what
//     hides it is another block's FMAs.  4 x 8 cells a lane and at most
//     128 registers (KNN_MINB = 2) let two 64-query blocks share an SM,
//     which beat one 128-query block of 8 x 8 cells in the sweep.
//   * Selection, from the registers.  A query's top-k list is spread
//     over its warp (entry j in lane j % 32, slot j / 32), with a
//     threshold: entry k - 1.  When a tile is scored, each lane tests its
//     cells against its row's threshold in the same order (value, then
//     id, so exact ties do not pass again and again); the few that pass
//     go, out of line, to the row's 32-entry buffer in shared memory
//     (positions by ballot and popc), and a full buffer is merged into the list by a bitonic sort and
//     merge-split under (value descending, id ascending).  Merges are rare
//     and warp-uniform.  (Inserting candidates into sorted lists one at a
//     time, from a score tile in shared memory, cost more than the FMAs:
//     about 550 cycles a warp an insertion, in a latency chain.  And the
//     appends and merges stay out of the tile loop: inlined in each row's
//     code, they made the loop outgrow the instruction cache; PERF.md.)
//   * Above K_REG (256) entries the lists leave the registers: RW lists
//     of 512 would take 256 registers a lane.  A row's list then waits in
//     its k slots of the split's output (MemList), in the same order, and
//     only its threshold stays in registers; a merge streams it slot by
//     slot (merge_row<SL>(MemList)), so one build (K_MEM) serves any k.
//     A merge then moves 8 k bytes each way through the caches; rows past
//     nq get a threshold nothing passes, so they never merge and write
//     nothing.  The tile loop, the filter and the merge steps are the
//     register lists', so the order and the result are the same.
//   * Rows of more than D_RESIDENT features (the WIDE builds): the query
//     tile no longer stays resident, and each stage carries the query
//     tile's kc feature rows beside the candidate tile's, on the same
//     barrier.  The stages of a tile add into the same cells in feature
//     order, so each score is the same fmaf chain, any d.
//   * Splits.  Each (query tile, split) block writes its k best to a
//     scratch buffer (SPLITS, nq, k); knn_merge_kernel merges the SPLITS
//     sorted lists of each query.  The splits cover ascending id ranges,
//     so taking the lower split on equal values keeps ties at the lower
//     id.  No atomics: the result repeats bit for bit.
// The ring, the register tile, the lists, the merges and the norms are
// the core this kernel shares with knn_binned.cu (knn_core.cuh).  Every
// score is one fmaf chain over kk from 0.f, and the selection is exact
// under (value, id), so with n_bins >= nc knn_binned gives this kernel's
// bits.
//
// TM, TN, SPLITS, KC, RING and MINB were chosen with knn_kernel_sweep.py
// (PERF.md), which builds this file again with -D sizes.

#include "knn_core.cuh"

namespace {

template <int K, bool WIDE>
__global__ void __launch_bounds__(THREADS, KNN_MINB)
    knn_select_kernel(const float* __restrict__ qP,
                      const float* __restrict__ cP,
                      const float* __restrict__ qn,
                      const float* __restrict__ cn, int nq, int nc, int d,
                      int kc, int nring, int k, int exclude_self,
                      float* __restrict__ out_v, int* __restrict__ out_i) {
  constexpr int SL = (K + 31) / 32;  // list slots a lane
  constexpr bool IN_MEMORY = K > K_REG;  // the lists wait in device memory
  extern __shared__ __align__(128) unsigned char smem[];
  const Smem m = carve(smem, query_rows(d, kc, nring, WIDE), kc, nring);
  const bool euclid = qn != nullptr;

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * QB;
  // this split's candidate tiles [t_begin, t_end)
  const int tiles = (nc + CB - 1) / CB;
  const int t_begin = (int)((int64_t)tiles * blockIdx.y / gridDim.y);
  const int t_end = (int)((int64_t)tiles * (blockIdx.y + 1) / gridDim.y);
  const int chunks = (d + kc - 1) / kc;
  const int stages = (t_end - t_begin) * chunks;

  const int warp = tid >> 5, lane = tid & 31;
  // Stage s of the sweep: tile t_begin + s / chunks, feature rows from
  // (s % chunks) * kc, into ring buffer s % nring.
  const float* qtile = qP + (int64_t)blockIdx.x * d * QB;
  auto issue = [&](int st) {
    const int k0 = st % chunks * kc;
    load_stage<WIDE>(m, st % nring, kc, qtile + (int64_t)k0 * QB,
                     cP + ((int64_t)(t_begin + st / chunks) * d + k0) * CB,
                     min(kc, d - k0));
  };
  ring_start(m, WIDE ? nullptr : qtile, d, nring, stages, issue);
  __syncthreads();
  const int g = lane >> 4;                     // which row of each pair
  const int r0 = warp * RW + 4 * g;            // rows r0 + 8h + i
  const int c0l = 4 * (lane & 15);             // columns c0l + 64h + j
  float* wbv = m.buf_v + warp * RW * CAP;      // the warp's row buffers
  int* wbi = m.buf_i + warp * RW * CAP;

  // The warp's RW lists and, per row, entry k - 1 (only a candidate
  // before it can enter) and the entries in its buffer.  In memory, list
  // q is at this split's slots of row q0 + warp * RW + q (mem(q)), and L
  // holds only the thresholds.
  const int64_t slice = (int64_t)blockIdx.y * nq * k;
  auto mem = [&](int q, const List<1>& t) {
    const int64_t at = slice + (int64_t)(q0 + warp * RW + q) * k;
    return MemList{out_v + at, out_i + at, t.tv, t.ti};
  };
  List<IN_MEMORY ? 1 : SL> L[RW];
  int cnt[RW];
#pragma unroll
  for (int q = 0; q < RW; ++q) {
    L[q].tv = -CUDART_INF_F;
    L[q].ti = NO_ID;
    cnt[q] = 0;
    if constexpr (IN_MEMORY) {
      if (q0 + warp * RW + q < nq) {
        const MemList l = mem(q, L[q]);
        for (int jj = lane; jj < k; jj += 32)
          l.v[jj] = -CUDART_INF_F, l.id[jj] = NO_ID;
      } else {
        L[q].tv = CUDART_INF_F, L[q].ti = -1;  // nothing passes
      }
    } else {
#pragma unroll
      for (int w = 0; w < SL; ++w)
        L[q].v[w] = -CUDART_INF_F, L[q].id[w] = NO_ID;
    }
  }

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  int t = t_begin, j = 0;  // the stage being scored: tile t, chunk j

  if (stages > 0 && !WIDE) bar_wait(m.qbar, 0);
  for (int s = 0; s < stages; ++s) {
    const int b = s % nring;
    bar_wait(m.full + b, (s / nring) & 1);  // stage s is in
    const int k0 = j * kc;
    score_stage(acc, stage_queries<WIDE>(m, b, kc, k0), m.ring + b * kc * CB,
                min(kc, d - k0), r0, c0l);
    release(m.done, b, s, nring, stages, lane, issue);
    if (++j < chunks) continue;

    // Tile t is scored.  Rows r0 + 8h + i of the two lane halves form a
    // pair (A = 8h + i for lanes 0-15, B = A + 4 for lanes 16-31 of the
    // warp's rows); each lane filters its TN cells of its row.
    const int c0 = t * CB;
#pragma unroll
    for (int hi = 0; hi < TM / 4; ++hi)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int A = 8 * hi + i, B = A + 4;
        const int row = r0 + 8 * hi + i;
        const float t_row = g ? L[B].tv : L[A].tv;
        const int t_id = g ? L[B].ti : L[A].ti;
        float o[TN];
        bool any = false;
#pragma unroll
        for (int e = 0; e < TN; ++e) {
          const int col = c0l + 64 * (e / 4) + e % 4;
          const int gcol = c0 + col;
          float val = acc[hi * 4 + i][e];
          if (euclid) val = -((qn[q0 + row] - 2.f * val) + cn[gcol]);
          if (gcol >= nc || (exclude_self && gcol == q0 + row))
            val = -CUDART_INF_F;
          o[e] = val;
          acc[hi * 4 + i][e] = 0.f;
          any |= enters(val, gcol, t_row, t_id);
        }
        if (!__any_sync(FULL, any)) continue;
        // Some cell of the pair may enter: out of line, so that the tile
        // loop stays small enough for the instruction cache.
        Cells<false> cl;
#pragma unroll
        for (int e = 0; e < TN; ++e) cl.v[e] = o[e];
        __syncwarp();
        if constexpr (IN_MEMORY) {
          const Pair<MemList> pr = take_cells<SL, false>(
              Pair<MemList>{mem(A, L[A]), mem(B, L[B]), cnt[A], cnt[B]}, cl,
              c0 + c0l, wbv + A * CAP, wbi + A * CAP, wbv + B * CAP,
              wbi + B * CAP, k, lane);
          L[A].tv = pr.a.tv, L[A].ti = pr.a.ti;
          L[B].tv = pr.b.tv, L[B].ti = pr.b.ti;
          cnt[A] = pr.na, cnt[B] = pr.nb;
        } else {
          const Pair<List<SL>> pr = take_cells<SL, false>(
              Pair<List<SL>>{L[A], L[B], cnt[A], cnt[B]}, cl, c0 + c0l,
              wbv + A * CAP, wbi + A * CAP, wbv + B * CAP, wbi + B * CAP, k,
              lane);
          L[A] = pr.a, L[B] = pr.b, cnt[A] = pr.na, cnt[B] = pr.nb;
        }
      }
    j = 0;
    ++t;
  }

  // the buffers' last entries, then this split's slice of the output
#pragma unroll
  for (int q = 0; q < RW; ++q) {
    const int qrow = q0 + warp * RW + q;
    if constexpr (IN_MEMORY) {
      if (qrow >= nq) continue;
      const MemList l =
          cnt[q] > 0 ? merge_row<SL>(mem(q, L[q]), wbv + q * CAP,
                                     wbi + q * CAP, cnt[q], k, lane)
                     : mem(q, L[q]);
      for (int jj = lane; jj < k; jj += 32)
        if (!isfinite(l.v[jj])) l.id[jj] = -1;
    } else {
      if (cnt[q] > 0)
        L[q] = merge_row<SL>(L[q], wbv + q * CAP, wbi + q * CAP, cnt[q], k,
                             lane);
      if (qrow >= nq) continue;
#pragma unroll
      for (int w = 0; w < SL; ++w) {
        const int jj = w * 32 + lane;
        if (jj < k) {
          out_v[slice + (int64_t)qrow * k + jj] = L[q].v[w];
          out_i[slice + (int64_t)qrow * k + jj] =
              isfinite(L[q].v[w]) ? L[q].id[w] : -1;
        }
      }
    }
  }
}

template <int K, bool WIDE>
cudaError_t launch(const float* qP, const float* cP, int nq, int nc, int d,
                   int k, int euclid, int exclude_self, float* out_v,
                   int* out_i, float* scratch, cudaStream_t stream) {
  int kc, nring;
  stage_shape(d, 0, WIDE, &kc, &nring);
  const size_t smem =
      smem_bytes(query_rows(d, kc, nring, WIDE), kc, nring, 0);
  auto kern = knn_select_kernel<K, WIDE>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  Scratch sc;
  e = scratch_and_norms(qP, cP, nq, nc, d, k, SPLITS, euclid, out_v, out_i,
                        scratch, stream, &sc);
  if (e != cudaSuccess) return e;
  const dim3 grid((nq + QB - 1) / QB, SPLITS);
  kern<<<grid, THREADS, smem, stream>>>(qP, cP, sc.qn, sc.cn, nq, nc, d, kc,
                                        nring, k, exclude_self, sc.sv, sc.si);
  return merge_splits(sc, nq, k, SPLITS, out_v, out_i, stream);
}

}  // namespace

extern "C" {

// The kernel's compile-time sizes and its K = 16 and K = 32 builds'
// registers, for the wrapper (packing, scratch) and the card checks:
// out[0] queries a block (the query pack's tile), out[1] candidates a
// tile (the candidate pack's), out[2] splits, out[3] candidate stages in
// flight at most, out[4] query rows and out[5] candidate columns a lane,
// out[6] / out[7] registers and local memory bytes a thread at K = 16,
// out[8] / out[9] at K = 32.  Returns the cudaFuncGetAttributes error
// (0 on success).
int sct_knn_select_layout(void* out) {
  return layout(static_cast<int*>(out), knn_select_kernel<16, false>,
                knn_select_kernel<32, false>);
}

// q and c packed tile-major as float (pack_tiles in ops/knn_kernel.py):
// q (ceil(nq / QB), d, QB) and c (ceil(nc / CB), d, CB), element [t, kk,
// i] = row t * W + i, feature kk, zero past the rows; out_v (nq, k) float
// and out_i (nq, k) int32; scratch of 2 * SPLITS * nq * k floats (split
// values, then int32 ids; none when SPLITS == 1), then for euclid
// round_up(nq, QB) + round_up(nc, CB) floats (the squared norms).  Any
// d >= 1 (above D_RESIDENT the WIDE build) and any k >= 1 (above K_REG
// the lists in device memory).  Launches on `stream` and returns
// cudaGetLastError() (0 on success).
int sct_knn_select(const void* q, const void* c, int nq, int nc, int d,
                   int k, int euclid, int exclude_self, void* out_v,
                   void* out_i, void* scratch, void* stream) {
  if (nq < 0 || nc < 0 || d < 1 || k < 1) return (int)cudaErrorInvalidValue;
  if (nq == 0) return 0;
  const float* qP = static_cast<const float*>(q);
  const float* cP = static_cast<const float*>(c);
  float* ov = static_cast<float*>(out_v);
  int* oi = static_cast<int*>(out_i);
  float* sc = static_cast<float*>(scratch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)by_shape(k, d, [&](auto K, auto WIDE) {
    return launch<decltype(K)::value, decltype(WIDE)::value>(
        qP, cP, nq, nc, d, k, euclid, exclude_self, ov, oi, sc, s);
  });
}

// The build a search at (k, d) launches (by_shape): out[0] its list
// size, out[1] 1 when WIDE, out[2] / out[3] the registers and local
// memory bytes a thread.  Returns the cudaFuncGetAttributes error.
int sct_knn_select_build(int k, int d, void* out) {
  if (d < 1 || k < 1) return (int)cudaErrorInvalidValue;
  int* o = static_cast<int*>(out);
  return (int)by_shape(k, d, [&](auto K, auto WIDE) {
    return build_of(o, knn_select_kernel<decltype(K)::value,
                                         decltype(WIDE)::value>,
                    K, WIDE);
  });
}

const char* sct_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
