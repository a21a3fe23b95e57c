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
//   * Splits.  Each (query tile, split) block writes its k best to a
//     scratch buffer (SPLITS, nq, k); knn_merge_kernel merges the SPLITS
//     sorted lists of each query.  The splits cover ascending id ranges,
//     so taking the lower split on equal values keeps ties at the lower
//     id.  No atomics: the result repeats bit for bit.
// The arithmetic of every score is that of the earlier 4x4 core that
// knn_binned.cu still runs (knn_tile.cuh), and the selection is exact
// under the same order, so with n_bins >= nc the two kernels give equal
// bits.
//
// TM, TN, SPLITS, KC, RING and MINB were chosen with knn_kernel_sweep.py
// (PERF.md), which builds this file again with -D sizes.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#ifndef KNN_TM
#define KNN_TM 4  // query rows of the score tile a lane holds
#endif
#ifndef KNN_TN
#define KNN_TN 8  // candidate columns a lane holds
#endif
#ifndef KNN_SPLITS
#define KNN_SPLITS 2  // contiguous candidate ranges, each its own block
#endif
#ifndef KNN_KC
#define KNN_KC 64  // most feature rows a stage holds
#endif
#ifndef KNN_RING
#define KNN_RING 2  // candidate stages in flight at most
#endif
#ifndef KNN_MINB
#define KNN_MINB 2  // blocks an SM the registers must allow
#endif

namespace {

constexpr int THREADS = 256;         // 8 warps
constexpr int TM = KNN_TM;
constexpr int TN = KNN_TN;
constexpr int RW = 2 * TM;           // query rows a warp scores and selects
constexpr int QB = 8 * RW;           // queries a block
constexpr int CB = 16 * TN;          // candidates a tile
constexpr int SPLITS = KNN_SPLITS;
constexpr int KC = KNN_KC;
constexpr int CAP = 32;             // entries a row buffer holds
constexpr int RING_MAX = KNN_RING;  // candidate stages in flight at most
constexpr int BAR_BYTES = 128;      // the mbarriers, before the tiles
constexpr int D_MAX = 256;
constexpr int K_MAX = 256;
constexpr int SMEM_MAX = 232448;     // dynamic shared memory of a block
constexpr int MERGE_THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;
constexpr int NO_ID = 0x7fffffff;  // a list entry not yet filled
static_assert(TM % 4 == 0 && TN % 4 == 0 && TM <= 8 && TN <= 8,
              "4 or 8 rows and columns a lane");
static_assert(SPLITS >= 1 && KC >= 1 && RING_MAX >= 2 && RING_MAX <= 8,
              "sizes");

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}
// Wait until the phase of parity `parity` of `bar` has completed.
__device__ __forceinline__ void bar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT_%=;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}
// Copy `bytes` (a multiple of 16) from global src to shared dst; the copy
// completes on `bar`, which the caller has told to expect the bytes.
__device__ __forceinline__ void bulk_load(float* dst, const float* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// (av, ai) comes before (bv, bi) in the selection's order: value
// descending, then id ascending.
__device__ __forceinline__ bool before(float av, int ai, float bv, int bi) {
  return av > bv || (av == bv && ai < bi);
}

// A finite-or-+inf cell (v, c) that comes before a row's entry k - 1
// (tv, ti): it may enter the row's top k.  Masked cells (-inf) never do.
__device__ __forceinline__ bool enters(float v, int c, float tv, int ti) {
  return v > -CUDART_INF_F && before(v, c, tv, ti);
}

// One compare-exchange stage of a bitonic network over the 32 lanes: the
// lower lane of each pair keeps the element that comes first when
// `desc`, the later one otherwise.
__device__ __forceinline__ void exchange(float& v, int& i, int lane,
                                         int stride, bool desc) {
  const float ov = __shfl_xor_sync(FULL, v, stride);
  const int oi = __shfl_xor_sync(FULL, i, stride);
  const bool lower = (lane & stride) == 0;
  if (before(v, i, ov, oi) != (lower == desc)) v = ov, i = oi;
}

// Sort a bitonic sequence over the warp into the selection's order.
__device__ __forceinline__ void bitonic_merge(float& v, int& i, int lane) {
#pragma unroll
  for (int stride = 16; stride > 0; stride >>= 1)
    exchange(v, i, lane, stride, true);
}

// A top-k list spread over a warp: entry j (j < k) in lane j % 32, slot
// j / 32, in the selection's order; entries past k and those not yet
// filled are (-inf, NO_ID).  (tv, ti) is entry k - 1: only a candidate
// before it can enter.
template <int SL>
struct List {
  float v[SL];
  int id[SL];
  float tv;
  int ti;
};

// Merge into a list the cnt entries of a row's buffer (shared memory,
// written by the warp) and keep the first k.  The buffer is sorted by a
// bitonic network, then each slot in turn keeps the first 32 of itself
// and the carry and passes the rest on.  Out of line: one copy of the
// network serves every row (inlined at each call, the kernel's code
// outgrew the instruction cache; PERF.md).
template <int SL>
__device__ __noinline__ List<SL> merge_row(List<SL> l, const float* bv,
                                           const int* bi, int cnt, int k,
                                           int lane) {
  __syncwarp();  // the buffer's writes are visible
  float cv = lane < cnt ? bv[lane] : -CUDART_INF_F;
  int ci = lane < cnt ? bi[lane] : NO_ID;
  __syncwarp();  // read before the next appends overwrite it
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1)
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1)
      exchange(cv, ci, lane, stride, (lane & size) == 0);
  float last = 0.f;
  int last_i = 0;
#pragma unroll
  for (int w = 0; w < SL; ++w) {
    const float rv = __shfl_sync(FULL, cv, 31 - lane);  // ascending
    const int ri = __shfl_sync(FULL, ci, 31 - lane);
    const bool mine = before(l.v[w], l.id[w], rv, ri);
    const float hv = mine ? l.v[w] : rv, lo_v = mine ? rv : l.v[w];
    const int hi = mine ? l.id[w] : ri, lo_i = mine ? ri : l.id[w];
    l.v[w] = hv, l.id[w] = hi;
    bitonic_merge(l.v[w], l.id[w], lane);
    if (w + 1 < SL) {
      cv = lo_v, ci = lo_i;
      bitonic_merge(cv, ci, lane);
    }
    if (w * 32 + lane >= k) l.v[w] = -CUDART_INF_F, l.id[w] = NO_ID;
    if (w == (k - 1) / 32) last = l.v[w], last_i = l.id[w];
  }
  l.tv = __shfl_sync(FULL, last, (k - 1) % 32);
  l.ti = __shfl_sync(FULL, last_i, (k - 1) % 32);
  return l;
}

// The cells of a row pair, each lane's TN cells of its row (rows A and
// B: lanes 0-15 and 16-31), with the rows' lists and buffer counts.
struct Cells {
  float v[TN];
};
template <int SL>
struct Pair {
  List<SL> a, b;
  int na, nb;
};

// Append a row pair's cells that may enter to the rows' buffers: all at
// once when they fit, else two cells a lane at a time (at most 32 a row),
// merging a buffer first when they would not fit.  Out of line, like
// merge_row, and called only for a pair with such a cell.  col0 is the
// column of cell 0.
template <int SL>
__device__ __noinline__ Pair<SL> take_cells(Pair<SL> p, Cells c, int col0,
                                            float* bva, int* bia, float* bvb,
                                            int* bib, int k, int lane) {
  __syncwarp();  // converged: the warp intrinsics below take their fast form
  const int g = lane >> 4;
  const unsigned below = (1u << (lane & 15)) - 1u;
  {
    const float tv = g ? p.b.tv : p.a.tv;
    const int ti = g ? p.b.ti : p.a.ti;
    unsigned m[TN];
    int na = 0, nb = 0;  // the cells that pass, of rows A and B
#pragma unroll
    for (int e = 0; e < TN; ++e) {
      m[e] = __ballot_sync(FULL, enters(c.v[e], col0 + 64 * (e / 4) + e % 4,
                                        tv, ti));
      na += __popc(m[e] & 0xffffu);
      nb += __popc(m[e] >> 16);
    }
    if (p.na + na <= CAP && p.nb + nb <= CAP) {
      int at = g ? p.nb : p.na;
      float* bv = g ? bvb : bva;
      int* bi = g ? bib : bia;
#pragma unroll
      for (int e = 0; e < TN; ++e) {
        const unsigned h = g ? m[e] >> 16 : m[e] & 0xffffu;
        if ((h >> (lane & 15)) & 1u) {
          const int pos = at + __popc(h & below);
          bv[pos] = c.v[e];
          bi[pos] = col0 + 64 * (e / 4) + e % 4;
        }
        at += __popc(h);
      }
      p.na += na;
      p.nb += nb;
      return p;
    }
  }
#pragma unroll
  for (int e0 = 0; e0 < TN; e0 += 2) {
    const int col = col0 + 64 * (e0 / 4) + e0 % 4;
    const float tv = g ? p.b.tv : p.a.tv;
    const int ti = g ? p.b.ti : p.a.ti;
    const bool p0 = enters(c.v[e0], col, tv, ti);
    const bool p1 = enters(c.v[e0 + 1], col + 1, tv, ti);
    const unsigned m0 = __ballot_sync(FULL, p0);
    const unsigned m1 = __ballot_sync(FULL, p1);
    const int na = __popc(m0 & 0xffffu) + __popc(m1 & 0xffffu);
    const int nb = __popc(m0 >> 16) + __popc(m1 >> 16);
    if (p.na + na > CAP) p.a = merge_row<SL>(p.a, bva, bia, p.na, k, lane), p.na = 0;
    if (p.nb + nb > CAP) p.b = merge_row<SL>(p.b, bvb, bib, p.nb, k, lane), p.nb = 0;
    const unsigned h0 = g ? m0 >> 16 : m0 & 0xffffu;
    const unsigned h1 = g ? m1 >> 16 : m1 & 0xffffu;
    const int base = g ? p.nb : p.na;
    float* bv = g ? bvb : bva;
    int* bi = g ? bib : bia;
    if (p0) {
      const int at = base + __popc(h0 & below);
      bv[at] = c.v[e0], bi[at] = col;
    }
    if (p1) {
      const int at = base + __popc(h0) + __popc(h1 & below);
      bv[at] = c.v[e0 + 1], bi[at] = col + 1;
    }
    p.na += na;
    p.nb += nb;
  }
  return p;
}

template <int K>
__global__ void __launch_bounds__(THREADS, KNN_MINB)
    knn_select_kernel(const float* __restrict__ qP,
                      const float* __restrict__ cP,
                      const float* __restrict__ qn,
                      const float* __restrict__ cn, int nq, int nc, int d,
                      int kc, int nring, int k, int exclude_self,
                      float* __restrict__ out_v, int* __restrict__ out_i) {
  constexpr int SL = (K + 31) / 32;  // list slots a lane
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);  // [RING_MAX]
  uint64_t* qbar = full + RING_MAX;
  int* done = reinterpret_cast<int*>(qbar + 1);  // [RING_MAX] warps done
  float* qs = reinterpret_cast<float*>(smem + BAR_BYTES);  // [d][QB]
  float* ring = qs + d * QB;          // nring x [kc][CB], candidate chunks
  float* buf_v = ring + nring * kc * CB;  // [QB][CAP], row buffers
  int* buf_i = reinterpret_cast<int*>(buf_v + QB * CAP);
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
  auto issue = [&](int st) {
    const int k0 = st % chunks * kc;
    const int b = st % nring;
    bulk_load(ring + b * kc * CB,
              cP + ((int64_t)(t_begin + st / chunks) * d + k0) * CB,
              min(kc, d - k0) * CB * 4, full + b);
  };
  if (tid == 0) {
    for (int b = 0; b < nring; ++b) bar_init(full + b, 1), done[b] = 0;
    bar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (stages > 0)
      bulk_load(qs, qP + (int64_t)blockIdx.x * d * QB, d * QB * 4, qbar);
    for (int st = 0; st < nring && st < stages; ++st) issue(st);
  }
  __syncthreads();
  const int g = lane >> 4;                     // which row of each pair
  const int r0 = warp * RW + 4 * g;            // rows r0 + 8h + i
  const int c0l = 4 * (lane & 15);             // columns c0l + 64h + j
  float* wbv = buf_v + warp * RW * CAP;        // the warp's row buffers
  int* wbi = buf_i + warp * RW * CAP;

  // The warp's RW lists and, per row, entry k - 1 (only a candidate
  // before it can enter) and the entries in its buffer.
  List<SL> L[RW];
  int cnt[RW];
#pragma unroll
  for (int q = 0; q < RW; ++q) {
    L[q].tv = -CUDART_INF_F;
    L[q].ti = NO_ID;
    cnt[q] = 0;
#pragma unroll
    for (int w = 0; w < SL; ++w) L[q].v[w] = -CUDART_INF_F, L[q].id[w] = NO_ID;
  }

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  int t = t_begin, j = 0;  // the stage being scored: tile t, chunk j

  if (stages > 0) bar_wait(qbar, 0);
  for (int s = 0; s < stages; ++s) {
    const int b = s % nring;
    bar_wait(full + b, (s / nring) & 1);  // stage s is in
    const float* cs = ring + b * kc * CB;
    const int k0 = j * kc;
    const int len = min(kc, d - k0);
    const float* qk = qs + k0 * QB;
#pragma unroll 2
    for (int kk = 0; kk < len; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int h = 0; h < TM / 4; ++h) {
        const float4 x =
            *reinterpret_cast<const float4*>(qk + kk * QB + r0 + 8 * h);
        a[h * 4] = x.x, a[h * 4 + 1] = x.y, a[h * 4 + 2] = x.z,
        a[h * 4 + 3] = x.w;
      }
#pragma unroll
      for (int h = 0; h < TN / 4; ++h) {
        const float4 y =
            *reinterpret_cast<const float4*>(cs + kk * CB + c0l + 64 * h);
        b[h * 4] = y.x, b[h * 4 + 1] = y.y, b[h * 4 + 2] = y.z,
        b[h * 4 + 3] = y.w;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int jj = 0; jj < TN; ++jj)
          acc[i][jj] = fmaf(a[i], b[jj], acc[i][jj]);
    }
    // The last warp done with buffer b refills it with stage s + nring.
    __syncwarp();
    if (lane == 0) {
      __threadfence_block();
      if (atomicAdd(done + b, 1) == 7) {
        done[b] = 0;
        if (s + nring < stages) {
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          issue(s + nring);
        }
      }
    }
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
        Cells cl;
#pragma unroll
        for (int e = 0; e < TN; ++e) cl.v[e] = o[e];
        __syncwarp();
        const Pair<SL> pr = take_cells<SL>(
            Pair<SL>{L[A], L[B], cnt[A], cnt[B]}, cl, c0 + c0l, wbv + A * CAP,
            wbi + A * CAP, wbv + B * CAP, wbi + B * CAP, k, lane);
        L[A] = pr.a, L[B] = pr.b, cnt[A] = pr.na, cnt[B] = pr.nb;
      }
    j = 0;
    ++t;
  }

  // the buffers' last entries, then this split's slice of the output
  const int64_t slice = (int64_t)blockIdx.y * nq * k;
#pragma unroll
  for (int q = 0; q < RW; ++q) {
    if (cnt[q] > 0)
      L[q] = merge_row<SL>(L[q], wbv + q * CAP, wbi + q * CAP, cnt[q], k,
                           lane);
    const int qrow = q0 + warp * RW + q;
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

// |x|^2 of each packed row (tile-major, W rows a tile), by the chain
// a += x * x over kk = 0 .. d - 1: the squared norms of the euclidean
// score, in the order of the earlier core.
__global__ void knn_norms_kernel(const float* __restrict__ p, int n_pad,
                                 int d, int W, float* __restrict__ out) {
  const int r = blockIdx.x * MERGE_THREADS + threadIdx.x;
  if (r >= n_pad) return;
  const float* x = p + (int64_t)(r / W) * d * W + r % W;
  float a = 0.f;
  for (int kk = 0; kk < d; ++kk) a += x[kk * W] * x[kk * W];
  out[r] = a;
}

// Merge the SPLITS sorted lists (value descending, ties by id ascending)
// of each query, one thread a query: the larger head value first; on equal
// values the lower split, whose ids are lower.  A slot with no finite
// value gets id -1.
__global__ void __launch_bounds__(MERGE_THREADS)
    knn_merge_kernel(const float* __restrict__ sv, const int* __restrict__ si,
                     int nq, int k, float* __restrict__ out_v,
                     int* __restrict__ out_i) {
  const int q = blockIdx.x * MERGE_THREADS + threadIdx.x;
  if (q >= nq) return;
  float head[SPLITS];
  int pos[SPLITS];
#pragma unroll
  for (int s = 0; s < SPLITS; ++s) {
    pos[s] = 0;
    head[s] = sv[((int64_t)s * nq + q) * k];
  }
  for (int t = 0; t < k; ++t) {
    int b = 0;
    float bv = head[0];
#pragma unroll
    for (int s = 1; s < SPLITS; ++s)
      if (head[s] > bv) b = s, bv = head[s];
    int bp = 0;
#pragma unroll
    for (int s = 0; s < SPLITS; ++s)
      if (s == b) {
        bp = pos[s]++;
        head[s] = pos[s] < k ? sv[((int64_t)s * nq + q) * k + pos[s]]
                             : -CUDART_INF_F;
      }
    out_v[(int64_t)q * k + t] = bv;
    out_i[(int64_t)q * k + t] =
        isfinite(bv) ? si[((int64_t)b * nq + q) * k + bp] : -1;
  }
}

inline size_t smem_bytes(int d, int kc, int nring) {
  return BAR_BYTES + sizeof(float) * ((size_t)d * QB + (size_t)nring * kc * CB +
                                      (size_t)2 * QB * CAP);
}

// Feature rows a stage holds: all d (up to KC) when two stages fit beside
// the query tile, else halved until they do; then as many stages as fit,
// up to RING_MAX.
inline void stage_shape(int d, int* kc, int* nring) {
  int c = d < KC ? d : KC;
  while (c > 1 && smem_bytes(d, c, 2) > (size_t)SMEM_MAX) c = (c + 1) / 2;
  int r = 2;
  while (r < RING_MAX && smem_bytes(d, c, r + 1) <= (size_t)SMEM_MAX) ++r;
  *kc = c;
  *nring = r;
}

inline int round_up(int n, int m) { return (n + m - 1) / m * m; }

template <int K>
cudaError_t launch(const float* qP, const float* cP, int nq, int nc, int d,
                   int k, int euclid, int exclude_self, float* out_v,
                   int* out_i, float* scratch, cudaStream_t stream) {
  int kc, nring;
  stage_shape(d, &kc, &nring);
  const size_t smem = smem_bytes(d, kc, nring);
  auto kern = knn_select_kernel<K>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const size_t lists = SPLITS == 1 ? 0 : (size_t)SPLITS * nq * k;
  float* sv = SPLITS == 1 ? out_v : scratch;
  int* si = SPLITS == 1 ? out_i : reinterpret_cast<int*>(scratch + lists);
  float* qn = nullptr;
  float* cn = nullptr;
  if (euclid) {
    const int ldq = round_up(nq, QB), ldc = round_up(nc, CB);
    qn = scratch + 2 * lists;
    cn = qn + ldq;
    knn_norms_kernel<<<(ldq + MERGE_THREADS - 1) / MERGE_THREADS,
                       MERGE_THREADS, 0, stream>>>(qP, ldq, d, QB, qn);
    if (ldc > 0)
      knn_norms_kernel<<<(ldc + MERGE_THREADS - 1) / MERGE_THREADS,
                         MERGE_THREADS, 0, stream>>>(cP, ldc, d, CB, cn);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((nq + QB - 1) / QB, SPLITS);
  kern<<<grid, THREADS, smem, stream>>>(qP, cP, qn, cn, nq, nc, d, kc,
                                             nring, k, exclude_self, sv, si);
  e = cudaGetLastError();
  if (e != cudaSuccess || SPLITS == 1) return e;
  knn_merge_kernel<<<(nq + MERGE_THREADS - 1) / MERGE_THREADS, MERGE_THREADS,
                     0, stream>>>(sv, si, nq, k, out_v, out_i);
  return cudaGetLastError();
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
  int* o = static_cast<int*>(out);
  o[0] = QB;
  o[1] = CB;
  o[2] = SPLITS;
  o[3] = RING_MAX;
  o[4] = TM;
  o[5] = TN;
  cudaFuncAttributes a16, a32;
  cudaError_t e = cudaFuncGetAttributes(&a16, knn_select_kernel<16>);
  if (e == cudaSuccess)
    e = cudaFuncGetAttributes(&a32, knn_select_kernel<32>);
  if (e != cudaSuccess) return (int)e;
  o[6] = a16.numRegs;
  o[7] = (int)a16.localSizeBytes;
  o[8] = a32.numRegs;
  o[9] = (int)a32.localSizeBytes;
  return 0;
}

// q and c packed tile-major as float (pack_tiles in ops/knn_kernel.py):
// q (ceil(nq / QB), d, QB) and c (ceil(nc / CB), d, CB), element [t, kk,
// i] = row t * W + i, feature kk, zero past the rows; out_v (nq, k) float
// and out_i (nq, k) int32; scratch of 2 * SPLITS * nq * k floats (split
// values, then int32 ids; none when SPLITS == 1), then for euclid
// round_up(nq, QB) + round_up(nc, CB) floats (the squared norms).
// Launches on `stream` and returns cudaGetLastError() (0 on success).
int sct_knn_select(const void* q, const void* c, int nq, int nc, int d,
                   int k, int euclid, int exclude_self, void* out_v,
                   void* out_i, void* scratch, void* stream) {
  if (nq < 0 || nc < 0 || d < 1 || d > D_MAX || k < 1 || k > K_MAX)
    return (int)cudaErrorInvalidValue;
  if (nq == 0) return 0;
  const float* qP = static_cast<const float*>(q);
  const float* cP = static_cast<const float*>(c);
  float* ov = static_cast<float*>(out_v);
  int* oi = static_cast<int*>(out_i);
  float* sc = static_cast<float*>(scratch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k <= 16)
    return (int)launch<16>(qP, cP, nq, nc, d, k, euclid, exclude_self, ov, oi,
                           sc, s);
  if (k <= 32)
    return (int)launch<32>(qP, cP, nq, nc, d, k, euclid, exclude_self, ov, oi,
                           sc, s);
  if (k <= 64)
    return (int)launch<64>(qP, cP, nq, nc, d, k, euclid, exclude_self, ov, oi,
                           sc, s);
  if (k <= 128)
    return (int)launch<128>(qP, cP, nq, nc, d, k, euclid, exclude_self, ov,
                            oi, sc, s);
  return (int)launch<256>(qP, cP, nq, nc, d, k, euclid, exclude_self, ov, oi,
                          sc, s);
}

const char* sct_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
