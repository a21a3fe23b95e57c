// The core that the two kNN kernels share, for Hopper (sm_90a):
// knn_select.cu (exact merge) and knn_binned.cu (binned merge).
//
// * Pre-packed operands.  The wrapper lays q and c out as f32 tiles,
//   tile-major and feature-major inside, (tiles, d, W) with W = QB or CB,
//   zero past the last row (ops/knn_kernel.py:pack_tiles).  A stage -- a
//   tile's feature rows [k0, k0 + kc) -- is one contiguous block, copied
//   by one cp.async.bulk that completes on an mbarrier.
// * The ring.  A block keeps its QB queries resident in shared memory and
//   streams candidate stages through a ring of up to RING_MAX buffers.
//   Rows wider than D_RESIDENT features do not stay resident: each stage
//   then carries the query tile's same feature rows beside the
//   candidates' (the WIDE builds), so any d fits.
//   Each stage's copy completes on its "full" mbarrier, which the warps
//   wait on; the last warp done with a buffer (a shared-memory counter)
//   issues the copy of the stage that refills it (release).  No
//   block-wide barrier follows the start, so warps drift apart by up to a
//   ring of stages, and one warp's selection (latency-bound) overlaps
//   another's FMAs (issue-bound).  Which tile a stage holds is the
//   kernel's choice: its `issue` callback maps a stage to a tile.
// * The register tile.  Warp w owns the RW = QB / 8 query rows [w*RW,
//   w*RW + RW) of the block: lane (g, cg) = (lane / 16, lane % 16) holds
//   the TM x TN scores at rows w*RW + 8h + 4g + i and columns 64h + 4cg +
//   j of a tile, fed by TM/4 + TN/4 float4 shared-memory loads a feature
//   row (score_stage).  Each score is one fmaf chain over kk = 0 .. d - 1
//   from 0.f, whatever the staging: the partial sums of a wide row's
//   stages add into the same cells before any selection, so a WIDE build
//   gives the bits the resident one would.
// * The lists.  A query's top-k list is spread over its warp (entry j in
//   lane j % 32, slot j / 32) in the order (value descending, key
//   ascending), with entry k - 1 as its threshold.  Up to K_REG entries
//   the list lives in the warp's registers (List); above it, in device
//   memory at the row's k output slots, with only its threshold in
//   registers (MemList), and a merge streams it slot by slot (any k).
//   Cells that may enter
//   go, out of line, to the row's 32-entry buffer in shared memory
//   (take_cells: positions by ballot and popc), and a full buffer is
//   merged into the list by a bitonic sort and merge-split (merge_row).
//   The key is the candidate id for the exact kernel and an order-giving
//   code of (bin, round) for the binned one (Cells<true>).  The result is
//   the exact top k under that order, whatever the order of insertion.
// * The splits.  Each (query tile, split) block writes its k best to a
//   scratch buffer (splits, nq, k); knn_merge_kernel merges the sorted
//   lists of each query, the lower split first on equal values.  The
//   splits cover ascending key ranges, so that keeps ties at the lower
//   key.  No atomics: results repeat bit for bit.
// * The euclidean norms: knn_norms_kernel, launched first, gives |x|^2 of
//   each packed row by the chain a += x * x over kk = 0 .. d - 1.
//
// The sizes below are macros with defaults, so that knn_kernel_sweep.py
// can build each kernel again with -D sizes; each kernel's source may set
// its own defaults before it includes this header.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

#ifndef KNN_TM
#define KNN_TM 4  // query rows of the score tile a lane holds
#endif
#ifndef KNN_TN
#define KNN_TN 8  // candidate columns a lane holds
#endif
#ifndef KNN_SPLITS
#define KNN_SPLITS 2  // most blocks a query tile's candidates are split over
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
#ifndef KNN_UNROLL
#define KNN_UNROLL 2  // feature rows a turn of the score loop
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
constexpr int UNROLL = KNN_UNROLL;
constexpr int CAP = 32;             // entries a row buffer holds
constexpr int RING_MAX = KNN_RING;  // candidate stages in flight at most
constexpr int BAR_BYTES = 128;      // the mbarriers, before the tiles
// Most feature rows the query tile keeps resident in shared memory; a
// wider query tile is staged with the candidates (the WIDE builds).
constexpr int D_RESIDENT = 256;
// Most entries a list keeps in registers: RW lists of K_REG / 32 (value,
// id) pairs a lane.  Above it a list lives in device memory (MemList):
// RW lists of 512 would need 256 registers a lane.  K_MEM is the build
// that serves every k above K_REG: its lists have no upper bound.
constexpr int K_REG = 256;
constexpr int K_MEM = 512;
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
// Arrive on `bar` and tell it to expect `bytes` more.
__device__ __forceinline__ void expect_bytes(uint64_t* bar, unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}
// Copy `bytes` (a multiple of 16) from global src to shared dst; the copy
// completes on `bar`, which has been told to expect the bytes.
__device__ __forceinline__ void bulk_copy(float* dst, const float* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}
__device__ __forceinline__ void bulk_load(float* dst, const float* src,
                                          unsigned bytes, uint64_t* bar) {
  expect_bytes(bar, bytes);
  bulk_copy(dst, src, bytes, bar);
}

// The shared memory of a block, from its start: the barriers (the ring's
// "full" mbarriers, the query tile's, the ring's done counters), the
// query tile [qrows][QB] (all d rows, or a WIDE build's nring stages of
// kc rows), the ring nring x [kc][CB], the row buffers' values and ids
// [QB][CAP] each.
struct Smem {
  uint64_t* full;
  uint64_t* qbar;
  int* done;
  float* qs;
  float* ring;
  float* buf_v;
  int* buf_i;
  unsigned char* end;  // what a kernel adds after these
};
__device__ __forceinline__ Smem carve(unsigned char* smem, int qrows, int kc,
                                      int nring) {
  Smem m;
  m.full = reinterpret_cast<uint64_t*>(smem);
  m.qbar = m.full + RING_MAX;
  m.done = reinterpret_cast<int*>(m.qbar + 1);
  m.qs = reinterpret_cast<float*>(smem + BAR_BYTES);
  m.ring = m.qs + qrows * QB;
  m.buf_v = m.ring + nring * kc * CB;
  m.buf_i = reinterpret_cast<int*>(m.buf_v + QB * CAP);
  m.end = reinterpret_cast<unsigned char*>(m.buf_i + QB * CAP);
  return m;
}

// Thread 0 sets up the barriers and starts the copies of the query tile
// at qsrc (none for a WIDE build: qsrc null) and of the first stages; the
// caller then syncs the block.
template <class Issue>
__device__ __forceinline__ void ring_start(const Smem& m, const float* qsrc,
                                           int d, int nring, int stages,
                                           Issue issue) {
  if (threadIdx.x == 0) {
    for (int b = 0; b < nring; ++b) bar_init(m.full + b, 1), m.done[b] = 0;
    bar_init(m.qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (stages > 0 && qsrc) bulk_load(m.qs, qsrc, d * QB * 4, m.qbar);
    for (int st = 0; st < nring && st < stages; ++st) issue(st);
  }
}

// Copy a stage into ring buffer b: the candidate tile's feature rows
// [k0, k0 + len) from csrc and, in a WIDE build, the query tile's same
// rows from qsrc, both on the buffer's barrier.
template <bool WIDE>
__device__ __forceinline__ void load_stage(const Smem& m, int b, int kc,
                                           const float* qsrc,
                                           const float* csrc, int len) {
  if constexpr (WIDE) {
    expect_bytes(m.full + b, len * (QB + CB) * 4);
    bulk_copy(m.qs + b * kc * QB, qsrc, len * QB * 4, m.full + b);
    bulk_copy(m.ring + b * kc * CB, csrc, len * CB * 4, m.full + b);
  } else {
    bulk_load(m.ring + b * kc * CB, csrc, len * CB * 4, m.full + b);
  }
}

// The query tile's rows of the stage in buffer b, from feature row k0.
template <bool WIDE>
__device__ __forceinline__ const float* stage_queries(const Smem& m, int b,
                                                      int kc, int k0) {
  return WIDE ? m.qs + b * kc * QB : m.qs + k0 * QB;
}

// Stage s, in buffer b, is scored by this warp: the last warp done with
// the buffer refills it with stage s + nring.
template <class Issue>
__device__ __forceinline__ void release(int* done, int b, int s, int nring,
                                        int stages, int lane, Issue issue) {
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
}

// Add feature rows [0, len) of a stage to the lane's TM x TN cells: qk is
// the query tile at the stage's first feature row ([kk][QB]), cs the
// stage's candidates ([kk][CB]); the lane's rows are r0 + 8h + i, its
// columns c0l + 64h + j.
__device__ __forceinline__ void score_stage(float (&acc)[TM][TN],
                                            const float* qk, const float* cs,
                                            int len, int r0, int c0l) {
#pragma unroll (UNROLL)
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
}

// (av, ai) comes before (bv, bi) in the selection's order: value
// descending, then key ascending.
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

// A top-k list of more than K_REG entries: its k entries in device
// memory (entry j at v[j], id[j], in List's order, written and read only
// by lane j % 32), its threshold (entry k - 1) in registers.
struct MemList {
  float* v;
  int* id;
  float tv;
  int ti;
};

// Merge into a list the cnt entries of a row's buffer (shared memory,
// written by the warp) and keep the first k.  The buffer is sorted by a
// bitonic network, then each slot in turn keeps the first 32 of itself
// and the carry and passes the rest on.
template <int SL>
__device__ __forceinline__ void merge_list(List<SL>& l, const float* bv,
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
}

// merge_list out of line: one copy of the network serves every row
// (inlined at each call, the kernel's code outgrew the instruction cache;
// PERF.md).
template <int SL>
__device__ __noinline__ List<SL> merge_row(List<SL> l, const float* bv,
                                           const int* bi, int cnt, int k,
                                           int lane) {
  merge_list<SL>(l, bv, bi, cnt, k, lane);
  return l;
}

// The same merge for a list in device memory, slot by slot: each slot is
// loaded, takes merge_list's step (keep the first 32 of itself and the
// carry, pass the rest on) and is stored back, so only one slot and the
// carry are in registers, whatever k.  The steps and their order are
// merge_list's, so the list is the one a List would hold.  SL is unused.
template <int SL>
__device__ __noinline__ MemList merge_row(MemList l, const float* bv,
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
  const int slots = (k + 31) / 32;
  float last = 0.f;
  int last_i = 0;
  for (int w = 0; w < slots; ++w) {
    const int jj = w * 32 + lane;
    float v = jj < k ? l.v[jj] : -CUDART_INF_F;
    int id = jj < k ? l.id[jj] : NO_ID;
    const float rv = __shfl_sync(FULL, cv, 31 - lane);  // ascending
    const int ri = __shfl_sync(FULL, ci, 31 - lane);
    const bool mine = before(v, id, rv, ri);
    const float lo_v = mine ? rv : v;
    const int lo_i = mine ? ri : id;
    if (!mine) v = rv, id = ri;
    bitonic_merge(v, id, lane);
    if (w + 1 < slots) {
      cv = lo_v, ci = lo_i;
      bitonic_merge(cv, ci, lane);
    }
    if (jj < k) l.v[jj] = v, l.id[jj] = id;
    if (w == slots - 1) last = v, last_i = id;
  }
  l.tv = __shfl_sync(FULL, last, (k - 1) % 32);
  l.ti = __shfl_sync(FULL, last_i, (k - 1) % 32);
  return l;
}

// The cells of a row pair, each lane's TN cells of its row (rows A and
// B: lanes 0-15 and 16-31).  Unkeyed cells take the key of their column,
// col0 + 64 (e / 4) + e % 4 for cell e; keyed ones carry their own.
template <bool KEYED>
struct Cells {
  float v[TN];
};
template <>
struct Cells<true> {
  float v[TN];
  int key[TN];
};
template <bool KEYED>
__device__ __forceinline__ int cell_key(const Cells<KEYED>& c, int col0,
                                        int e) {
  if constexpr (KEYED)
    return c.key[e];
  else
    return col0 + 64 * (e / 4) + e % 4;
}

// A row pair's lists (List<SL> or MemList) and buffer counts.
template <class L>
struct Pair {
  L a, b;
  int na, nb;
};

// Which of a row pair's cells may enter, against the threshold (tv, ti)
// of the lane's row: a ballot a cell (row A in the low 16 bits, row B in
// the high), and how many pass in each row.
struct Passing {
  unsigned m[TN];
  int na, nb;
};
template <bool KEYED>
__device__ __forceinline__ Passing passing(const Cells<KEYED>& c, int col0,
                                           float tv, int ti) {
  Passing ps;
  ps.na = ps.nb = 0;
#pragma unroll
  for (int e = 0; e < TN; ++e) {
    ps.m[e] = __ballot_sync(FULL, enters(c.v[e], cell_key(c, col0, e), tv,
                                         ti));
    ps.na += __popc(ps.m[e] & 0xffffu);
    ps.nb += __popc(ps.m[e] >> 16);
  }
  return ps;
}

// Write the passing cells to the rows' buffers, after the at (row A) or
// bt (row B) entries they hold; the caller has checked that they fit.
template <bool KEYED>
__device__ __forceinline__ void append_cells(const Cells<KEYED>& c, int col0,
                                             const Passing& ps, int at,
                                             int bt, float* bva, int* bia,
                                             float* bvb, int* bib,
                                             int lane) {
  const int g = lane >> 4;
  const unsigned below = (1u << (lane & 15)) - 1u;
  int pos0 = g ? bt : at;
  float* bv = g ? bvb : bva;
  int* bi = g ? bib : bia;
#pragma unroll
  for (int e = 0; e < TN; ++e) {
    const unsigned h = g ? ps.m[e] >> 16 : ps.m[e] & 0xffffu;
    if ((h >> (lane & 15)) & 1u) {
      const int pos = pos0 + __popc(h & below);
      bv[pos] = c.v[e];
      bi[pos] = cell_key(c, col0, e);
    }
    pos0 += __popc(h);
  }
}

// Append a row pair's cells that may enter to the rows' buffers: all at
// once when they fit, else two cells a lane at a time (at most 32 a row),
// merging a buffer first when they would not fit.  Out of line, like
// merge_row, and called only for a pair with such a cell.  L is List<SL>
// or MemList (SL slots in the merges).
template <int SL, bool KEYED, class L>
__device__ __noinline__ Pair<L> take_cells(Pair<L> p, Cells<KEYED> c,
                                            int col0, float* bva, int* bia,
                                            float* bvb, int* bib, int k,
                                            int lane) {
  __syncwarp();  // converged: the warp intrinsics below take their fast form
  const int g = lane >> 4;
  const unsigned below = (1u << (lane & 15)) - 1u;
  {
    const Passing ps =
        passing(c, col0, g ? p.b.tv : p.a.tv, g ? p.b.ti : p.a.ti);
    if (p.na + ps.na <= CAP && p.nb + ps.nb <= CAP) {
      append_cells(c, col0, ps, p.na, p.nb, bva, bia, bvb, bib, lane);
      p.na += ps.na;
      p.nb += ps.nb;
      return p;
    }
  }
#pragma unroll
  for (int e0 = 0; e0 < TN; e0 += 2) {
    const int key0 = cell_key(c, col0, e0), key1 = cell_key(c, col0, e0 + 1);
    const float tv = g ? p.b.tv : p.a.tv;
    const int ti = g ? p.b.ti : p.a.ti;
    const bool p0 = enters(c.v[e0], key0, tv, ti);
    const bool p1 = enters(c.v[e0 + 1], key1, tv, ti);
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
      bv[at] = c.v[e0], bi[at] = key0;
    }
    if (p1) {
      const int at = base + __popc(h0) + __popc(h1 & below);
      bv[at] = c.v[e0 + 1], bi[at] = key1;
    }
    p.na += na;
    p.nb += nb;
  }
  return p;
}

// |x|^2 of each packed row (tile-major, W rows a tile), by the chain
// a += x * x over kk = 0 .. d - 1: the squared norms of the euclidean
// score.
__global__ void knn_norms_kernel(const float* __restrict__ p, int n_pad,
                                 int d, int W, float* __restrict__ out) {
  const int r = blockIdx.x * MERGE_THREADS + threadIdx.x;
  if (r >= n_pad) return;
  const float* x = p + (int64_t)(r / W) * d * W + r % W;
  float a = 0.f;
  for (int kk = 0; kk < d; ++kk) a += x[kk * W] * x[kk * W];
  out[r] = a;
}

// Merge the `splits` (<= SPLITS) sorted lists (value descending, ties by
// key ascending) of each query, one thread a query: the larger head value
// first; on equal values the lower split, whose keys are lower.  The
// lists hold final ids (-1 for no finite value), copied as they are; a
// slot with no finite value gets id -1.
__global__ void __launch_bounds__(MERGE_THREADS)
    knn_merge_kernel(const float* __restrict__ sv, const int* __restrict__ si,
                     int nq, int k, int splits, float* __restrict__ out_v,
                     int* __restrict__ out_i) {
  const int q = blockIdx.x * MERGE_THREADS + threadIdx.x;
  if (q >= nq) return;
  float head[SPLITS];
  int pos[SPLITS];
#pragma unroll
  for (int s = 0; s < SPLITS; ++s) {
    pos[s] = 0;
    head[s] = s < splits ? sv[((int64_t)s * nq + q) * k] : -CUDART_INF_F;
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

// Feature rows of the query tile in shared memory: all d, or in a WIDE
// build one stage's kc a ring buffer.
__host__ __device__ __forceinline__ int query_rows(int d, int kc,
                                                     int nring, bool wide) {
  return wide ? nring * kc : d;
}

// Bytes of dynamic shared memory: the barriers, the query tile (qrows
// feature rows), the ring, the row buffers and `extra` bytes of the
// kernel's own.
inline size_t smem_bytes(int qrows, int kc, int nring, size_t extra) {
  return BAR_BYTES + extra +
         sizeof(float) * ((size_t)qrows * QB + (size_t)nring * kc * CB +
                          (size_t)2 * QB * CAP);
}

// Feature rows a stage holds: all d (up to KC) when two stages fit beside
// the query tile, else halved until they do; then as many stages as fit,
// up to RING_MAX.
inline void stage_shape(int d, size_t extra, bool wide, int* kc,
                        int* nring) {
  int c = d < KC ? d : KC;
  while (c > 1 &&
         smem_bytes(query_rows(d, c, 2, wide), c, 2, extra) >
             (size_t)SMEM_MAX)
    c = (c + 1) / 2;
  int r = 2;
  while (r < RING_MAX &&
         smem_bytes(query_rows(d, c, r + 1, wide), c, r + 1, extra) <=
             (size_t)SMEM_MAX)
    ++r;
  *kc = c;
  *nring = r;
}

inline int round_up(int n, int m) { return (n + m - 1) / m * m; }

// The scratch of a launch (2 * SPLITS * nq * k floats of split lists,
// values then int32 ids, none when SPLITS == 1; then for euclid the
// squared norms of the packed rows, round_up(nq, QB) + round_up(nc, CB)
// floats): where the score launch writes its lists (the output itself
// with one split), and the norms (null for cosine), launched here.
struct Scratch {
  float* sv;
  int* si;
  float* qn;
  float* cn;
};
inline cudaError_t scratch_and_norms(const float* qP, const float* cP, int nq,
                                     int nc, int d, int k, int splits,
                                     int euclid, float* out_v, int* out_i,
                                     float* scratch, cudaStream_t stream,
                                     Scratch* s) {
  const size_t lists = SPLITS == 1 ? 0 : (size_t)SPLITS * nq * k;
  s->sv = splits == 1 ? out_v : scratch;
  s->si = splits == 1 ? out_i : reinterpret_cast<int*>(scratch + lists);
  s->qn = s->cn = nullptr;
  if (!euclid) return cudaSuccess;
  const int ldq = round_up(nq, QB), ldc = round_up(nc, CB);
  s->qn = scratch + 2 * lists;
  s->cn = s->qn + ldq;
  knn_norms_kernel<<<(ldq + MERGE_THREADS - 1) / MERGE_THREADS, MERGE_THREADS,
                     0, stream>>>(qP, ldq, d, QB, s->qn);
  if (ldc > 0)
    knn_norms_kernel<<<(ldc + MERGE_THREADS - 1) / MERGE_THREADS,
                       MERGE_THREADS, 0, stream>>>(cP, ldc, d, CB, s->cn);
  return cudaGetLastError();
}

// After the score launch: merge its `splits` lists into the output.
inline cudaError_t merge_splits(const Scratch& s, int nq, int k, int splits,
                                float* out_v, int* out_i,
                                cudaStream_t stream) {
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return e;
  knn_merge_kernel<<<(nq + MERGE_THREADS - 1) / MERGE_THREADS, MERGE_THREADS,
                     0, stream>>>(s.sv, s.si, nq, k, splits, out_v, out_i);
  return cudaGetLastError();
}

// out[0..9] of a layout entry point: queries a block, candidates a tile,
// splits, stages in flight at most, rows and columns a lane, then the
// registers and local bytes a thread of the kernels k16 and k32.
template <class F16, class F32>
int layout(int* o, F16 k16, F32 k32) {
  o[0] = QB;
  o[1] = CB;
  o[2] = SPLITS;
  o[3] = RING_MAX;
  o[4] = TM;
  o[5] = TN;
  cudaFuncAttributes a16, a32;
  cudaError_t e = cudaFuncGetAttributes(&a16, k16);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&a32, k32);
  if (e != cudaSuccess) return (int)e;
  o[6] = a16.numRegs;
  o[7] = (int)a16.localSizeBytes;
  o[8] = a32.numRegs;
  o[9] = (int)a32.localSizeBytes;
  return 0;
}

// The build that serves (k, d), for both kNN kernels: launch(K, WIDE)
// is called with K and WIDE as std::integral_constant / bool_constant.
// K is the smallest register list that holds k, else K_MEM; WIDE when
// rows are wider than D_RESIDENT.  The WIDE builds come in three list
// sizes only, to keep the build short: the list size changes the time,
// never the result.
template <int K>
using ListK = std::integral_constant<int, K>;

template <class F>
cudaError_t by_shape(int k, int d, F launch) {
  using W = std::bool_constant<true>;
  using R = std::bool_constant<false>;
  if (d > D_RESIDENT) {
    if (k <= 32) return launch(ListK<32>{}, W{});
    if (k <= K_REG) return launch(ListK<K_REG>{}, W{});
    return launch(ListK<K_MEM>{}, W{});
  }
  if (k <= 16) return launch(ListK<16>{}, R{});
  if (k <= 32) return launch(ListK<32>{}, R{});
  if (k <= 64) return launch(ListK<64>{}, R{});
  if (k <= 128) return launch(ListK<128>{}, R{});
  if (k <= K_REG) return launch(ListK<K_REG>{}, R{});
  return launch(ListK<K_MEM>{}, R{});
}

// out[0..3] of a build entry point: the list size and WIDE of the build
// `kern`, then the registers and local bytes a thread it takes.
template <class F>
cudaError_t build_of(int* o, F kern, int K, bool wide) {
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, kern);
  if (e != cudaSuccess) return e;
  o[0] = K;
  o[1] = wide;
  o[2] = a.numRegs;
  o[3] = (int)a.localSizeBytes;
  return cudaSuccess;
}

}  // namespace
