// Host packing loops of the port (sctools_tpu_torch/native): CSR ->
// padded-ELL, the layout of SparseCells (sctools_tpu_torch/data/sparse.py),
// for one matrix and for the chunks of one shard-store shard.  Plain C
// symbols, bound with ctypes.  The caller passes the thread count (the
// cores the process may run on).
//
// Built at first use by sctools_tpu_torch/host_build.py
// ($CXX -O3 -fPIC -std=c++17 -pthread -shared) into
// sctools_tpu_torch/_build/libscio_<hash>.so.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// Row-range worker: rows are disjoint, so threads never touch the
// same output bytes (each row owns its capacity-strided slice).
void pack_rows(const int64_t* indptr, const int32_t* indices,
               const float* data, int64_t capacity, int32_t* out_idx,
               float* out_val, int64_t r0, int64_t r1) {
  for (int64_t r = r0; r < r1; ++r) {
    const int64_t lo = indptr[r], hi = indptr[r + 1];
    // Clamp to capacity: the Python layer refuses an oversized row up
    // front; this keeps one from overwriting its neighbours all the same.
    const int64_t n = hi - lo > capacity ? capacity : hi - lo;
    int32_t* oi = out_idx + r * capacity;
    float* ov = out_val + r * capacity;
    std::memcpy(oi, indices + lo, sizeof(int32_t) * n);
    std::memcpy(ov, data + lo, sizeof(float) * n);
  }
}

}  // namespace

extern "C" {

// CSR -> padded-ELL.  out_idx must be pre-filled with the sentinel,
// out_val with zeros (the caller allocates; only occupied slots are
// written).  Threaded over disjoint row ranges, n_threads of them
// (ctypes releases the GIL around the call).
void scio_pack_ell_f32(const int64_t* indptr, const int32_t* indices,
                       const float* data, int64_t n_rows,
                       int64_t rows_padded, int64_t capacity,
                       int32_t sentinel, int32_t* out_idx,
                       float* out_val, int64_t n_threads) {
  (void)rows_padded;
  (void)sentinel;
  // Below ~32k rows the memcpy loop finishes in well under a
  // millisecond: starting threads would dominate.
  if (n_threads <= 1 || n_rows < 32768) {
    pack_rows(indptr, indices, data, capacity, out_idx, out_val, 0, n_rows);
    return;
  }
  std::vector<std::thread> workers;
  const int64_t step = (n_rows + n_threads - 1) / n_threads;
  for (int64_t t = 1; t < n_threads; ++t) {
    const int64_t r0 = t * step;
    const int64_t r1 = std::min(n_rows, r0 + step);
    if (r0 >= r1) break;
    workers.emplace_back(pack_rows, indptr, indices, data, capacity,
                         out_idx, out_val, r0, r1);
  }
  pack_rows(indptr, indices, data, capacity, out_idx, out_val, 0,
            std::min(n_rows, step));
  for (auto& w : workers) w.join();
}

// The shard store's decode (sctools_tpu_torch/data/shardstore.py): one
// stored shard is n_chunks CSR chunk files owning disjoint row ranges of
// the same padded-ELL output, one thread a chunk.  indptrs / indices /
// datas are per-chunk arrays of pointers; chunk_rows[c] rows of chunk c
// land at output row row_offsets[c].  The caller pre-fills the outputs
// as for scio_pack_ell_f32; at most n_threads threads decode.
void scio_pack_ell_f32_chunks(const int64_t* const* indptrs,
                              const int32_t* const* indices,
                              const float* const* datas,
                              const int64_t* chunk_rows,
                              const int64_t* row_offsets,
                              int64_t n_chunks, int64_t capacity,
                              int32_t* out_idx, float* out_val,
                              int64_t n_threads) {
  auto decode_one = [&](int64_t c) {
    pack_rows(indptrs[c], indices[c], datas[c], capacity,
              out_idx + row_offsets[c] * capacity,
              out_val + row_offsets[c] * capacity, 0, chunk_rows[c]);
  };
  if (n_threads <= 1 || n_chunks <= 1) {
    for (int64_t c = 0; c < n_chunks; ++c) decode_one(c);
    return;
  }
  const int64_t t_n = std::min<int64_t>(n_threads, n_chunks);
  std::vector<std::thread> workers;
  for (int64_t t = 1; t < t_n; ++t) {
    workers.emplace_back([&decode_one, t, t_n, n_chunks]() {
      for (int64_t c = t; c < n_chunks; c += t_n) decode_one(c);
    });
  }
  for (int64_t c = 0; c < n_chunks; c += t_n) decode_one(c);
  for (auto& w : workers) w.join();
}

}  // extern "C"
