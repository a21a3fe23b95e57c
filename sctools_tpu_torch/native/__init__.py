"""The port's native host loops (``csrc/scio.cpp``, built at first use by
``host_build.py``), with the Python contracts of
``sctools_tpu/native/__init__.py``:

* ``pack_ell`` — CSR → padded-ELL, float32 data natively, other dtypes
  through numpy (``data/sparse.py:pack_ell_plain``);
* ``pack_ell_chunks`` — the shard store's decode of one shard's CSR
  chunks, one thread a chunk.

Both run on as many threads as the cores the process may use.  The
reference's ``parse_mtx`` is not bound: ``read_10x_mtx`` reads every
``matrix.mtx`` with ``scipy.io.mmread``, which is faster.

There is no numpy fallback when the library cannot be built: the call
raises with the compiler's output.  The inputs are checked here before a
pointer reaches C (row pointers in range and non-decreasing, rows within
``rows_padded``, no row over ``capacity``, chunks disjoint).
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from ..host_build import library

_P64 = ctypes.POINTER(ctypes.c_int64)
_P32 = ctypes.POINTER(ctypes.c_int32)
_PF = ctypes.POINTER(ctypes.c_float)


def have_native() -> bool:
    """The reference's ``have_native`` kept for its contract: True once
    the host library is built and loaded.  The port has no fallback to
    choose, so this either returns True or raises with the build's
    error."""
    return library() is not None


def _threads() -> int:
    return len(os.sched_getaffinity(0))


def _check_csr(indptr: np.ndarray, n_idx: int, n_val: int,
               capacity: int) -> None:
    if len(indptr) == 0:
        raise ValueError("indptr is empty (a CSR of n rows has n + 1)")
    nnz = np.diff(indptr)
    if indptr[0] < 0 or (len(nnz) and nnz.min() < 0):
        raise ValueError("indptr must be non-negative and non-decreasing")
    if indptr[-1] > min(n_idx, n_val):
        raise ValueError(
            f"indptr ends at {indptr[-1]} past the {min(n_idx, n_val)} "
            "stored entries")
    if len(nnz) and nnz.max() > capacity:
        raise ValueError(
            f"capacity={capacity} < max nnz/row={int(nnz.max())}; refusing "
            "to drop counts")


def _planes(rows_padded: int, capacity: int, sentinel: int):
    return (np.full((rows_padded, capacity), sentinel, dtype=np.int32),
            np.zeros((rows_padded, capacity), dtype=np.float32))


def pack_ell(indptr, col_indices, data, rows_padded, capacity, sentinel):
    """CSR arrays → padded-ELL ``(indices, values)`` numpy arrays of shape
    ``(rows_padded, capacity)``: row r's entries in its leading slots,
    the rest ``sentinel`` and 0."""
    data = np.asarray(data)
    if data.dtype != np.float32:
        from ..data.sparse import pack_ell_plain

        return pack_ell_plain(indptr, col_indices, data, rows_padded,
                              capacity, sentinel)
    indptr = np.ascontiguousarray(indptr, dtype=np.int64)
    col_indices = np.ascontiguousarray(col_indices, dtype=np.int32)
    data = np.ascontiguousarray(data)
    n_rows = len(indptr) - 1
    if n_rows > rows_padded:
        raise ValueError(f"{n_rows} rows do not fit rows_padded="
                         f"{rows_padded}")
    _check_csr(indptr, len(col_indices), len(data), capacity)
    out_idx, out_val = _planes(rows_padded, capacity, sentinel)
    library().scio_pack_ell_f32(
        indptr.ctypes.data_as(_P64), col_indices.ctypes.data_as(_P32),
        data.ctypes.data_as(_PF), n_rows, rows_padded, capacity, sentinel,
        out_idx.ctypes.data_as(_P32), out_val.ctypes.data_as(_PF),
        _threads())
    return out_idx, out_val


def pack_ell_chunks(chunks, rows_padded, capacity, sentinel):
    """Decode several CSR chunks (disjoint row ranges of one shard) into
    one padded-ELL buffer — the shard store's read path.  ``chunks`` is a
    list of ``(indptr, col_indices, data, row_offset)``; chunk rows land
    at ``out[row_offset : row_offset + rows]``.  float32 chunks decode on
    one thread a chunk, others through numpy
    (``data/sparse.py:pack_ell_chunks_plain``).  Returns numpy
    ``(indices, values)`` of shape ``(rows_padded, capacity)``."""
    if not all(np.asarray(c[2]).dtype == np.float32 for c in chunks):
        from ..data.sparse import pack_ell_chunks_plain

        return pack_ell_chunks_plain(chunks, rows_padded, capacity,
                                     sentinel)
    out_idx, out_val = _planes(rows_padded, capacity, sentinel)
    n = len(chunks)
    if n == 0:
        return out_idx, out_val
    # the contiguous arrays must outlive the C call: these lists hold them
    indptrs = [np.ascontiguousarray(c[0], np.int64) for c in chunks]
    colids = [np.ascontiguousarray(c[1], np.int32) for c in chunks]
    datas = [np.ascontiguousarray(c[2], np.float32) for c in chunks]
    rows = np.asarray([len(p) - 1 for p in indptrs], np.int64)
    offs = np.asarray([c[3] for c in chunks], np.int64)
    for p, ci, d in zip(indptrs, colids, datas):
        _check_csr(p, len(ci), len(d), capacity)
    spans = sorted(zip(offs.tolist(), (offs + rows).tolist()))
    if spans[0][0] < 0 or spans[-1][1] > rows_padded or any(
            b[0] < a[1] for a, b in zip(spans, spans[1:])):
        raise ValueError(
            f"chunk row ranges {spans} overlap or leave [0, {rows_padded})")
    lib = library()
    lib.scio_pack_ell_f32_chunks(
        (_P64 * n)(*[a.ctypes.data_as(_P64) for a in indptrs]),
        (_P32 * n)(*[a.ctypes.data_as(_P32) for a in colids]),
        (_PF * n)(*[a.ctypes.data_as(_PF) for a in datas]),
        rows.ctypes.data_as(_P64), offs.ctypes.data_as(_P64), n, capacity,
        out_idx.ctypes.data_as(_P32), out_val.ctypes.data_as(_PF),
        _threads())
    return out_idx, out_val

