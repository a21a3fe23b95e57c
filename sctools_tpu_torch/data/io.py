"""Host IO: the in-memory entry points, and the streamed path's
shard-store chunk files and h5ad shard reader.

Counterparts of ``from_scipy``, ``from_dense``, ``write_csr_chunk``,
``read_csr_chunk`` and ``shard_iter`` in ``sctools_tpu/data/io.py``,
with the same files.
``h5py`` is imported inside ``shard_iter``: the h5ad reader is the
only part of the port that needs it.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np

from ..config import config, round_up
from ..utils.checkpoint import (_read_arrays, load_npz_verified,
                                save_npz_verified)
from .dataset import CellData
from .sparse import SparseCells


def from_scipy(X, obs=None, var=None, **kw) -> CellData:
    """A host ``CellData`` over a scipy sparse matrix (as CSR)."""
    return CellData(X.tocsr(), obs=obs or {}, var=var or {}, **kw)


def from_dense(X, obs=None, var=None, **kw) -> CellData:
    """A host ``CellData`` over a dense array."""
    return CellData(np.asarray(X), obs=obs or {}, var=var or {}, **kw)


def write_csr_chunk(path: str, data, indices, indptr, shape,
                    fingerprint: str | None = None) -> str:
    """Write one shard-store chunk: a CSR row slice as a checksummed
    ``.npz`` (content digest, schema, identity ``fingerprint``), atomic
    by rename.  Returns the content digest, which the store's manifest
    records."""
    arrays = {
        "data": np.ascontiguousarray(data),
        "indices": np.ascontiguousarray(indices, np.int32),
        "indptr": np.ascontiguousarray(indptr, np.int64),
        "shape": np.asarray(shape, np.int64),
    }
    return save_npz_verified(path, fingerprint=fingerprint, **arrays)


def read_csr_chunk(path: str, expect_fingerprint: str | None = None,
                   expect_digest: str | None = None,
                   verify: bool = True) -> tuple:
    """Read (and with ``verify``, re-hash and check) a chunk written by
    :func:`write_csr_chunk`.  Returns ``(data, indices, indptr,
    shape)``.  Unreadable bytes, a digest, schema or fingerprint
    mismatch, missing integrity keys or a digest other than
    ``expect_digest`` raise ``CheckpointCorruptError`` with its
    ``.reason``."""
    if verify:
        arrays = load_npz_verified(
            path, expect_fingerprint=expect_fingerprint,
            require_digest=True, expect_digest=expect_digest)
    else:
        arrays = _read_arrays(path)
    return (arrays["data"], arrays["indices"], arrays["indptr"],
            tuple(int(x) for x in arrays["shape"]))


def shard_iter(path: str, shard_rows: int, capacity: int | None = None,
               start_row: int = 0) -> Iterator[SparseCells]:
    """Stream the X of an h5ad file as host padded-ELL shards of
    ``shard_rows`` cells without loading the whole matrix.  Every shard
    shares one ``capacity`` (without one: twice the first shard's max
    nnz per row; a later row over it raises).  ``start_row`` (a
    ``shard_rows`` multiple) seeks straight to that shard."""
    import h5py
    import scipy.sparse as sp

    if start_row % shard_rows:
        raise ValueError(
            f"start_row={start_row} must be a multiple of "
            f"shard_rows={shard_rows}")

    def pack(sub):
        nonlocal capacity
        if capacity is None:
            nnz_max = int(np.diff(sub.indptr).max()) if sub.shape[0] else 1
            capacity = round_up(max(nnz_max * 2, 1),
                                config.capacity_multiple)
        return SparseCells.from_scipy_csr(sub, capacity=capacity)

    with h5py.File(path, "r") as h5:
        node = h5["X"]
        if isinstance(node, h5py.Dataset):
            n = node.shape[0]
            for s in range(start_row, n, shard_rows):
                yield pack(sp.csr_matrix(node[s: min(n, s + shard_rows)]))
            return
        enc = node.attrs.get("encoding-type", b"csr_matrix")
        enc = enc.decode() if isinstance(enc, bytes) else enc
        if not str(enc).startswith("csr"):
            raise NotImplementedError(
                f"shard_iter requires CSR-encoded X, got {enc!r}")
        indptr = node["indptr"][...]
        shape = tuple(node.attrs["shape"])
        n = shape[0]
        for s in range(start_row, n, shard_rows):
            e = min(n, s + shard_rows)
            lo, hi = indptr[s], indptr[e]
            yield pack(sp.csr_matrix(
                (node["data"][lo:hi], node["indices"][lo:hi],
                 indptr[s: e + 1] - lo), shape=(e - s, shape[1])))
