"""Padded-ELL sparse count matrices as torch tensors.

The layout of ``sctools_tpu/data/sparse.py``, kept as it is so that the
two packages reduce in the same order:

    indices : (rows_padded, capacity) int32  — gene ids, row-major
    data    : (rows_padded, capacity) float32 — counts

Each cell's nonzeros occupy the leading slots of its row; the rest of
the row is padding (``index == n_genes`` sentinel, ``value == 0``).
``capacity`` is the max nnz per row rounded up to 128 and
``rows_padded`` rounds up to 8.  A gather from a ``(n_genes + 1, d)``
table whose last row is zero annihilates padding, and a segment sum
into ``n_genes + 1`` bins drops it in the last bin.

Everything that expands the slot array by a feature dimension ``d`` is
chunked over ``_ROW_CHUNK`` rows: the ``(rows, capacity, d)`` gather at
68k cells × ~2.8k slots × 60 columns would be ~46 GB.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import config, round_up, true_f32


@dataclasses.dataclass(frozen=True)
class SparseCells:
    """Padded-ELL sparse matrix of shape ``(n_cells, n_genes)``."""

    indices: torch.Tensor  # (rows_padded, capacity) int32
    data: torch.Tensor  # (rows_padded, capacity) float32
    n_cells: int
    n_genes: int

    @property
    def shape(self):
        return (self.n_cells, self.n_genes)

    @property
    def rows_padded(self) -> int:
        return self.indices.shape[0]

    @property
    def capacity(self) -> int:
        return self.indices.shape[1]

    @property
    def sentinel(self) -> int:
        return self.n_genes

    @property
    def device(self) -> torch.device:
        return self.data.device

    def valid_mask(self) -> torch.Tensor:
        """(rows_padded, capacity) bool — True at real nonzero slots."""
        return self.indices != self.n_genes

    def row_mask(self) -> torch.Tensor:
        """(rows_padded,) bool — True for real (non-padding) cells."""
        return torch.arange(self.rows_padded, device=self.device) < self.n_cells

    def with_data(self, data: torch.Tensor) -> "SparseCells":
        """Same sparsity pattern, new values."""
        return SparseCells(self.indices, data, self.n_cells, self.n_genes)

    def to(self, device) -> "SparseCells":
        return SparseCells(self.indices.to(device), self.data.to(device),
                           self.n_cells, self.n_genes)

    @classmethod
    def from_scipy_csr(cls, csr, capacity: int | None = None,
                       rows_multiple: int | None = None, dtype=None,
                       device="cpu") -> "SparseCells":
        """Pack a scipy sparse matrix into padded-ELL (on the host, then
        moved to ``device``)."""
        import scipy.sparse as sp

        if not sp.issparse(csr):
            raise TypeError(f"expected scipy sparse matrix, got {type(csr)}")
        csr = csr.tocsr()
        csr.sort_indices()
        n_cells, n_genes = csr.shape
        dtype = dtype or np.float32
        nnz = np.diff(csr.indptr)
        max_nnz = int(nnz.max()) if len(nnz) else 0
        if capacity is None:
            capacity = max(round_up(max(max_nnz, 1), config.capacity_multiple),
                           config.capacity_multiple)
        elif max_nnz > capacity:
            raise ValueError(
                f"capacity={capacity} < max nnz/row={max_nnz}; refusing "
                "to drop counts")
        rows_padded = round_up(max(n_cells, 1),
                               rows_multiple or config.sublane)
        indices, data = pack_ell(csr.indptr.astype(np.int64),
                                 csr.indices.astype(np.int32),
                                 csr.data.astype(dtype), rows_padded,
                                 capacity, sentinel=n_genes)
        return cls(torch.from_numpy(indices).to(device),
                   torch.from_numpy(data).to(device), n_cells, n_genes)

    def to_scipy_csr(self):
        import scipy.sparse as sp

        ind = self.indices.cpu().numpy()
        dat = self.data.cpu().numpy()
        mask = ind != self.n_genes
        nnz = mask.sum(axis=1)[: self.n_cells]
        indptr = np.zeros(self.n_cells + 1, dtype=np.int64)
        np.cumsum(nnz, out=indptr[1:])
        rows = np.repeat(np.arange(self.rows_padded), mask.sum(axis=1))
        keep = rows < self.n_cells
        return sp.csr_matrix((dat[mask][keep], ind[mask][keep], indptr),
                             shape=(self.n_cells, self.n_genes))

    def to_dense(self) -> torch.Tensor:
        """Densify (small matrices / tests only)."""
        table = torch.zeros((self.rows_padded, self.n_genes + 1),
                            dtype=self.data.dtype, device=self.device)
        table.scatter_add_(1, self.indices.long(), self.data)
        return table[: self.n_cells, : self.n_genes]

    def __repr__(self):
        return (f"SparseCells(shape=({self.n_cells}, {self.n_genes}), "
                f"padded={self.rows_padded}x{self.capacity}, "
                f"dtype={self.data.dtype}, device={self.device})")


def gather_rows_sparse(x: SparseCells, idx) -> SparseCells:
    """Row subset of a padded-ELL matrix on its device: new row i is old
    row ``idx[i]`` (ids in ``[0, n_cells)``).  ``rows_padded`` rounds
    the new count up to ``config.sublane``; the padding rows are empty
    (sentinel id, value 0).  Counterpart of the ``SparseCells`` branch
    of ``sctools_tpu/ops/qc.py:_gather_rows_matrix``."""
    idx = torch.as_tensor(np.asarray(idx, np.int64), device=x.device)
    n_new = idx.shape[0]
    rows_padded = round_up(max(n_new, 1), config.sublane)
    gidx = torch.cat([idx, torch.full((rows_padded - n_new,),
                                      x.rows_padded - 1, dtype=torch.int64,
                                      device=x.device)])
    ind = x.indices.index_select(0, gidx)
    dat = x.data.index_select(0, gidx)
    if rows_padded > n_new:  # the padding rows hold no entries
        ind[n_new:] = x.sentinel
        dat[n_new:] = 0.0
    return SparseCells(ind, dat, n_new, x.n_genes)


def pack_ell(indptr, col_indices, data, rows_padded, capacity, sentinel):
    """CSR arrays → padded-ELL ``(indices, values)`` numpy arrays of
    shape ``(rows_padded, capacity)``."""
    n_rows = len(indptr) - 1
    nnz = np.diff(indptr)
    out_idx = np.full((rows_padded, capacity), sentinel, dtype=np.int32)
    out_val = np.zeros((rows_padded, capacity), dtype=data.dtype)
    rows = np.repeat(np.arange(n_rows), nnz)
    slots = np.arange(len(col_indices)) - np.repeat(indptr[:-1], nnz)
    out_idx[rows, slots] = col_indices
    out_val[rows, slots] = data
    return out_idx, out_val


# ----------------------------------------------------------------------
# Sparse linear algebra over row chunks.
# ----------------------------------------------------------------------

_ROW_CHUNK = 2048


def _row_chunks(x: SparseCells, block: int):
    """``(row_offset, indices, data)`` per chunk of ``block`` rows."""
    for r0 in range(0, x.rows_padded, block):
        yield r0, x.indices[r0:r0 + block], x.data[r0:r0 + block]


def segment_reduce(x: SparseCells, slot_values_fn, d: int, dtype=None,
                   block: int = _ROW_CHUNK) -> torch.Tensor:
    """Gene-axis reduction: accumulates the segment sum by gene id of
    ``slot_values_fn(ind_blk, dat_blk, row_offset) -> (rows, capacity,
    d)`` over row chunks into a ``(n_genes, d)`` result.  Each chunk is
    summed on its own and then added to the total, as the reference's
    scan does."""
    dtype = dtype or x.data.dtype
    G1 = x.n_genes + 1
    acc = torch.zeros((G1, d), dtype=dtype, device=x.device)
    for r0, ind, dat in _row_chunks(x, block):
        vals = slot_values_fn(ind, dat, r0)
        part = torch.zeros((G1, d), dtype=dtype, device=x.device)
        part.index_add_(0, ind.reshape(-1), vals.reshape(-1, d))
        acc = acc + part
    return acc[: x.n_genes]


def _rows_of(ind: torch.Tensor, row_offset: int) -> torch.Tensor:
    return row_offset + torch.arange(ind.shape[0], device=ind.device)


def spmm(x: SparseCells, v: torch.Tensor,
         block: int = _ROW_CHUNK) -> torch.Tensor:
    """``X @ V`` for padded-ELL ``X`` and dense ``V`` (n_genes, d) →
    (rows_padded, d) float32.  Per row chunk: gather the rows of ``V``
    (padded with a zero row, so sentinel slots vanish) and contract the
    slots.  The inputs follow ``config.matmul_dtype``: bf16-rounded
    under the bf16 policy, true f32 otherwise; the contraction is f32."""
    mm = config.matmul_torch_dtype()
    d = v.shape[1]
    vp = torch.cat([v, torch.zeros((1, d), dtype=v.dtype, device=v.device)])
    vp = vp.to(mm).float()
    out = torch.empty((x.rows_padded, d), dtype=torch.float32,
                      device=x.device)
    with true_f32():
        for r0, ind, dat in _row_chunks(x, block):
            g = vp.index_select(0, ind.reshape(-1)).reshape(*ind.shape, d)
            out[r0:r0 + ind.shape[0]] = torch.einsum(
                "rc,rcd->rd", dat.to(mm).float(), g)
    return out


def spmm_t(x: SparseCells, w: torch.Tensor,
           block: int = _ROW_CHUNK) -> torch.Tensor:
    """``Xᵀ @ W`` for dense ``W`` (rows_padded, d) → (n_genes, d).
    Padding rows of ``W`` must be zero.  Chunked segment sum; the
    sentinel bin is dropped."""

    def slot_vals(ind, dat, row_offset):
        wblk = w[row_offset:row_offset + ind.shape[0]]
        return dat[:, :, None] * wblk[:, None, :]

    return segment_reduce(x, slot_vals, w.shape[-1], dtype=w.dtype,
                          block=block)


def row_sum(x: SparseCells) -> torch.Tensor:
    """Per-cell total counts, (rows_padded,)."""
    return x.data.sum(dim=1)


def gene_sum(x: SparseCells) -> torch.Tensor:
    """Per-gene total counts, (n_genes,)."""
    return gene_stats(x)[0]


def gene_stats(x: SparseCells):
    """Per-gene (sum, sum of squares, nnz count) over valid cells, in
    one chunked pass.  For variances use :func:`gene_moments`: ``ss −
    n·mean²`` in f32 cancels when ``mean² ≫ var``."""

    def slot_vals(ind, dat, row_offset):
        valid = ((ind != x.sentinel)
                 & (_rows_of(ind, row_offset) < x.n_cells)[:, None])
        return torch.stack([dat, dat * dat, valid.to(dat.dtype)], dim=2)

    out = segment_reduce(x, slot_vals, 3)
    return out[:, 0], out[:, 1], out[:, 2]


def gene_moments(x: SparseCells):
    """Per-gene (mean, centred second moment Σ(x−μ)², nnz) over valid
    cells, cancellation-free: pass 1 gets sums and nnz; pass 2, seeded
    with the means, sums the non-negative ``(x−μ)²`` of stored entries
    and adds the zeros' ``(n−nnz)·μ²``."""
    n_cells = x.n_cells

    def valid_of(ind, row_offset):
        return ((ind != x.sentinel)
                & (_rows_of(ind, row_offset) < n_cells)[:, None])

    def slot_sums(ind, dat, row_offset):
        return torch.stack([dat, valid_of(ind, row_offset).to(dat.dtype)],
                           dim=2)

    out1 = segment_reduce(x, slot_sums, 2)
    s, nnz = out1[:, 0], out1[:, 1]
    mu = s / max(n_cells, 1)
    mu_pad = torch.cat([mu, torch.zeros((1,), dtype=mu.dtype,
                                        device=mu.device)])

    def slot_sq(ind, dat, row_offset):
        dev = torch.where(valid_of(ind, row_offset),
                          dat - mu_pad[ind.long()], 0.0)
        return (dev * dev)[:, :, None]

    m2 = segment_reduce(x, slot_sq, 1)[:, 0]
    m2 = m2 + torch.clamp(n_cells - nnz, min=0.0) * mu * mu
    return mu, m2, nnz
