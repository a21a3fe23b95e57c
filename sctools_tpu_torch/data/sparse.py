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
# pack_ell_chunks is the shard store's decode (data/shardstore.py)
from ..native import pack_ell, pack_ell_chunks  # noqa: F401


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

    def nnz_per_row(self) -> torch.Tensor:
        """(rows_padded,) int32 — stored entries per row."""
        return self.valid_mask().sum(dim=1, dtype=torch.int32)

    def to(self, device, non_blocking: bool = False) -> "SparseCells":
        """Both planes on ``device``.  ``non_blocking`` copies from
        pinned host memory run on the current CUDA stream without
        blocking the host (the prefetch worker of ``data/stream.py``
        issues them on its side stream)."""
        return SparseCells(
            self.indices.to(device, non_blocking=non_blocking),
            self.data.to(device, non_blocking=non_blocking),
            self.n_cells, self.n_genes)

    def pad_rows_to(self, rows: int) -> "SparseCells":
        """Empty rows (sentinel ids, zero values) appended up to
        ``rows``; ``self`` when it has as many already."""
        extra = rows - self.rows_padded
        if extra <= 0:
            return self
        cap = self.capacity
        ind = torch.full((extra, cap), self.sentinel,
                         dtype=self.indices.dtype, device=self.device)
        dat = torch.zeros((extra, cap), dtype=self.data.dtype,
                          device=self.device)
        return SparseCells(torch.cat([self.indices, ind]),
                           torch.cat([self.data, dat]), self.n_cells,
                           self.n_genes)

    def pin_memory(self) -> "SparseCells":
        """Page-locked host copies of both planes (the source of an
        asynchronous host-to-device copy)."""
        return SparseCells(self.indices.pin_memory(),
                           self.data.pin_memory(), self.n_cells,
                           self.n_genes)

    @classmethod
    def from_scipy_csr(cls, csr, capacity: int | None = None,
                       rows_multiple: int | None = None, dtype=None,
                       device="cpu") -> "SparseCells":
        """Pack a scipy sparse matrix into padded-ELL (on the host, by
        the native packer for float32 data, then moved to ``device``)."""
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
        indices, data = pack_ell(csr.indptr.astype(np.int64, copy=False),
                                 csr.indices.astype(np.int32, copy=False),
                                 csr.data.astype(dtype, copy=False),
                                 rows_padded, capacity, sentinel=n_genes)
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


def pack_ell_plain(indptr, col_indices, data, rows_padded, capacity,
                   sentinel):
    """CSR arrays → padded-ELL ``(indices, values)`` numpy arrays of
    shape ``(rows_padded, capacity)``, in numpy: the plain version of
    the native :func:`pack_ell`, which the tests hold to it, and its path
    for data other than float32."""
    n_rows = len(indptr) - 1
    nnz = np.diff(indptr)
    out_idx = np.full((rows_padded, capacity), sentinel, dtype=np.int32)
    out_val = np.zeros((rows_padded, capacity), dtype=data.dtype)
    rows = np.repeat(np.arange(n_rows), nnz)
    slots = np.arange(len(col_indices)) - np.repeat(indptr[:-1], nnz)
    out_idx[rows, slots] = col_indices
    out_val[rows, slots] = data
    return out_idx, out_val


def pack_ell_chunks_plain(chunks, rows_padded, capacity, sentinel):
    """The native :func:`pack_ell_chunks` in numpy, one chunk after
    another: its plain version, which the tests hold to it, and its path
    for data other than float32.  Same arguments and output."""
    dtype = (np.asarray(chunks[0][2]).dtype if chunks else np.float32)
    out_idx = np.full((rows_padded, capacity), sentinel, dtype=np.int32)
    out_val = np.zeros((rows_padded, capacity), dtype=dtype)
    for indptr, col_indices, data, row0 in chunks:
        indptr = np.asarray(indptr, np.int64)
        rows = len(indptr) - 1
        if rows and int(np.diff(indptr).max()) > capacity:
            raise ValueError(
                f"capacity={capacity} < max nnz/row="
                f"{int(np.diff(indptr).max())}; refusing to drop counts")
        idx, val = pack_ell_plain(indptr, np.asarray(col_indices, np.int32),
                                  np.asarray(data), rows, capacity,
                                  sentinel)
        out_idx[row0: row0 + rows] = idx
        out_val[row0: row0 + rows] = val
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
    summed on its own (:func:`_gene_segment_sum`, in a fixed order) and
    then added to the total, as the reference's scan does, so the
    result repeats its bits on every device."""
    dtype = dtype or x.data.dtype
    acc = torch.zeros((x.n_genes, d), dtype=dtype, device=x.device)
    for r0, ind, dat in _row_chunks(x, block):
        vals = slot_values_fn(ind, dat, r0)
        acc = acc + _gene_segment_sum(ind, vals.reshape(-1, d).to(dtype),
                                      x.n_genes)
    return acc


#: rows of a first-level segment of :func:`_gene_segment_sum` on the
#: card: no thread's sequential sum there runs longer than this many
#: slots (``segment_sweep.py``)
_SEG_ROWS = 32


def _gene_segment_sum(ind: torch.Tensor, vals: torch.Tensor,
                      n_genes: int, seg_rows: int | None = None
                      ) -> torch.Tensor:
    """Sums of ``vals`` (rows · capacity, d) by gene id ``ind`` (rows,
    capacity), in a fixed order on every device (the card's
    ``index_add_`` would add them in no fixed order): first each gene's
    slots within each block of ``seg_rows`` rows, in row order (a
    stable sort by block and id, then ``torch.segment_reduce``, whose
    sum of a segment is one sequential loop), then the blocks' sums by
    one sum over the block axis.  Empty slots go to segments of their
    own, ``seg_rows`` consecutive slots each.  ``seg_rows`` None is
    ``_SEG_ROWS`` on the card, which bounds each thread's loop, and all
    the rows on the CPU, where a gene's slots then add in row order, as
    the reference's scatter adds them there.  (n_genes, d)."""
    rows, cap = ind.shape
    if seg_rows is None:
        seg_rows = _SEG_ROWS if ind.is_cuda else rows
    n_blk = -(-rows // seg_rows)
    slot = torch.arange(rows * cap, device=ind.device,
                        dtype=torch.int32).view(rows, cap)
    key = torch.where(ind == n_genes, n_blk * n_genes + slot // seg_rows,
                      slot // (cap * seg_rows) * n_genes + ind).reshape(-1)
    key, order = torch.sort(key, stable=True)
    # segment lengths from the sorted ids, with no host sync (bincount
    # and segment_reduce's own length checks read the card)
    n_seg = n_blk * n_genes + -(-rows * cap // seg_rows)
    ends = torch.searchsorted(key, torch.arange(
        1, n_seg + 1, device=key.device, dtype=key.dtype))
    lengths = torch.diff(ends, prepend=ends.new_zeros(1))
    seg = torch.segment_reduce(vals[order], "sum", lengths=lengths, axis=0,
                               unsafe=True)
    return seg[:n_blk * n_genes].view(n_blk, n_genes, -1).sum(dim=0)


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
           block: int = 4 * _ROW_CHUNK) -> torch.Tensor:
    """``Xᵀ @ W`` for dense ``W`` (rows_padded, d) → (n_genes, d).
    Padding rows of ``W`` must be zero.  Per row chunk the stored slots
    are scattered by gene id; sentinel slots are left out before the
    scatter, where all of them would contend for the same ``d``
    addresses of one dropped row.  One host sync a chunk (the count of
    stored slots)."""
    d = w.shape[-1]
    out = torch.zeros((x.n_genes, d), dtype=w.dtype, device=x.device)
    for r0, ind, dat in _row_chunks(x, block):
        r, s = (ind != x.sentinel).nonzero(as_tuple=True)
        out.index_add_(0, ind[r, s].long(),
                       dat[r, s, None] * w[r0 + r])
    return out


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
    out1 = gene_sums_nnz(x)
    s, nnz = out1[:, 0], out1[:, 1]
    mu = s / max(n_cells, 1)
    m2 = gene_centred_sq(x, mu)
    m2 = m2 + torch.clamp(n_cells - nnz, min=0.0) * mu * mu
    return mu, m2, nnz


def _valid_of(x: SparseCells, ind, row_offset):
    return ((ind != x.sentinel)
            & (_rows_of(ind, row_offset) < x.n_cells)[:, None])


def gene_sums_nnz(x: SparseCells) -> torch.Tensor:
    """Per gene (sum, stored entries) over valid cells, (n_genes, 2):
    the first pass of :func:`gene_moments`."""

    def slot_sums(ind, dat, row_offset):
        return torch.stack([dat, _valid_of(x, ind, row_offset)
                            .to(dat.dtype)], dim=2)

    return segment_reduce(x, slot_sums, 2)


def gene_centred_sq(x: SparseCells, mu: torch.Tensor) -> torch.Tensor:
    """Per gene Σ (x − μ)² over the stored entries of valid cells: the
    second pass of :func:`gene_moments` (the zeros' ``(n − nnz)·μ²``
    is the caller's)."""
    mu_pad = torch.cat([mu, torch.zeros((1,), dtype=mu.dtype,
                                        device=mu.device)])

    def slot_sq(ind, dat, row_offset):
        dev = torch.where(_valid_of(x, ind, row_offset),
                          dat - mu_pad[ind.long()], 0.0)
        return (dev * dev)[:, :, None]

    return segment_reduce(x, slot_sq, 1)[:, 0]


# ----------------------------------------------------------------------
# Gene-major views of the stored slots.
# ----------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class GeneSlots:
    """The stored slots of a padded-ELL matrix (valid rows, gene id
    below the sentinel) in the order :func:`segment_reduce` adds them:
    per row chunk, sorted by first-level block and gene id, row order
    within.  Built once by :func:`gene_slots`, so a caller that sums
    over the same matrix many times (the logistic regression's 300
    gradients) sorts once.  Per chunk: ``rows`` (m,) int64 absolute row
    ids, ``data`` (m,) the values, ``lengths`` (n_blk · n_genes,) int64
    the sizes of the (block, gene) segments, and ``n_blk``."""

    chunks: tuple
    n_genes: int


def gene_slots(x: SparseCells, block: int = _ROW_CHUNK,
               seg_rows: int | None = None) -> GeneSlots:
    """:class:`GeneSlots` of ``x``: the sort of :func:`_gene_segment_sum`
    for each chunk of ``block`` rows, with the empty slots (and padding
    rows) left out.  ``seg_rows`` as there.  One host sync a chunk (its
    count of stored slots)."""
    chunks = []
    for r0, ind, dat in _row_chunks(x, block):
        rows, cap = ind.shape
        sr = seg_rows or (_SEG_ROWS if ind.is_cuda else rows)
        n_blk = -(-rows // sr)
        n_seg = n_blk * x.n_genes
        slot = torch.arange(rows * cap, device=ind.device,
                            dtype=torch.int64).view(rows, cap)
        valid = _valid_of(x, ind, r0)
        key = torch.where(valid, slot // (cap * sr) * x.n_genes + ind,
                          n_seg).reshape(-1)
        key, order = torch.sort(key, stable=True)
        ends = torch.searchsorted(key, torch.arange(
            1, n_seg + 1, device=key.device, dtype=key.dtype))
        lengths = torch.diff(ends, prepend=ends.new_zeros(1))
        m = int(ends[-1]) if n_seg else 0
        order = order[:m]
        chunks.append((r0 + order // cap, dat.reshape(-1)[order], lengths,
                       n_blk))
    return GeneSlots(tuple(chunks), x.n_genes)


def gene_slots_sum(slots: GeneSlots, values_fn, d: int) -> torch.Tensor:
    """Per-gene sums of ``values_fn(rows, data) -> (m, d)`` over the
    stored slots, (n_genes, d): the bits :func:`segment_reduce` gives
    for the same slot values (empty slots adding nothing)."""
    acc = None
    for rows, dat, lengths, n_blk in slots.chunks:
        vals = values_fn(rows, dat)
        if acc is None:
            acc = torch.zeros((slots.n_genes, d), dtype=vals.dtype,
                              device=vals.device)
        if rows.numel() == 0:
            continue
        seg = torch.segment_reduce(vals, "sum", lengths=lengths, axis=0,
                                   unsafe=True)
        acc = acc + seg.view(n_blk, slots.n_genes, d).sum(dim=0)
    return acc


def dense_gene_block(x: SparseCells, lo: int, width: int) -> torch.Tensor:
    """Gene columns ``[lo, lo + width)`` of ``x`` densified, (n_cells,
    width), without the full matrix: the stored slots in range are
    found and written to their cells (each (cell, gene) once, so the
    result does not depend on the order of the writes)."""
    n = x.n_cells
    shifted = x.indices[:n] - lo
    r, s = ((shifted >= 0) & (shifted < width)
            & (x.indices[:n] != x.sentinel)).nonzero(as_tuple=True)
    out = torch.zeros((n, width), dtype=x.data.dtype, device=x.device)
    out.index_put_((r, shifted[r, s].long()), x.data[r, s],
                   accumulate=True)
    return out
