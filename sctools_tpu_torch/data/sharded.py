"""Cell-sharded arrays: rows cut into equal blocks, one on each device
of a mesh.

The reference places a cell-sharded array with a ``NamedSharding`` over
its mesh's cell axis and lets GSPMD insert the collectives.  torch has
no such array, so the port holds the blocks itself: a
:class:`ShardedRows` is P row blocks of one shape, block d on
``mesh.devices[d]``, and the code that runs on it runs each block on its
own device and combines per-gene partials with
``parallel.mesh.reduce_sum`` (the counterpart of ``psum``).

A block is a :class:`~.sparse.SparseCells` (a padded-ELL X; its
``n_cells`` counts the valid rows of that block, so every row mask of
the single-device code holds inside a block) or a tensor (a dense X, a
per-cell column, a per-cell matrix such as ``X_pca``).  Rows past
``n_cells`` are padding: empty ELL rows, zero dense rows.

``pieces`` lists, when the blocks do not hold the rows in order, the
``(block, start, stop)`` slices that make the rows in order: a streamed
source cut across a mesh puts block d of every shard on device d.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from .sparse import SparseCells


@dataclasses.dataclass(frozen=True)
class ShardedRows:
    """P row blocks of one width, block d on ``mesh.devices[d]``; the
    first ``n_cells`` rows of the order ``pieces`` gives (the blocks in
    turn when it is None) are valid."""

    blocks: tuple
    mesh: Any
    n_cells: int
    pieces: tuple | None = None

    @property
    def sparse(self) -> bool:
        return isinstance(self.blocks[0], SparseCells)

    @property
    def n_genes(self) -> int:
        b = self.blocks[0]
        return b.n_genes if isinstance(b, SparseCells) else b.shape[1]

    @property
    def block_rows(self) -> int:
        b = self.blocks[0]
        return b.rows_padded if isinstance(b, SparseCells) else b.shape[0]

    @property
    def rows_padded(self) -> int:
        return self.block_rows * len(self.blocks)

    @property
    def capacity(self) -> int:
        return self.blocks[0].capacity

    @property
    def device(self) -> torch.device:
        """The first block's device, where per-gene results are held."""
        return torch.device(self.mesh.devices[0])

    def valid_rows(self, d: int) -> int:
        """Valid rows of block ``d`` (blocks in row order)."""
        m = self.block_rows
        return max(0, min(m, self.n_cells - d * m))

    def map_blocks(self, fn) -> "ShardedRows":
        """``fn(block, d)`` for every block: a new ShardedRows of the
        same rows (``fn`` is row-local and keeps the block's device)."""
        return dataclasses.replace(
            self, blocks=tuple(fn(b, d) for d, b in enumerate(self.blocks)))

    def gather(self, device=None):
        """The rows in order, concatenated on ``device`` (the first
        block's by default): a ``SparseCells`` of ``n_cells`` cells, or
        a tensor with the padding rows of the blocks (the valid rows
        only, when ``pieces`` orders them)."""
        device = self.device if device is None else torch.device(device)
        if self.pieces is None:
            parts = list(self.blocks)
        else:
            parts = [_rows(self.blocks[d], a, b) for d, a, b in self.pieces]
        if isinstance(parts[0], SparseCells):
            return SparseCells(
                torch.cat([p.indices.to(device) for p in parts]),
                torch.cat([p.data.to(device) for p in parts]),
                self.n_cells, parts[0].n_genes)
        return torch.cat([p.to(device) for p in parts])

    def __repr__(self):
        kind = "SparseCells" if self.sparse else "tensor"
        return (f"ShardedRows({len(self.blocks)} {kind} blocks of "
                f"{self.block_rows} rows, n_cells={self.n_cells}, "
                f"devices={[str(d) for d in self.mesh.devices]})")


def _rows(block, a: int, b: int):
    if isinstance(block, SparseCells):
        return SparseCells(block.indices[a:b], block.data[a:b], b - a,
                           block.n_genes)
    return block[a:b]


def reduce_sum(parts: list, device) -> torch.Tensor:
    """The per-device partials ``parts`` (one a block, in mesh order)
    added in that order on ``device``: the fixed-order counterpart of
    GSPMD's ``psum``.  With partials that repeat their bits (the
    fixed-order gene sums of ``sparse.segment_reduce``) the sum repeats
    them too.  One part comes back as it is (moved to ``device``)."""
    device = torch.device(device)
    acc = parts[0].to(device)
    for p in parts[1:]:
        acc = acc + p.to(device)
    return acc


def valid_blocks(x) -> list:
    """The row blocks of ``x``, a ShardedRows or one matrix (then its
    only block): dense blocks cut to their valid rows (views), a
    ``SparseCells`` block as it is (it masks its padding rows
    itself)."""
    if not isinstance(x, ShardedRows):
        return [x]
    if x.sparse:
        return list(x.blocks)
    return [b[:x.valid_rows(d)] for d, b in enumerate(x.blocks)]


def is_sharded(data) -> bool:
    """Whether ``data`` (a CellData or an array) is cell-sharded."""
    return isinstance(getattr(data, "X", data), ShardedRows)


def split_blocks(x, mesh, n_cells: int | None = None) -> ShardedRows:
    """``x`` (a ``SparseCells`` or a tensor of rows) cut into
    ``mesh.size`` equal row blocks, block d moved to ``mesh.devices[d]``
    (a view, with no copy, where ``x`` already lies there).  The row
    count must divide: pad it first.  ``n_cells`` defaults to
    ``x.n_cells`` (a sparse ``x``) or its row count."""
    p = mesh.size
    sparse = isinstance(x, SparseCells)
    rows = x.rows_padded if sparse else x.shape[0]
    if rows % p:
        raise ValueError(f"{rows} rows do not divide over {p} devices; "
                         "pad rows first")
    if n_cells is None:
        n_cells = x.n_cells if sparse else rows
    m = rows // p
    blocks = []
    for d, dev in enumerate(mesh.devices):
        a, b = d * m, (d + 1) * m
        if sparse:
            valid = max(0, min(m, n_cells - a))
            blocks.append(SparseCells(x.indices[a:b].to(dev),
                                      x.data[a:b].to(dev), valid,
                                      x.n_genes))
        else:
            blocks.append(x[a:b].to(dev))
    return ShardedRows(tuple(blocks), mesh, n_cells)
