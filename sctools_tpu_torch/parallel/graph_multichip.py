"""Multi-device edge-list graph products: ``knn_matvec_sharded``,
``smooth_layers_sharded`` and ``diffuse_sharded``.

Counterpart of ``sctools_tpu/parallel/graph_multichip.py``.  ``P @ x``
with P the padded (n, k) edge list (``ops/graph.py`` ``knn_matvec``),
rows cut into equal shards over a :class:`~.mesh.Mesh`.  Edge ids are
global row ids.  Each shard's local product is ``graph_matvec``: the
hand kernel on the card, its plain version on the CPU.  Two strategies:

* ``"all_gather"``: each shard gathers the whole ``x`` and multiplies
  its edges against it, one ``graph_matvec`` a shard (the kernel takes
  an ``x`` of other than n rows);
* ``"ring"``: the shards of ``x`` circulate (``mesh.ring``); at step s
  shard i holds the chunk that started on shard ``(i − s) mod P``, and
  multiplies its edges remapped to that chunk's rows (ids outside it
  become -1, which weigh nothing), adding the P products in step order.

Rows must divide over the mesh: ``pad_rows_for_mesh`` pads them (-1
edges, zero weights, zero rows).  The result is the whole (rows, d)
product on ``mesh.devices[0]``.
"""

from __future__ import annotations

import torch

from ..ops.graph_kernels import matvec
from .mesh import CELL_AXIS, all_gather, pad_rows, ring, split_rows

STRATEGIES = ("all_gather", "ring")


def require_cell_axis(mesh, who: str, axis: str = CELL_AXIS) -> int:
    """The device count of ``mesh``'s ``axis``; raises a ValueError
    naming ``who`` when the mesh has no such axis."""
    if axis not in mesh.shape:
        raise ValueError(
            f"{who}: mesh has axes {tuple(mesh.shape)}; expected a "
            f"{axis!r} axis (parallel.make_mesh)")
    return mesh.shape[axis]


def pad_rows_for_mesh(mesh, *, idx, weights, x, axis: str = CELL_AXIS,
                      who: str = "graph_multichip"):
    """``(idx, weights, x, n)``: the rows padded to a multiple of the
    device count (-1 edges, zero weights, zero rows) and the original
    row count to slice the result with."""
    n_dev = require_cell_axis(mesh, who, axis)
    n = x.shape[0]
    rows = -(-n // n_dev) * n_dev
    return (pad_rows(idx, rows, -1), pad_rows(weights, rows, 0.0),
            pad_rows(x, rows, 0.0), n)


class _Sharded:
    """A graph's edges cut over a mesh, checked against the ``x`` they
    will multiply, with the remapped edge lists the ring needs built
    once for every product."""

    def __init__(self, who, knn_idx, weights, x, mesh, axis, strategy):
        require_cell_axis(mesh, who, axis)
        if strategy not in STRATEGIES:
            raise ValueError(f"{who}: unknown strategy {strategy!r} "
                             f"(use 'all_gather' or 'ring')")
        if not (knn_idx.shape[0] == weights.shape[0] == x.shape[0]):
            raise ValueError(
                f"{who}: idx/weights/x row counts differ "
                f"({knn_idx.shape[0]}/{weights.shape[0]}/{x.shape[0]})")
        self.mesh = mesh
        self.strategy = strategy
        self.idx = split_rows(knn_idx.to(torch.int32), mesh)
        self.w = split_rows(weights.float(), mesh)
        if strategy == "ring":
            # local[i][src]: shard i's edges as rows of the chunk that
            # started on shard src, -1 outside it
            m = knn_idx.shape[0] // mesh.size
            self.local = [[torch.where((ib >= s * m) & (ib < (s + 1) * m),
                                       ib - s * m, -1)
                           for s in range(mesh.size)] for ib in self.idx]

    def apply(self, xs: list) -> list:
        """``P @ x`` for ``x`` given as shards ``xs``: the product's
        shards."""
        mesh = self.mesh
        if self.strategy == "all_gather":
            # every gather before any product: a copy from a device runs
            # on that device's current stream, behind a product there
            full = [all_gather(xs, dev) for dev in mesh.devices]
            return [matvec(self.idx[i], self.w[i], f)
                    for i, f in enumerate(full)]
        acc = [None] * mesh.size

        def step(t, i, src, chunk):
            y = matvec(self.local[i][src], self.w[i], chunk)
            acc[i] = y if acc[i] is None else acc[i] + y

        ring(mesh, xs, step)
        return acc


def knn_matvec_sharded(knn_idx, weights, x, mesh, axis: str = CELL_AXIS,
                       strategy: str = "all_gather") -> torch.Tensor:
    """``P @ x`` with the rows sharded over ``mesh``: ``knn_matvec``'s
    result (-1 edges weigh nothing) up to float32 summation order."""
    g = _Sharded("knn_matvec_sharded", knn_idx, weights, x, mesh, axis,
                 strategy)
    return all_gather(g.apply(split_rows(x.float(), mesh)),
                      mesh.devices[0])


def smooth_layers_sharded(knn_idx, weights, layers, mesh,
                          axis: str = CELL_AXIS,
                          strategy: str = "all_gather") -> list:
    """The velocity-moments smoothing, sharded: ``(X + P @ X) / (1 +
    rowsum(P))`` for each layer X (-1 edges weigh nothing)."""
    w = torch.where(knn_idx < 0, 0.0, weights.float())
    denom = 1.0 + w.sum(dim=1, keepdim=True)
    out = []
    for X in layers:
        y = knn_matvec_sharded(knn_idx, weights, X, mesh, axis=axis,
                               strategy=strategy)
        out.append((X.float().to(y.device) + y) / denom.to(y.device))
    return out


def diffuse_sharded(knn_idx, weights, x, mesh, t: int,
                    axis: str = CELL_AXIS,
                    strategy: str = "all_gather") -> torch.Tensor:
    """``P^t @ x`` (MAGIC's diffusion) with the rows sharded over
    ``mesh``: the shards stay on their devices for all ``t`` steps, and
    each step gathers or circulates the current ``x`` again."""
    g = _Sharded("diffuse_sharded", knn_idx, weights, x, mesh, axis,
                 strategy)
    xs = split_rows(x.float(), mesh)
    for _ in range(t):
        xs = g.apply(xs)
    return all_gather(xs, mesh.devices[0])
