"""Graph autocorrelation per gene: ``metrics.morans_i`` and
``metrics.gearys_c``.

Counterpart of ``sctools_tpu/ops/metrics.py`` (scanpy's
``metrics.morans_i`` / ``metrics.gearys_c``), over the kNN graph's
edge weights (``obsp["connectivities"]``, else unit weights):

* Moran's I_g  = (n / S0) · Σ_i z_i (Wz)_i / Σ_i z_i²
* Geary's C_g = ((n − 1) / 2S0) · Σ_ij w_ij (x_i − x_j)² / Σ_i z_i²

with z the centred values and S0 = Σ w_ij.  The pair sum expands to
Σ_i r_i x_i² + Σ_j c_j x_j² − 2 Σ_i x_i (Wx)_i (r, c the row and column
sums of W), so each block of 256 genes takes two products ``W @ z`` and
``W @ x``: the ``graph_matvec`` kernel on the card
(``graph.knn_matvec``).  A sparse X is densified one block at a time
(``dense_gene_block``).  The per-gene sums are float32 on the device,
combined on the host in float64, as in the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import resolve_device
from ..data.dataset import CellData
from ..data.sparse import SparseCells, dense_gene_block
from ..registry import register
from .graph import _host, knn_matvec

_GCHUNK = 256  # genes a block: two graph_matvec launches each


def _edge_arrays(data: CellData):
    """(idx (n, k) int32, w (n, k) float64 with -1 slots at 0), host."""
    if "knn_indices" not in data.obsp:
        raise KeyError("metrics: run neighbors.knn (+ "
                       "graph.connectivities) first")
    n = data.n_cells
    idx = _host(data.obsp["knn_indices"])[:n]
    if "connectivities" in data.obsp:
        w = _host(data.obsp["connectivities"]).astype(np.float64)[:n]
    else:
        w = np.ones_like(idx, np.float64)
    w = np.where(idx >= 0, w, 0.0)
    return idx, w


def _resolve_values(data: CellData, use_rep: str):
    """X, the layer or the obsm basis named ``use_rep``."""
    if use_rep == "X":
        return data.X
    M = data.layers.get(use_rep, data.obsm.get(use_rep))
    if M is None:
        raise KeyError(f"metrics: no layer/obsm named {use_rep!r}")
    return M


def _values_chunk(M, n: int, lo: int, hi: int) -> torch.Tensor:
    """Columns [lo, hi) of the value matrix, (n, hi − lo) float32."""
    if isinstance(M, SparseCells):
        return dense_gene_block(M, lo, hi - lo)
    return M[:n, lo:hi].float().contiguous()


def _auto_terms(idx, w, Xc, colsum_w):
    """Per gene of one value block: (Moran numerator, Geary numerator,
    Σ z²), float32 on the device."""
    z = Xc - Xc.mean(dim=0, keepdim=True)
    Wz = knn_matvec(idx, w, z)
    num_i = (z * Wz).sum(dim=0)
    r = w.sum(dim=1)
    Wx = knn_matvec(idx, w, Xc)
    x2 = Xc * Xc
    num_c = ((r[:, None] * x2).sum(dim=0)
             + (colsum_w[:, None] * x2).sum(dim=0)
             - 2.0 * (Xc * Wx).sum(dim=0))
    denom = (z * z).sum(dim=0)
    return num_i, num_c, denom


def _metrics(data: CellData, use_rep: str, dev):
    """(Moran's I, Geary's C) per column of ``use_rep``, float64 host."""
    idx, w = _edge_arrays(data)
    n = len(idx)
    S0 = float(w.sum())
    colsum = np.zeros(n)
    np.add.at(colsum, np.where(idx >= 0, idx, 0).ravel(), w.ravel())
    M = _resolve_values(data, use_rep)
    G = M.n_genes if isinstance(M, SparseCells) else M.shape[1]
    idx_d = torch.from_numpy(np.ascontiguousarray(idx, np.int32)).to(dev)
    w_d = torch.from_numpy(w.astype(np.float32)).to(dev)
    cs_d = torch.from_numpy(colsum.astype(np.float32)).to(dev)
    terms = [_auto_terms(idx_d, w_d, _values_chunk(M, data.n_cells, lo,
                                                   min(G, lo + _GCHUNK)),
                         cs_d)
             for lo in range(0, G, _GCHUNK)]
    ni, nc, dn = (_host(torch.cat(t)).astype(np.float64)
                  for t in zip(*terms))
    dn = np.maximum(dn, 1e-12)
    return (n / S0) * ni / dn, ((n - 1) / (2.0 * S0)) * nc / dn


def _store(data: CellData, name: str, use_rep: str, values) -> CellData:
    if use_rep == "X" or use_rep in data.layers:
        return data.with_var(**{name: values.astype(np.float32)})
    return data.with_uns(**{f"{name}_{use_rep}": values})


@register("metrics.morans_i")
def morans_i(data: CellData, use_rep: str = "X", device=None) -> CellData:
    """Moran's I of each gene over the kNN graph in ``var["morans_i"]``
    (``uns["morans_i_<rep>"]`` for an obsm basis): +1 neighbours share
    the value, 0 noise, < 0 anti-correlated.  ``use_rep``: X, a layer or
    an obsm basis."""
    dev = resolve_device(device)
    data = data.to_device(dev)
    return _store(data, "morans_i", use_rep, _metrics(data, use_rep, dev)[0])


@register("metrics.gearys_c")
def gearys_c(data: CellData, use_rep: str = "X", device=None) -> CellData:
    """Geary's C of each gene over the kNN graph in ``var["gearys_c"]``
    (``uns["gearys_c_<rep>"]`` for an obsm basis): 0 perfect positive
    autocorrelation, 1 none, > 1 anti-correlated."""
    dev = resolve_device(device)
    data = data.to_device(dev)
    return _store(data, "gearys_c", use_rep, _metrics(data, use_rep, dev)[1])
