"""QC transforms: ``qc.per_cell_metrics``, and the cell subset
``select_cells_device`` behind ``CellData.__getitem__``.

Counterpart of ``sctools_tpu/ops/qc.py``: per-cell metrics are row
reductions over the padded-ELL slots; the mito share gathers a
``(n_genes + 1,)`` mask table by the slot indices.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import resolve_device
from ..data.dataset import CellData
from ..data.sparse import SparseCells, gather_rows_sparse
from ..registry import register


def _mito_mask(data: CellData):
    if "mito" in data.var:
        return data.var["mito"]
    if "gene_name" in data.var:
        names = np.asarray(data.var["gene_name"])
        return np.char.startswith(np.char.upper(names.astype(str)), "MT-")
    return None


def _sparse_X(data: CellData) -> SparseCells:
    if not isinstance(data.X, SparseCells):
        raise TypeError(
            f"the port's ops take padded-ELL SparseCells X, got "
            f"{type(data.X).__name__}; dense X is not ported yet")
    return data.X


def _gather_rows_matrix(M, idx: np.ndarray):
    """Row subset of an X-shaped matrix (SparseCells, scipy or a dense
    tensor), shared by X and every layer so they cannot drift."""
    import scipy.sparse as sp

    if sp.issparse(M):
        return M.tocsr()[idx]
    if isinstance(M, SparseCells):
        return gather_rows_sparse(M, idx)
    if isinstance(M, torch.Tensor):
        return M.index_select(0, torch.as_tensor(idx, device=M.device))
    return np.asarray(M)[idx]


def select_cells_device(data: CellData, idx) -> CellData:
    """Subset a CellData to the cells in ``idx`` (int ids in
    ``[0, n_cells)``), counterpart of ``sctools_tpu/ops/qc.py:
    select_cells_device``.  X, obs, obsm and every layer are gathered
    consistently on their devices (per-cell tensors that carry padded
    rows come out trimmed); obsp is dropped, since pairwise graphs refer
    to rows that may be gone."""
    idx = np.asarray(idx, np.int64)

    def take(v):
        if isinstance(v, torch.Tensor):
            return v.index_select(0, torch.as_tensor(idx, device=v.device))
        return np.asarray(v)[idx]

    return data.replace(
        X=_gather_rows_matrix(data.X, idx),
        obs={k: take(v) for k, v in data.obs.items()},
        obsm={k: take(v) for k, v in data.obsm.items()}, obsp={},
        layers={k: _gather_rows_matrix(v, idx)
                for k, v in data.layers.items()})


@register("qc.per_cell_metrics", fusable=True, mask_aware=True)
def per_cell_metrics(data: CellData, mito_mask=None,
                     percent_top: tuple = (), device=None) -> CellData:
    """Adds obs ``n_genes`` (int32), ``total_counts``, ``pct_counts_mt``
    and, for each N in ``percent_top``, ``pct_counts_in_top_N_genes``
    (the share of a cell's counts in its N highest-count genes)."""
    data = data.to_device(resolve_device(device))
    X = _sparse_X(data)
    if mito_mask is None:
        mito_mask = _mito_mask(data)
    n_genes = X.valid_mask().sum(dim=1, dtype=torch.int32)
    total = X.data.sum(dim=1)
    if mito_mask is not None:
        mask = torch.as_tensor(mito_mask, device=X.device)
        table = torch.cat([mask.to(X.data.dtype),
                           torch.zeros((1,), dtype=X.data.dtype,
                                       device=X.device)])
        mito_counts = (X.data * table[X.indices.long()]).sum(dim=1)
    else:
        mito_counts = torch.zeros_like(total)
    pct_mt = 100.0 * mito_counts / torch.clamp(total, min=1e-12)
    extra = {}
    for N in percent_top:
        k_eff = min(int(N), X.capacity)
        top = torch.topk(X.data, k_eff, dim=1).values
        extra[f"pct_counts_in_top_{int(N)}_genes"] = (
            100.0 * top.sum(dim=1) / torch.clamp(total, min=1e-12))
    return data.with_obs(n_genes=n_genes, total_counts=total,
                         pct_counts_mt=pct_mt, **extra)
