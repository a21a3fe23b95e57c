"""QC transforms: ``qc.per_cell_metrics``, ``qc.per_gene_metrics``,
``qc.filter_cells``, ``qc.filter_genes``, ``qc.subsample`` and
``util.snapshot_layer``, and the cell subset ``select_cells_device``
behind ``CellData.__getitem__``.

Counterpart of ``sctools_tpu/ops/qc.py``: per-cell metrics are row
reductions over the padded-ELL slots (or the rows of a dense X); the
mito share gathers a ``(n_genes + 1,)`` mask table by the slot indices.
The filters are materialization points: the keep mask is computed on
the device and read once on the host, because the output's shape
depends on it; the rows or genes are then gathered on the device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import resolve_device, true_f32
from ..data.dataset import CellData
from ..data.sparse import SparseCells, gather_rows_sparse, gene_stats
from ..registry import register


def _mito_mask(data: CellData):
    if "mito" in data.var:
        return data.var["mito"]
    if "gene_name" in data.var:
        names = np.asarray(data.var["gene_name"])
        return np.char.startswith(np.char.upper(names.astype(str)), "MT-")
    return None


def _matrix_X(data: CellData):
    """X as the ops take it: padded-ELL ``SparseCells`` or a dense
    (n_cells, n_genes) tensor."""
    if not isinstance(data.X, (SparseCells, torch.Tensor)):
        raise TypeError(
            f"the port's ops take SparseCells or a dense tensor as X, got "
            f"{type(data.X).__name__}; move the data with to_device first")
    return data.X


def _dense_X(data: CellData) -> torch.Tensor:
    """X densified to (n_cells, n_genes), as the reference's
    ``to_dense`` gives it (padding rows dropped)."""
    X = _matrix_X(data)
    return X.to_dense() if isinstance(X, SparseCells) else X


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
    X = _matrix_X(data)
    if mito_mask is None:
        mito_mask = _mito_mask(data)
    vals = X.data if isinstance(X, SparseCells) else X
    if isinstance(X, SparseCells):
        n_genes = X.valid_mask().sum(dim=1, dtype=torch.int32)
    else:
        n_genes = (X > 0).sum(dim=1, dtype=torch.int32)
    total = vals.sum(dim=1)
    if mito_mask is None:
        mito_counts = torch.zeros_like(total)
    elif isinstance(X, SparseCells):
        mask = torch.as_tensor(mito_mask, device=X.device)
        table = torch.cat([mask.to(X.data.dtype),
                           torch.zeros((1,), dtype=X.data.dtype,
                                       device=X.device)])
        mito_counts = (X.data * table[X.indices.long()]).sum(dim=1)
    else:
        mask = torch.as_tensor(mito_mask, device=X.device).to(X.dtype)
        with true_f32():
            mito_counts = X @ mask
    pct_mt = 100.0 * mito_counts / torch.clamp(total, min=1e-12)
    extra = {}
    for N in percent_top:
        k_eff = min(int(N), vals.shape[1])
        top = torch.topk(vals, k_eff, dim=1).values
        extra[f"pct_counts_in_top_{int(N)}_genes"] = (
            100.0 * top.sum(dim=1) / torch.clamp(total, min=1e-12))
    return data.with_obs(n_genes=n_genes, total_counts=total,
                         pct_counts_mt=pct_mt, **extra)


@register("qc.per_gene_metrics", fusable=True, mask_aware=True)
def per_gene_metrics(data: CellData, device=None) -> CellData:
    """Adds var ``n_cells`` (int32: cells expressing the gene),
    ``total_counts`` and ``mean_counts``."""
    data = data.to_device(resolve_device(device))
    X = _matrix_X(data)
    if isinstance(X, SparseCells):
        total, _, nnz = gene_stats(X)
        n_cells_by = nnz.to(torch.int32)
    else:
        n_cells_by = (X > 0).sum(dim=0, dtype=torch.int32)
        total = X.sum(dim=0)
    return data.with_var(n_cells=n_cells_by, total_counts=total,
                         mean_counts=total / data.n_cells)


def _as_tensor(v, device) -> torch.Tensor:
    return v if isinstance(v, torch.Tensor) else torch.as_tensor(
        np.asarray(v), device=device)


def _cell_keep_mask(data: CellData, device, min_genes, min_counts,
                    max_pct_mt, max_genes=None, max_counts=None
                    ) -> torch.Tensor:
    """Bool keep mask over the obs rows (bounds inclusive), on
    ``device``."""
    obs = data.obs
    need = [k for k in ("n_genes", "total_counts") if k not in obs]
    if need:
        raise ValueError(
            f"qc.filter_cells requires qc.per_cell_metrics first (missing "
            f"{need})")
    n_genes = _as_tensor(obs["n_genes"], device)
    total = _as_tensor(obs["total_counts"], device)
    keep = torch.ones(n_genes.shape, dtype=torch.bool, device=device)
    if min_genes is not None:
        keep &= n_genes >= min_genes
    if max_genes is not None:
        keep &= n_genes <= max_genes
    if min_counts is not None:
        keep &= total >= min_counts
    if max_counts is not None:
        keep &= total <= max_counts
    if max_pct_mt is not None and "pct_counts_mt" in obs:
        keep &= _as_tensor(obs["pct_counts_mt"], device) <= max_pct_mt
    return keep


@register("qc.filter_cells")
def filter_cells(data: CellData, min_genes: int | None = None,
                 min_counts: float | None = None,
                 max_pct_mt: float | None = None,
                 max_genes: int | None = None,
                 max_counts: float | None = None, device=None) -> CellData:
    """Drop cells outside the given QC bounds (scanpy ``pp.filter_cells``
    semantics, bounds inclusive; ``max_pct_mt`` caps the mitochondrial
    share when ``obs["pct_counts_mt"]`` exists).  Requires
    ``qc.per_cell_metrics`` first.  The keep mask is read on the host
    once (the output's shape depends on it); obsp is dropped."""
    dev = resolve_device(device)
    data = data.to_device(dev)
    keep = _cell_keep_mask(data, dev, min_genes, min_counts, max_pct_mt,
                           max_genes, max_counts)
    # per-cell metrics of the device carry padded rows: only the first
    # n_cells entries are cells
    idx = torch.nonzero(keep[: data.n_cells]).flatten().cpu().numpy()
    return select_cells_device(data, idx)


@register("qc.filter_genes")
def filter_genes(data: CellData, min_cells: int | None = 3,
                 min_counts: float | None = None,
                 max_cells: int | None = None,
                 max_counts: float | None = None, device=None) -> CellData:
    """Drop genes outside the given QC bounds (scanpy ``pp.filter_genes``
    semantics, bounds inclusive) on var ``n_cells`` / ``total_counts``,
    computed by ``qc.per_gene_metrics`` when missing.  The keep mask is
    read on the host once; the genes are dropped on the device."""
    from .hvg import select_genes_device

    dev = resolve_device(device)
    data = data.to_device(dev)
    if "n_cells" not in data.var:
        data = per_gene_metrics(data, device=dev)
    n_cells = _as_tensor(data.var["n_cells"], dev)
    total = _as_tensor(data.var["total_counts"], dev)
    keep = torch.ones(data.n_genes, dtype=torch.bool, device=dev)
    if min_cells is not None:
        keep &= n_cells >= min_cells
    if max_cells is not None:
        keep &= n_cells <= max_cells
    if min_counts is not None:
        keep &= total >= min_counts
    if max_counts is not None:
        keep &= total <= max_counts
    idx = torch.nonzero(keep).flatten().cpu().numpy()
    return select_genes_device(data, idx)


def _subsample_idx(n_cells: int, fraction: float | None,
                   n_obs: int | None, seed: int) -> np.ndarray:
    if (fraction is None) == (n_obs is None):
        raise ValueError("qc.subsample needs exactly one of fraction= or "
                         "n_obs=")
    if fraction is not None:
        if not 0.0 < fraction <= 1.0:
            raise ValueError(f"fraction must be in (0, 1], got {fraction}")
        n_obs = int(fraction * n_cells)  # floor, scanpy's convention
    if not 0 < n_obs <= n_cells:
        raise ValueError(
            f"n_obs={n_obs} out of range (need 1..{n_cells}); a fraction "
            "too small to keep one cell also lands here")
    rng = np.random.default_rng(seed)
    return np.sort(rng.choice(n_cells, size=n_obs, replace=False))


@register("qc.subsample")
def subsample(data: CellData, fraction: float | None = None,
              n_obs: int | None = None, seed: int = 0,
              device=None) -> CellData:
    """Random cell subset without replacement (scanpy ``pp.subsample``:
    exactly one of ``fraction`` / ``n_obs``, the fraction floored to a
    count), in order.  The rows come from ``np.random.default_rng(seed)``
    on the host, so they are the reference's rows.  A selection of no
    cell raises.  obsp is dropped."""
    data = data.to_device(resolve_device(device))
    return select_cells_device(
        data, _subsample_idx(data.n_cells, fraction, n_obs, seed))


@register("util.snapshot_layer", fusable=True, mask_aware=True)
def snapshot_layer(data: CellData, layer: str = "counts",
                   device=None) -> CellData:
    """``layers[layer] = X`` (the AnnData idiom for keeping raw counts
    before normalisation).  The layer shares X's tensors: no op of the
    port writes its input in place."""
    data = data.to_device(resolve_device(device))
    return data.with_layers(**{layer: data.X})
