"""The in-memory ops on cell-sharded data (``shard_celldata``):
``qc.per_cell_metrics``, ``normalize.library_size``, ``normalize.log1p``,
``hvg.select`` (seurat_v3) and ``pca.randomized`` (CholeskyQR).

The reference runs its jitted ops on a cell-sharded ``CellData`` and
GSPMD inserts the collectives (``tests/test_multichip.py``).  Here each
op runs the single-device code on every block on that block's device:
the row-local work as it is, and each cross-row reduction per block,
the partials added in mesh order on the first device
(``data.sharded.reduce_sum``; ``hvg._gene_moments``,
``hvg._seurat_v3_scores`` and ``pca.randomized_pca_arrays`` take the
blocks themselves).  Per-cell results stay sharded (``ShardedRows`` of
per-block columns); per-gene results lie on the first device.
``library_size(target_sum=None)`` gathers the (n,) totals for their
median.  Each is registered with ``registry.register_sharded``, which
is how ``apply`` and ``Pipeline.run`` reach it; any other op given
sharded data raises there.
"""

from __future__ import annotations

import torch

from ..config import resolve_device
from ..data.dataset import SHARDED_TODO, CellData
from ..data.sharded import ShardedRows
from ..data.sparse import SparseCells, row_sum
from ..ops import hvg, normalize, pca, qc
from ..registry import register_sharded


def _sharded_X(data: CellData, device) -> ShardedRows:
    """X of sharded ``data``, after checking that ``device`` is of the
    mesh's kind (a CUDA mesh never runs a block on the CPU)."""
    dev = resolve_device(device)
    X = data.X
    if X.mesh.devices[0].type != dev.type:
        raise ValueError(f"the data is sharded over "
                         f"{X.mesh.devices[0].type} devices, not over "
                         f"device={dev}")
    return X


def _columns(X: ShardedRows, outs: list) -> dict:
    """Per-block dicts of per-cell columns → one ShardedRows a key."""
    return {k: ShardedRows(tuple(o[k] for o in outs), X.mesh, X.n_cells)
            for k in outs[0]}


@register_sharded("qc.per_cell_metrics")
def per_cell_metrics(data: CellData, mito_mask=None, percent_top=(),
                     device=None) -> CellData:
    """``qc.per_cell_metrics`` block by block (row-local)."""
    X = _sharded_X(data, device)
    if mito_mask is None:
        mito_mask = qc._mito_mask(data)
    outs = [qc.per_cell_metrics(CellData(b), mito_mask=mito_mask,
                                percent_top=percent_top,
                                device=b.device).obs for b in X.blocks]
    return data.with_obs(**_columns(X, outs))


@register_sharded("normalize.library_size")
def library_size(data: CellData, target_sum: float | None = 1e4,
                 exclude_highly_expressed: bool = False,
                 max_fraction: float = 0.05, device=None) -> CellData:
    """``normalize.library_size`` block by block; ``target_sum=None``
    takes the median of the (n,) totals, gathered on the first
    device."""
    X = _sharded_X(data, device)
    if exclude_highly_expressed:
        raise NotImplementedError(
            f"normalize.library_size(exclude_highly_expressed=True): "
            f"{SHARDED_TODO}")
    totals = [row_sum(b) if isinstance(b, SparseCells) else b.sum(dim=1)
              for b in X.blocks]
    if target_sum is None:
        target = normalize._median(torch.cat(
            [t[:X.valid_rows(d)].to(X.device)
             for d, t in enumerate(totals)]))
    else:
        target = torch.tensor(target_sum, dtype=totals[0].dtype,
                              device=X.device)

    def scaled(b, d):
        scale = normalize._scale_rows(totals[d], target.to(b.device))
        if isinstance(b, SparseCells):
            return b.with_data(b.data * scale[:, None])
        return b * scale[:, None]

    lib = ShardedRows(tuple(totals), X.mesh, X.n_cells)
    return data.with_X(X.map_blocks(scaled)).with_obs(library_size=lib)


@register_sharded("normalize.log1p")
def log1p(data: CellData, device=None) -> CellData:
    """``normalize.log1p`` block by block."""
    X = _sharded_X(data, device)
    return data.with_X(X.map_blocks(
        lambda b, d: b.with_data(torch.log1p(b.data))
        if isinstance(b, SparseCells) else torch.log1p(b)))


@register_sharded("hvg.select")
def hvg_select(data: CellData, n_top: int = 2000,
               flavor: str = "seurat_v3", subset: bool = False,
               compact: bool = True, batch_key: str | None = None,
               theta: float = 100.0, device=None) -> CellData:
    """``hvg.select`` (seurat_v3) on sharded data: the gene moments and
    the clipped sums over the blocks, the trend fit and the ranking on
    the first device.  ``subset`` keeps the genes in every block."""
    X = _sharded_X(data, device)
    if flavor != "seurat_v3" or batch_key is not None:
        raise NotImplementedError(
            f"hvg.select(flavor={flavor!r}, batch_key={batch_key!r}): "
            f"{SHARDED_TODO}")
    mean, var, nnz = hvg._gene_moments(X)
    score = hvg._seurat_v3_scores(X, mean, var, nnz, X.n_cells)
    return hvg._ranked(data, score, n_top, subset, compact, means=mean,
                       variances=var)


@register_sharded("pca.randomized")
def pca_randomized(data: CellData, n_components: int = 50,
                   oversample: int = 10, n_iter: int = 2,
                   center: bool = True, seed: int = 0,
                   qr_method: str = "cholesky", omega=None,
                   device=None) -> CellData:
    """``pca.randomized`` on sharded data (``qr_method="cholesky"``):
    ``randomized_pca_arrays`` on the blocks, the iterate and the scores
    kept in per-device row blocks (obsm ``X_pca`` a ShardedRows)."""
    X = _sharded_X(data, device)
    pca._warn_width(n_components, X.n_cells, X.n_genes)
    scores, comps, expl, mu = pca.randomized_pca_arrays(
        X, n_components=n_components, oversample=oversample,
        n_iter=n_iter, center=center, qr_method=qr_method,
        omega=None if omega is None else torch.as_tensor(omega),
        seed=seed)
    return data.with_obsm(X_pca=scores).with_varm(PCs=comps).with_uns(
        pca_explained_variance=expl, pca_mean=mu)
