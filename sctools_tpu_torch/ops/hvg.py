"""Highly-variable-gene selection: ``hvg.select``, flavor ``seurat_v3``.

Counterpart of ``sctools_tpu/ops/hvg.py``: per-gene mean and variance
from the cancellation-free two-pass ``gene_moments``, a quadratic fit
of log10(var) on log10(mean) (the reference's stand-in for loess), then
the clipped standardised variance from one chunked segment pass, and a
stable descending ranking.  The other flavors and ``batch_key`` of the
in-memory op are not ported yet; the streamed ranking
(``data/stream.py:stream_hvg``) has all five flavors, scored on the
host in float64 by the ``*_np`` helpers below.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import config, resolve_device, round_up, true_f32
from ..data.dataset import CellData
from ..data.sparse import SparseCells, gene_moments, segment_reduce
from ..registry import register
from .qc import _sparse_X


# ----------------------------------------------------------------------
# Gene subsetting
# ----------------------------------------------------------------------


def subset_genes_sparse(x: SparseCells, gene_idx: np.ndarray,
                        capacity: int | None = None) -> SparseCells:
    """Gene subset of a padded-ELL matrix: an old→new gene-id map
    (dropped genes → the new sentinel) remaps the slot indices in place;
    ``capacity`` re-packs the rows tighter."""
    gene_idx = np.asarray(gene_idx)
    g_new = len(gene_idx)
    mapping = np.full(x.n_genes + 1, g_new, dtype=np.int32)
    mapping[gene_idx] = np.arange(g_new, dtype=np.int32)
    mapping = torch.from_numpy(mapping).to(x.device)
    new_ind = mapping[x.indices.long()]
    new_dat = torch.where(new_ind == g_new, 0.0, x.data)
    out = SparseCells(new_ind, new_dat, x.n_cells, g_new)
    if capacity is not None and capacity < x.capacity:
        out = _compact_capacity(out, capacity)
    return out


def _compact_capacity(x: SparseCells, capacity: int) -> SparseCells:
    """Shift valid slots left (stable) and truncate to ``capacity``."""
    capacity = round_up(capacity, config.capacity_multiple)
    is_pad = (x.indices == x.sentinel).to(torch.int32)
    order = torch.argsort(is_pad, dim=1, stable=True)[:, :capacity]
    ind = torch.gather(x.indices, 1, order)
    dat = torch.gather(x.data, 1, order)
    return SparseCells(ind.contiguous(), dat.contiguous(), x.n_cells,
                       x.n_genes)


def _subset_genes_matrix(M, gene_idx: np.ndarray, compact: bool):
    if not isinstance(M, SparseCells):
        raise TypeError(f"expected SparseCells, got {type(M).__name__}")
    cap = None
    if compact:
        # safe upper bound on the new nnz per row
        cap = min(M.capacity, round_up(max(len(gene_idx), 1),
                                       config.capacity_multiple))
    return subset_genes_sparse(M, gene_idx, capacity=cap)


def select_genes_device(data: CellData, gene_idx: np.ndarray,
                        compact: bool = False) -> CellData:
    """Subset a CellData to ``gene_idx``: X, var, varm and every layer
    are sliced consistently."""
    gene_idx = np.asarray(gene_idx)

    def take(v):
        if isinstance(v, torch.Tensor):
            return v[torch.from_numpy(gene_idx).to(v.device)]
        return np.asarray(v)[gene_idx]  # strings/objects stay host-side

    return data.replace(
        X=_subset_genes_matrix(data.X, gene_idx, compact),
        var={k: take(v) for k, v in data.var.items()},
        varm={k: take(v) for k, v in data.varm.items()},
        layers={k: _subset_genes_matrix(v, gene_idx, compact)
                for k, v in data.layers.items()})


# ----------------------------------------------------------------------
# seurat_v3
# ----------------------------------------------------------------------


def _gene_moments(X: SparseCells):
    """Per-gene mean, (ddof=1) variance and nnz over cells."""
    mean, m2, nnz = gene_moments(X)
    var = m2 / max(X.n_cells - 1, 1)
    return mean, torch.clamp(var, min=0.0), nnz


def _fit_mean_var_trend(mean: torch.Tensor, var: torch.Tensor
                        ) -> torch.Tensor:
    """Quadratic fit of log10(var) ~ log10(mean) over expressed genes;
    returns the predicted variance per gene.  The regressor is
    standardised first: the raw [1, lm, lm²] normal equations are too
    ill-conditioned for float32."""
    expressed = (mean > 0) & (var > 0)
    lm = torch.log10(torch.where(mean > 0, mean, 1.0))
    lv = torch.log10(torch.where(var > 0, var, 1.0))
    w = expressed.to(lm.dtype)
    wsum = torch.clamp(w.sum(), min=1.0)
    m0 = (lm * w).sum() / wsum
    s0 = torch.sqrt(torch.clamp((w * (lm - m0) ** 2).sum() / wsum,
                                min=1e-12))
    t = (lm - m0) / s0
    A = torch.stack([torch.ones_like(t), t, t * t], dim=1)
    Aw = A * w[:, None]
    G = Aw.T @ A
    b = Aw.T @ lv
    eye = torch.eye(3, dtype=lm.dtype, device=lm.device)
    coef = torch.linalg.solve(G + 1e-6 * eye, b)
    return torch.pow(10.0, A @ coef)


# ----------------------------------------------------------------------
# Host float64 scores of the streamed ranking (data/stream.py)
# ----------------------------------------------------------------------


def _fit_mean_var_trend_np(mean: np.ndarray, var: np.ndarray
                           ) -> np.ndarray:
    """numpy (float64) counterpart of :func:`_fit_mean_var_trend`, for
    the moments a streamed pass accumulates on the host."""
    expressed = (mean > 0) & (var > 0)
    lm = np.log10(np.where(mean > 0, mean, 1.0))
    lv = np.log10(np.where(var > 0, var, 1.0))
    w = expressed.astype(lm.dtype)
    wsum = max(np.sum(w), 1.0)
    m0 = np.sum(lm * w) / wsum
    s0 = np.sqrt(max(np.sum(w * (lm - m0) ** 2) / wsum, 1e-12))
    t = (lm - m0) / s0
    A = np.stack([np.ones_like(t), t, t * t], axis=1)
    Aw = A * w[:, None]
    coef = np.linalg.solve(Aw.T @ A + 1e-6 * np.eye(3, dtype=lm.dtype),
                           Aw.T @ lv)
    return np.power(10.0, A @ coef)


def _seurat_v3_scores_np(mean, var, clipped_ssq, n: int) -> np.ndarray:
    """Standardised variance from the clipped second moment."""
    return np.where((mean > 0) & (var > 0),
                    clipped_ssq / max(n - 1, 1), 0.0)


def _dispersion_scores_np(mean, var, n_bins: int = 20) -> np.ndarray:
    """Seurat-v1 dispersion: var/mean, z-scored within ``n_bins``
    equal-width bins of log1p(mean)."""
    disp = np.where(mean > 0, var / np.maximum(mean, 1e-12), 0.0)
    logm = np.log1p(mean)
    lo = np.min(logm)
    hi = np.max(logm) + 1e-6
    bins = np.clip(((logm - lo) / (hi - lo) * n_bins).astype(np.int32),
                   0, n_bins - 1)
    m = np.zeros(n_bins)
    s = np.zeros(n_bins)
    cnt = np.zeros(n_bins)
    np.add.at(cnt, bins, 1.0)
    np.add.at(m, bins, disp)
    np.add.at(s, bins, disp * disp)
    cnt = np.maximum(cnt, 1.0)
    bmean = m / cnt
    bstd = np.sqrt(np.maximum(s / cnt - bmean ** 2, 1e-12))
    return (disp - bmean[bins]) / bstd[bins]


def _cell_ranger_scores_np(mean, var, min_bins: int = 3) -> np.ndarray:
    """scanpy flavor "cell_ranger": dispersion normalised by the median
    and median absolute deviation within mean-percentile bins; genes in
    bins smaller than ``min_bins`` keep their raw dispersion."""
    mean = np.asarray(mean, np.float64)
    var = np.asarray(var, np.float64)
    disp = np.where(mean > 0, var / np.maximum(mean, 1e-12), 0.0)
    edges = np.percentile(mean[mean > 0], np.arange(10, 105, 5))
    bins = np.digitize(mean, np.unique(edges))
    score = np.zeros_like(disp)
    for b in np.unique(bins):
        m = bins == b
        if m.sum() < min_bins:
            score[m] = disp[m]
            continue
        med = np.median(disp[m])
        mad = np.median(np.abs(disp[m] - med)) + 1e-12
        score[m] = (disp[m] - med) / mad  # signed, as in scanpy
    return score


@register("hvg.select", fusable=False, mem_cost=2.5, mask_aware=False)
def hvg_select(data: CellData, n_top: int = 2000,
               flavor: str = "seurat_v3", subset: bool = False,
               compact: bool = True, batch_key: str | None = None,
               device=None) -> CellData:
    """Rank genes by the seurat_v3 clipped standardised variance; adds
    var ``highly_variable``, ``hvg_rank``, ``hvg_score``, ``means`` and
    ``variances``.  ``subset=True`` returns the gene subset (re-packed
    to a tighter capacity with ``compact``)."""
    if flavor != "seurat_v3":
        raise NotImplementedError(
            f"hvg.select flavor={flavor!r} is not ported yet (seurat_v3 "
            "is)")
    if batch_key is not None:
        raise NotImplementedError("hvg.select batch_key is not ported yet")
    data = data.to_device(resolve_device(device))
    X = _sparse_X(data)
    n = data.n_cells
    mean, var, nnz = _gene_moments(X)
    with true_f32():
        trend = _fit_mean_var_trend(mean, var)
    std = torch.clamp(torch.sqrt(trend), min=1e-12)
    clip = torch.sqrt(torch.tensor(float(n), device=X.device))
    # clipped standardised second moment in one chunked pass:
    # Σ_c min(clip, (x - μ)/σ)² = [stored entries] + (n - nnz)·(μ/σ)²
    zero = torch.zeros((1,), device=X.device)
    table_mu = torch.cat([mean / std, zero])
    table_inv = torch.cat([1.0 / std, zero])

    def slot_vals(ind, dat, row_offset):
        il = ind.long()
        z = torch.clamp(table_inv[il] * dat - table_mu[il], -clip, clip)
        rows = row_offset + torch.arange(ind.shape[0], device=ind.device)
        ok = (ind != X.sentinel) & (rows < X.n_cells)[:, None]
        return torch.where(ok, z * z, 0.0)[:, :, None]

    ssq_nnz = segment_reduce(X, slot_vals, 1)[:, 0]
    zero_term = torch.clamp(-mean / std, -clip, clip) ** 2
    ssq = ssq_nnz + (n - nnz) * zero_term
    score = torch.where((mean > 0) & (var > 0), ssq / max(n - 1, 1), 0.0)

    order = torch.argsort(-score, stable=True)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(data.n_genes, device=X.device)
    out = data.with_var(
        highly_variable=rank < n_top, hvg_rank=rank.to(torch.int32),
        hvg_score=score, means=mean, variances=var)
    if subset:
        top_idx = np.sort(order[:n_top].cpu().numpy())
        out = select_genes_device(out, top_idx, compact=compact)
    return out
