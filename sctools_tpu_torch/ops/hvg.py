"""Highly-variable-gene selection: ``hvg.select``.

Counterpart of ``sctools_tpu/ops/hvg.py``, with its flavors:

* ``"seurat_v3"``: per-gene mean and variance from the cancellation-free
  two-pass ``gene_moments``, a quadratic fit of log10(var) on
  log10(mean) (the reference's stand-in for loess), then the clipped
  standardised variance from one chunked segment pass;
* ``"dispersion"`` / ``"seurat"``: var/mean z-scored within 20
  equal-width bins of log1p(mean), in float32 on the device;
* ``"cell_ranger"``: dispersion normalised by the median and MAD within
  mean-percentile bins, on the host in float64 (as the reference does);
* ``"pearson_residuals"``: the variance of the clipped Pearson
  residuals of the raw counts; on a sparse X the zeros' residuals come
  from dense (cells × 256 genes) tiles of the margins and the stored
  entries correct them in one segment pass, so X is never densified.

``batch_key`` ranks each batch alone and combines the ranks.  Every
flavor takes a dense X too.  The streamed ranking
(``data/stream.py:stream_hvg``) scores on the host in float64 by the
``*_np`` helpers below.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import config, resolve_device, round_up, true_f32
from ..data.dataset import CellData
from ..data.sparse import SparseCells, gene_moments, segment_reduce
from ..registry import register
from .qc import _matrix_X


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
    """Gene subset of an X-shaped matrix (SparseCells, a dense tensor,
    scipy or numpy), shared by X and every layer so they cannot
    drift."""
    import scipy.sparse as sp

    if sp.issparse(M):
        return M.tocsc()[:, gene_idx].tocsr()
    if isinstance(M, SparseCells):
        cap = None
        if compact:
            # safe upper bound on the new nnz per row
            cap = min(M.capacity, round_up(max(len(gene_idx), 1),
                                           config.capacity_multiple))
        return subset_genes_sparse(M, gene_idx, capacity=cap)
    if isinstance(M, torch.Tensor):
        return M.index_select(1, torch.as_tensor(gene_idx, dtype=torch.long,
                                                 device=M.device))
    return np.asarray(M)[:, gene_idx]


def select_genes_device(data: CellData, gene_idx: np.ndarray,
                        compact: bool = False) -> CellData:
    """Subset a CellData to ``gene_idx``: X, var, varm and every layer
    are sliced consistently."""
    gene_idx = np.asarray(gene_idx, np.int64)

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


_DENSE_ROWS = 8192  # rows a tile of the dense per-gene passes


def _gene_moments(X):
    """Per-gene mean, (ddof=1) variance and nnz over cells, of a
    SparseCells or a dense X."""
    if isinstance(X, SparseCells):
        mean, m2, nnz = gene_moments(X)
        var = m2 / max(X.n_cells - 1, 1)
    else:
        mean = X.mean(dim=0)
        var = X.var(dim=0, correction=1)
        nnz = (X != 0).sum(dim=0).to(mean.dtype)
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


# ----------------------------------------------------------------------
# Device scores of the in-memory op
# ----------------------------------------------------------------------


def _seurat_v3_scores(X, mean, var, nnz, n: int) -> torch.Tensor:
    """Clipped standardised variance against the mean-variance trend:
    Σ_c min(clip, (x − μ)/σ)² / (n − 1), clip = sqrt(n)."""
    with true_f32():
        trend = _fit_mean_var_trend(mean, var)
    std = torch.clamp(torch.sqrt(trend), min=1e-12)
    clip = torch.sqrt(torch.tensor(float(n), device=mean.device))
    if isinstance(X, SparseCells):
        # stored entries in one chunked pass; the zeros' term is
        # (n − nnz)·min(clip, μ/σ)²
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
    else:
        ssq = torch.zeros_like(mean)
        for r0 in range(0, X.shape[0], _DENSE_ROWS):
            z = torch.clamp((X[r0:r0 + _DENSE_ROWS] - mean) / std, -clip,
                            clip)
            ssq += (z * z).sum(dim=0)
    return torch.where((mean > 0) & (var > 0), ssq / max(n - 1, 1), 0.0)


def _dispersion_scores(mean: torch.Tensor, var: torch.Tensor,
                       n_bins: int = 20) -> torch.Tensor:
    """Seurat-v1 dispersion in float32 on the device, line for line the
    reference's ``_dispersion_scores(mean, var, jnp)``: var/mean, z-scored
    within ``n_bins`` equal-width bins of log1p(mean).  The bin variance
    ``s/cnt − mean²`` cancels in float32, as in the reference, so ulps
    of the moments move the scores by up to ~1e-2 at 32k genes and the
    card's unordered sums flip a few genes at the cutoff from run to run
    (PERF.md §6).  A gene whose mean lies on a bin edge may change
    bin between this and the float64 ``_dispersion_scores_np`` of the
    streamed ranking."""
    disp = torch.where(mean > 0, var / torch.clamp(mean, min=1e-12), 0.0)
    logm = torch.log1p(mean)
    lo = logm.min()
    hi = logm.max() + 1e-6
    bins = torch.clamp(((logm - lo) / (hi - lo) * n_bins).to(torch.int32),
                       0, n_bins - 1).long()
    cnt = torch.zeros(n_bins, device=mean.device).index_add_(
        0, bins, torch.ones_like(disp))
    m = torch.zeros(n_bins, device=mean.device).index_add_(0, bins, disp)
    s = torch.zeros(n_bins, device=mean.device).index_add_(
        0, bins, disp * disp)
    cnt = torch.clamp(cnt, min=1.0)
    bmean = m / cnt
    bstd = torch.sqrt(torch.clamp(s / cnt - bmean ** 2, min=1e-12))
    return (disp - bmean[bins]) / bstd[bins]


def _pearson_zero_chunk(totals_block, p_chunk, theta: float, clip: float):
    """Residual sums of the zero entries of a (cells × gene chunk) tile:
    the residual at x = 0 depends only on the cell total."""
    mu = totals_block[:, None] * p_chunk[None, :]
    denom = torch.clamp(torch.sqrt(mu + mu * mu / theta), min=1e-12)
    r0 = torch.clamp(-mu / denom, -clip, clip)
    return r0.sum(dim=0), (r0 * r0).sum(dim=0)


def _pearson_residual_var_sparse(X: SparseCells, mean: torch.Tensor,
                                 theta: float, gchunk: int = 256
                                 ) -> torch.Tensor:
    """Per-gene variance of the clipped Pearson residuals of raw counts
    ``r = clip((x − μ)/sqrt(μ + μ²/θ), ±sqrt(n))``, ``μ = t_i p_j``,
    without densifying X (the reference's
    ``_pearson_residual_var_sparse_tpu``): the zeros' residual depends on
    the cell total, so it is summed densely per gene chunk (n × gchunk),
    and the stored entries add (r − r0, r² − r0²) in one segment pass.
    Sums combine in float64 on the host."""
    n = X.n_cells
    totals = X.data.sum(dim=1)[:n]
    p = (n * mean) / torch.clamp(totals.sum(), min=1e-12)
    clip = float(np.sqrt(n))
    G = p.shape[0]
    S = np.zeros(G, np.float64)
    Q = np.zeros(G, np.float64)
    for lo in range(0, G, gchunk):
        s0, q0 = _pearson_zero_chunk(totals, p[lo:lo + gchunk], theta, clip)
        S[lo:lo + gchunk] = s0.cpu().numpy()
        Q[lo:lo + gchunk] = q0.cpu().numpy()
    zero = torch.zeros((X.rows_padded - n,), dtype=totals.dtype,
                       device=X.device)
    totals_pad = torch.cat([totals, zero])
    p_pad = torch.cat([p, torch.zeros((1,), device=X.device)])

    def slot_vals(ind, dat, row_offset):
        rows = row_offset + torch.arange(ind.shape[0], device=ind.device)
        t = totals_pad[torch.clamp(rows, max=X.rows_padded - 1)]
        mu = t[:, None] * p_pad[ind.long()]
        denom = torch.clamp(torch.sqrt(mu + mu * mu / theta), min=1e-12)
        r = torch.clamp((dat - mu) / denom, -clip, clip)
        r0 = torch.clamp(-mu / denom, -clip, clip)
        ok = (ind != X.sentinel) & (rows < n)[:, None]
        return torch.stack([torch.where(ok, r - r0, 0.0),
                            torch.where(ok, r * r - r0 * r0, 0.0)], dim=2)

    corr = segment_reduce(X, slot_vals, 2).cpu().numpy().astype(np.float64)
    S += corr[:, 0]
    Q += corr[:, 1]
    var = (Q - S * S / n) / max(n - 1, 1)
    return torch.from_numpy(var.astype(np.float32)).to(X.device)


def _pearson_residual_var_dense(X: torch.Tensor, theta: float
                                ) -> torch.Tensor:
    """Dense counterpart: the residual matrix's per-gene (ddof=1)
    variance."""
    n = X.shape[0]
    totals = X.sum(dim=1, keepdim=True)
    p = X.sum(dim=0) / torch.clamp(totals.sum(), min=1e-12)
    mu = totals * p[None, :]
    denom = torch.clamp(torch.sqrt(mu + mu * mu / theta), min=1e-12)
    clip = float(np.sqrt(n))
    r = torch.clamp((X - mu) / denom, -clip, clip)
    return r.var(dim=0, correction=1)


def _ranked(data: CellData, score: torch.Tensor, n_top: int, subset: bool,
            compact: bool, **var) -> CellData:
    """Stable descending rank of ``score``; the top ``n_top`` flagged,
    or kept with ``subset``."""
    order = torch.argsort(-score, stable=True)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(data.n_genes, device=score.device)
    out = data.with_var(highly_variable=rank < n_top,
                        hvg_rank=rank.to(torch.int32), hvg_score=score,
                        **var)
    if subset:
        out = select_genes_device(out, np.sort(order[:n_top].cpu().numpy()),
                                  compact=compact)
    return out


def _hvg_batched(data: CellData, n_top: int, flavor: str, subset: bool,
                 compact: bool, batch_key: str, device) -> CellData:
    """scanpy's ``batch_key``: each batch's cells ranked alone, then the
    genes flagged in more batches first, the median per-batch rank
    breaking ties.  Adds var ``highly_variable_nbatches``."""
    n = data.n_cells
    if batch_key not in data.obs:
        raise KeyError(f"hvg.select: obs has no {batch_key!r}")
    labels = data.obs[batch_key]
    labels = (labels.cpu().numpy() if isinstance(labels, torch.Tensor)
              else np.asarray(labels))[:n]
    ranks, flags = [], []
    for b in np.unique(labels):
        scored = hvg_select(data[labels == b], n_top=n_top, flavor=flavor,
                            device=device)
        ranks.append(scored.var["hvg_rank"].cpu().numpy())
        flags.append(scored.var["highly_variable"].cpu().numpy())
    nb = np.sum(np.stack(flags), axis=0).astype(np.int32)
    med = np.median(np.stack(ranks), axis=0)
    order = np.lexsort((med, -nb))
    rank = np.empty(data.n_genes, np.int64)
    rank[order] = np.arange(data.n_genes)
    dev = data.X.device

    def put(a):
        return torch.from_numpy(a).to(dev)

    out = data.with_var(
        highly_variable=put(rank < n_top),
        hvg_rank=put(rank.astype(np.int32)),
        highly_variable_nbatches=put(nb),
        hvg_score=put((-med).astype(np.float32)))
    if subset:
        out = select_genes_device(out, np.sort(order[:n_top]),
                                  compact=compact)
    return out


@register("hvg.select", fusable=False, mem_cost=2.5, mask_aware=False)
def hvg_select(data: CellData, n_top: int = 2000,
               flavor: str = "seurat_v3", subset: bool = False,
               compact: bool = True, batch_key: str | None = None,
               theta: float = 100.0, device=None) -> CellData:
    """Rank genes by variability under ``flavor`` (see the module
    docstring); adds var ``highly_variable``, ``hvg_rank``,
    ``hvg_score``, ``means`` and ``variances`` (ddof=1).
    ``subset=True`` returns the gene subset (re-packed to a tighter
    capacity with ``compact``).  ``batch_key`` ranks each batch of
    ``obs[batch_key]`` alone and combines the ranks (adds
    ``highly_variable_nbatches``; no ``means``/``variances``).
    ``theta`` is the overdispersion of the pearson_residuals flavor."""
    dev = resolve_device(device)
    data = data.to_device(dev)
    if batch_key is not None:
        return _hvg_batched(data, n_top, flavor, subset, compact,
                            batch_key, dev)
    X = _matrix_X(data)
    mean, var, nnz = _gene_moments(X)
    if flavor == "seurat_v3":
        score = _seurat_v3_scores(X, mean, var, nnz, data.n_cells)
    elif flavor in ("dispersion", "seurat"):
        # "seurat" is scanpy's name for this ranking
        score = _dispersion_scores(mean, var)
    elif flavor == "cell_ranger":
        score = torch.from_numpy(_cell_ranger_scores_np(
            mean.cpu().numpy(), var.cpu().numpy()).astype(np.float32)).to(dev)
    elif flavor == "pearson_residuals":
        # on raw counts, as seurat_v3
        score = (_pearson_residual_var_sparse(X, mean, theta)
                 if isinstance(X, SparseCells)
                 else _pearson_residual_var_dense(X, theta))
    else:
        raise ValueError(f"unknown hvg flavor {flavor!r}")
    return _ranked(data, score, n_top, subset, compact, means=mean,
                   variances=var)
