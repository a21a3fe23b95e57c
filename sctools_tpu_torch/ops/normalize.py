"""Normalisation transforms: ``normalize.library_size``,
``normalize.log1p``, ``normalize.scale``, ``normalize.pearson_residuals``,
``normalize.regress_out``, ``normalize.clr`` and
``normalize.downsample_counts``.

Counterpart of ``sctools_tpu/ops/normalize.py``, in float32: per-row
rescaling of the padded-ELL values (or of a dense X); ``scale``,
``pearson_residuals`` and ``regress_out`` densify, as the reference's
do.  No op writes its input in place: ``util.snapshot_layer`` makes
``layers["counts"]`` share X's tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import resolve_device, true_f32
from ..data.dataset import CellData
from ..data.sparse import SparseCells, gene_sum, row_sum, segment_reduce
from ..registry import register
from .qc import _dense_X, _matrix_X


def _median(values: torch.Tensor) -> torch.Tensor:
    """Median as numpy/jnp define it: the mean of the two middle values
    for an even count (``torch.median`` returns the lower one)."""
    s = torch.sort(values).values
    n = s.shape[0]
    return (s[(n - 1) // 2] + s[n // 2]) / 2


def _target(totals: torch.Tensor, n_cells: int, target_sum):
    if target_sum is None:
        return _median(totals[:n_cells])
    return torch.tensor(target_sum, dtype=totals.dtype,
                        device=totals.device)


def _scale_rows(totals: torch.Tensor, target) -> torch.Tensor:
    return torch.where(totals > 0, target / torch.clamp(totals, min=1e-12),
                       0.0)


def _library_size_sparse(x: SparseCells, target_sum):
    """Per-shard library-size normalisation of the streamed passes
    (``data/stream.py``): the rows of ``x`` scaled to ``target_sum``
    (the median of the valid rows' totals when ``None``), and the
    totals.  Counterpart of the reference's ``_library_size_sparse``."""
    totals = row_sum(x)
    scale = _scale_rows(totals, _target(totals, x.n_cells, target_sum))
    return x.with_data(x.data * scale[:, None]), totals


def _he_gene_flag(x: SparseCells, totals: torch.Tensor,
                  max_fraction: float) -> torch.Tensor:
    """Genes taking > ``max_fraction`` of ANY cell's counts (scanpy's
    exclude_highly_expressed rule): indicator slots, one segment sum."""
    inv_tot = torch.where(totals > 0,
                          1.0 / torch.clamp(totals, min=1e-12), 0.0)

    def slot_vals(ind, dat, row_offset):
        rows = row_offset + torch.arange(ind.shape[0], device=ind.device)
        valid = (ind != x.sentinel) & (rows < x.n_cells)[:, None]
        frac = dat * inv_tot[torch.clamp(rows, max=len(totals) - 1)][:, None]
        return (valid & (frac > max_fraction)).to(dat.dtype)[:, :, None]

    return segment_reduce(x, slot_vals, 1)[:, 0] > 0


@register("normalize.library_size", fusable=True, mem_cost=2.5,
          mask_aware=True)
def library_size(data: CellData, target_sum: float | None = 1e4,
                 exclude_highly_expressed: bool = False,
                 max_fraction: float = 0.05, device=None) -> CellData:
    """Scale every cell to ``target_sum`` total counts (median of the
    totals when ``target_sum=None``).  ``exclude_highly_expressed``:
    genes taking more than ``max_fraction`` of any cell's counts are
    left out of the size computation, but still scaled.  Adds obs
    ``library_size`` (and var ``highly_expressed``)."""
    data = data.to_device(resolve_device(device))
    X = _matrix_X(data)
    he = None
    if isinstance(X, SparseCells):
        totals = row_sum(X)
        if exclude_highly_expressed:
            he = _he_gene_flag(X, totals, max_fraction)
            table = torch.cat([he.to(X.data.dtype),
                               torch.zeros((1,), dtype=X.data.dtype,
                                           device=X.device)])
            totals = totals - (X.data * table[X.indices.long()]).sum(dim=1)
        scale = _scale_rows(totals, _target(totals, X.n_cells, target_sum))
        Xs = X.with_data(X.data * scale[:, None])
    else:
        totals = X.sum(dim=1)
        if exclude_highly_expressed:
            frac = X / torch.clamp(totals[:, None], min=1e-12)
            he = (frac > max_fraction).any(dim=0)
            del frac
            totals = torch.where(he[None, :], 0.0, X).sum(dim=1)
        scale = _scale_rows(totals, _target(totals, X.shape[0], target_sum))
        Xs = X * scale[:, None]
    out = data.with_X(Xs).with_obs(library_size=totals)
    if he is not None:
        out = out.with_var(highly_expressed=he)
    return out


@register("normalize.log1p", fusable=True, mask_aware=True)
def log1p(data: CellData, device=None) -> CellData:
    """``x -> log(1 + x)`` (on the stored values of a sparse X:
    log1p(0) == 0, so the sparsity pattern is kept)."""
    data = data.to_device(resolve_device(device))
    X = _matrix_X(data)
    if isinstance(X, SparseCells):
        return data.with_X(X.with_data(torch.log1p(X.data)))
    return data.with_X(torch.log1p(X))


@register("normalize.scale", fusable=True, mem_cost=3.0, mask_aware=True)
def scale(data: CellData, max_value: float | None = 10.0,
          zero_center: bool = True, device=None) -> CellData:
    """Per-gene standardisation to unit variance (``correction=0``, as
    ``jnp.var``), zero mean with ``zero_center``, clipped to
    ``±max_value`` unless it is None.  Densifies X to (n_cells,
    n_genes).  Adds var ``scale_mean`` and ``scale_std``."""
    data = data.to_device(resolve_device(device))
    X = _dense_X(data)
    mean = X.mean(dim=0)
    Xs = X - mean  # the reference's two-pass variance
    std = torch.sqrt(torch.clamp((Xs * Xs).mean(dim=0), min=1e-12))
    if zero_center:
        Xs /= std
    else:
        Xs = X / std
    if max_value is not None:
        Xs.clamp_(-max_value, max_value)
    return data.with_X(Xs).with_var(scale_mean=mean, scale_std=std)


@register("normalize.pearson_residuals", fusable=True, mem_cost=4.0,
          mask_aware=True)
def pearson_residuals(data: CellData, theta: float = 100.0,
                      clip: float | None = None, device=None) -> CellData:
    """Analytic Pearson residuals of the NB offset model (Lause et al.
    2021): ``z = (x − μ) / sqrt(μ + μ²/θ)`` with ``μ_ij = t_i g_j / T``,
    clipped to ``±clip`` (default ``sqrt(n_cells)``).  Densifies X (run
    it after an HVG subset).  Adds uns ``pearson_theta``."""
    data = data.to_device(resolve_device(device))
    Xd = _dense_X(data)
    n = Xd.shape[0]
    c = float(clip) if clip is not None else float(np.sqrt(n))
    with true_f32():
        totals = Xd.sum(dim=1)
        gene_sums = Xd.sum(dim=0)
        mu = totals[:, None] * gene_sums[None, :]
        mu /= torch.clamp(totals.sum(), min=1e-12)
        denom = torch.sqrt(mu + mu * mu / theta)
        Z = Xd - mu
        del mu
        Z /= torch.clamp(denom, min=1e-12)
        del denom
        Z.clamp_(-c, c)
    return data.with_X(Z).with_uns(pearson_theta=theta)


def _design_matrix(data: CellData, keys, n_rows: int, device
                   ) -> torch.Tensor:
    """Intercept + one column per numeric covariate; a categorical
    (string/object) covariate is one-hot encoded on the host with its
    first level (in ``np.unique`` order) dropped.  Covariates longer
    than ``n_rows`` carry padded rows and are trimmed; shorter ones
    raise."""

    def fit(kname, v):
        if v.shape[0] >= n_rows:
            return v[:n_rows]
        raise ValueError(
            f"regress_out: obs[{kname!r}] has {v.shape[0]} entries, X has "
            f"{n_rows} rows")

    cols = [torch.ones((n_rows,), dtype=torch.float32, device=device)]
    for kname in keys:
        if kname not in data.obs:
            raise KeyError(f"regress_out: obs has no key {kname!r}; "
                           f"available: {sorted(data.obs)}")
        v = data.obs[kname]
        if not isinstance(v, torch.Tensor) and np.asarray(
                v).dtype.kind in "OUS":
            host = fit(kname, np.asarray(v).reshape(-1))
            _, codes = np.unique(host, return_inverse=True)
            onehot = np.eye(codes.max() + 1, dtype=np.float32)[codes][:, 1:]
            cols.extend(torch.from_numpy(np.ascontiguousarray(
                onehot[:, j])).to(device) for j in range(onehot.shape[1]))
            continue
        v = torch.as_tensor(np.asarray(v) if not isinstance(
            v, torch.Tensor) else v, device=device)
        cols.append(fit(kname, v.to(torch.float32).reshape(-1)))
    return torch.stack(cols, dim=1)  # (n_rows, p)


@register("normalize.regress_out")
def regress_out(data: CellData, keys: list | tuple = (),
                ridge: float = 1e-6, device=None) -> CellData:
    """Remove the linear effect of the ``obs[keys]`` covariates from
    every gene (scanpy ``pp.regress_out``) by one normal-equations
    solve: ``β = (CᵀC + λI)⁻¹ CᵀX`` (Cholesky), ``X ← X − Cβ``.
    Densifies X; categorical covariates are one-hot encoded."""
    if not keys:
        raise ValueError("regress_out needs at least one obs key")
    data = data.to_device(resolve_device(device))
    X = _dense_X(data)
    C = _design_matrix(data, keys, X.shape[0], X.device)
    with true_f32():
        ctc = C.T @ C + ridge * torch.eye(C.shape[1], dtype=X.dtype,
                                          device=X.device)
        beta = torch.cholesky_solve(C.T @ X, torch.linalg.cholesky(ctc))
        out = X - C @ beta
    return data.with_X(out)


@register("normalize.clr", fusable=True)
def clr(data: CellData, axis: str = "cell", device=None) -> CellData:
    """Centered log-ratio transform (Seurat's CLR for CITE-seq ADT
    counts): ``y = log1p(x / exp(mean(log1p(x))))``, the mean over each
    cell's features (``axis="cell"``) or each feature's cells
    (``axis="gene"``).  A sparse X keeps its pattern."""
    if axis not in ("cell", "gene"):
        raise ValueError(f"normalize.clr: axis must be 'cell' or 'gene', "
                         f"got {axis!r}")
    data = data.to_device(resolve_device(device))
    X = _matrix_X(data)
    if isinstance(X, SparseCells):
        lg = torch.log1p(X.data)
        if axis == "cell":
            m = lg.sum(dim=1) / data.n_genes  # zeros add 0
            return data.with_X(X.with_data(
                torch.log1p(X.data * torch.exp(-m)[:, None])))
        m = gene_sum(X.with_data(lg)) / data.n_cells
        scale_pad = torch.cat([torch.exp(-m),
                               torch.ones((1,), dtype=lg.dtype,
                                          device=lg.device)])
        return data.with_X(X.with_data(
            torch.log1p(X.data * scale_pad[X.indices.long()])))
    m = torch.log1p(X).mean(dim=1 if axis == "cell" else 0, keepdim=True)
    return data.with_X(torch.log1p(X * torch.exp(-m)))


@register("normalize.downsample_counts", fusable=True)
def downsample_counts(data: CellData, target_total: float = 1e3,
                      seed: int = 0, device=None) -> CellData:
    """Binomially thin each cell's counts to about ``target_total``
    (scanpy ``pp.downsample_counts``, per cell): ``x ← Binomial(⌊x⌋,
    p_i)`` with ``p_i = min(1, target / Σ⌊x⌋)``.  Values are floored
    first; a cell at or under the target keeps its floored counts.  On
    a sparse X an entry thinned to zero becomes a sentinel slot.  The
    draws come from a ``torch.Generator`` seeded with ``seed`` on X's
    device (the reference draws ``jax.random.binomial``, which torch
    cannot reproduce: the two agree in law, not in bits)."""
    data = data.to_device(resolve_device(device))
    X = _matrix_X(data)
    vals = X.data if isinstance(X, SparseCells) else X
    counts = torch.floor(vals.to(torch.float32))
    totals = counts.sum(dim=1)
    p = torch.clamp(target_total / torch.clamp(totals, min=1e-12), max=1.0)
    gen = torch.Generator(device=counts.device).manual_seed(seed)
    drawn = torch.binomial(counts, p[:, None].expand_as(counts).contiguous(),
                           generator=gen)
    new = torch.where((p < 1.0)[:, None], drawn, counts).to(vals.dtype)
    if isinstance(X, SparseCells):
        ind = torch.where(new == 0, X.sentinel, X.indices).to(
            X.indices.dtype)
        return data.with_X(SparseCells(ind, new, X.n_cells, X.n_genes))
    return data.with_X(new)
