"""Normalisation transforms: ``normalize.library_size`` and
``normalize.log1p``.

Counterpart of ``sctools_tpu/ops/normalize.py``: per-row rescaling of
the padded-ELL values, in float32.
"""

from __future__ import annotations

import torch

from ..config import resolve_device
from ..data.dataset import CellData
from ..data.sparse import SparseCells, row_sum, segment_reduce
from ..registry import register
from .qc import _sparse_X


def _median(values: torch.Tensor) -> torch.Tensor:
    """Median as numpy/jnp define it: the mean of the two middle values
    for an even count (``torch.median`` returns the lower one)."""
    s = torch.sort(values).values
    n = s.shape[0]
    return (s[(n - 1) // 2] + s[n // 2]) / 2


def _target(totals: torch.Tensor, x: SparseCells, target_sum):
    if target_sum is None:
        return _median(totals[: x.n_cells])
    return torch.tensor(target_sum, dtype=x.data.dtype, device=x.device)


def _library_size_sparse(x: SparseCells, target_sum):
    """Per-shard library-size normalisation of the streamed passes
    (``data/stream.py``): the rows of ``x`` scaled to ``target_sum``
    (the median of the valid rows' totals when ``None``), and the
    totals.  Counterpart of the reference's ``_library_size_sparse``."""
    totals = row_sum(x)
    target = _target(totals, x, target_sum)
    scale = torch.where(totals > 0, target / torch.clamp(totals, min=1e-12),
                        0.0)
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
    X = _sparse_X(data)
    totals = row_sum(X)
    he = None
    if exclude_highly_expressed:
        he = _he_gene_flag(X, totals, max_fraction)
        table = torch.cat([he.to(X.data.dtype),
                           torch.zeros((1,), dtype=X.data.dtype,
                                       device=X.device)])
        totals = totals - (X.data * table[X.indices.long()]).sum(dim=1)
    target = _target(totals, X, target_sum)
    scale = torch.where(totals > 0, target / torch.clamp(totals, min=1e-12),
                        0.0)
    out = data.with_X(X.with_data(X.data * scale[:, None])).with_obs(
        library_size=totals)
    if he is not None:
        out = out.with_var(highly_expressed=he)
    return out


@register("normalize.log1p", fusable=True, mask_aware=True)
def log1p(data: CellData, device=None) -> CellData:
    """``x -> log(1 + x)`` on the stored values (log1p(0) == 0, so the
    sparsity pattern is kept)."""
    data = data.to_device(resolve_device(device))
    X = _sparse_X(data)
    return data.with_X(X.with_data(torch.log1p(X.data)))
