"""``da.neighborhoods``: Milo-style differential abundance.

Counterpart of ``sctools_tpu/ops/abundance.py`` (the Milo recipe, Dann
et al. 2022): a neighbourhood is an index cell's kNN set plus itself.

* ``sample_key=None`` (no replicates): a binomial normal approximation
  of each neighbourhood's condition fraction against the global
  proportion, BH-corrected (composition-shift calls, not
  replicate-backed inference).
* ``sample_key=`` (replicates): per-sample neighbourhood counts,
  depth-normalised to frequencies, and a Welch t-test across the
  replicates of the two conditions (≥ 2 samples each, each sample in
  one condition): the quasi-likelihood analogue of Milo's NB GLM.

The counts run on the device: each is a gather of 0/1 cell flags over
the edge list, with the index cell as its first column, summed over the
row, one flag pass a sample, so memory stays O(n·k).  Counts are exact
integers in float32.  ``prop=`` samples index cells with a host
``numpy.random.default_rng(seed)``.  The tests, BH and the log fold
changes are host numpy/scipy in float64, as in the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import resolve_device
from ..data.dataset import CellData
from ..registry import register
from .graph import _host


def nbhd_counts(idx: torch.Tensor, flags: torch.Tensor) -> torch.Tensor:
    """Each row's count of flagged cells among its ids ``idx`` (rows,
    m) (-1 slots ignored): ``flags`` (n,) 0/1; float32 on idx's
    device.  The caller puts the index cell in the first column."""
    safe = torch.where(idx < 0, 0, idx).long()
    f = flags.float()
    return torch.where(idx >= 0, f[safe], 0.0).sum(dim=1)


def _nbhd_sample_counts(idx: torch.Tensor, codes: np.ndarray, S: int
                        ) -> np.ndarray:
    """(rows, S) float64: each row's neighbourhood count per sample
    code, one flag pass a sample."""
    codes_t = torch.from_numpy(np.asarray(codes)).to(idx.device)
    cols = [_host(nbhd_counts(idx, codes_t == s)) for s in range(S)]
    return np.stack(cols, axis=1).astype(np.float64)


def _expand(vals, index_cells: np.ndarray, n: int) -> np.ndarray:
    """Per-index-cell results as (n,) float32, NaN for the other cells
    (Milo's convention: they have no neighbourhood)."""
    if len(index_cells) == n:
        return np.asarray(vals, np.float32)
    out = np.full(n, np.nan, np.float32)
    out[index_cells] = vals
    return out


def _bh_fdr(pvals: np.ndarray) -> np.ndarray:
    order = np.argsort(pvals)
    q = pvals[order] * len(pvals) / np.arange(1, len(pvals) + 1)
    q = np.minimum.accumulate(q[::-1])[::-1]
    fdr = np.empty_like(q)
    fdr[order] = np.clip(q, 0, 1)
    return fdr


def _replicate_test(idx: torch.Tensor, cond, samples, a, b):
    """Welch t-test across per-sample neighbourhood frequencies (the
    replicate-aware mode)."""
    from scipy import stats as sps

    slevels, scodes = np.unique(samples, return_inverse=True)
    S = len(slevels)
    samp_cond = np.empty(S, dtype=object)
    for si, s in enumerate(slevels):
        cs = set(cond[samples == s].tolist())
        if len(cs) != 1:
            raise ValueError(
                f"da.neighborhoods: sample {s!r} spans conditions "
                f"{sorted(cs)}; each sample must belong to exactly one")
        samp_cond[si] = cs.pop()
    in_a = samp_cond == a
    in_b = samp_cond == b
    if in_a.sum() < 2 or in_b.sum() < 2:
        raise ValueError(
            f"da.neighborhoods: replicate-aware test needs >=2 samples "
            f"per condition (got {int(in_a.sum())} {a!r} / "
            f"{int(in_b.sum())} {b!r}); omit sample_key= for the "
            f"closed-form composition test")
    C = _nbhd_sample_counts(idx, scodes, S)
    Ns = np.bincount(scodes, minlength=S).astype(np.float64)
    R = C / np.maximum(Ns[None, :], 1.0)
    ra, rb = R[:, in_a], R[:, in_b]
    na_s, nb_s = int(in_a.sum()), int(in_b.sum())
    ma, mb = ra.mean(axis=1), rb.mean(axis=1)
    va = ra.var(axis=1, ddof=1) / na_s
    vb = rb.var(axis=1, ddof=1) / nb_s
    se = np.sqrt(np.maximum(va + vb, 1e-24))
    t = (ma - mb) / se
    # Welch–Satterthwaite df; zero-variance neighbourhoods take the
    # pooled df
    denom = (va**2 / max(na_s - 1, 1) + vb**2 / max(nb_s - 1, 1))
    df = np.where(denom > 0, (va + vb) ** 2 / np.maximum(denom, 1e-300),
                  na_s + nb_s - 2)
    df = np.clip(df, 1.0, None)
    pvals = 2.0 * sps.t.sf(np.abs(t), df)
    eps = 0.5 / max(Ns.mean(), 1.0)  # half-cell pseudo-frequency
    lfc = np.log2((ma + eps) / (mb + eps))
    return t, pvals, lfc, slevels


@register("da.neighborhoods")
def neighborhoods(data: CellData, condition_key: str = "condition",
                  groups=None, sample_key: str | None = None,
                  prop: float = 1.0, seed: int = 0, device=None
                  ) -> CellData:
    """Adds obs ``da_score`` (signed z or Welch t, + = enriched for the
    first level), ``da_fdr`` and ``da_logfc`` (float32, NaN off the
    index cells), uns ``da_conditions``, ``da_method`` and
    ``da_index_cells`` (and ``da_samples`` with ``sample_key``).
    ``prop < 1`` samples that share of the cells as index cells.
    Requires ``neighbors.knn``."""
    dev = resolve_device(device)
    data = data.to_device(dev)
    n = data.n_cells
    if "knn_indices" not in data.obsp:
        raise KeyError("da.neighborhoods: run neighbors.knn first")
    if condition_key not in data.obs:
        raise KeyError(f"da.neighborhoods: obs has no {condition_key!r}")
    cond = _host(data.obs[condition_key]).astype(str)[:n]
    levels = sorted(set(cond.tolist())) if groups is None else list(groups)
    if len(levels) != 2:
        raise ValueError(
            f"da.neighborhoods compares exactly 2 condition levels, "
            f"got {levels}")
    a, b = levels
    if not (0.0 < prop <= 1.0):
        raise ValueError(f"da.neighborhoods: prop={prop} not in (0, 1]")
    idx = data.obsp["knn_indices"][:n]
    index_cells = np.arange(n)
    if prop < 1.0:
        rng = np.random.default_rng(seed)
        n_idx = max(int(round(prop * n)), 2)
        index_cells = np.sort(rng.choice(n, size=n_idx, replace=False))
        idx = idx[torch.from_numpy(index_cells).to(dev)]
    # the neighbourhood: the index cell, then its kNN set
    idx = torch.cat([torch.from_numpy(index_cells).to(dev, idx.dtype)[:,
                                                                      None],
                     idx], dim=1)

    if sample_key is not None:
        if sample_key not in data.obs:
            raise KeyError(
                f"da.neighborhoods: obs has no {sample_key!r}")
        samples = _host(data.obs[sample_key]).astype(str)[:n]
        score, pvals, lfc, slevels = _replicate_test(idx, cond, samples, a,
                                                     b)
        fdr, method = _bh_fdr(pvals), "replicate-welch"
        extra = {"da_samples": [str(s) for s in slevels]}
    else:
        from scipy import stats as sps

        in_a = torch.from_numpy(cond == a).to(dev)
        in_b = torch.from_numpy(cond == b).to(dev)
        na = _host(nbhd_counts(idx, in_a)).astype(np.float64)
        nb = _host(nbhd_counts(idx, in_b)).astype(np.float64)
        tot = na + nb
        p0 = float((cond == a).sum()) / max(len(cond), 1)
        se = np.sqrt(np.maximum(tot * p0 * (1 - p0), 1e-12))
        score = (na - tot * p0) / se
        fdr = _bh_fdr(2.0 * sps.norm.sf(np.abs(score)))
        lfc = np.log2((na + 0.5) / (nb + 0.5)
                      / (p0 / max(1 - p0, 1e-12)))
        method, extra = "binomial-global", {}

    def col(v):
        return torch.from_numpy(_expand(v, index_cells, n)).to(dev)

    return data.with_obs(
        da_score=col(score), da_fdr=col(fdr), da_logfc=col(lfc)).with_uns(
        da_conditions=[a, b], da_method=method,
        da_index_cells=index_cells.astype(np.int64), **extra)
