"""Gene-set scores: ``score.genes`` and ``score.cell_cycle``.

Counterpart of ``sctools_tpu/ops/score.py`` (scanpy's
``tl.score_genes`` / ``tl.score_genes_cell_cycle``): a cell's score is
its mean expression over the gene set minus its mean over control genes
drawn from the set's expression bins (Satija et al. 2015).  Both means
are one ``X @ w`` product with a (n_genes, 2) weight table (``spmm`` on
a sparse X), so the op is one pass over the data whatever the set's
size.  The control draw is host numpy on the per-gene means (from the
fixed-order ``gene_stats``) with ``np.random.default_rng(seed)``, so
one seed draws the reference's control genes.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from ..config import resolve_device, true_f32
from ..data.dataset import CellData
from ..data.sparse import SparseCells, gene_stats, spmm
from ..registry import register
from .graph import _host
from .qc import _matrix_X


def _resolve_gene_indices(data: CellData, genes) -> np.ndarray:
    """Gene list -> integer indices; names resolved through
    ``var["gene_name"]`` (missing names warned about and ignored)."""
    genes = np.asarray(genes)
    if genes.dtype.kind in "iu":
        return genes.astype(np.int64)
    if "gene_name" not in data.var:
        raise KeyError("score.genes: gene names given but var has no "
                       "'gene_name' column")
    names = _host(data.var["gene_name"]).astype(str)
    lut = {n: i for i, n in enumerate(names)}
    wanted = genes.astype(str)
    idx = [lut[g] for g in wanted if g in lut]
    missing = [g for g in wanted if g not in lut]
    if not idx:
        raise ValueError("score.genes: none of the given genes found in "
                         "var['gene_name']")
    if missing:
        warnings.warn(
            f"score.genes: {len(missing)}/{len(wanted)} genes not in "
            f"var['gene_name'] and ignored (e.g. {missing[:5]})",
            stacklevel=3)
    return np.asarray(idx, np.int64)


def _gene_means_host(X) -> np.ndarray:
    """Per-gene mean expression on the host (for the control bins)."""
    if isinstance(X, SparseCells):
        return _host(gene_stats(X)[0]) / X.n_cells
    return _host(X).mean(axis=0)  # numpy's sum order, as the reference


def _control_indices(gene_means, target_idx, ctrl_size, n_bins, seed):
    """Expression-matched control genes: bin all genes by the rank of
    their mean, then for each bin holding a target gene draw
    ``ctrl_size`` genes of it (targets excluded)."""
    rng = np.random.default_rng(seed)
    n_genes = gene_means.shape[0]
    order = np.argsort(gene_means)
    bin_of = np.empty(n_genes, np.int64)
    bin_of[order] = np.arange(n_genes) * n_bins // n_genes
    target_set = np.zeros(n_genes, bool)
    target_set[target_idx] = True
    ctrl = []
    for b in np.unique(bin_of[target_idx]):
        pool = np.where((bin_of == b) & ~target_set)[0]
        if len(pool) == 0:
            continue
        take = min(ctrl_size, len(pool))
        ctrl.append(rng.choice(pool, size=take, replace=False))
    if not ctrl:
        raise ValueError("score.genes: control pool is empty")
    return np.unique(np.concatenate(ctrl))


def _score_weights(n_genes, target_idx, ctrl_idx):
    """(n_genes, 2) weights: column 0 averages the target set, column 1
    the controls; score = X @ w[:, 0] − X @ w[:, 1]."""
    w = np.zeros((n_genes, 2), np.float32)
    w[target_idx, 0] = 1.0 / len(target_idx)
    w[ctrl_idx, 1] = 1.0 / len(ctrl_idx)
    return w


@register("score.genes")
def score_genes(data: CellData, genes=None, score_name: str = "score",
                ctrl_size: int = 50, n_bins: int = 25, seed: int = 0,
                device=None) -> CellData:
    """Per-cell gene-set score, mean(set) − mean(expression-matched
    controls), in ``obs[score_name]`` (float32, rows_padded long for a
    sparse X).  ``genes``: ids, or names looked up in
    ``var["gene_name"]``."""
    dev = resolve_device(device)
    if genes is None:
        raise ValueError("score.genes needs a gene list")
    data = data.to_device(dev)
    X = _matrix_X(data)
    target_idx = _resolve_gene_indices(data, genes)
    ctrl_idx = _control_indices(_gene_means_host(X), target_idx, ctrl_size,
                                n_bins, seed)
    w = torch.from_numpy(_score_weights(data.n_genes, target_idx,
                                        ctrl_idx)).to(dev)
    if isinstance(X, SparseCells):
        both = spmm(X, w)  # (rows_padded, 2)
    else:
        with true_f32():
            both = X.float() @ w
    return data.with_obs(**{score_name: both[:, 0] - both[:, 1]})


@register("score.cell_cycle")
def cell_cycle(data: CellData, s_genes=None, g2m_genes=None, seed: int = 0,
               device=None) -> CellData:
    """S and G2M scores and the phase call (scanpy's
    ``score_genes_cell_cycle``): ``obs["S_score"]``, ``obs["G2M_score"]``
    and ``obs["phase"]`` in {G1, S, G2M} ("" on padding rows)."""
    dev = resolve_device(device)
    if s_genes is None or g2m_genes is None:
        raise ValueError("score.cell_cycle needs s_genes and g2m_genes")
    data = score_genes(data, genes=s_genes, score_name="S_score", seed=seed,
                       device=dev)
    data = score_genes(data, genes=g2m_genes, score_name="G2M_score",
                       seed=seed + 1, device=dev)
    s = _host(data.obs["S_score"])
    g2m = _host(data.obs["G2M_score"])
    phase = np.where((s <= 0) & (g2m <= 0), "G1",
                     np.where(s > g2m, "S", "G2M"))
    phase[data.n_cells:] = ""
    return data.with_obs(phase=phase)
