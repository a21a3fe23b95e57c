"""Synthetic single-cell data for tests and the chip smoke run.

numpy-only copies of ``sctools_tpu/data/synthetic.py``'s
``synthetic_counts`` and ``gaussian_blobs``: the same seed gives the
same counts and points in both packages.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from .dataset import CellData


def synthetic_counts(n_cells: int, n_genes: int, *, density: float = 0.05,
                     n_clusters: int = 1, mito_frac: float = 0.01,
                     seed: int = 0, dtype=np.float32) -> CellData:
    """Host-side CellData with scipy CSR counts and gene names:
    lognormal per-gene rates, ``n_clusters`` gene programs, per-cell
    library-size variation, ``mito_frac`` of genes named ``MT-*``.
    ``density`` is the expected nnz fraction per cell."""
    rng = np.random.default_rng(seed)
    n_mito = max(1, int(n_genes * mito_frac)) if mito_frac > 0 else 0

    base = rng.lognormal(mean=0.0, sigma=1.5, size=n_genes)
    programs = np.tile(base, (n_clusters, 1))
    for c in range(1, n_clusters):
        boost = rng.choice(n_genes, size=max(1, n_genes // 20), replace=False)
        programs[c, boost] *= rng.uniform(3.0, 10.0, size=len(boost))
    programs /= programs.sum(axis=1, keepdims=True)

    labels = rng.integers(0, n_clusters, size=n_cells)
    lib = rng.lognormal(mean=0.0, sigma=0.4, size=n_cells)
    cdfs = np.cumsum(programs, axis=1)

    target_nnz = int(density * n_genes)
    rows, cols, vals = [], [], []
    chunk = max(1, min(n_cells, 200_000_000 // max(target_nnz, 1) // 8))
    for start in range(0, n_cells, chunk):
        stop = min(n_cells, start + chunk)
        nnz = np.maximum(
            1, rng.poisson(target_nnz * lib[start:stop])).astype(np.int64)
        nnz = np.minimum(nnz, n_genes)
        total = int(nnz.sum())
        row_idx = np.repeat(np.arange(start, stop), nnz)
        # gene ids per draw from the cell's cluster program: one
        # searchsorted per cluster, no per-cell loop
        draw_cluster = labels[row_idx]
        u = rng.random(total)
        gene_idx = np.empty(total, dtype=np.int32)
        for c in range(n_clusters):
            sel = draw_cluster == c
            gene_idx[sel] = np.searchsorted(cdfs[c], u[sel])
        gene_idx = np.clip(gene_idx, 0, n_genes - 1)
        count = rng.geometric(0.4, size=total).astype(dtype)
        rows.append(row_idx)
        cols.append(gene_idx)
        vals.append(count)

    coo = sp.coo_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
        shape=(n_cells, n_genes))
    coo.sum_duplicates()
    gene_names = np.array(
        [f"MT-{i}" if i < n_mito else f"GENE{i}" for i in range(n_genes)])
    return CellData(
        coo.tocsr(),
        obs={"cluster_true": labels.astype(np.int32)},
        var={"gene_name": gene_names, "mito": np.arange(n_genes) < n_mito},
    )


def gaussian_blobs(n_points: int, dim: int, n_clusters: int = 5, *,
                   spread: float = 0.2, seed: int = 0, dtype=np.float32):
    """Dense clustered points for kNN tests: (points (n, dim), labels
    (n,))."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_clusters, dim)).astype(dtype)
    labels = rng.integers(0, n_clusters, size=n_points)
    pts = centers[labels] + spread * rng.normal(
        size=(n_points, dim)).astype(dtype)
    return pts.astype(dtype), labels.astype(np.int32)
