"""``integrate.ingest`` — map query cells onto a reference atlas.

Counterpart of ``sctools_tpu/ops/ingest.py`` (scanpy's ``tl.ingest``):
nothing is fitted on the query.  It is projected into the reference's
fitted PCA space, ``(Xq − μ) @ PCs`` (one ``spmm`` for a sparse X, the
mean entering as the rank-1 term ``μ @ PCs``), each query cell's k
nearest reference cells are found there (``knn_arrays``: one
``knn_select`` launch on the card), and then

* categorical ``obs`` columns are transferred by inverse-distance
  weighted majority vote (with a ``<col>_confidence`` column),
* numeric ``obs`` columns and reference ``obsm`` embeddings (e.g.
  ``X_umap``) by inverse-distance weighted averaging.

The votes and averages are host numpy on the fetched (n_query, k)
neighbours.  The query must be preprocessed as the reference was, in
the same gene space: gene names that do not match are refused.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import resolve_device, true_f32
from ..data.dataset import CellData
from ..data.sparse import SparseCells, spmm
from ..registry import register
from .graph import _host
from .knn import knn_arrays
from .qc import _matrix_X


def _weights(dist: np.ndarray, eps: float = 1e-12) -> np.ndarray:
    """Inverse-distance weights, rows normalised to 1; an exact hit
    (distance 0) takes its row's mass through the ``eps`` floor."""
    w = 1.0 / np.maximum(dist.astype(np.float64), eps)
    return w / w.sum(axis=1, keepdims=True)


def _transfer(ref_obs, ref_obsm, obs, embeddings, idx, dist, n_query):
    """Votes and averages on the host from the fetched neighbours."""
    idx = np.asarray(idx)[:n_query]
    dist = np.asarray(dist)[:n_query]
    w = _weights(dist)
    new_obs: dict = {}
    for col in obs:
        if col not in ref_obs:
            raise KeyError(f"ingest: obs column {col!r} not in reference")
        vals = _host(ref_obs[col])
        if vals.dtype.kind in "ifu":
            new_obs[col] = (w * vals[idx].astype(np.float64)).sum(axis=1)
        else:
            levels, codes = np.unique(vals, return_inverse=True)
            votes = np.zeros((len(idx), len(levels)), np.float64)
            rows = np.repeat(np.arange(len(idx)), idx.shape[1])
            np.add.at(votes, (rows, codes[idx].ravel()), w.ravel())
            win = votes.argmax(axis=1)
            new_obs[col] = levels[win]
            new_obs[f"{col}_confidence"] = votes[np.arange(len(idx)), win]
    new_obsm: dict = {}
    for emb in embeddings:
        # only what the reference has; X_pca comes from the projection,
        # never from the neighbours
        if emb not in ref_obsm or emb == "X_pca":
            continue
        E = _host(ref_obsm[emb])
        new_obsm[emb] = np.einsum("qk,qkd->qd", w, E[idx])
    return new_obs, new_obsm


def _check(query: CellData, ref: CellData):
    if query.n_genes != ref.n_genes:
        raise ValueError(
            f"ingest: query has {query.n_genes} genes but reference has "
            f"{ref.n_genes} — align var spaces first (same contract as "
            "scanpy tl.ingest)")
    qn, rn = query.var.get("gene_name"), ref.var.get("gene_name")
    if qn is not None and rn is not None:
        qn, rn = _host(qn), _host(rn)
        if qn.shape == rn.shape and not (qn == rn).all():
            bad = int(np.argmin(qn == rn))
            raise ValueError(
                "ingest: query/reference gene names differ (first "
                f"mismatch at {bad}: {qn[bad]!r} vs {rn[bad]!r}) — a "
                "same-width projection onto mismatched loadings would "
                "transfer confidently-wrong labels")
    if "PCs" not in ref.varm or "X_pca" not in ref.obsm:
        raise ValueError(
            "ingest: reference needs varm['PCs'] + obsm['X_pca'] — run "
            "pca.randomized on it first")


def _as_tensor(v, dev) -> torch.Tensor:
    if not isinstance(v, torch.Tensor):
        v = torch.from_numpy(np.asarray(v, np.float32))
    return v.to(device=dev, dtype=torch.float32)


@register("integrate.ingest")
def ingest(query: CellData, *, ref: CellData, obs: tuple | list = (),
           embeddings=("X_umap",), k: int = 15, metric: str = "cosine",
           refine: int = 64, device=None) -> CellData:
    """Returns ``query`` with the transferred obs columns (categoricals
    add ``<col>_confidence``), obsm ``X_pca`` in the reference's space
    (n_cells rows) and the requested reference embeddings
    interpolated.  The search takes ``max(k, refine)`` candidates and
    re-ranks them exactly in float32."""
    dev = resolve_device(device)
    _check(query, ref)
    query = query.to_device(dev)
    PCs = _as_tensor(ref.varm["PCs"], dev)
    mu = _as_tensor(ref.uns.get("pca_mean", np.zeros(ref.n_genes)), dev)
    Xq = _matrix_X(query)
    with true_f32():
        if isinstance(Xq, SparseCells):
            scores = spmm(Xq, PCs) - (mu @ PCs)[None, :]
            scores = torch.where(Xq.row_mask()[:, None], scores, 0.0)
        else:
            scores = (Xq.float() - mu[None, :]) @ PCs
    n_q = query.n_cells
    idx, dist = knn_arrays(scores, _as_tensor(ref.obsm["X_pca"], dev), k=k,
                           metric=metric, n_query=n_q, n_cand=ref.n_cells,
                           refine=refine)
    new_obs, new_obsm = _transfer(ref.obs, ref.obsm, obs, embeddings,
                                  idx.cpu().numpy(), dist.cpu().numpy(),
                                  n_q)
    out = query.with_obsm(X_pca=scores[:n_q], **new_obsm)
    return out.with_obs(**new_obs)
