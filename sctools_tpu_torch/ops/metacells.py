"""``metacells.seacells`` and ``metacells.aggregate``: SEACells-style
metacells by kernel archetypal analysis on the kNN kernel.

Counterpart of ``sctools_tpu/ops/metacells.py``.  Archetypes B (convex
combinations of cells) and assignments A (convex combinations of
archetypes) minimise ‖K − K·B·A‖²_F by Frank–Wolfe steps on the
probability simplex.  The n×n kernel K never exists: it is the
symmetrised kNN edge list, and every product with it is a k-sparse
``knn_matvec`` (K·V) or ``knn_rmatvec`` (Kᵀ·V) — the ``graph_matvec``
and ``graph_rmatvec`` kernels on the card.  Per round

    ∇_A = 2·(CᵀC)·A − 2·CᵀK          with C = K·B   (n × m)
    ∇_B = 2·KᵀK·B·(AAᵀ) − 2·KᵀK·Aᵀ

where the m × m products are dense ``torch.matmul`` in true float32
(TF32 moves the argmins).  The seeds are max–min (farthest-point)
samples of the embedding.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import resolve_device, true_f32
from ..data.dataset import CellData
from ..data.sparse import _ROW_CHUNK, SparseCells, _row_chunks
from ..registry import register
from . import graph_kernels
from .graph import (_require_knn, _symmetrized_weights, connectivities,
                    knn_matvec, knn_rmatvec)


def maxmin_sample(points, m: int, seed: int = 0) -> np.ndarray:
    """Farthest-point sampling of ``m`` row indices of ``points`` (n, d),
    in float64 on the points' device: the first index is numpy's
    ``default_rng(seed).integers(n)`` and each next one the first row
    farthest from those chosen, as the reference's host loop draws
    them."""
    pts = torch.as_tensor(points).to(torch.float64)
    n = pts.shape[0]
    first = int(np.random.default_rng(seed).integers(n))
    chosen = torch.empty(m, dtype=torch.int64, device=pts.device)
    chosen[0] = first
    dmin = torch.linalg.vector_norm(pts - pts[first], dim=1)
    for i in range(1, m):
        nxt = torch.argmax(dmin)  # the first maximum
        chosen[i] = nxt
        dmin = torch.minimum(dmin, torch.linalg.vector_norm(
            pts - pts.index_select(0, nxt.reshape(1)), dim=1))
    return chosen.cpu().numpy()


def _one_hot_cols(ids: torch.Tensor, rows: int) -> torch.Tensor:
    """(rows, len(ids)) float32 with a 1 at (ids[j], j)."""
    out = torch.zeros((rows, len(ids)), dtype=torch.float32,
                      device=ids.device)
    out[ids, torch.arange(len(ids), device=ids.device)] = 1.0
    return out


def seacells_arrays(knn_idx: torch.Tensor, kernel_w: torch.Tensor,
                    init_idx, n_iter: int = 50):
    """Kernel archetypal analysis on the kNN kernel: ``knn_idx`` and
    ``kernel_w`` (n, k) the symmetric kernel's edge list, ``init_idx``
    (m,) the seed cells.  Returns ``(A (m, n), B (n, m))``, both
    column-stochastic.  Launches ``matvec`` 1 + 3·n_iter and ``rmatvec``
    3·n_iter times; the destination order of the edge list is built
    once for all of them."""
    n = knn_idx.shape[0]
    dev = knn_idx.device
    init = torch.as_tensor(np.asarray(init_idx), dtype=torch.int64,
                           device=dev)
    m = len(init)
    order = graph_kernels.rmatvec_order(knn_idx, n)

    def Kmat(V):  # K @ V
        return knn_matvec(knn_idx, kernel_w, V)

    def KTmat(V):  # Kᵀ @ V
        return knn_rmatvec(knn_idx, kernel_w, V, n, order=order)

    cols = torch.arange(m, device=dev)
    with true_f32():
        B = _one_hot_cols(init, n)
        # each cell to its most similar archetype (one kernel hop)
        A = _one_hot_cols(torch.argmax(Kmat(B), dim=1), m)
        for t in range(n_iter):
            # the reference's float32 step size and its complement
            gamma = np.float32(2.0) / np.float32(t + 2.0)
            keep = float(np.float32(1.0) - gamma)
            gamma = float(gamma)
            # A: columns = cells, simplex over archetypes
            C = Kmat(B)
            gA = 2.0 * ((C.T @ C) @ A) - 2.0 * KTmat(C).T
            A = keep * A + gamma * _one_hot_cols(torch.argmin(gA, dim=0), m)
            # B: columns = archetypes, simplex over cells
            KtKB = KTmat(Kmat(B))
            KtKAt = KTmat(Kmat(A.T))
            gB = 2.0 * (KtKB @ (A @ A.T)) - 2.0 * KtKAt
            eB = torch.zeros_like(B)
            eB[torch.argmin(gB, dim=0), cols] = 1.0
            B = keep * B + gamma * eB
    return A, B


def _sym_kernel(data: CellData, device=None):
    """The symmetrised (averaged) connectivities as the kernel edge
    list: ``(data, knn_idx, w)``, connectivities computed first if
    missing."""
    if "connectivities" not in data.obsp:
        data = connectivities(data, device=device)
    n = data.n_cells
    idx, _ = _require_knn(data)
    w = _symmetrized_weights(idx, data.obsp["connectivities"][:n])
    return data, idx, w


def _attach_metacells(data: CellData, A, B, init_idx) -> CellData:
    labels = torch.argmax(A, dim=0).to(torch.int32)
    return data.with_obs(metacell=labels).with_uns(
        seacells_A=A, seacells_B=B,
        seacells_seed_cells=np.asarray(init_idx))


@register("metacells.seacells")
def seacells(data: CellData, n_metacells: int | None = None,
             n_iter: int = 50, use_rep: str = "X_pca", seed: int = 0,
             device=None) -> CellData:
    """Adds obs ``metacell`` (int32 hard assignment: the archetype of
    largest weight in A) and uns ``seacells_A`` (m, n), ``seacells_B``
    (n, m) and ``seacells_seed_cells``.  Requires ``neighbors.knn``;
    ``n_metacells`` defaults to round(n/75) (at least 2), the SEACells
    rule of thumb."""
    data = data.to_device(resolve_device(device))
    n = data.n_cells
    if n_metacells is None:
        n_metacells = max(2, int(round(n / 75)))
    data, idx, w = _sym_kernel(data, device=device)
    init_idx = maxmin_sample(data.obsm[use_rep][:n], n_metacells, seed=seed)
    A, B = seacells_arrays(idx, w, init_idx, n_iter=n_iter)
    return _attach_metacells(data, A, B, init_idx)


@register("metacells.aggregate")
def aggregate(data: CellData, key: str = "metacell", device=None
              ) -> CellData:
    """Sum the counts of each metacell: uns ``metacell_counts``
    (n_metacells, n_genes) float32 and ``metacell_sizes``
    (n_metacells,) float32.  X is ``SparseCells`` or a dense matrix
    (``index_add_`` over the cells).

    For ``SparseCells`` the reference multiplies by a one-hot,
    ``spmm_t(X, onehot)ᵀ`` with onehot (rows_padded, n_metacells); here
    the same sum is a segment sum of the ELL slots keyed by (metacell,
    gene), which skips the one-hot's zeros (n_metacells times less
    work); padding rows and sentinel slots land in dropped bins."""
    if key not in data.obs:
        raise ValueError(f"run metacells.seacells first ({key!r} missing)")
    data = data.to_device(resolve_device(device))
    n = data.n_cells
    labels = data.obs[key][:n].long()
    m = int(labels.max()) + 1
    X = data.X
    if isinstance(X, SparseCells):
        G1 = X.n_genes + 1  # + the sentinel column
        # padding rows go to the dropped metacell m
        row_label = torch.full((X.rows_padded,), m, dtype=torch.int64,
                               device=X.device)
        row_label[:n] = labels
        flat = torch.zeros((m + 1) * G1, dtype=torch.float32,
                           device=X.device)
        for r0, ind, dat in _row_chunks(X, _ROW_CHUNK):
            slot = row_label[r0:r0 + ind.shape[0], None] * G1 + ind
            flat.index_add_(0, slot.reshape(-1), dat.reshape(-1).float())
        counts = flat.reshape(m + 1, G1)[:m, :X.n_genes].contiguous()
    else:
        counts = torch.zeros((m, X.shape[1]), dtype=torch.float32,
                             device=X.device).index_add_(
            0, labels, X[:n].float())
    sizes = torch.zeros(m, dtype=torch.float32, device=labels.device
                        ).index_add_(0, labels, torch.ones(
                            n, dtype=torch.float32, device=labels.device))
    return data.with_uns(metacell_counts=counts, metacell_sizes=sizes)
