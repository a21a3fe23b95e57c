"""PCA: ``pca.randomized`` (Halko randomized SVD) and ``pca.exact``
(a full SVD, for small data).

Counterpart of ``sctools_tpu/ops/pca.py``.  The large products are the
two sparse primitives (``spmm``, ``spmm_t``), or two true-float32
matrix products for a dense X; the factorizations of the (n × L) and
(L × G) sketches are small.  Mean-centering never densifies X — it
enters as a rank-1 correction:

    (X - 1 μᵀ) Ω  = X Ω - 1 (μᵀ Ω)
    (X - 1 μᵀ)ᵀ Q = Xᵀ Q - μ (1ᵀ Q)

The reference draws its sketch with ``jax.random`` (threefry), which
torch cannot reproduce: ``omega=`` takes a given sketch (see
``carry.pca_omega_from_numpy``), and without it the sketch comes from a
``torch.Generator`` seeded with ``seed``.
"""

from __future__ import annotations

import warnings

import torch

from ..config import resolve_device, true_f32
from ..data.dataset import SHARDED_TODO, CellData
from ..data.sharded import ShardedRows, reduce_sum, valid_blocks
from ..data.sparse import SparseCells, gene_sum, spmm, spmm_t
from ..registry import register
from .qc import _dense_X, _matrix_X


def _center_matvec(X, mu, V, n_valid: int | None = None):
    """(X - 1 μᵀ) @ V, with the padding rows forced to zero: a sparse
    X's past its ``n_cells``, a dense X's past ``n_valid`` (None: it
    has none)."""
    if isinstance(X, SparseCells):
        out = spmm(X, V) - (mu @ V)[None, :]
        return torch.where(X.row_mask()[:, None], out, 0.0)
    out = X @ V - (mu @ V)[None, :]
    if n_valid is not None:
        out[n_valid:] = 0.0
    return out


def _center_rmatvec(X, mu, Q):
    """(X - 1 μᵀ)ᵀ @ Q; the padded rows of Q are zero."""
    if isinstance(X, SparseCells):
        colsum = torch.where(X.row_mask()[:, None], Q, 0.0).sum(dim=0)
        return spmm_t(X, Q) - torch.outer(mu, colsum)
    return X.T @ Q - torch.outer(mu, Q.sum(dim=0))


def cholesky_qr_blocks(blocks: list, device, iters: int = 2) -> list:
    """CholeskyQR2 of a matrix whose row blocks ``blocks`` may lie on
    several devices: the Gram matrix is the mesh-order sum
    (``reduce_sum``) of the blocks' ``Q_dᵀ Q_d`` on ``device``, the only
    cross-row reduction, and ``Q_d ← Q_d R⁻¹`` runs on each block's
    device.  Products in true float32.  Returns the new blocks, in
    order."""
    with true_f32():
        for _ in range(iters):
            G = reduce_sum([b.T @ b for b in blocks], device)
            L = G.shape[0]
            G = G + 1e-7 * torch.trace(G) / L * torch.eye(
                L, dtype=G.dtype, device=G.device)
            R = torch.linalg.cholesky(G, upper=True)
            blocks = [torch.linalg.solve_triangular(
                R.to(b.device), b, upper=True, left=False) for b in blocks]
    return blocks


def cholesky_qr(Y: torch.Tensor, iters: int = 2) -> torch.Tensor:
    """Orthonormalise the columns of ``Y`` by CholeskyQR2 (one block of
    :func:`cholesky_qr_blocks`)."""
    return cholesky_qr_blocks([Y], Y.device, iters)[0]


def _orthonormalize(blocks: list, device, method: str) -> list:
    if method == "cholesky":
        return cholesky_qr_blocks(blocks, device)
    if method == "householder":
        if len(blocks) > 1:
            raise NotImplementedError(
                f"pca.randomized(qr_method='householder'): {SHARDED_TODO}")
        with true_f32():
            return [torch.linalg.qr(blocks[0]).Q]
    raise ValueError(f"unknown qr_method {method!r}")


def _warn_width(n_components: int, n_cells: int, n_genes: int) -> None:
    lim = min(n_cells, n_genes)
    if n_components > lim:
        warnings.warn(
            f"pca.randomized: n_components={n_components} exceeds "
            f"min(n_cells, n_genes)={lim}; returning {lim} components",
            stacklevel=3)


def randomized_pca_arrays(X, n_components: int = 50,
                          oversample: int = 10, n_iter: int = 2,
                          center: bool = True, qr_method: str = "cholesky",
                          omega: torch.Tensor | None = None, seed: int = 0):
    """Randomized PCA of ``X``: padded-ELL or dense (n, G), or a
    ``ShardedRows`` of such row blocks on a mesh's devices (one matrix
    is one block).  Returns (scores, components (G, k), explained
    variance (k,), mean (G,)); the scores are (rows, k), ``rows`` being
    ``rows_padded`` for a sparse X, or for a ShardedRows one such block
    a device.

    The (n, L) iterate stays in row blocks: ``X_d Ω`` runs on block d's
    device, ``Xᵀ Q`` is the mesh-order sum of the blocks' ``X_dᵀ Q_d``
    on the first, and CholeskyQR2 reduces the blocks' Gram matrices
    (:func:`cholesky_qr_blocks`); ``qr_method="householder"`` takes one
    block.  ``omega`` (G, L) with ``L = min(n_components + oversample,
    G, n)`` is the sketch; without it a standard normal sketch is drawn
    from a ``torch.Generator`` seeded with ``seed`` on the first
    block's device."""
    blocks = list(X.blocks) if isinstance(X, ShardedRows) else [X]
    G, n = ((X.n_genes, X.n_cells)
            if isinstance(X, (SparseCells, ShardedRows))
            else (X.shape[1], X.shape[0]))
    # the valid rows of each dense block (a sparse block masks its own)
    valid = [X.valid_rows(d) if isinstance(X, ShardedRows) else None
             for d in range(len(blocks))]
    # a sketch wider than the matrix makes the Gram matrix singular
    L = min(n_components + oversample, G, n)
    k = min(n_components, L)
    dev = blocks[0].device
    if center:
        mu = reduce_sum([gene_sum(b) if isinstance(b, SparseCells)
                         else b.sum(dim=0) for b in valid_blocks(X)],
                        dev) / n
    else:
        mu = torch.zeros((G,), dtype=torch.float32, device=dev)
    if omega is None:
        gen = torch.Generator(device=dev).manual_seed(seed)
        omega = torch.randn((G, L), generator=gen, device=dev)
    else:
        if tuple(omega.shape) != (G, L):
            raise ValueError(
                f"omega has shape {tuple(omega.shape)}, expected {(G, L)}")
        omega = omega.to(device=dev, dtype=torch.float32)

    def matvec(V):
        return _orthonormalize(
            [_center_matvec(b, mu.to(b.device), V.to(b.device), v)
             for b, v in zip(blocks, valid)], dev, qr_method)

    def rmatvec(Q):
        return reduce_sum([_center_rmatvec(b, mu.to(b.device), q)
                           for b, q in zip(blocks, Q)], dev)

    with true_f32():
        Q = matvec(omega)
        for _ in range(n_iter):
            Q = matvec(_orthonormalize([rmatvec(Q)], dev, qr_method)[0])
        B = rmatvec(Q).T  # (L, G)
        U_b, S, Vt = torch.linalg.svd(B, full_matrices=False)
        W = U_b[:, :k]
        scores = [(q @ W.to(q.device)) * S[:k].to(q.device) for q in Q]
    scores = (ShardedRows(tuple(scores), X.mesh, n)
              if isinstance(X, ShardedRows) else scores[0])
    return scores, Vt[:k].T, (S[:k] ** 2) / max(n - 1, 1), mu


@register("pca.randomized", fusable=True, mem_cost=4.0, mask_aware=True)
def pca_randomized(data: CellData, n_components: int = 50,
                   oversample: int = 10, n_iter: int = 2,
                   center: bool = True, seed: int = 0,
                   qr_method: str = "cholesky", omega=None,
                   device=None) -> CellData:
    """Adds obsm ``X_pca``, varm ``PCs``, uns ``pca_explained_variance``
    and ``pca_mean``.  More components than min(n_cells, n_genes)
    returns the achievable width with a warning."""
    _warn_width(n_components, data.n_cells, data.n_genes)
    data = data.to_device(resolve_device(device))
    scores, comps, expl, mu = randomized_pca_arrays(
        _matrix_X(data), n_components=n_components, oversample=oversample,
        n_iter=n_iter, center=center, qr_method=qr_method,
        omega=None if omega is None else torch.as_tensor(omega),
        seed=seed)
    return data.with_obsm(X_pca=scores).with_varm(PCs=comps).with_uns(
        pca_explained_variance=expl, pca_mean=mu)


@register("pca.exact")
def pca_exact(data: CellData, n_components: int = 50, center: bool = True,
              device=None) -> CellData:
    """PCA by a full SVD of the (centred) densified X, for small data
    and as an oracle.  Adds what ``pca.randomized`` adds; the scores
    have ``n_cells`` rows."""
    data = data.to_device(resolve_device(device))
    Xd = _dense_X(data)
    mu = (Xd.mean(dim=0) if center
          else torch.zeros(Xd.shape[1], dtype=Xd.dtype, device=Xd.device))
    with true_f32():
        U, S, Vt = torch.linalg.svd(Xd - mu, full_matrices=False)
    k = n_components
    return data.with_obsm(X_pca=U[:, :k] * S[:k]).with_varm(
        PCs=Vt[:k].T).with_uns(
        pca_explained_variance=(S[:k] ** 2) / max(data.n_cells - 1, 1),
        pca_mean=mu)
