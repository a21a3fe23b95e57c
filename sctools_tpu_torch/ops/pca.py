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
from ..data.dataset import CellData
from ..data.sparse import SparseCells, gene_sum, spmm, spmm_t
from ..registry import register
from .qc import _dense_X, _matrix_X


def _gene_mean(X) -> torch.Tensor:
    if isinstance(X, SparseCells):
        return gene_sum(X) / X.n_cells
    return X.mean(dim=0)


def _center_matvec(X, mu, V):
    """(X - 1 μᵀ) @ V, with the padded rows of a sparse X forced to
    zero."""
    if isinstance(X, SparseCells):
        out = spmm(X, V) - (mu @ V)[None, :]
        return torch.where(X.row_mask()[:, None], out, 0.0)
    return X @ V - (mu @ V)[None, :]


def _center_rmatvec(X, mu, Q):
    """(X - 1 μᵀ)ᵀ @ Q; the padded rows of Q are zero."""
    if isinstance(X, SparseCells):
        colsum = torch.where(X.row_mask()[:, None], Q, 0.0).sum(dim=0)
        return spmm_t(X, Q) - torch.outer(mu, colsum)
    return X.T @ Q - torch.outer(mu, Q.sum(dim=0))


def cholesky_qr(Y: torch.Tensor, iters: int = 2) -> torch.Tensor:
    """Orthonormalise the columns of ``Y`` by CholeskyQR2: the only
    cross-row reduction is the (L, L) Gram matrix, taken in true f32."""
    with true_f32():
        for _ in range(iters):
            G = Y.T @ Y
            L = G.shape[0]
            G = G + 1e-7 * torch.trace(G) / L * torch.eye(
                L, dtype=G.dtype, device=G.device)
            R = torch.linalg.cholesky(G, upper=True)
            Y = torch.linalg.solve_triangular(R, Y, upper=True, left=False)
    return Y


def _orthonormalize(Y, method: str):
    if method == "cholesky":
        return cholesky_qr(Y)
    if method == "householder":
        with true_f32():
            return torch.linalg.qr(Y).Q
    raise ValueError(f"unknown qr_method {method!r}")


def randomized_pca_arrays(X, n_components: int = 50,
                          oversample: int = 10, n_iter: int = 2,
                          center: bool = True, qr_method: str = "cholesky",
                          omega: torch.Tensor | None = None, seed: int = 0):
    """Randomized PCA of ``X``, padded-ELL or dense (n, G).  Returns
    (scores (rows, k), components (G, k), explained variance (k,), mean
    (G,)); ``rows`` is ``rows_padded`` for a sparse X.

    ``omega`` (G, L) with ``L = min(n_components + oversample, G, n)``
    is the sketch; without it a standard normal sketch is drawn from a
    ``torch.Generator`` seeded with ``seed`` on X's device."""
    G, n = ((X.n_genes, X.n_cells) if isinstance(X, SparseCells)
            else (X.shape[1], X.shape[0]))
    # a sketch wider than the matrix makes the Gram matrix singular
    L = min(n_components + oversample, G, n)
    k = min(n_components, L)
    dev = X.device
    mu = (_gene_mean(X) if center
          else torch.zeros((G,), dtype=torch.float32, device=dev))
    if omega is None:
        gen = torch.Generator(device=dev).manual_seed(seed)
        omega = torch.randn((G, L), generator=gen, device=dev)
    else:
        if tuple(omega.shape) != (G, L):
            raise ValueError(
                f"omega has shape {tuple(omega.shape)}, expected {(G, L)}")
        omega = omega.to(device=dev, dtype=torch.float32)
    with true_f32():
        Y = _center_matvec(X, mu, omega)
        Q = _orthonormalize(Y, qr_method)
        for _ in range(n_iter):
            Qz = _orthonormalize(_center_rmatvec(X, mu, Q), qr_method)
            Q = _orthonormalize(_center_matvec(X, mu, Qz), qr_method)
        B = _center_rmatvec(X, mu, Q).T  # (L, G)
        U_b, S, Vt = torch.linalg.svd(B, full_matrices=False)
        scores = (Q @ U_b[:, :k]) * S[:k]
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
    lim = min(data.n_cells, data.n_genes)
    if n_components > lim:
        warnings.warn(
            f"pca.randomized: n_components={n_components} exceeds "
            f"min(n_cells, n_genes)={lim}; returning {lim} components",
            stacklevel=2)
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
