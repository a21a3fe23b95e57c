"""Batch correction: ``integrate.harmony`` and ``integrate.combat``.

Counterpart of ``sctools_tpu/ops/integrate.py``.

``integrate.harmony`` (the published Harmony method) alternates

* a diversity-penalised soft k-means of the cosine-normalised
  embedding, whose assignments R are updated in ~20 large row blocks
  one after another (each block leaves its own counts out of the
  cluster-by-batch table O, takes its new assignments against the
  penalty, and adds them back: a synchronous update of all rows
  equilibrates poorly), and
* a ridge mixture-of-experts regression per cluster that subtracts the
  batch component from the original embedding: the normal equations
  are summed in row chunks of ``_ROW_CHUNK`` (never an (n, K, B + 1)
  tensor), the K systems of size (B + 1) × (B + 1) solved at once and
  the intercept row zeroed,

for a fixed number of rounds.  Every product runs in true float32
(``config.true_f32``), as the reference computes them.  The systems
are near-singular, so, where the reference solves them in float32 as
summed, the port builds their intercept row from the batch rows and
solves in float64 (``_correct``): the result no longer hangs on the
order of the float32 sums, and the card and the CPU agree.  The start is
the port's k-means (``cluster.kmeans_init``, seeded on the CPU, then
``kmeans_lloyd``) on the normalised embedding, where the reference
draws with ``jax.random``: one seed gives other starting centroids.

``integrate.combat`` (ComBat, Johnson et al. 2007; scanpy's
``pp.combat`` with the batch design only) standardises each gene,
estimates per-batch location and scale, shrinks them toward their
method-of-moments priors by a fixed number of empirical-Bayes
iterations, and adjusts a dense X.  The per-batch sums add each batch's
rows in index order (``cluster._segment_sum``), so the card repeats its
bits and the CPU adds as the reference does there.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import resolve_device, true_f32
from ..data.dataset import CellData
from ..data.sparse import SparseCells
from ..registry import register
from .cluster import (_row_sum, _segment_sum, kmeans_init, kmeans_lloyd,
                      segment_order)
from .graph import _host

_ROW_CHUNK = 8192


def _l2norm(z: torch.Tensor) -> torch.Tensor:
    return z / torch.clamp(torch.linalg.vector_norm(z, dim=1, keepdim=True),
                           min=1e-12)


def _batch_onehot(batch: np.ndarray):
    """(one-hot (n, B) float32, sorted levels, codes (n,) int32)."""
    levels, codes = np.unique(np.asarray(batch), return_inverse=True)
    onehot = np.zeros((len(codes), len(levels)), np.float32)
    onehot[np.arange(len(codes)), codes] = 1.0
    return onehot, levels, codes.astype(np.int32)


# ----------------------------------------------------------------------
# integrate.harmony
# ----------------------------------------------------------------------


def _cluster(Zn_p, R_p, phi_p, n_blocks: int, bs: int, theta: float,
             sigma: float, n_iter: int) -> torch.Tensor:
    """``n_iter`` sweeps of the block-incremental soft k-means on the
    padded rows (padding: Zn and φ zero, R 1/K, which its softmax keeps)."""
    for _ in range(n_iter):
        C = _l2norm(R_p.T @ Zn_p)  # padded Zn rows are 0
        O = R_p.T @ phi_p  # (K, B)
        R_new = torch.empty_like(R_p)
        for b in range(n_blocks):
            sl = slice(b * bs, (b + 1) * bs)
            Rb, phib = R_p[sl], phi_p[sl]
            O = O - Rb.T @ phib  # this block left out
            m_k = O.sum(dim=1)  # cluster mass of the other blocks
            n_b = O.sum(dim=0)  # their batch counts
            n_inc = torch.clamp(n_b.sum(), min=1.0)
            E = m_k[:, None] * n_b[None, :] / n_inc
            pen = theta * torch.log((E + 1.0) / (O + 1.0))
            dist = 2.0 * (1.0 - Zn_p[sl] @ C.T)
            logits = -dist / sigma + phib @ pen.T
            Rb = torch.softmax(logits, dim=1)
            O = O + Rb.T @ phib
            R_new[sl] = Rb
        R_p = R_new
    return R_p


def _correct(Z, phi, R, ridge) -> torch.Tensor:
    """The mixture-of-experts ridge correction of the original ``Z``:
    per cluster k, with G = [1, φ], W_k = (Gᵀ diag(R_k) G + ridge)⁻¹
    Gᵀ diag(R_k) Z with its intercept row zeroed, and
    Z − Σ_k diag(R_k) G W_k.

    The intercept column is the sum of the one-hot batch columns, so
    the systems are near-singular (only the ridge on the batch
    coefficients makes them invertible; the condition number grows
    with the cluster's mass): a float32 solve, or an intercept row
    summed apart from the batch rows, turns the last bits of the
    float32 sums into ~1e-4 of the scale, which the rounds then carry.
    So only the batch parts are summed (true float32, in row chunks):
    n_kb = Σ_i R_ik φ_ib and s_kb = Σ_i R_ik φ_ib z_i; the intercept
    row and column are built from them exactly and the (B + 1)² systems
    solved in float64.  The batch rows of W (the intercept's is zeroed)
    go back to float32 for the correction."""
    n, d = Z.shape
    K, B = R.shape[1], phi.shape[1]
    nkb = torch.zeros((K, B), dtype=Z.dtype, device=Z.device)
    skb = torch.zeros((K * B, d), dtype=Z.dtype, device=Z.device)

    def rp_of(c0):
        r, p = R[c0:c0 + _ROW_CHUNK], phi[c0:c0 + _ROW_CHUNK]
        return (r[:, :, None] * p[:, None, :]).reshape(-1, K * B), r, p

    for c0 in range(0, n, _ROW_CHUNK):
        rp, r, p = rp_of(c0)
        nkb = nkb + r.T @ p
        skb = skb + rp.T @ Z[c0:c0 + _ROW_CHUNK]
    f64 = torch.float64
    n64, s64 = nkb.to(f64), skb.to(f64).view(K, B, d)
    A = torch.zeros((K, B + 1, B + 1), dtype=f64, device=Z.device)
    A[:, 0, 0] = n64.sum(dim=1)
    A[:, 0, 1:] = n64
    A[:, 1:, 0] = n64
    A[:, 1:, 1:] = torch.diag_embed(n64)
    rhs = torch.cat([s64.sum(dim=1, keepdim=True), s64], dim=1)
    W = torch.linalg.solve(A + ridge.to(f64), rhs)
    # the intercept row (the cluster's mean) is kept: only the batch rows
    Wb = W[:, 1:, :].to(Z.dtype).reshape(K * B, d)
    corr = torch.cat([rp_of(c0)[0] @ Wb for c0 in range(0, n, _ROW_CHUNK)])
    return Z - corr


def harmony_arrays(Z: torch.Tensor, phi: torch.Tensor, n_clusters: int,
                   theta: float = 2.0, sigma: float = 0.1, lamb: float = 1.0,
                   n_rounds: int = 10, n_cluster_iter: int = 10,
                   seed: int = 0) -> torch.Tensor:
    """Harmony on the device of ``Z``: ``Z`` (n, d) embedding, ``phi``
    (n, B) one-hot batches.  Returns the corrected (n, d) float32
    embedding.  The start is ``kmeans_init(seed)`` + 10 Lloyd rounds on
    the normalised Z; then ``n_rounds`` × (``n_cluster_iter`` block
    sweeps, one correction)."""
    Z = Z.float()
    phi = phi.to(device=Z.device, dtype=torch.float32)
    n, d = Z.shape
    B = phi.shape[1]
    dev = Z.device
    # the ridge penalises the batch coefficients, never the intercept
    ridge = lamb * torch.diag(torch.cat([torch.zeros(1, device=dev),
                                         torch.ones(B, device=dev)]))
    # ~5 % of the cells a block (at most 20 blocks); padded rows have
    # φ = 0, so they never touch O or E
    n_blocks = max(1, min(20, -(-n // 128)))
    bs = -(-n // n_blocks)
    pad_r = n_blocks * bs - n
    phi_p = torch.cat([phi, torch.zeros((pad_r, B), device=dev)])
    with true_f32():
        Zn0 = _l2norm(Z)
        _, C0, _ = kmeans_lloyd(Zn0, kmeans_init(Zn0, n_clusters, seed=seed),
                                n_iter=10)
        R = torch.softmax(-2.0 * (1.0 - Zn0 @ _l2norm(C0).T) / sigma, dim=1)
        K = R.shape[1]
        Z_corr = Z
        for _ in range(n_rounds):
            Zn_p = torch.cat([_l2norm(Z_corr), torch.zeros((pad_r, d),
                                                           device=dev)])
            R_p = torch.cat([R, torch.full((pad_r, K), 1.0 / K, device=dev)])
            R = _cluster(Zn_p, R_p, phi_p, n_blocks, bs, theta, sigma,
                         n_cluster_iter)[:n]
            Z_corr = _correct(Z, phi, R, ridge)
    return Z_corr


def _resolve_harmony_inputs(data: CellData, batch_key: str, use_rep: str,
                            n_clusters):
    if batch_key not in data.obs:
        raise ValueError(f"batch_key={batch_key!r} not in obs "
                         f"({sorted(data.obs)})")
    if use_rep not in data.obsm:
        raise ValueError(f"use_rep={use_rep!r} not in obsm; run "
                         "pca.randomized first")
    n = data.n_cells
    Z = data.obsm[use_rep][:n]
    onehot, levels, _ = _batch_onehot(_host(data.obs[batch_key])[:n])
    if n_clusters is None:
        n_clusters = int(min(100, max(2, round(n / 30))))
    return Z, onehot, levels, n_clusters


@register("integrate.harmony")
def harmony(data: CellData, batch_key: str = "batch",
            use_rep: str = "X_pca", theta: float = 2.0, sigma: float = 0.1,
            lamb: float = 1.0, n_clusters: int | None = None,
            n_rounds: int = 10, seed: int = 0, device=None) -> CellData:
    """Adds obsm ``X_harmony`` (the batch-corrected embedding, n_cells
    rows) and uns ``harmony_batches`` and ``harmony_n_clusters``
    (default min(100, max(2, round(n / 30))))."""
    dev = resolve_device(device)
    data = data.to_device(dev)
    Z, onehot, levels, n_clusters = _resolve_harmony_inputs(
        data, batch_key, use_rep, n_clusters)
    out = harmony_arrays(Z, torch.from_numpy(onehot).to(dev),
                         n_clusters=n_clusters, theta=theta, sigma=sigma,
                         lamb=lamb, n_rounds=n_rounds, seed=seed)
    return data.with_obsm(X_harmony=out).with_uns(
        harmony_batches=levels, harmony_n_clusters=n_clusters)


# ----------------------------------------------------------------------
# integrate.combat
# ----------------------------------------------------------------------


def _combat_hyperpriors(gamma_hat: torch.Tensor, delta_sq: torch.Tensor):
    """Method-of-moments hyperpriors of the ComBat model: a normal prior
    on the per-batch gene shifts, an inverse gamma on the scales.  The
    variances are sample variances (ddof = 1), as scanpy's (pandas')
    are."""
    gamma_bar = gamma_hat.mean(dim=1)  # (B,)
    t2 = gamma_hat.var(dim=1, correction=1)
    m = delta_sq.mean(dim=1)
    s2 = delta_sq.var(dim=1, correction=1)
    a_prior = (2.0 * s2 + m * m) / torch.clamp(s2, min=1e-12)
    b_prior = (m * s2 + m ** 3) / torch.clamp(s2, min=1e-12)
    return gamma_bar, t2, a_prior, b_prior


def combat_arrays(X: torch.Tensor, codes: torch.Tensor,
                  n_per_batch: torch.Tensor, n_iter: int = 100
                  ) -> torch.Tensor:
    """ComBat on a dense (n, g) ``X``: ``codes`` (n,) batch ids,
    ``n_per_batch`` (B,) cells a batch.  Returns the adjusted (n, g)
    float32 matrix.  Everything reduces to per-batch sums into (B, g)
    tables (each batch's rows in index order) and ``n_iter`` elementwise
    empirical-Bayes steps on them; a fixed count replaces the
    convergence loop (100 steps is far past its 1e-4 tolerance)."""
    X = X.float()
    n = X.shape[0]
    codes = codes.to(device=X.device, dtype=torch.int64)
    nb = n_per_batch.to(device=X.device, dtype=torch.float32)[:, None]
    B = nb.shape[0]
    order = segment_order(codes, B)

    def bsum(M):  # per-batch column sums -> (B, g)
        return _segment_sum(M, None, B, order=order)

    # per-batch means; the pooled variance of the batch-centred data
    batch_mean = bsum(X) / nb
    grand_mean = _row_sum((batch_mean * (nb / n)).T)  # (g,), batch order
    resid = X - batch_mean[codes]
    var_pooled = (resid * resid).sum(dim=0) / n
    del resid
    std = torch.sqrt(torch.clamp(var_pooled, min=1e-12))
    Z = (X - grand_mean[None, :]) / std[None, :]

    sZ = bsum(Z)
    gamma_hat = sZ / nb
    zc = Z - gamma_hat[codes]
    delta_sq = bsum(zc * zc) / torch.clamp(nb - 1.0, min=1.0)
    del zc
    gamma_bar, t2, a_prior, b_prior = _combat_hyperpriors(gamma_hat,
                                                          delta_sq)
    # Σ_i∈b (Z − γ*)² = Σ Z² − 2 γ* Σ Z + n_b γ*², so the steps never
    # touch Z
    sZZ = bsum(Z * Z)
    nt2 = nb * t2[:, None]
    denom = nb / 2.0 + a_prior[:, None] - 1.0
    g_star, d_star = gamma_hat, delta_sq
    for _ in range(n_iter):
        g_star = ((nt2 * gamma_hat + d_star * gamma_bar[:, None])
                  / (nt2 + d_star))
        sum2 = sZZ - 2.0 * g_star * sZ + nb * g_star * g_star
        d_star = torch.clamp((b_prior[:, None] + 0.5 * sum2) / denom,
                             min=1e-12)
    adj = (Z - g_star[codes]) / torch.sqrt(d_star[codes])
    return adj * std[None, :] + grand_mean[None, :]


@register("integrate.combat")
def combat(data: CellData, batch_key: str = "batch", n_iter: int = 100,
           device=None) -> CellData:
    """ComBat batch correction (scanpy ``pp.combat``, batch design
    only) of a log-normalised X, e.g. after ``hvg.select(subset=True)``:
    a sparse X is densified.  Replaces X with the adjusted dense
    (n_cells, n_genes) matrix; adds uns ``combat_batches``."""
    dev = resolve_device(device)
    if batch_key not in data.obs:
        raise KeyError(f"obs has no {batch_key!r}")
    data = data.to_device(dev)
    n = data.n_cells
    X = data.X
    Xd = X.to_dense() if isinstance(X, SparseCells) else X
    onehot, levels, codes = _batch_onehot(_host(data.obs[batch_key])[:n])
    if len(levels) < 2:
        raise ValueError("combat needs >= 2 batches")
    out = combat_arrays(Xd[:n], torch.from_numpy(codes).to(dev),
                        torch.from_numpy(onehot.sum(0)), n_iter=n_iter)
    return data.with_X(out).with_uns(combat_batches=levels)
