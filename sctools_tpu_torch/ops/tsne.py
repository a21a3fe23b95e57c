"""``embed.tsne`` — t-SNE of the kNN graph.

Counterpart of ``sctools_tpu/ops/tsne.py``:

* input affinities: perplexity-calibrated Gaussian kernels on the kNN
  distances, symmetrised over the directed edge list (host numpy and
  scipy, copied from the reference);
* attraction: a row gather plus an ``index_add_`` segment sum over the
  directed kNN edges (plain torch; on the card ``index_add_`` adds with
  atomics, so layouts agree from run to run only to float32 order);
* repulsion: exact over all pairs, no Barnes-Hut or FFT approximation,
  through ``graph_kernels.tsne_repulsion`` (the CUDA kernel on the
  card, its plain version on the CPU);
* optimisation: momentum and per-coordinate gains with early
  exaggeration, as a Python loop over the iterations.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from ..config import resolve_device
from ..data.dataset import CellData
from ..registry import register
from .graph_kernels import gather_rows, tsne_repulsion


def _calibrate_p(dist2, perplexity, n_iter: int = 40):
    """Per-row Gaussian bandwidths by bisection so the conditional
    distribution over the k neighbours has entropy log(perplexity).
    dist2: (n, k) squared distances, inf = missing.  Returns (n, k)
    conditional probabilities (rows sum to 1 over present entries)."""
    finite = np.isfinite(dist2)
    d2 = np.where(finite, dist2, 0.0)
    # shift per row so the smallest distance has weight 1 (numerics)
    d2 = d2 - np.min(np.where(finite, d2, np.inf), axis=1, keepdims=True)
    target = np.log(perplexity)
    lo = np.full(d2.shape[:1], 1e-8)
    hi = np.full(d2.shape[:1], 1e8)
    for _ in range(n_iter):
        beta = np.sqrt(lo * hi)  # geometric bisection over scales
        w = np.where(finite, np.exp(-d2 * beta[:, None]), 0.0)
        s = np.maximum(w.sum(axis=1), 1e-30)
        p = w / s[:, None]
        h = -np.sum(np.where(p > 0, p * np.log(np.maximum(p, 1e-30)), 0.0),
                    axis=1)
        # entropy decreases in beta: too much entropy => raise beta
        hi_next = np.where(h > target, hi, beta)
        lo_next = np.where(h > target, beta, lo)
        lo, hi = lo_next, hi_next
    beta = np.sqrt(lo * hi)
    w = np.where(finite, np.exp(-d2 * beta[:, None]), 0.0)
    return w / np.maximum(w.sum(axis=1), 1e-30)[:, None]


def _prep_p(idx, dist, perplexity):
    """kNN distances → symmetrised affinities aligned to the DIRECTED
    edge list: each undirected p_ij is split across the one or two
    directed slots that carry it, so the segment-sum reaction in the
    attraction reconstitutes the full symmetric force.

    Returns (P, effective perplexity).  The perplexity is capped at
    k/3: with k stored neighbours an entropy target at or above log(k)
    pins the bisection at its bound and the affinities go uniform."""
    n, k = idx.shape
    eff = min(float(perplexity), max(2.0, k / 3.0))
    if eff < perplexity:
        warnings.warn(
            f"embed.tsne: perplexity={perplexity} needs ≥3x as many "
            f"kNN neighbours, but the graph has k={k}; using "
            f"perplexity={eff:.1f} (rebuild neighbors.knn with "
            f"k≈{int(3 * perplexity)} for the requested value)",
            stacklevel=3)
    perplexity = eff
    is_self = idx == np.arange(n)[:, None]
    d2 = np.where((idx < 0) | is_self, np.inf,
                  np.asarray(dist, np.float64) ** 2)
    pc = _calibrate_p(d2, perplexity)  # conditional p_{j|i}
    # p_ij = (p_{j|i} + p_{i|j}) / 2n over the union of directed edges
    import scipy.sparse as sp

    rows = np.repeat(np.arange(n), k)
    cols = idx.reshape(-1)
    keep = (cols >= 0) & ~is_self.reshape(-1)
    A = sp.coo_matrix((pc.reshape(-1)[keep],
                       (rows[keep], cols[keep])), shape=(n, n)).tocsr()
    S = (A + A.T).tocsr()
    S.data /= 2.0 * n
    total = S.sum()
    if total > 0:
        S.data /= total  # exact Σ p_ij = 1 (kNN truncation drops mass)
    # a slot carries p_ij/2 when the reverse edge also exists (the
    # reaction adds the other half), else the full p_ij; the mutual
    # mask comes from the index structure, not the values (a
    # conditional affinity that underflowed to 0 is still an edge)
    B = sp.coo_matrix((np.ones(int(keep.sum())),
                       (rows[keep], cols[keep])), shape=(n, n)).tocsr()
    both = B.multiply(B.T).tocsr()
    Sd = np.asarray(S[rows, cols.clip(0)]).reshape(n, k)
    both_d = np.asarray(both[rows, cols.clip(0)]).reshape(n, k)
    P = np.where(both_d > 0, Sd / 2.0, Sd).astype(np.float32)
    P[(idx < 0) | is_self] = 0.0
    return P, perplexity


def _exag_iters(n_iter: int, nominal: int = 100) -> int:
    """Early-exaggeration length: the standard 100 iterations, but never
    more than a quarter of the run."""
    return min(nominal, max(1, n_iter // 4))


def tsne_layout_arrays(knn_idx: torch.Tensor, P: torch.Tensor,
                       init: torch.Tensor, n_iter: int = 500,
                       exaggeration: float = 12.0,
                       exaggeration_iter: int = 100,
                       learning_rate: float = 200.0) -> torch.Tensor:
    """Optimise the t-SNE layout: ``knn_idx`` (n, k) neighbour ids (-1
    padding), ``P`` (n, k) symmetrised affinities aligned with it (Σ P
    = 1 over the stored entries), ``init`` (n, dim).  Returns the final
    (n, dim) float32 embedding; every iteration launches the repulsion
    kernel once on the card."""
    n, k = knn_idx.shape
    dim = init.shape[1]
    dead = knn_idx < 0
    safe = torch.where(dead, 0, knn_idx).long()
    flat = safe.reshape(-1)
    p = torch.where(dead, 0.0, P.float())

    def attraction(y):
        """Σ_j p_ij w_ij (y_i − y_j) over the directed kNN edges, plus
        the reaction on y_j (the edges are stored one way)."""
        diff = y[:, None, :] - gather_rows(y, safe)  # (n, k, dim)
        d2 = (diff * diff).sum(dim=2)
        att = (p / (1.0 + d2))[:, :, None] * diff
        reaction = torch.zeros_like(y).index_add_(
            0, flat, (-att).reshape(-1, dim))
        return att.sum(dim=1) + reaction

    y = init.float().clone()
    gains = torch.ones_like(y)
    vel = torch.zeros_like(y)
    for it in range(n_iter):
        early = it < exaggeration_iter
        exag = exaggeration if early else 1.0
        momentum = 0.5 if early else 0.8
        f_rep, z = tsne_repulsion(y, n)
        grad = 4.0 * (exag * attraction(y) - f_rep / z)
        same_sign = (grad * vel) > 0
        gains = torch.clamp(torch.where(same_sign, gains * 0.8, gains + 0.2),
                            0.01, 1e3)
        vel = momentum * vel - learning_rate * gains * grad
        y = y + vel
        y = y - y.mean(dim=0, keepdim=True)  # keep centred
    return y


@register("embed.tsne")
def tsne(data: CellData, n_components: int = 2, perplexity: float = 30.0,
         n_iter: int = 500, learning_rate: float = 200.0, seed: int = 0,
         device=None) -> CellData:
    """t-SNE of the kNN graph (requires ``neighbors.knn``).  Adds obsm
    ``X_tsne`` (n, n_components ≤ 4) and uns ``tsne_perplexity`` (the
    perplexity used).  The initial layout is ``1e-4 ×`` standard normal
    draws of numpy's ``default_rng(seed)``, as in the reference."""
    if "knn_indices" not in data.obsp:
        raise ValueError("run neighbors.knn first")
    dev = resolve_device(device)
    data = data.to_device(dev)
    n = data.n_cells
    idx = data.obsp["knn_indices"][:n].cpu().numpy()
    dist = data.obsp["knn_distances"][:n].cpu().numpy()
    P, eff = _prep_p(idx, dist, perplexity)
    rng = np.random.default_rng(seed)
    init = (rng.standard_normal((n, n_components)) * 1e-4).astype(
        np.float32)
    y = tsne_layout_arrays(
        torch.from_numpy(idx).to(dev), torch.from_numpy(P).to(dev),
        torch.from_numpy(init).to(dev), n_iter=n_iter,
        exaggeration_iter=_exag_iters(n_iter), learning_rate=learning_rate)
    return data.with_obsm(X_tsne=y).with_uns(tsne_perplexity=eff)
