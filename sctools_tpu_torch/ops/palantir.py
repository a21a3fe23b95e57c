"""``palantir.run``: trajectory fate mapping (Palantir) on the kNN graph.

Counterpart of ``sctools_tpu/ops/palantir.py``.  Every stage works on
the (n, k) kNN edge list:

* **multiscale space**: diffusion-map eigenvectors scaled by λ/(1−λ),
  the count picked by the eigengap (host numpy, as in the reference);
* **pseudotime**: single-source shortest path from the root by min-plus
  relaxation (Bellman–Ford): a pull over each row's out-edges and a
  push along the reversed edges (``scatter_reduce`` "amin"), a fixed
  number of rounds;
* **directed chain**: an anisotropic Gaussian kernel in multiscale
  space gated by a logistic in the pseudotime increment, rows
  renormalised (the reference's documented divergence from Palantir's
  hard backward cut);
* **terminal states**: the stationary mass by power iteration of Pᵀ
  (``knn_rmatvec``: the ``graph_rmatvec`` kernel on the card), then
  late-pseudotime local maxima, deduplicated through the graph (host
  numpy);
* **fate probabilities**: absorption probabilities by the fixed point
  ``B ← P·B`` with terminal rows pinned (``knn_matvec``), until
  ``max|ΔB| ≤ tol``, read on the host after every step; their entropy
  is the differentiation potential.

``palantir.gene_trends``: each gene's expression along the pseudotime by
Nadaraya–Watson regression on a grid (the reference's documented
divergence from Palantir's per-gene GAM fits): one Gaussian matrix K
(n_grid × n) weighted by a lineage's fate probabilities, then ``K @ X``
and ``K @ X²`` as true-float32 matrix products for every gene at once.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from ..config import resolve_device, true_f32
from ..data.dataset import CellData
from ..data.sparse import SparseCells
from ..registry import register
from . import graph_kernels
from .graph import _band, knn_matvec, knn_rmatvec, spectral


# ----------------------------------------------------------------------
# multiscale space
# ----------------------------------------------------------------------


def multiscale_space(evals, evecs, n_eigs: int | None = None) -> np.ndarray:
    """Palantir's multiscale data space (host): the first ``n_eigs``
    eigenvectors scaled by λ/(1−λ); ``n_eigs`` defaults to the position
    of the largest eigengap (at least 2)."""
    evals = np.asarray(evals, np.float64)
    evecs = np.asarray(evecs, np.float64)
    if n_eigs is None:
        gaps = evals[:-1] - evals[1:]
        n_eigs = max(int(np.argmax(gaps) + 1), 2)
    use = slice(0, n_eigs)
    scale = evals[use] / (1.0 - np.minimum(evals[use], 1.0 - 1e-6))
    return (evecs[:, use] * scale[None, :]).astype(np.float32)


def _edge_lengths(idx: np.ndarray, ms: np.ndarray) -> np.ndarray:
    """Edge lengths (n, k) float32 in multiscale space, inf on -1 slots
    (host)."""
    safe = np.where(idx < 0, 0, idx)
    d = np.linalg.norm(ms[:, None, :] - ms[safe], axis=2)
    return np.where(idx < 0, np.inf, d).astype(np.float32)


# ----------------------------------------------------------------------
# pseudotime
# ----------------------------------------------------------------------


def shortest_path_arrays(knn_idx: torch.Tensor, edge_len: torch.Tensor,
                         root: int, n_rounds: int = 64) -> torch.Tensor:
    """Min-plus Bellman–Ford from ``root`` over ``n_rounds`` rounds:
    (n,) float32 distances, inf where unreachable in that many rounds.
    ``edge_len`` (n, k) holds non-negative lengths; -1 slots are
    ignored.  Each round pulls along the out-edges and pushes along the
    reversed ones, so the graph counts as undirected."""
    n, k = knn_idx.shape
    dead = knn_idx < 0
    safe = torch.where(dead, 0, knn_idx).long()
    wlen = torch.where(dead, float("inf"), edge_len.float())
    seg = torch.where(dead, n, knn_idx).long().reshape(-1)
    d = torch.full((n,), float("inf"), device=knn_idx.device)
    d[root] = 0.0
    for _ in range(n_rounds):
        d = torch.minimum(d, (d[safe] + wlen).amin(dim=1))
        push = torch.full((n + 1,), float("inf"), device=d.device)
        push.scatter_reduce_(0, seg, (d[:, None] + wlen).reshape(-1),
                             "amin")
        d = torch.minimum(d, push[:n])
    return d


# ----------------------------------------------------------------------
# directed transition matrix
# ----------------------------------------------------------------------


def _nanmedian(x: torch.Tensor) -> torch.Tensor:
    """Row medians ignoring NaN, numpy's rule (``jnp.nanmedian``): the
    mean of the two middle values when the count is even, as the
    linear-interpolation quantile ``lo·(1 − h) + hi·h`` with h = 0.5;
    NaN for a row without values.  (``torch.nanmedian`` returns the
    lower middle value instead.)"""
    valid = ~torch.isnan(x)
    cnt = valid.sum(dim=1)
    srt = torch.sort(x, dim=1).values  # NaN sort last
    q = 0.5 * (cnt.float() - 1.0)
    low, high = torch.floor(q), torch.ceil(q)
    hw = q - low
    lo_i = torch.clamp(low.long(), min=0)[:, None]
    hi_i = torch.clamp(high.long(), min=0)[:, None]
    med = (torch.gather(srt, 1, lo_i)[:, 0] * (1.0 - hw)
           + torch.gather(srt, 1, hi_i)[:, 0] * hw)
    return torch.where(cnt > 0, med, float("nan"))


def _nanstd(x: torch.Tensor) -> torch.Tensor:
    """Row standard deviations ignoring NaN, ddof 0 (``jnp.nanstd``);
    NaN for a row without values."""
    valid = ~torch.isnan(x)
    cnt = valid.sum(dim=1).float()
    mean = torch.where(valid, x, 0.0).sum(dim=1) / cnt
    centered = torch.where(valid, x - mean[:, None], 0.0)
    var = (centered * centered).sum(dim=1)
    var = torch.where(cnt > 0, var / torch.clamp(cnt, min=1.0),
                      float("nan"))
    return torch.sqrt(var)


def directed_chain_arrays(knn_idx: torch.Tensor, ms_emb: torch.Tensor,
                          pseudotime: torch.Tensor, beta: float = 4.0
                          ) -> torch.Tensor:
    """Pseudotime-directed row-stochastic transition weights (n, k) on
    the kNN edge list: ``exp(−d²/(σ_i σ_j))`` with σ the median
    neighbour distance in multiscale space, times ``sigmoid(β·Δpt/s_i)``
    with s_i the spread (std) of the row's pseudotime increments; -1
    slots and empty rows get 0."""
    dead = knn_idx < 0
    safe = torch.where(dead, 0, knn_idx).long()
    emb = ms_emb.float()
    diff = emb[:, None, :] - graph_kernels.gather_rows(emb, safe)
    d = torch.sqrt(torch.clamp((diff * diff).sum(dim=2), min=0.0))
    d = torch.where(dead, float("inf"), d)
    finite = torch.isfinite(d)
    sigma = torch.clamp(_nanmedian(torch.where(finite, d, float("nan"))),
                        min=1e-12)
    w = torch.exp(-(d * d) / (sigma[:, None] * sigma[safe]))
    pt = pseudotime.float()
    dpt = pt[safe] - pt[:, None]  # > 0 = forward
    s = _nanstd(torch.where(finite, dpt, float("nan")))
    s = torch.clamp(torch.where(torch.isfinite(s), s, 0.0), min=1e-9)
    w = torch.where(finite, w * torch.sigmoid(beta * dpt / s[:, None]), 0.0)
    row = w.sum(dim=1, keepdim=True)
    return torch.where(row > 0, w / torch.clamp(row, min=1e-12), 0.0)


# ----------------------------------------------------------------------
# stationary mass and fate probabilities
# ----------------------------------------------------------------------


def _self_mass(knn_idx: torch.Tensor, p_edges: torch.Tensor
               ) -> torch.Tensor:
    """1 − the row's edge mass: rows that do not sum to 1 keep the rest
    on themselves."""
    return 1.0 - torch.where(knn_idx < 0, 0.0, p_edges).sum(dim=1)


def stationary_arrays(knn_idx: torch.Tensor, p_edges: torch.Tensor,
                      n_iter: int = 100, band_rows: int | None = None
                      ) -> torch.Tensor:
    """Stationary mass (n,) of the directed chain by ``n_iter`` steps of
    power iteration with Pᵀ (rows' missing mass as self-loops),
    renormalised every step.  The destination order of the edge list is
    built once for all ``n_iter`` ``rmatvec`` launches."""
    n = knn_idx.shape[0]
    order = graph_kernels.rmatvec_order(knn_idx, n)
    x = torch.full((n, 1), 1.0 / n, device=knn_idx.device)
    self_mass = _self_mass(knn_idx, p_edges)[:, None]
    for _ in range(n_iter):
        x_new = knn_rmatvec(knn_idx, p_edges, x, n, band_rows=band_rows,
                            order=order) + self_mass * x
        x = x_new / torch.clamp(x_new.sum(), min=1e-12)
    return x[:, 0]


def fate_probs_arrays(knn_idx: torch.Tensor, p_edges: torch.Tensor,
                      terminal_onehot: torch.Tensor,
                      is_terminal: torch.Tensor, n_iter: int = 5000,
                      tol: float = 1e-6, band_rows: int | None = None
                      ) -> tuple[torch.Tensor, int]:
    """Absorption probabilities of the directed chain: ``(B (n, T),
    steps)``.  ``terminal_onehot`` (n, T) is one-hot over the fates on
    terminal rows and zero elsewhere; ``is_terminal`` (n,) bool.  The
    fixed point ``B ← P·B`` (missing mass as self-loops) with terminal
    rows pinned runs until ``max|ΔB| ≤ tol`` or ``n_iter`` steps, the
    condition read on the host after each step; ``steps`` is the number
    of ``matvec`` launches."""
    self_mass = _self_mass(knn_idx, p_edges)[:, None]
    onehot = terminal_onehot.float()
    pinned = is_terminal.bool()[:, None]
    B = onehot
    steps = 0
    delta = float("inf")
    while steps < n_iter and delta > tol:
        Bn = knn_matvec(knn_idx, p_edges, B, band_rows=band_rows) \
            + self_mass * B
        Bn = torch.where(pinned, onehot, Bn)
        delta = float((Bn - B).abs().max())
        B = Bn
        steps += 1
    return B, steps


def _find_terminal_states(knn_idx, stationary, pseudotime,
                          max_terminal: int = 10, pt_quantile: float = 0.7,
                          reachable=None) -> np.ndarray:
    """Late-pseudotime local maxima of the stationary mass, deduplicated
    through the graph (host numpy).  ``reachable`` masks the cells
    reachable from the root (default: finite pseudotime); unreachable
    cells, whose pseudotime the caller clamps to the maximum, are never
    candidates."""
    idx = np.asarray(knn_idx)
    pi = np.asarray(stationary, np.float64)
    pt = np.asarray(pseudotime, np.float64)
    n = idx.shape[0]
    if reachable is None:
        reachable = np.isfinite(pt)
    reachable = np.asarray(reachable, bool)
    safe = np.where(idx < 0, 0, idx)
    nb_pi = np.where(idx < 0, -np.inf, pi[safe])
    is_max = pi >= nb_pi.max(axis=1)
    late = pt >= np.quantile(pt[np.isfinite(pt) & reachable], pt_quantile)
    cand = np.flatnonzero(is_max & late & np.isfinite(pt) & reachable)
    cand = cand[np.argsort(-pi[cand])]
    chosen: list[int] = []
    taken = np.zeros(n, bool)
    for c in cand:
        if taken[c]:
            continue
        chosen.append(int(c))
        taken[c] = True
        taken[safe[c][idx[c] >= 0]] = True  # block its neighbourhood
        if len(chosen) >= max_terminal:
            break
    return np.asarray(chosen, np.int64)


# ----------------------------------------------------------------------
# palantir.run
# ----------------------------------------------------------------------


@register("palantir.run")
def run(data: CellData, root: int = 0, terminal_states=None,
        n_eigs: int | None = None, max_terminal: int = 10,
        sp_rounds: int = 64, fate_iter: int = 5000, device=None
        ) -> CellData:
    """Adds obs ``palantir_pseudotime`` and ``palantir_entropy``, obsm
    ``palantir_fate_probs`` (n, T) and uns ``palantir_terminal_states``
    and ``palantir_fate_labels``.  Requires ``neighbors.knn``;
    ``embed.spectral`` runs first if ``X_diffmap`` is missing.  Cells
    still unreachable after ``sp_rounds`` relaxation rounds get a rerun
    with 4× the rounds, then a warning, and their pseudotime is clamped
    to the maximum.  ``terminal_states`` (cell ids) skips the search for
    them."""
    dev = resolve_device(device)
    data = data.to_device(dev)
    if "X_diffmap" not in data.obsm:
        data = spectral(data, device=device)
    if "knn_indices" not in data.obsp:
        raise ValueError("run neighbors.knn first")
    n = data.n_cells
    idx = data.obsp["knn_indices"][:n]
    idx_h = idx.cpu().numpy()
    ms = multiscale_space(data.uns["diffmap_evals"].cpu().numpy(),
                          data.obsm["X_diffmap"][:n].cpu().numpy(),
                          n_eigs=n_eigs)
    band = _band(data)
    elen = torch.from_numpy(_edge_lengths(idx_h, ms)).to(dev)
    d = shortest_path_arrays(idx, elen, root, n_rounds=sp_rounds)
    # cells past the relaxation horizon keep d = inf and would pass for
    # terminal states once clamped: retry deeper, then warn
    if not bool(torch.isfinite(d).all()):
        d = shortest_path_arrays(idx, elen, root, n_rounds=4 * sp_rounds)
        n_inf = int((~torch.isfinite(d)).sum())
        if n_inf:
            warnings.warn(
                f"palantir: {n_inf} cells unreachable from root {root} "
                f"after {4 * sp_rounds} relaxation rounds (disconnected "
                "graph or raise sp_rounds); their pseudotime is clamped "
                "to the max", stacklevel=2)
    reach = torch.isfinite(d)
    pt_max = torch.where(reach, d, 0.0).max()
    pt = torch.where(reach, d, pt_max) / torch.clamp(pt_max, min=1e-12)

    p = directed_chain_arrays(idx, torch.from_numpy(ms).to(dev), pt)
    if terminal_states is None:
        pi = stationary_arrays(idx, p, band_rows=band)
        terminal_states = _find_terminal_states(
            idx_h, pi.cpu().numpy(), pt.cpu().numpy(),
            max_terminal=max_terminal, reachable=reach.cpu().numpy())
    terminal_states = np.asarray(terminal_states, np.int64)
    T = len(terminal_states)
    if T == 0:
        raise ValueError("no terminal states found; pass terminal_states")
    terms = torch.from_numpy(terminal_states).to(dev)
    onehot = torch.zeros((n, T), device=dev)
    onehot[terms, torch.arange(T, device=dev)] = 1.0
    is_term = torch.zeros(n, dtype=torch.bool, device=dev)
    is_term[terms] = True
    B, _ = fate_probs_arrays(idx, p, onehot, is_term, n_iter=fate_iter,
                             band_rows=band)
    rowsum = B.sum(dim=1, keepdim=True)
    Bn = torch.where(rowsum > 1e-6, B / torch.clamp(rowsum, min=1e-12),
                     1.0 / T)
    ent = -torch.where(Bn > 0, Bn * torch.log(Bn), 0.0).sum(dim=1)
    return data.with_obs(
        palantir_pseudotime=pt, palantir_entropy=ent,
    ).with_obsm(palantir_fate_probs=Bn).with_uns(
        palantir_terminal_states=terminal_states,
        palantir_fate_labels=terminal_states.copy())


# ----------------------------------------------------------------------
# palantir.gene_trends
# ----------------------------------------------------------------------


def gene_trends_arrays(pseudotime: torch.Tensor, weights: torch.Tensor,
                       X: torch.Tensor, n_grid: int = 100,
                       bandwidth: float | None = None):
    """Kernel regression of expression against pseudotime: ``pseudotime``
    (n,) in [0, 1], ``weights`` (n,) cell weights (a lineage's fate
    probabilities, or ones), ``X`` (n, g).  Returns (grid (n_grid,),
    trends (n_grid, g), std (n_grid, g)), float32 on X's device; the
    bandwidth defaults to 0.75·(range of the pseudotime)/n_grid^0.4."""
    pt = pseudotime.float()
    w = weights.float()
    X = X.float()
    grid = torch.linspace(0.0, 1.0, n_grid, device=X.device)
    if bandwidth is None:
        bandwidth = 0.75 * (pt.max() - pt.min() + 1e-12) / (n_grid ** 0.4)
    K = torch.exp(-0.5 * ((grid[:, None] - pt[None, :]) / bandwidth) ** 2)
    K = K * w[None, :]
    norm = torch.clamp(K.sum(dim=1, keepdim=True), min=1e-12)
    with true_f32():
        trends = (K @ X) / norm
        second = (K @ (X * X)) / norm
    std = torch.sqrt(torch.clamp(second - trends ** 2, min=0.0))
    return grid, trends, std


@register("palantir.gene_trends")
def gene_trends(data: CellData, genes=None, lineage: int | None = None,
                n_grid: int = 100, bandwidth: float | None = None,
                use_rep: str = "X", device=None) -> CellData:
    """Expression trends along Palantir pseudotime, weighted by one
    lineage's fate probabilities when ``lineage`` is given.  Adds uns
    ``gene_trends`` = {"grid", "trends", "std", "gene_idx",
    "lineage"}.  ``genes`` (ids or names in var ``gene_name``) picks
    the genes; a sparse X is densified for those genes only."""
    from .hvg import subset_genes_sparse
    from .score import _resolve_gene_indices

    if "palantir_pseudotime" not in data.obs:
        raise ValueError("run palantir.run first")
    dev = resolve_device(device)
    data = data.to_device(dev)
    n = data.n_cells
    pt = data.obs["palantir_pseudotime"][:n]
    if lineage is not None:
        w = data.obsm["palantir_fate_probs"][:n, lineage]
    else:
        w = torch.ones((n,), dtype=torch.float32, device=dev)
    X = data.X if use_rep == "X" else data.obsm[use_rep]
    if genes is None:
        gene_idx = np.arange(X.n_genes if isinstance(X, SparseCells)
                             else X.shape[1])
    else:
        gene_idx = _resolve_gene_indices(data, genes)
        if isinstance(X, SparseCells) and len(np.unique(gene_idx)) == len(
                gene_idx):
            X = subset_genes_sparse(X, gene_idx)
        else:
            X = (X.to_dense() if isinstance(X, SparseCells) else X)[
                :, torch.from_numpy(gene_idx).to(dev)]
    Xd = (X.to_dense() if isinstance(X, SparseCells) else X)[:n]
    grid, trends, std = gene_trends_arrays(pt, w, Xd, n_grid=n_grid,
                                           bandwidth=bandwidth)
    return data.with_uns(gene_trends={
        "grid": grid, "trends": trends, "std": std,
        "gene_idx": np.asarray(gene_idx), "lineage": lineage})
