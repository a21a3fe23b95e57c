"""``qc.doublet_score``: Scrublet-style doublet detection.

Counterpart of ``sctools_tpu/ops/doublet.py`` (the published Scrublet
method): simulate doublets by summing random pairs of observed cells,
embed them with the observed cells, and score each observed cell by how
enriched its neighbourhood is in simulated doublets.

* The observed embedding: the raw counts library-size normalised and
  log1p'd (a copy; ``data.X`` is left as it is), then
  ``pca.randomized_pca_arrays``.  Its sketch is ``omega=`` when given
  (``carry.pca_omega_from_numpy`` carries the reference's ``jax.random``
  one), else a ``torch.Generator`` seeded with ``seed``.
* The simulated doublets are never materialised as counts
  (``project_doublets``): per block of 1,024 pairs, both parents' ELL
  slots side by side, sorted by gene id, duplicate genes merged exactly
  by the cumsum difference at run ends (counts are non-negative, so the
  running maximum of the run-end sums is the previous run end's),
  library-normalised and log1p'd, then contracted against the loadings
  gathered per slot (a zero row for the sentinel) in true float32.
* The neighbour search over observed + simulated cells is
  ``knn.knn_arrays`` with ``k_adj`` neighbours, euclidean, self
  excluded: the ``knn_select`` kernel on the card (k_adj = 393 at
  68,579 cells); ``knn_numpy`` (float64) on the CPU, as the reference's
  CPU backend.  The likelihood is computed from the neighbour counts in
  float64 on the host on both devices.

Parent pairs come from a host ``numpy.random.default_rng(seed)``, so a
seed simulates the reference's doublets.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import resolve_device, true_f32
from ..data.dataset import CellData
from ..data.sparse import SparseCells
from ..registry import register
from .knn import knn_arrays, knn_numpy
from .normalize import _library_size_sparse
from .pca import randomized_pca_arrays


def _default_k(n_cells: int) -> int:
    return max(10, int(round(0.5 * np.sqrt(n_cells))))


def _resolve_params(n: int, sim_ratio: float, k: int | None):
    """(n_sim, k, k_adj): n_sim depends only on the statistics, so a
    seed simulates the same doublets on every device."""
    n_sim = max(1, int(round(sim_ratio * n)))
    k = k or _default_k(n)
    k_adj = int(round(k * (1.0 + n_sim / n)))
    return n_sim, k, k_adj


def _doublet_likelihood(q, r, rho):
    """Scrublet's posterior doublet likelihood from the simulated-
    neighbour fraction ``q``, simulation ratio ``r = n_sim/n_obs`` and
    expected doublet rate ``rho``.  q == r/(1+r) (no enrichment) maps
    to rho; q -> 1 maps to 1."""
    return q * rho / r / (1.0 - rho - q * (1.0 - rho - rho / r))


def _sample_pairs(n_cells: int, n_sim: int, seed: int) -> np.ndarray:
    """(n_sim, 2) parent indices, i != j, from a host numpy rng."""
    rng = np.random.default_rng(seed)
    i = rng.integers(0, n_cells, size=n_sim)
    j = (i + 1 + rng.integers(0, n_cells - 1, size=n_sim)) % n_cells
    return np.stack([i, j], axis=1).astype(np.int32)


def project_doublets(x: SparseCells, pairs: torch.Tensor,
                     comps: torch.Tensor, mu: torch.Tensor,
                     target_sum: float, block: int = 1024) -> torch.Tensor:
    """PCA scores (n_sim, d) of the doublets ``pairs`` (n_sim, 2) of the
    raw-count rows of ``x``, without their count matrix: per block of
    ``block`` pairs the parents' slots are merged by gene (see the
    module docstring), normalised to ``target_sum``, log1p'd and
    projected on ``comps`` (G, d) around the gene means ``mu`` (G,)."""
    G, d = comps.shape
    dev = comps.device
    comps_pad = torch.cat([comps.float(),
                           torch.zeros((1, d), device=dev)], dim=0)
    with true_f32():
        mu_proj = mu.float() @ comps.float()
    pairs = pairs.to(dev).long()
    out = torch.empty((pairs.shape[0], d), dtype=torch.float32, device=dev)
    for lo in range(0, pairs.shape[0], block):
        p = pairs[lo:lo + block]
        ind2 = torch.cat([x.indices[p[:, 0]], x.indices[p[:, 1]]], dim=1)
        dat2 = torch.cat([x.data[p[:, 0]], x.data[p[:, 1]]], dim=1)
        ind_s, order = torch.sort(ind2, dim=1, stable=True)
        cs = torch.cumsum(torch.gather(dat2, 1, order).float(), dim=1)
        is_last = torch.ones_like(ind_s, dtype=torch.bool)
        is_last[:, :-1] = ind_s[:, :-1] != ind_s[:, 1:]
        boundary = torch.where(is_last, cs, 0.0)
        prev = torch.zeros_like(cs)
        prev[:, 1:] = torch.cummax(boundary, dim=1).values[:, :-1]
        val = torch.where(is_last, cs - prev, 0.0)
        totals = cs[:, -1]
        scale = torch.where(totals > 0,
                            target_sum / torch.clamp(totals, min=1e-12), 0.0)
        v = torch.log1p(val * scale[:, None])
        g = comps_pad[torch.clamp(ind_s, max=G).long()]  # (b, slots, d)
        with true_f32():
            out[lo:lo + block] = torch.bmm(v[:, None, :], g)[:, 0] \
                - mu_proj[None, :]
    return out


def _neighbor_scores(emb_obs: torch.Tensor, emb_sim: torch.Tensor,
                     k_adj: int, metric: str, expected_rate: float):
    """The kNN over the combined embedding (the ``knn_select`` kernel on
    the card, ``knn_numpy`` on the CPU); each row's simulated-neighbour
    fraction → the doublet likelihood, float64 on the host.  Returns
    (observed scores, simulated scores) as float32 numpy."""
    n_obs, n_sim = emb_obs.shape[0], emb_sim.shape[0]
    n = n_obs + n_sim
    if emb_obs.device.type == "cpu":
        combined = np.concatenate([emb_obs.numpy().astype(np.float64),
                                   emb_sim.numpy().astype(np.float64)])
        idx, _ = knn_numpy(combined, combined, k=k_adj, metric=metric,
                           exclude_self=True)
    else:
        combined = torch.cat([emb_obs, emb_sim], dim=0)
        idx, _ = knn_arrays(combined, combined, k=k_adj, metric=metric,
                            n_query=n, n_cand=n, exclude_self=True)
        idx = idx[:n].cpu().numpy()
    n_sim_nb = (idx >= n_obs).sum(axis=1)
    n_valid = (idx >= 0).sum(axis=1)
    q = (n_sim_nb + 1.0) / (n_valid + 2.0)
    scores = _doublet_likelihood(q, n_sim / n_obs, expected_rate)
    return (scores[:n_obs].astype(np.float32),
            scores[n_obs:].astype(np.float32))


def doublet_embeddings(x: SparseCells, sim_ratio: float = 2.0,
                       n_components: int = 30, target_sum: float = 1e4,
                       seed: int = 0, omega=None, block: int = 1024):
    """The observed cells' PCA scores (n, d) and the simulated
    doublets' (n_sim, d), on the device of ``x`` (raw counts)."""
    n = x.n_cells
    n_sim = _resolve_params(n, sim_ratio, None)[0]
    x_scaled, _ = _library_size_sparse(x, target_sum)
    x_norm = x_scaled.with_data(torch.log1p(x_scaled.data))
    scores, comps, _, mu = randomized_pca_arrays(
        x_norm, n_components=n_components, seed=seed,
        omega=None if omega is None else torch.as_tensor(omega))
    pairs = torch.from_numpy(_sample_pairs(n, n_sim, seed))
    sim = project_doublets(x, pairs, comps, mu, target_sum, block=block)
    return scores[:n], sim


@register("qc.doublet_score")
def doublet_score(data: CellData, expected_rate: float = 0.06,
                  sim_ratio: float = 2.0, n_components: int = 30,
                  k: int | None = None, metric: str = "euclidean",
                  target_sum: float = 1e4, seed: int = 0,
                  threshold: float | None = None, block: int = 1024,
                  omega=None, device=None) -> CellData:
    """Scrublet-style doublet scoring.  ``data.X`` must hold **raw
    counts** (run before normalisation).  Adds obs ``doublet_score``,
    uns ``doublet_sim_scores`` and ``doublet_expected_rate``; with
    ``threshold`` also obs ``predicted_doublet`` and uns
    ``doublet_threshold``.  ``omega`` (G, min(n_components + 10, G, n))
    is the PCA's sketch (default: drawn from ``seed``)."""
    dev = resolve_device(device)
    data = data.to_device(dev)
    X = data.X
    if not isinstance(X, SparseCells):
        raise TypeError("qc.doublet_score expects sparse raw counts "
                        "(SparseCells or a scipy CSR X)")
    n = data.n_cells
    _, _, k_adj = _resolve_params(n, sim_ratio, k)
    obs_emb, sim_emb = doublet_embeddings(
        X, sim_ratio, n_components, target_sum, seed, omega, block)
    obs_s, sim_s = _neighbor_scores(obs_emb, sim_emb, k_adj, metric,
                                    expected_rate)
    scores = torch.from_numpy(obs_s).to(dev)
    out = data.with_obs(doublet_score=scores).with_uns(
        doublet_sim_scores=torch.from_numpy(sim_s).to(dev),
        doublet_expected_rate=expected_rate)
    if threshold is not None:
        out = out.with_obs(predicted_doublet=scores > threshold).with_uns(
            doublet_threshold=threshold)
    return out
