"""``wishbone.run``: bifurcating-trajectory detection (Wishbone, Setty
et al. 2016).

Counterpart of ``sctools_tpu/ops/wishbone.py``:

1. ``n_waypoints`` by greedy max-min farthest-point sampling of the
   embedding from the start cell (host numpy);
2. shortest-path distances from the start and every waypoint over the
   symmetrised kNN graph (edge weights = kNN distances);
3. the trajectory: the distance from the start, refined by each
   waypoint's perspective ``τ(w) ± d_w(i)`` under Gaussian weights until
   stable;
4. the branches: a cosine 2-means of the waypoints' disagreement
   vectors, the branch point from cross-arm pairs, each cell the label
   of its nearest waypoint (steps 3 and 4 are the reference's host
   numpy, copied).

Step 2 runs on the card as min-plus Bellman–Ford over the symmetrised
edge list (``velocity._sym_pairs``, the reference's ``_sym_edges``):
``D ← min(D, min_j D[nbr_j] + w_j)``, for 32 waypoints at a time.  A
sweep gathers ``D`` at each edge's target and takes the minimum per
source with ``scatter_reduce("amin")`` (exact in any order), in
float64 as scipy's ``dijkstra`` sums (each path summed from its source
outwards in both, so the card's distances are the CPU's: in float32 a
difference of 1e-7 moved a near-tie of the trajectory's refinement and
the trajectory by 1.5 % of its range), so its
cost follows the edges, not the reference's padding of every row to
the largest degree (a hub of the symmetrised main graph made that
padded gather take 30 s a run on the card).  A round is 128 sweeps
and ``changed`` (the last sweep still relaxed a distance) is read on
the host once a round, as the reference's ``_distances_tpu`` does.
On the CPU the distances are scipy's ``dijkstra`` on the same graph, as
in the reference's CPU backend.  Cells unreachable from a source sit at
twice the largest finite distance.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import resolve_device
from ..data.dataset import CellData
from ..registry import register
from .graph import _host
from .velocity import _sym_pairs

_WCHUNK = 32  # sources a Bellman–Ford pass
_SWEEPS = 128  # sweeps a round, between reads of ``changed``
_INF = 3e38


def sym_edges(idx: np.ndarray, dist: np.ndarray):
    """The undirected edge list padded per row with -1: (idx2 (n, K2)
    int32, w2 (n, K2) float32), every kNN edge and its reverse, each
    pair once (the forward edge's weight where both exist), weights
    below 0 raised to 0.  (A cosine distance 1 − cos can round to
    −1e-7; a negative self-loop or edge would lower its cells' distances
    at every sweep, so the relaxation would never settle, and scipy's
    dijkstra does not take negative weights.)"""
    n = idx.shape[0]
    a, b, counts, w = _sym_pairs(idx, dist)
    K2 = int(counts.max()) if len(a) else 1
    idx2 = np.full((n, K2), -1, np.int32)
    w2 = np.zeros((n, K2), np.float32)
    starts = np.zeros(n + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    slot = np.arange(len(a)) - starts[a]
    idx2[a, slot] = b.astype(np.int32)
    w2[a, slot] = np.maximum(w, 0.0).astype(np.float32)
    return idx2, w2


def minplus_round(src: torch.Tensor, dst: torch.Tensor, w: torch.Tensor,
                  D: torch.Tensor, sweeps: int = _SWEEPS):
    """``sweeps`` min-plus relaxation sweeps of the distances ``D``
    (n, W) over the edges ``src`` → ``dst`` (E,) int64 of length ``w``
    (E,): ``D[src] ← min(D[src], D[dst] + w)``.  Returns (D, changed),
    ``changed`` a device bool, True when the last sweep still lowered a
    distance.  A sweep advances every frontier one hop."""
    index = src[:, None].expand(-1, D.shape[1])
    wcol = w.to(D.dtype)[:, None]
    changed = torch.ones((), dtype=torch.bool, device=D.device)
    for _ in range(sweeps):
        Dn = D.scatter_reduce(0, index, D[dst] + wcol, "amin")
        changed = (Dn < D).any()
        D = Dn
    return D, changed


def minplus_distances(idx2: torch.Tensor, w2: torch.Tensor,
                      sources: np.ndarray) -> np.ndarray:
    """Shortest-path distances (n, len(sources)) float64 from each
    source over the padded edge list ``idx2``/``w2`` (n, K2), by min-plus
    rounds over ``_WCHUNK`` sources at a time, until a round changes
    nothing (at most ceil((n - 1) / _SWEEPS) rounds); unreachable cells
    keep a distance above 1e37."""
    n = idx2.shape[0]
    dev = idx2.device
    valid = idx2 >= 0
    src = torch.arange(n, device=dev)[:, None].expand_as(idx2)[valid]
    dst = idx2[valid].long()
    w = w2[valid]
    out = []
    for lo in range(0, len(sources), _WCHUNK):
        pad = min(_WCHUNK, len(sources) - lo)
        chunk = np.full(_WCHUNK, int(sources[0]), np.int64)
        chunk[:pad] = sources[lo:lo + pad]
        D = torch.full((n, _WCHUNK), _INF, dtype=torch.float64, device=dev)
        D[torch.from_numpy(chunk).to(dev),
          torch.arange(_WCHUNK, device=dev)] = 0.0
        for _ in range(-(-max(n - 1, 1) // _SWEEPS)):
            D, changed = minplus_round(src, dst, w, D)
            if not bool(changed):
                break
        out.append(_host(D[:, :pad]))
    return np.concatenate(out, axis=1)


def dijkstra_distances(idx2: np.ndarray, w2: np.ndarray,
                       sources: np.ndarray) -> np.ndarray:
    """scipy's ``dijkstra`` on the same undirected graph: (n,
    len(sources)) float64, inf where unreachable."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import dijkstra

    n, K2 = idx2.shape
    rows = np.repeat(np.arange(n), K2)
    cols = idx2.reshape(-1)
    vals = w2.reshape(-1)
    keep = cols >= 0
    G = sp.csr_matrix((vals[keep], (rows[keep], cols[keep])), shape=(n, n))
    return dijkstra(G, directed=False, indices=np.asarray(sources)).T


def _maxmin_waypoints(E, n_waypoints, start, rng):
    """Greedy farthest-point sampling in the embedding (the paper's
    coverage goal) seeded at the start cell."""
    n = len(E)
    n_waypoints = min(n_waypoints, n)
    chosen = [int(start)]
    d = np.linalg.norm(E - E[start], axis=1)
    while len(chosen) < n_waypoints:
        nxt = int(np.argmax(d))
        if d[nxt] <= 0:
            nxt = int(rng.integers(0, n))
        chosen.append(nxt)
        d = np.minimum(d, np.linalg.norm(E - E[nxt], axis=1))
    return np.array(chosen, np.int64)


def _wishbone_host(D, waypoints, branch, n_iter, sigma_scale):
    """The trajectory and branch logic on the distances D (n, n_way)
    from each waypoint (waypoints[0] is the start), host numpy."""
    n, n_way = D.shape
    tau = D[:, 0].copy()  # distance from start
    sigma = sigma_scale * np.mean(D[waypoints, 0]) + 1e-12
    Wgt = np.exp(-0.5 * (D / sigma) ** 2) + 1e-30
    Wgt /= Wgt.sum(axis=1, keepdims=True)
    V = np.zeros_like(D)
    for _ in range(n_iter):
        tau_w = tau[waypoints]  # (n_way,)
        before = tau[:, None] < tau_w[None, :]
        V = np.where(before, tau_w[None, :] - D, tau_w[None, :] + D)
        V[:, 0] = D[:, 0]  # the start's perspective is the raw distance
        tau_new = (Wgt * V).sum(axis=1)
        if np.max(np.abs(tau_new - tau)) < 1e-6 * max(tau.max(), 1e-12):
            tau = tau_new
            break
        tau = tau_new
    tau = tau - tau.min()
    if not branch:
        return tau, None, None
    # disagreement structure across waypoints: the two arms' rows have
    # nearly disjoint supports, so a cosine 2-means of the
    # row-normalised disagreement vectors separates them; trunk rows
    # (small norm) are gated out first
    Q = V - tau[:, None]                      # (n, n_way)
    Qw = np.abs(Q[waypoints].T)               # rows: waypoint views
    rn = np.linalg.norm(Qw, axis=1)
    confident = rn > 0.3 * rn.max()
    R = Qw / np.maximum(rn, 1e-12)[:, None]
    seed1 = int(np.argmax(rn))
    cos_to_1 = R @ R[seed1]
    cand = np.where(confident)[0]
    seed2 = int(cand[np.argmin(np.abs(cos_to_1[cand]))])
    c1, c2 = R[seed1].copy(), R[seed2].copy()
    lab = np.zeros(n_way, np.int32)
    for _ in range(10):
        s1, s2 = R @ c1, R @ c2
        lab = np.where(s1 >= s2, 1, 2).astype(np.int32)
        for b, c in ((1, c1), (2, c2)):
            m = confident & (lab == b)
            if m.any():
                v = R[m].mean(axis=0)
                c[:] = v / max(np.linalg.norm(v), 1e-12)
    tau_w = tau[waypoints]
    m1 = confident & (lab == 1)
    m2 = confident & (lab == 2)
    if not m1.any() or not m2.any():
        return tau, np.zeros(n, np.int32), float(tau.max())
    # the branch point: each confident cross-arm pair (w, u) gives
    # min(τ_w, τ_u) − |Q_w(u)| / 2; the median is robust to the noisy
    # pairs near the branch
    iw, iu = np.where(m1)[0], np.where(m2)[0]
    tmin = np.minimum(tau_w[iw][:, None], tau_w[iu][None, :])
    bt_est = tmin - 0.5 * Qw[iw][:, iu]
    branch_time = float(np.median(bt_est))
    # waypoints: trunk before 92 % of the branch time, else their label
    # (weak ones that of their nearest confident waypoint); cells: the
    # label of their nearest waypoint
    Dw = D[waypoints]                         # waypoint x waypoint
    conf_idx = np.where(confident)[0]
    nearest_conf = conf_idx[np.argmin(Dw[:, conf_idx], axis=1)]
    lab_f = np.where(confident, lab, lab[nearest_conf])
    way_branch = np.where(tau_w <= 0.92 * branch_time, 0,
                          lab_f).astype(np.int32)
    way_branch[0] = 0
    cell_branch = way_branch[np.argmin(D, axis=1)].astype(np.int32)
    return tau, cell_branch, branch_time


@register("wishbone.run")
def run(data: CellData, start_cell: int, *, use_rep: str = "auto",
        n_waypoints: int = 150, branch: bool = True, n_iter: int = 25,
        sigma_scale: float = 0.5, seed: int = 0, device=None) -> CellData:
    """Adds obs ``wishbone_trajectory`` (pseudotime from ``start_cell``)
    and ``wishbone_branch`` (0 = trunk, 1 and 2 the arms), uns
    ``wishbone_waypoints``, ``wishbone_start_cell`` and
    ``wishbone_branch_time``.  ``use_rep="auto"`` takes X_diffmap when
    present, else X_pca.  Requires ``neighbors.knn``."""
    dev = resolve_device(device)
    data = data.to_device(dev)
    if "knn_indices" not in data.obsp:
        raise KeyError("wishbone.run: run neighbors.knn first")
    n = data.n_cells
    if not 0 <= int(start_cell) < n:
        raise ValueError(f"wishbone.run: start_cell {start_cell} out of "
                         f"range [0, {n})")
    idx = _host(data.obsp["knn_indices"])[:n]
    dist = _host(data.obsp["knn_distances"]).astype(np.float64)[:n]
    rep = ("X_diffmap" if use_rep == "auto" and "X_diffmap" in data.obsm
           else "X_pca" if use_rep == "auto" else use_rep)
    E = _host(data.obsm[rep]).astype(np.float64)[:n]
    rng = np.random.default_rng(seed)
    waypoints = _maxmin_waypoints(E, n_waypoints, int(start_cell), rng)
    idx2, w2 = sym_edges(idx, dist)
    if dev.type == "cpu":
        D = dijkstra_distances(idx2, w2, waypoints)
    else:
        D = minplus_distances(torch.from_numpy(idx2).to(dev),
                              torch.from_numpy(w2).to(dev), waypoints)
    unreach = ~np.isfinite(D) | (D > 1e37)
    if unreach.any():
        # far, but finite, so that the weighting stays defined
        D = np.where(unreach, 2.0 * D[~unreach].max(), D)
    tau, cell_branch, branch_time = _wishbone_host(
        D, waypoints, branch, n_iter, sigma_scale)
    out = data.with_obs(wishbone_trajectory=torch.from_numpy(
        tau.astype(np.float32)).to(dev))
    uns = {"wishbone_waypoints": waypoints,
           "wishbone_start_cell": int(start_cell)}
    if branch:
        out = out.with_obs(wishbone_branch=torch.from_numpy(
            cell_branch).to(dev))
        uns["wishbone_branch_time"] = branch_time
    return out.with_uns(**uns)
