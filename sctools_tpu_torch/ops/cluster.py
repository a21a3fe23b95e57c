"""Clustering: ``cluster.kmeans``, ``cluster.leiden`` (alias
``cluster.louvain``), ``cluster.leiden_like``, ``cluster.phenograph``
and ``cluster.dendrogram``.

Counterpart of ``sctools_tpu/ops/cluster.py``, with its algorithms, tie
rules, thresholds and ``obs``/``uns`` keys:

* ``cluster.leiden`` optimises γ-resolution Newman modularity by
  parallel local-move rounds on the symmetrised kNN graph (alternating
  node-parity halves, ties to the lower community id) interleaved with
  aggregation merges of the coarse community graph;
* ``cluster.leiden_like`` is weighted label propagation (a move only on
  strictly better support, or on a tie toward the lower label) followed
  by the same merge; ``cluster.phenograph`` runs it on ``graph.jaccard``
  weights (the ``graph_jaccard`` kernel on the card);
* ``cluster.kmeans`` is Lloyd's algorithm after a k-means++-lite draw.

The per-node work runs on the device of the graph: on the card for a
card's ``CellData``, the coarse merge's moves included.  Graph
symmetrisation and aggregation, the dense matching merge, modularity,
the dendrogram's linkage and PAGA's group statistics are host numpy and
scipy, as in the reference.

Exactness.  Labels depend on ties and on 1e-12 thresholds, so every
float sum on the path has one fixed order, the same on every device:

* a row's slots are summed in slot order (``_label_runs``: each row's
  slots sorted stably by label, each run of one label summed left to
  right), the order of the reference's reductions over k on the CPU
  for rows of fewer than 32 slots;
* per-community sums (Σ_tot, k-means' centroid sums) add their members
  in index order (``_segment_sum``: a stable sort by label, then
  ``torch.segment_reduce``), as the reference's ``segment_sum`` does on
  the CPU; the card's ``index_add_`` would add them in no fixed order.

The reference's ``cluster.leiden`` CPU oracle (serial sweeps, with its
native binding) is not ported: it is a test oracle, not a device path.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import resolve_device, true_f32
from ..data.dataset import CellData
from ..registry import register
from .graph import _host, _require_knn
from .knn import _get_rep

INT_MAX = torch.iinfo(torch.int32).max


# ----------------------------------------------------------------------
# Fixed-order sums
# ----------------------------------------------------------------------


def _row_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum of each row of ``x`` (n, c) or (n, c, d) over its c axis,
    left to right."""
    acc = torch.zeros_like(x[:, 0])
    for j in range(x.shape[1]):
        acc = acc + x[:, j]
    return acc


def segment_order(seg: torch.Tensor, n_segments: int):
    """``(order, lengths)`` of ``_segment_sum`` for the segment ids
    ``seg`` (n,): the stable sort and the segment sizes, for a caller
    that sums over one grouping many times."""
    return (torch.argsort(seg, stable=True),
            torch.bincount(seg, minlength=n_segments))


def _segment_sum(values: torch.Tensor, seg: torch.Tensor | None,
                 n_segments: int, order=None) -> torch.Tensor:
    """Sums of ``values`` (n,) or (n, d) by segment id ``seg`` (n,),
    each segment's members added in index order: (n_segments,) or
    (n_segments, d).  Deterministic on every device.  ``order`` is
    ``segment_order(seg, n_segments)``, built once (``seg`` is then
    not read)."""
    order, lengths = (segment_order(seg, n_segments) if order is None
                      else order)
    v = values[order]
    flat = v.dim() == 1
    if flat:
        v = v[:, None]
    # two-dimensional data: the per-segment loop of segment_reduce, the
    # same on the CPU and the card
    out = torch.segment_reduce(v, "sum", lengths=lengths, axis=0)
    return out[:, 0] if flat else out


def _label_runs(nl: torch.Tensor, w: torch.Tensor):
    """Each row's slot weights summed by label, in slot order.

    ``nl`` (n, c) int32 labels, ``w`` (n, c) float32 weights.  Returns
    ``(L, R, end)``, each (c, n) (slot position first): ``L`` each row's
    labels sorted (stable, so one label's slots keep their order),
    ``R`` the running sum of the run of equal labels that position
    closes, and ``end`` marking each run's last position, where ``R``
    is that label's total.  The totals equal the reference's sums over
    the (k, k) same-label mask: the same terms in the same order, with
    the mask's zeros left out.  Memory O(n·c); c launches."""
    lab_s, order = torch.sort(nl, dim=1, stable=True)
    L = lab_s.T.contiguous()
    W = torch.gather(w, 1, order).T.contiguous()
    c = L.shape[0]
    same = (L[1:] == L[:-1]).to(W.dtype)
    R = torch.empty_like(W)
    R[0] = W[0]
    for j in range(1, c):
        # W[j] + same·R[j-1]: same is 1 or 0, so the product is exact and
        # the one rounding is that of the add
        torch.addcmul(W[j], same[j - 1], R[j - 1], out=R[j])
    end = torch.ones_like(L, dtype=torch.bool)
    end[:-1] = L[1:] != L[:-1]
    return L, R, end


def _label_total(L, R, end, labels) -> torch.Tensor:
    """Each row's total weight on its own label ``labels`` (n,), 0 where
    no slot holds it (one run per label, so the sum adds one value to
    zeros: exact)."""
    return torch.where(end & (L == labels), R, 0.0).sum(dim=0)


# ----------------------------------------------------------------------
# Label propagation over the kNN graph ("leiden-like" communities)
# ----------------------------------------------------------------------


def label_propagation_arrays(knn_idx: torch.Tensor, weights: torch.Tensor,
                             n_iter: int = 30) -> torch.Tensor:
    """Weighted label propagation on a kNN graph; int32 labels (n,).

    ``knn_idx`` (n, k) neighbour ids (-1 = missing), ``weights`` (n, k).
    From singleton labels, each round every node takes the label of
    most support among its neighbours (ties to the lower id), but only
    when that support beats its own label's by more than 1e-12, or ties
    it within 1e-12 and the label is lower.  Self-edges never vote.
    Rounds stop early at a fixed point, which later rounds would keep."""
    n, k = knn_idx.shape
    dev = knn_idx.device
    rows = torch.arange(n, device=dev)
    dead = (knn_idx < 0) | (knn_idx == rows[:, None])
    safe = torch.where(knn_idx < 0, 0, knn_idx).long()
    w = torch.where(dead, 0.0, weights.float())
    labels = rows.to(torch.int32)
    neg_inf = torch.tensor(float("-inf"), device=dev)
    for _ in range(n_iter):
        nl = torch.where(dead, -1, labels[safe])
        L, R, end = _label_runs(nl, w)
        score = torch.where(end, torch.where(L < 0, -1.0, R), neg_inf)
        bw = score.amax(dim=0)
        lab = torch.where(score == bw, L, INT_MAX).amin(dim=0)
        cur = _label_total(L, R, end, labels)
        valid = (lab >= 0) & (lab < INT_MAX)
        better = bw > cur + 1e-12
        tie_lower = ((bw - cur).abs() <= 1e-12) & (lab < labels)
        new = torch.where((better | tie_lower) & valid, lab, labels)
        if torch.equal(new, labels):
            break
        labels = new
    return labels


# ----------------------------------------------------------------------
# Parallel modularity local moves
# ----------------------------------------------------------------------


def louvain_moves_arrays(idx: torch.Tensor, w: torch.Tensor,
                         labels0: torch.Tensor, resolution: float = 1.0,
                         n_rounds: int = 20) -> torch.Tensor:
    """Parallel modularity local-move rounds on a SYMMETRIC ELL graph
    (``idx`` (n, c) with -1 padding, ``w`` (n, c)); int32 labels (n,).

    Each round every node of the active parity half (node id % 2 ==
    round % 2) moves to the neighbouring community of largest gain

        ΔQ ∝ (w_{i→c} − w_{i→cur}) − γ·d_i·(Σ_c − Σ_cur + d_i)/2m

    if it exceeds 1e-12, ties to the lower community id.  Self-loops (a
    coarse supernode's internal weight) count in the degree and never
    vote.  The reference tiles rows to bound its (block, c, c) mask;
    this port never forms the mask (``_label_runs``), so it takes no
    block size.  Rounds stop early after two rounds without a move (a
    fixed point of both halves)."""
    n, c = idx.shape
    dev = idx.device
    rows = torch.arange(n, device=dev)
    dead = idx < 0
    novote = dead | (idx == rows[:, None])
    safe = torch.where(dead, 0, idx).long()
    w_deg = torch.where(dead, 0.0, w.float())
    wv = torch.where(novote, 0.0, w_deg)
    deg = _row_sum(w_deg)
    # 2m in float64, rounded once: the same bits on every device
    m2 = torch.clamp(deg.double().sum().float(), min=1e-12)
    parity = rows % 2
    labels = labels0.to(device=dev, dtype=torch.int32)
    neg_inf = torch.tensor(float("-inf"), device=dev)
    idle = 0
    for r in range(n_rounds):
        sig = _segment_sum(deg, labels.long(), n)  # Σ_tot
        nl = torch.where(novote, -1, labels[safe])
        L, R, end = _label_runs(nl, wv)
        w_cur = _label_total(L, R, end, labels)
        sig_l = sig[torch.where(L < 0, 0, L).long()]
        sig_cur = sig[labels.long()]
        gain = (R - w_cur) - resolution * deg * (sig_l - (sig_cur - deg)) / m2
        gain = torch.where(~end | (L < 0) | (L == labels), neg_inf, gain)
        bg = gain.amax(dim=0)
        bc = torch.where(gain == bg, L, INT_MAX).amin(dim=0)
        move = (parity == r % 2) & (bg > 1e-12) & (bc < INT_MAX)
        new = torch.where(move, bc, labels)
        idle = idle + 1 if torch.equal(new, labels) else 0
        labels = new
        if idle == 2:
            break
    return labels


# ----------------------------------------------------------------------
# Host graph helpers (numpy / scipy, as in the reference)
# ----------------------------------------------------------------------


def _compact_labels(labels: np.ndarray) -> np.ndarray:
    uniq, inv = np.unique(labels, return_inverse=True)
    return inv.astype(np.int32)


def _coarse_ell(labels: np.ndarray, idx: np.ndarray, w: np.ndarray,
                max_capacity: int = 1024):
    """Aggregate a (possibly directed) ELL graph by community labels
    into a symmetric coarse ELL graph over ``m`` supernodes.
    Intra-community weight becomes a SELF-LOOP on the supernode (it
    counts in the degree, never votes).  Hub rows beyond
    ``max_capacity`` keep their heaviest off-diagonal edges, with
    symmetry restored by dropping the reverse copies too; the diagonal
    is never dropped.

    Returns (idx2 (m, cap) int32 with -1 padding, w2 (m, cap) f32)."""
    import scipy.sparse as sp

    n, k = idx.shape
    m = int(labels.max()) + 1
    rows = np.repeat(labels.astype(np.int64), k)
    cols = idx.reshape(-1)
    keep = cols >= 0
    cj = labels[np.clip(cols, 0, n - 1)].astype(np.int64)
    vals = np.asarray(w, np.float64).reshape(-1)
    A = sp.coo_matrix((vals[keep], (rows[keep], cj[keep])),
                      shape=(m, m)).tocsr()
    A.sum_duplicates()
    S = (0.5 * (A + A.T)).tocsr()  # no-op for symmetric input
    S.eliminate_zeros()
    nnz = np.diff(S.indptr)
    if len(nnz) and int(nnz.max()) > max_capacity:
        for r in np.flatnonzero(nnz > max_capacity):
            lo, hi = S.indptr[r], S.indptr[r + 1]
            d = S.data[lo:hi]
            offd = np.flatnonzero(S.indices[lo:hi] != r)
            n_drop = (hi - lo) - max_capacity
            drop = offd[np.argpartition(d[offd], n_drop - 1)[:n_drop]]
            d[drop] = 0.0
        S.eliminate_zeros()
        # edge kept iff kept in BOTH rows; minimum(S, Sᵀ) keeps S's
        # diagonal, so self-loops survive
        S = S.minimum(S.T).tocsr()
        S.eliminate_zeros()
        nnz = np.diff(S.indptr)
    cap = max(int(nnz.max()) if len(nnz) and S.nnz else 1, 1)
    idx2 = np.full((m, cap), -1, np.int32)
    w2 = np.zeros((m, cap), np.float32)
    slot = np.arange(S.nnz) - np.repeat(S.indptr[:-1], nnz)
    rr = np.repeat(np.arange(m), nnz)
    idx2[rr, slot] = S.indices
    w2[rr, slot] = S.data
    return idx2, w2


def _symmetrize_knn(idx: np.ndarray, w: np.ndarray,
                    max_capacity: int | None = None):
    """Directed kNN ELL → symmetric union ELL: ``A`` and ``Aᵀ`` combined
    by elementwise max (self-edges, -1 slots and zero weights dropped).
    Rows beyond ``max_capacity`` (default ``max(4k, 64)``) keep their
    heaviest edges, symmetry restored by keeping an edge only if both
    rows kept it.

    Returns (idx2 (n, c) int32 with -1 padding, w2 (n, c) float32)."""
    import scipy.sparse as sp

    n, k = idx.shape
    if max_capacity is None:
        max_capacity = max(4 * k, 64)
    rows = np.repeat(np.arange(n, dtype=np.int64), k)
    cols = idx.reshape(-1).astype(np.int64)
    vals = np.asarray(w, np.float64).reshape(-1)
    keep = (cols >= 0) & (vals > 0) & (cols != rows)
    A = sp.coo_matrix((vals[keep], (rows[keep], cols[keep])),
                      shape=(n, n)).tocsr()
    A.sum_duplicates()
    S = A.maximum(A.T).tocsr()
    nnz = np.diff(S.indptr)
    if len(nnz) and int(nnz.max()) > max_capacity:
        for r in np.flatnonzero(nnz > max_capacity):
            lo, hi = S.indptr[r], S.indptr[r + 1]
            d = S.data[lo:hi]
            # positional argpartition: a value cut would keep every tie
            drop = np.argpartition(d, len(d) - max_capacity)[
                : len(d) - max_capacity]
            d[drop] = 0.0
        S.eliminate_zeros()
        S = S.minimum(S.T).tocsr()
        S.eliminate_zeros()
        nnz = np.diff(S.indptr)
    cap = int(nnz.max()) if len(nnz) and S.nnz else 1
    idx2 = np.full((n, cap), -1, np.int32)
    w2 = np.zeros((n, cap), np.float32)
    slot = np.arange(S.nnz) - np.repeat(S.indptr[:-1], nnz)
    rr = np.repeat(np.arange(n), nnz)
    idx2[rr, slot] = S.indices
    w2[rr, slot] = S.data
    return idx2, w2


def modularity(idx: np.ndarray, w: np.ndarray, labels: np.ndarray,
               resolution: float = 1.0) -> float:
    """Newman modularity of a partition on a SYMMETRIC ELL graph (each
    undirected edge stored in both rows); host float64, independent of
    the optimisers."""
    labels = np.asarray(labels)
    idx = np.asarray(idx)
    w = np.asarray(w, np.float64)
    dead = idx < 0
    wv = np.where(dead, 0.0, w)
    safe = np.where(dead, 0, idx)
    deg = wv.sum(axis=1)
    m2 = deg.sum()
    if m2 <= 0:
        return 0.0
    same = labels[safe] == labels[:, None]
    w_in = np.where(same & ~dead, wv, 0.0).sum()
    sig = np.bincount(labels, weights=deg,
                      minlength=int(labels.max()) + 1)
    return float(w_in / m2 - resolution * np.sum((sig / m2) ** 2))


def adjusted_rand_index(a, b) -> float:
    """ARI between two labelings (test/check metric)."""
    a = np.asarray(a)
    b = np.asarray(b)
    n = len(a)
    ua, ia = np.unique(a, return_inverse=True)
    ub, ib = np.unique(b, return_inverse=True)
    m = np.zeros((len(ua), len(ub)), np.int64)
    np.add.at(m, (ia, ib), 1)
    ai = m.sum(1)
    bj = m.sum(0)

    def comb(x):
        return x * (x - 1) / 2.0

    s_ij = comb(m).sum()
    s_a = comb(ai).sum()
    s_b = comb(bj).sum()
    s_n = comb(np.float64(n))
    expected = s_a * s_b / s_n
    max_idx = 0.5 * (s_a + s_b)
    if max_idx == expected:
        return 1.0
    return float((s_ij - expected) / (max_idx - expected))


def _modularity_merge(labels: np.ndarray, knn_idx: np.ndarray,
                      weights: np.ndarray, resolution: float = 1.0,
                      max_communities: int = 4096, *,
                      device) -> np.ndarray:
    """Aggregation phase: merge communities of the coarse label graph
    while γ-modularity increases (host labels in and out).

    Up to ``max_communities`` communities: round-based greedy matching
    merges on the dense (m, m) coarse matrix (host float64; each round
    applies a maximal set of disjoint positive-gain pairs, ΔQ =
    2·(A_ij/total − γ·deg_i·deg_j/total²)).  Above it the graph is
    aggregated (``_coarse_ell``) and coarsened by
    ``louvain_moves_arrays`` on ``device``, the graph's device,
    recursing until the count fits the dense merge; a level that does
    not coarsen returns its labels."""
    labels = _compact_labels(labels)
    m = int(labels.max()) + 1 if len(labels) else 0
    if m <= 1:
        return labels
    if m > max_communities:
        cidx, cw = _coarse_ell(labels, knn_idx, weights)
        sub = louvain_moves_arrays(
            torch.from_numpy(cidx).to(device), torch.from_numpy(cw).to(device),
            torch.arange(m, dtype=torch.int32, device=device),
            resolution=resolution, n_rounds=20)
        sub = _compact_labels(_host(sub))
        if int(sub.max()) + 1 >= m:  # no coarsening: do not recurse
            return labels
        sub = _modularity_merge(sub, cidx, cw, resolution=resolution,
                                max_communities=max_communities,
                                device=device)
        return _compact_labels(sub[labels])
    n, k = knn_idx.shape
    li = np.repeat(labels, k)
    cols = knn_idx.reshape(-1)
    keep = cols >= 0
    lj = labels[np.clip(cols, 0, n - 1)]
    w = np.asarray(weights, np.float64).reshape(-1)
    A = np.zeros((m, m))
    np.add.at(A, (li[keep], lj[keep]), w[keep])
    A = 0.5 * (A + A.T)
    total = A.sum()
    if total <= 0:
        return labels
    group = np.arange(m)
    while m > 1:
        deg = A.sum(axis=1)
        gain = 2.0 * (A / total
                      - resolution * np.outer(deg, deg) / (total * total))
        np.fill_diagonal(gain, -np.inf)
        j_best = np.argmax(gain, axis=1)
        g_best = gain[np.arange(m), j_best]
        order = np.argsort(-g_best)
        taken = np.zeros(m, bool)
        target = np.arange(m)
        n_pairs = 0
        for i in order:
            if g_best[i] <= 1e-12:
                break
            j = j_best[i]
            if taken[i] or taken[j]:
                continue
            taken[i] = taken[j] = True
            target[j] = i
            n_pairs += 1
        if n_pairs == 0:
            break
        keep = np.flatnonzero(target == np.arange(m))
        new_id = np.full(m, -1)
        new_id[keep] = np.arange(len(keep))
        mapping = new_id[target]  # every j maps to its partner's new id
        M = np.zeros((m, len(keep)))
        M[np.arange(m), mapping] = 1.0
        A = M.T @ A @ M
        group = mapping[group]
        m = len(keep)
    return _compact_labels(group[labels])


# ----------------------------------------------------------------------
# cluster.leiden_like / cluster.phenograph
# ----------------------------------------------------------------------


@register("cluster.leiden_like")
def leiden_like(data: CellData, n_iter: int = 30,
                weight_key: str = "connectivities", device=None) -> CellData:
    """Community labels from label propagation over the kNN graph
    (``label_propagation_arrays``) plus a modularity merge of the coarse
    label graph.  Requires neighbors.knn (and uses ``obsp[weight_key]``
    as vote weights when present, else unit weights).  Adds obs
    ``leiden_like`` (int32)."""
    dev = resolve_device(device)
    data = data.to_device(dev)
    idx, _ = _require_knn(data)
    if weight_key in data.obsp:
        w = data.obsp[weight_key][: data.n_cells].float()
    else:
        w = torch.ones(idx.shape, dtype=torch.float32, device=dev)
    labels = label_propagation_arrays(idx, w, n_iter=n_iter)
    # the merge sees the same self-edge-free weights the votes used
    idx_h = _host(idx)
    dead = (idx_h < 0) | (idx_h == np.arange(data.n_cells)[:, None])
    w_h = np.where(dead, 0.0, _host(w))
    labels = _modularity_merge(_host(labels), idx_h, w_h, device=dev)
    return data.with_obs(leiden_like=torch.from_numpy(labels).to(dev))


@register("cluster.phenograph")
def phenograph(data: CellData, n_iter: int = 30, jaccard_block: int = 1024,
               device=None) -> CellData:
    """PhenoGraph: the kNN graph reweighted by neighbour-set Jaccard
    similarity (``graph.jaccard`` when ``obsp`` has no ``jaccard``; the
    ``graph_jaccard`` kernel on the card), then ``cluster.leiden_like``
    on those weights.  Adds obs ``phenograph`` and obsp ``jaccard``.
    ``jaccard_block`` is forwarded to ``graph.jaccard``."""
    from .graph import jaccard

    dev = resolve_device(device)
    data = data.to_device(dev)
    if "jaccard" not in data.obsp:
        data = jaccard(data, block=jaccard_block, device=dev)
    out = leiden_like(data, n_iter=n_iter, weight_key="jaccard", device=dev)
    return _as_phenograph(data, out)


def _as_phenograph(before: CellData, after: CellData) -> CellData:
    """Move the delegated leiden_like labels to obs ``phenograph``,
    restoring (or dropping) the caller's own obs ``leiden_like``."""
    obs = dict(after.obs)
    labels = obs.pop("leiden_like")
    if "leiden_like" in before.obs:
        obs["leiden_like"] = before.obs["leiden_like"]
    obs["phenograph"] = labels
    return after.replace(obs=obs)


# ----------------------------------------------------------------------
# cluster.leiden / cluster.louvain
# ----------------------------------------------------------------------


def _leiden_graph(data: CellData, weight_key: str):
    idx = _host(_require_knn(data)[0])
    if weight_key in data.obsp:
        w = _host(data.obsp[weight_key]).astype(np.float64)[: data.n_cells]
    else:
        w = np.ones_like(idx, np.float64)
    return _symmetrize_knn(idx, w)


@register("cluster.leiden")
def leiden(data: CellData, resolution: float = 1.0, n_rounds: int = 20,
           n_levels: int = 3, weight_key: str = "connectivities",
           key_added: str = "leiden", device=None) -> CellData:
    """Modularity clustering of the kNN graph: parallel local moves
    (``louvain_moves_arrays``) on the symmetrised graph interleaved with
    coarse-graph merges, level by level until modularity gains no more
    than 1e-9.  ``resolution`` γ scales the null-model term (higher:
    more, smaller communities).  Requires neighbors.knn (and uses
    ``obsp[weight_key]`` as edge weights when present).  Adds obs
    ``<key_added>`` (int32) and uns ``<key_added>_modularity`` and
    ``<key_added>_resolution`` (float32)."""
    dev = resolve_device(device)
    data = data.to_device(dev)
    idx2, w2 = _leiden_graph(data, weight_key)
    idx_d, w_d = torch.from_numpy(idx2).to(dev), torch.from_numpy(w2).to(dev)
    labels = np.arange(data.n_cells, dtype=np.int32)
    best_q, best_labels = -np.inf, labels
    for _ in range(max(1, n_levels)):
        labels = _host(louvain_moves_arrays(
            idx_d, w_d, torch.from_numpy(labels).to(dev),
            resolution=resolution, n_rounds=n_rounds))
        labels = _modularity_merge(labels, idx2, w2, resolution=resolution,
                                   device=dev)
        q = modularity(idx2, w2, labels, resolution=resolution)
        if q <= best_q + 1e-9:
            break
        best_q, best_labels = q, labels
    return data.with_obs(**{key_added: torch.from_numpy(
        best_labels.astype(np.int32)).to(dev)}).with_uns(
        **{f"{key_added}_modularity": np.float32(best_q),
           f"{key_added}_resolution": np.float32(resolution)})


@register("cluster.louvain")
def louvain(data: CellData, resolution: float = 1.0, n_rounds: int = 20,
            n_levels: int = 3, weight_key: str = "connectivities",
            device=None) -> CellData:
    """scanpy's ``tl.louvain`` name: ``cluster.leiden``'s computation,
    stored under obs ``louvain``."""
    return leiden(data, resolution=resolution, n_rounds=n_rounds,
                  n_levels=n_levels, weight_key=weight_key,
                  key_added="louvain", device=device)


# ----------------------------------------------------------------------
# cluster.kmeans
# ----------------------------------------------------------------------


def kmeans_init(points: torch.Tensor, n_clusters: int,
                seed: int = 0) -> torch.Tensor:
    """k-means++-lite starting centroids (n_clusters, d): one point drawn
    uniformly, then ``n_clusters - 1`` more without replacement with
    probability ∝ squared distance to it (one D²-weighted round, as in
    the reference).  The draws come from a CPU ``torch.Generator``
    seeded with ``seed``, so every device starts from the same points;
    they are not JAX's threefry draws (the reference's key)."""
    pts = points.float()
    n = pts.shape[0]
    gen = torch.Generator().manual_seed(seed)
    i0 = int(torch.randint(n, (1,), generator=gen))
    c0 = pts[i0:i0 + 1]
    d2 = _host(_row_sum((pts - c0) ** 2)).astype(np.float64)
    probs = torch.from_numpy(d2 / max(d2.sum(), 1e-12))
    # Gumbel top-k: a draw without replacement ∝ probs (zero-probability
    # points come last instead of failing the draw)
    u = torch.rand(n, generator=gen, dtype=torch.float64)
    keys = torch.log(probs) - torch.log(-torch.log(u))
    rest = torch.topk(keys, n_clusters - 1).indices
    return torch.cat([c0, pts[rest.to(pts.device)]])


def _assign(pts: torch.Tensor, pp: torch.Tensor, centroids: torch.Tensor):
    """Nearest centroid (ties to the lower index) and squared distance."""
    with true_f32():
        s = pts @ centroids.T
    d2 = _row_sum(centroids * centroids)[None, :] - 2.0 * s
    lab = torch.argmin(d2, dim=1)
    return lab, d2.gather(1, lab[:, None])[:, 0] + pp


def kmeans_lloyd(points: torch.Tensor, centroids0: torch.Tensor,
                 n_iter: int = 25):
    """Lloyd's algorithm from ``centroids0`` (k, d): ``n_iter`` rounds of
    assignment (true float32 scores ‖c‖² − 2·p·c, argmin ties to the
    lower index) and update (each centroid the mean of its points, in
    index order; an empty cluster keeps its centroid), then a last
    assignment.  Stops early when the labels repeat (the centroids
    would too).  Returns (labels (n,) int32, centroids (k, d),
    inertia ())."""
    pts = points.float()
    c = centroids0.to(device=pts.device, dtype=torch.float32)
    k = c.shape[0]
    pp = _row_sum(pts * pts)
    prev = None
    for _ in range(n_iter):
        lab, _ = _assign(pts, pp, c)
        if prev is not None and torch.equal(lab, prev):
            break
        sums = _segment_sum(pts, lab, k)
        counts = torch.bincount(lab, minlength=k).float()[:, None]
        c = torch.where(counts > 0, sums / torch.clamp(counts, min=1.0), c)
        prev = lab
    lab, best = _assign(pts, pp, c)
    inertia = best.double().sum().float()
    return lab.to(torch.int32), c, inertia


@register("cluster.kmeans")
def kmeans(data: CellData, n_clusters: int = 8, n_iter: int = 25,
           use_rep: str = "X_pca", seed: int = 0,
           device=None) -> CellData:
    """k-means on ``obsm[use_rep]``: ``kmeans_init`` (seeded), then
    ``kmeans_lloyd``.  Adds obs ``kmeans`` (int32), uns
    ``kmeans_centroids`` and ``kmeans_inertia``."""
    dev = resolve_device(device)
    data = data.to_device(dev)
    rep = _get_rep(data, use_rep)[: data.n_cells].float()
    c0 = kmeans_init(rep, n_clusters, seed=seed)
    labels, centroids, inertia = kmeans_lloyd(rep, c0, n_iter=n_iter)
    return data.with_obs(kmeans=labels).with_uns(
        kmeans_centroids=centroids, kmeans_inertia=inertia)


# ----------------------------------------------------------------------
# cluster.dendrogram
# ----------------------------------------------------------------------


def _dendrogram(data: CellData, groupby: str, use_rep: str, method: str,
                rep: np.ndarray) -> CellData:
    from scipy.cluster import hierarchy
    from scipy.spatial.distance import squareform

    labels = _host(data.obs[groupby])[: data.n_cells]
    levels, codes = np.unique(labels, return_inverse=True)
    rep = np.asarray(rep, np.float64)[: data.n_cells]
    means = np.stack([rep[codes == g].mean(axis=0)
                      for g in range(len(levels))])
    if len(levels) < 2:
        raise ValueError(
            f"cluster.dendrogram: obs[{groupby!r}] has "
            f"{len(levels)} level(s); need at least 2")
    corr = np.corrcoef(means)
    # zero-variance centroids give NaN rows: uncorrelated (distance 1)
    corr = np.nan_to_num(corr, nan=0.0)
    np.fill_diagonal(corr, 1.0)
    dist = np.maximum(1.0 - corr, 0.0)
    np.fill_diagonal(dist, 0.0)
    Z = hierarchy.linkage(squareform(dist, checks=False), method=method)
    order = hierarchy.leaves_list(Z)
    return data.with_uns(**{f"dendrogram_{groupby}": {
        "linkage": Z,
        "groupby": groupby,
        "use_rep": use_rep,
        "categories_ordered": [str(levels[i]) for i in order],
        "categories_idx_ordered": order.astype(np.int64),
        "correlation_matrix": corr,
    }})


@register("cluster.dendrogram")
def dendrogram(data: CellData, groupby: str = "leiden",
               use_rep: str = "X_pca", method: str = "complete",
               device=None) -> CellData:
    """Hierarchical clustering of group centroids (scanpy
    ``tl.dendrogram``): per-group float64 means of ``obsm[use_rep]``,
    scipy linkage (default ``complete``) on the condensed 1 − Pearson
    correlation distance, leaf order.  Adds uns
    ``dendrogram_<groupby>``.  The (n_groups × d) linkage is host work,
    as in the reference, which also reads the embedding back to the
    host for the means."""
    data = data.to_device(resolve_device(device))
    return _dendrogram(data, groupby, use_rep, method,
                       _host(_get_rep(data, use_rep)))
