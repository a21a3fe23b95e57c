"""k-nearest-neighbour graphs: ``neighbors.knn`` and ``neighbors.bbknn``.

Counterpart of ``sctools_tpu/ops/knn.py``.  The search is brute force,
through the fused distance + top-k of ``knn_kernel``: the CUDA kernel
on the card, its plain version on the CPU, so the full N×N distance
matrix never exists.  ``config.knn_impl`` picks the merge: exact
(``knn_select``, the default) or binned (``knn_binned`` under
``"pallas_binned"``, approximate once there are more candidates than
``config.knn_bins``); ``"xla"`` is the reference's blocked search in
plain torch (``_knn_blocked``).  ``refine`` re-ranks a wider coarse
search (e.g. under the bf16 matmul policy or the binned merge) exactly
in float32, by query block or in sorted id order
(``config.knn_refine_mode``).

``knn_numpy`` and ``recall_at_k`` are the float64 oracle and the recall
metric, copied so that the port needs nothing of the reference.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..config import config, resolve_device, round_up, true_f32
from ..data.dataset import CellData
from ..data.sparse import SparseCells
from ..registry import register
from ..utils.sync import hard_sync
from .knn_kernel import _write_top, knn_binned, knn_select


def _prep(points: torch.Tensor, metric: str, dtype: torch.dtype
          ) -> torch.Tensor:
    points = points.float()
    if metric == "cosine":
        norms = torch.linalg.vector_norm(points, dim=1, keepdim=True)
        points = points / torch.clamp(norms, min=1e-12)
    return points.to(dtype).contiguous()


def knn_arrays(query: torch.Tensor, cand: torch.Tensor, *, k: int = 15,
               metric: str = "cosine", n_query: int | None = None,
               n_cand: int | None = None, exclude_self: bool = False,
               refine: int = 0, n_valid_cand: int | None = None):
    """Exact kNN of the first ``n_query`` rows of ``query`` against the
    first ``n_cand`` rows of ``cand``.

    Returns (indices (n_query_padded, k) int32, distances float32),
    sorted by distance; cosine distance is ``1 - cos``, euclidean the L2
    distance, correlation the cosine distance of the row-centred
    vectors.  ``n_query_padded`` rounds ``n_query`` up to
    ``min(config.row_block, 256)``, as the reference's fused kernel pads
    it; the padding rows hold id -1 and distance 0.  Ties go to the
    lower candidate id.  ``exclude_self`` drops the pair of equal ids
    (use only when query is cand).  Scores follow
    ``config.matmul_dtype``; ``refine > 0`` searches ``max(k, refine)``
    candidates and re-ranks them exactly in float32, gathering as
    ``config.resolved_refine_mode(n_cand)`` says.  Under
    ``knn_impl="pallas_binned"`` the search keeps one candidate per bin
    of ``config.knn_bins`` (ties to the lower bin) and raises when the
    search width exceeds ``knn_bins``; under ``"xla"`` it is the
    blocked search of :func:`_knn_blocked`.

    ``n_valid_cand``: only the first so many candidate rows are real,
    the rest of ``cand[:n_cand]`` is padding.  The kernels search the
    real rows alone; the blocked search masks the rest to ``-inf``, as
    the reference's traced mask does.  Both give the same neighbours."""
    if metric == "correlation":
        # Pearson correlation distance is the cosine distance of the
        # row-centred vectors
        query = query - query.mean(dim=1, keepdim=True)
        cand = cand - cand.mean(dim=1, keepdim=True)
        metric = "cosine"
    if metric not in ("cosine", "euclidean"):
        raise ValueError(f"unknown metric {metric!r}")
    if config.knn_coarse not in ("topk", "approx"):
        raise ValueError(
            f"unknown knn_coarse {config.knn_coarse!r} (expected 'topk' "
            "or 'approx')")
    impl = config.resolved_knn_impl()
    n_query = n_query or query.shape[0]
    n_cand = n_cand or cand.shape[0]
    n_valid = n_cand if n_valid_cand is None else min(int(n_valid_cand),
                                                      n_cand)
    k_search = max(k, refine) if refine else k
    mm = config.matmul_torch_dtype()
    q = _prep(query[:n_query], metric, mm)
    if impl == "xla":
        vals, idx = _knn_blocked(q, _prep(cand[:n_cand], metric, mm),
                                 n_valid, k=k_search, metric=metric,
                                 exclude_self=exclude_self)
    elif impl == "binned":
        vals, idx = knn_binned(q, _prep(cand[:n_valid], metric, mm),
                               k=k_search, n_bins=config.knn_bins,
                               metric=metric, exclude_self=exclude_self)
    else:
        vals, idx = knn_select(q, _prep(cand[:n_valid], metric, mm),
                               k=k_search, metric=metric,
                               exclude_self=exclude_self)
    if refine:
        refine_fn = (_refine_sorted
                     if config.resolved_refine_mode(n_cand) == "sorted"
                     else _refine)
        idx, dist = refine_fn(query[:n_query], cand[:n_cand], idx, k=k,
                              metric=metric)
    else:
        dist = _to_dist(vals, metric)
    pad = round_up(n_query, min(config.row_block, 256)) - n_query
    idx = torch.cat([idx, torch.full((pad, k), -1, dtype=torch.int32,
                                      device=idx.device)])
    dist = torch.cat([dist, torch.zeros((pad, k), dtype=dist.dtype,
                                        device=dist.device)])
    return idx, dist


def _to_dist(vals: torch.Tensor, metric: str) -> torch.Tensor:
    """Distances of scores: ``1 - s`` for cosine, ``sqrt(max(-s, 0))``
    for euclidean (whose score is the negated squared distance)."""
    if metric == "cosine":
        return 1.0 - vals
    return torch.sqrt(torch.clamp(-vals, min=0.0))


def _top(vals: torch.Tensor, k: int):
    """The ``k`` largest of each row and their columns, ties to the
    lower column (``lax.top_k``'s rule)."""
    v, sel = torch.sort(vals, dim=1, descending=True, stable=True)
    return v[:, :k], sel[:, :k]


def _knn_blocked(q: torch.Tensor, c: torch.Tensor, n_valid: int, *, k: int,
                 metric: str, exclude_self: bool):
    """The blocked search of ``knn_impl="xla"`` (the reference's
    ``_knn_jit``) on rows prepared by ``_prep``: per block of
    ``config.row_block`` queries, the candidate blocks of
    ``config.col_block`` rows in ascending order, each score tile one
    true-float32 ``torch.matmul`` (bf16 inputs multiplied as their
    float32 values, so products are exact and sums float32).  Columns at
    or past ``n_valid`` and, under ``exclude_self``, the query's own id
    score ``-inf``.  Each tile is merged into the running ``(rows, k)``
    top k with ties to the lower id.  ``config.knn_coarse`` has no
    branch here: the reference's "approx" (``lax.approx_max_k`` on the
    fresh tile) is exact off the TPU, so on every device the port runs
    it selects what "topk" selects; the counterpart of its binned TPU
    selection is ``knn_impl="pallas_binned"``.  Returns ``(values (nq,
    k) float32, ids (nq, k) int32)``, id -1 where no finite score is
    left."""
    qb, cb = config.row_block, config.col_block
    nq, nc = q.shape[0], c.shape[0]
    dev = q.device
    qf, cf = q.float(), c.float()
    euclid = metric == "euclidean"
    cn2 = (cf * cf).sum(dim=1) if euclid else None
    out_v = torch.empty((nq, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((nq, k), dtype=torch.int32, device=dev)
    for q0 in range(0, nq, qb):
        qblk = qf[q0:q0 + qb]
        b = qblk.shape[0]
        qn2 = (qblk * qblk).sum(dim=1) if euclid else None
        qids = torch.arange(q0, q0 + b, device=dev)
        bv = torch.full((b, k), float("-inf"), device=dev)
        bi = torch.full((b, k), -1, dtype=torch.int64, device=dev)
        for c0 in range(0, nc, cb):
            c1 = min(nc, c0 + cb)
            with true_f32():
                s = qblk @ cf[c0:c1].T
            if euclid:
                s = -((qn2[:, None] - 2.0 * s) + cn2[None, c0:c1])
            gcol = torch.arange(c0, c1, device=dev)
            if c1 > n_valid:
                s = s.masked_fill(gcol[None, :] >= n_valid, float("-inf"))
            if exclude_self:
                s = s.masked_fill(gcol[None, :] == qids[:, None],
                                  float("-inf"))
            gcol = gcol.expand(b, -1)
            bv, sel = _top(torch.cat([bv, s], dim=1), k)
            bi = torch.gather(torch.cat([bi, gcol], dim=1), 1, sel)
        _write_top(bv, bi, out_v[q0:q0 + b], out_i[q0:q0 + b])
    return out_v, out_i


def _refine_rows(query: torch.Tensor, cand: torch.Tensor, metric: str):
    """The refine's float32 rows, normalised for cosine."""
    q, c = query.float(), cand.float()
    if metric == "cosine":
        q = q / torch.clamp(torch.linalg.vector_norm(q, dim=1, keepdim=True),
                            min=1e-12)
        c = c / torch.clamp(torch.linalg.vector_norm(c, dim=1, keepdim=True),
                            min=1e-12)
    return q, c


def _refine(query: torch.Tensor, cand: torch.Tensor, cand_idx: torch.Tensor,
            *, k: int, metric: str):
    """Exact float32 re-rank of per-query candidate lists ``cand_idx``
    (-1 = no candidate) per query block (``knn_refine_mode="blocked"``);
    the top ``k`` by exact score, ties to the earlier list position
    (``lax.top_k``'s rule)."""
    q, c = _refine_rows(query, cand, metric)
    idx_out, dist_out = [], []
    block = config.row_block
    with true_f32():
        for q0 in range(0, q.shape[0], block):
            qb = q[q0:q0 + block]
            ib = cand_idx[q0:q0 + block]
            g = c[torch.clamp(ib, min=0).long()]  # (qb, k', d)
            s = torch.einsum("qd,qkd->qk", qb, g)
            if metric == "euclidean":
                qn2 = (qb * qb).sum(dim=1)
                cn2 = (g * g).sum(dim=2)
                s = -((qn2[:, None] - 2.0 * s) + cn2)
            v, sel = _top(s.masked_fill(ib < 0, float("-inf")), k)
            idx_out.append(torch.gather(ib, 1, sel))
            dist_out.append(_to_dist(v, metric))
    return torch.cat(idx_out), torch.cat(dist_out)


SORTED_SLICE = 1 << 19  # gathered rows a slice of the sorted refine


def _refine_sorted(query: torch.Tensor, cand: torch.Tensor,
                   cand_idx: torch.Tensor, *, k: int, metric: str):
    """The refine of ``knn_refine_mode="sorted"`` (the reference's
    ``_refine_sorted_jit``): the same lists and selection rule as
    :func:`_refine`, gathered for locality.  All candidate ids are
    argsorted once (-1 sorts last), candidate rows are gathered in
    ascending id order in slices of ``SORTED_SLICE``, each scored
    against its owner query as it arrives, and only the scores go back
    through the inverse permutation.  Scores equal the blocked refine's
    up to float32 reduction order."""
    q, c = _refine_rows(query, cand, metric)
    nq, kp = cand_idx.shape
    nc = c.shape[0]
    flat = cand_idx.reshape(-1).long()
    order = torch.argsort(torch.where(flat < 0, nc, flat), stable=True)
    ids = flat[order].clamp(min=0)
    owner = order // kp
    scores = torch.empty(flat.shape[0], dtype=torch.float32,
                         device=c.device)
    for s0 in range(0, flat.shape[0], SORTED_SLICE):
        part = slice(s0, s0 + SORTED_SLICE)
        g = c[ids[part]]
        qg = q[owner[part]]
        s = (qg * g).sum(dim=1)
        if metric == "euclidean":
            s = -(((qg * qg).sum(dim=1) - 2.0 * s) + (g * g).sum(dim=1))
        scores[order[part]] = s
    s = scores.reshape(nq, kp).masked_fill(cand_idx < 0, float("-inf"))
    v, sel = _top(s, k)
    return torch.gather(cand_idx, 1, sel), _to_dist(v, metric)


def resolve_knn_chunk(chunk: int, n: int) -> int:
    """The query-chunk size :func:`iter_knn_chunks` uses: ``chunk``
    capped at ``n`` and rounded up to ``config.row_block``, so that
    every chunk but the last is whole."""
    return round_up(min(max(chunk, 1), n), config.row_block)


def iter_knn_chunks(scores: torch.Tensor, *, k: int, chunk: int,
                    metric: str = "cosine", refine: int = 0,
                    n: int | None = None):
    """Query-chunked self-kNN of the first ``n`` rows of ``scores``:
    yields ``(offset, nq, idx, dist, wall_s)`` per chunk, ``idx`` and
    ``dist`` trimmed to the chunk's ``nq`` valid rows.  Each chunk is one
    :func:`knn_arrays` call (one ``knn_select`` launch on the card)
    against all ``n`` candidates, drained (``hard_sync``) before it is
    yielded; ``wall_s`` is its host time from the call to the drain.
    The consumer decides about budgets and early stops (it just stops
    iterating)."""
    n = n or int(scores.shape[0])
    chunk = resolve_knn_chunk(chunk, n)
    for off in range(0, n, chunk):
        nq = min(chunk, n - off)
        t0 = time.perf_counter()
        idx_c, dist_c = knn_arrays(scores[off:off + nq], scores, k=k,
                                   metric=metric, n_query=nq, n_cand=n,
                                   refine=refine)
        hard_sync(idx_c, dist_c)
        yield off, nq, idx_c[:nq], dist_c[:nq], time.perf_counter() - t0


def _get_rep(data: CellData, use_rep: str) -> torch.Tensor:
    if use_rep == "X":
        if isinstance(data.X, SparseCells):
            raise ValueError(
                "neighbors.knn on raw sparse X is not supported; run "
                "pca.randomized first (use_rep='X_pca')")
        return data.X
    if use_rep not in data.obsm:
        raise ValueError(
            f"use_rep={use_rep!r} not in obsm ({sorted(data.obsm)}); run "
            "pca.randomized first")
    return data.obsm[use_rep]


@register("neighbors.knn", mask_aware=True)
def knn(data: CellData, k: int = 15, metric: str = "cosine",
        use_rep: str = "X_pca", exclude_self: bool = False,
        refine: int = 0, device=None) -> CellData:
    """Adds obsp ``knn_indices`` and ``knn_distances`` (rows padded as
    ``knn_arrays`` pads them), uns ``knn_k`` and ``knn_metric``.  The
    graph-layout statistics of an earlier ``graph.reorder`` (measured
    on the graph this call replaces) are dropped; its permutation
    stays, since the row layout is unchanged."""
    from .graph import invalidate_graph_layout_stats

    data = data.to_device(resolve_device(device))
    rep = _get_rep(data, use_rep)
    idx, dist = knn_arrays(rep, rep, k=k, metric=metric,
                           n_query=data.n_cells, n_cand=data.n_cells,
                           exclude_self=exclude_self, refine=refine)
    data = invalidate_graph_layout_stats(data)
    return data.with_obsp(knn_indices=idx, knn_distances=dist).with_uns(
        knn_k=k, knn_metric=metric)


def knn_numpy(query, cand, k=15, metric="cosine", exclude_self=False,
              chunk=4096):
    """Exact brute-force kNN in numpy float64 — the recall oracle."""
    query = np.asarray(query, np.float64)
    cand = np.asarray(cand, np.float64)
    if metric == "correlation":
        query = query - query.mean(axis=1, keepdims=True)
        cand = cand - cand.mean(axis=1, keepdims=True)
        metric = "cosine"
    if metric == "cosine":
        qn = query / np.maximum(
            np.linalg.norm(query, axis=1, keepdims=True), 1e-12)
        cn = cand / np.maximum(
            np.linalg.norm(cand, axis=1, keepdims=True), 1e-12)
    n = len(query)
    out_i = np.empty((n, k), np.int32)
    out_d = np.empty((n, k), np.float32)
    cn2 = (cand ** 2).sum(axis=1)
    for s in range(0, n, chunk):
        e = min(n, s + chunk)
        if metric == "cosine":
            score = qn[s:e] @ cn.T
        else:
            qn2 = (query[s:e] ** 2).sum(axis=1)
            score = -(qn2[:, None] - 2 * (query[s:e] @ cand.T)
                      + cn2[None, :])
        if exclude_self:
            rows = np.arange(s, e)
            valid = rows < len(cand)
            score[np.arange(e - s)[valid], rows[valid]] = -np.inf
        part = np.argpartition(-score, k - 1, axis=1)[:, :k]
        ps = np.take_along_axis(score, part, axis=1)
        order = np.argsort(-ps, axis=1, kind="stable")
        out_i[s:e] = np.take_along_axis(part, order, axis=1)
        sc = np.take_along_axis(ps, order, axis=1)
        out_d[s:e] = (1.0 - sc) if metric == "cosine" else np.sqrt(
            np.maximum(-sc, 0.0))
    return out_i, out_d


def recall_at_k(pred_idx, true_idx, k: int | None = None) -> float:
    """Mean fraction of the true k neighbours recovered
    (order-insensitive); ``-1`` padding in ``pred_idx`` never matches."""
    pred_idx = np.asarray(pred_idx)
    true_idx = np.asarray(true_idx)
    n = min(len(pred_idx), len(true_idx))
    pred_idx, true_idx = pred_idx[:n], true_idx[:n]
    if k is not None:
        pred_idx, true_idx = pred_idx[:, :k], true_idx[:, :k]
    hits = (true_idx[:, :, None] == pred_idx[:, None, :]).any(axis=2)
    return float(hits.sum()) / (n * true_idx.shape[1])


# ----------------------------------------------------------------------
# neighbors.bbknn — batch-balanced kNN
# ----------------------------------------------------------------------


def _bbknn_combine(parts):
    """Stack per-batch (idx, dist) results and sort each row by
    distance (missing slots ranked last)."""
    gi = np.concatenate([p[0] for p in parts], axis=1)   # (n, B*k)
    gd = np.concatenate([p[1] for p in parts], axis=1)
    gd = np.where(gi < 0, np.inf, gd)
    order = np.argsort(gd, axis=1, kind="stable")
    gi = np.take_along_axis(gi, order, axis=1)
    gd = np.take_along_axis(gd, order, axis=1)
    gd = np.where(gi < 0, np.inf, gd).astype(np.float32)
    return gi.astype(np.int32), np.where(np.isfinite(gd), gd, 0.0)


def _bbknn_driver(batch, n, k_within, search):
    """One BBKNN pass over host arrays, given ``search(sel, k) -> (idx,
    dist)`` of every cell against the batch's cells ``sel`` (ids local
    to ``sel``).  Each batch contributes exactly ``k_within`` columns;
    a batch with fewer cells pads with -1.  A cell's own row is a
    candidate only in its own batch, where local and global ids differ,
    so each search takes one extra neighbour and the self match is
    dropped by global id."""
    levels = np.unique(batch)
    if len(levels) < 2:
        raise ValueError("bbknn needs >= 2 batches")
    parts = []
    for lv in levels:
        sel = np.flatnonzero(batch == lv)
        idx, dist = search(sel, min(k_within + 1, len(sel)))
        idx = np.asarray(idx)[:n]
        dist = np.asarray(dist)[:n]
        gidx = np.where(idx >= 0, sel[np.clip(idx, 0, len(sel) - 1)], -1)
        self_hit = gidx == np.arange(n)[:, None]
        gidx = np.where(self_hit, -1, gidx)
        dist = np.where(self_hit, np.inf, dist)
        order = np.argsort(np.where(gidx < 0, np.inf, dist), axis=1,
                           kind="stable")[:, :k_within]
        gi = np.take_along_axis(gidx, order, axis=1)
        gd = np.take_along_axis(dist, order, axis=1)
        if gi.shape[1] < k_within:  # batch smaller than k_within
            pad = k_within - gi.shape[1]
            gi = np.pad(gi, ((0, 0), (0, pad)), constant_values=-1)
            gd = np.pad(gd, ((0, 0), (0, pad)), constant_values=np.inf)
        parts.append((gi, gd))
    return _bbknn_combine(parts), levels


@register("neighbors.bbknn")
def bbknn(data: CellData, batch_key: str = "batch", k_within: int = 3,
          metric: str = "cosine", use_rep: str = "X_pca", refine: int = 0,
          device=None) -> CellData:
    """Batch-balanced kNN (the BBKNN method): every cell takes its
    ``k_within`` nearest neighbours from each batch of obs
    ``batch_key``, so no batch can monopolise a neighbourhood.  Adds
    obsp ``knn_indices`` / ``knn_distances`` with k = n_batches ×
    ``k_within`` (one row per cell, sorted by distance, self matches
    dropped, -1 where a batch has too few cells), uns ``knn_k``,
    ``knn_metric``, ``bbknn_batches`` and ``bbknn_k_within``.  One
    :func:`knn_arrays` search per batch: one ``knn_select`` launch on
    the card."""
    from .graph import invalidate_graph_layout_stats

    if batch_key not in data.obs:
        raise KeyError(f"obs has no {batch_key!r}")
    data = data.to_device(resolve_device(device))
    n = data.n_cells
    rep = _get_rep(data, use_rep)[:n]
    batch = data.obs[batch_key]
    batch = (batch.cpu().numpy() if isinstance(batch, torch.Tensor)
             else np.asarray(batch))[:n]

    def search(sel, k):
        # the reference pads each batch's candidates to a multiple of
        # 1024 rows and masks the padding (n_valid_cand) so that batches
        # share compiled programs; eager torch compiles nothing, so the
        # batch's rows are searched as they are
        cand = rep[torch.from_numpy(sel).to(rep.device)]
        idx, dist = knn_arrays(rep, cand, k=k, metric=metric, n_query=n,
                               n_cand=len(sel), refine=refine)
        return idx.cpu().numpy(), dist.cpu().numpy()

    (gi, gd), levels = _bbknn_driver(batch, n, k_within, search)
    data = invalidate_graph_layout_stats(data)
    return data.with_obsp(
        knn_indices=torch.from_numpy(gi).to(rep.device),
        knn_distances=torch.from_numpy(gd).to(rep.device)).with_uns(
        knn_k=gi.shape[1], knn_metric=metric, bbknn_batches=levels,
        bbknn_k_within=k_within)
