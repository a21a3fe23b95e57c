"""k-nearest-neighbour graph: ``neighbors.knn``.

Counterpart of ``sctools_tpu/ops/knn.py``.  The search is brute force,
through the fused distance + top-k of ``knn_kernel``: the CUDA kernel
on the card, its plain version on the CPU, so the full N×N distance
matrix never exists.  ``config.knn_impl`` picks the merge: exact
(``knn_select``, the default) or binned (``knn_binned`` under
``"pallas_binned"``, approximate once there are more candidates than
``config.knn_bins``).  ``refine`` re-ranks a wider coarse search (e.g.
under the bf16 matmul policy or the binned merge) exactly in float32.

``knn_numpy`` and ``recall_at_k`` are the float64 oracle and the recall
metric, copied so that the port needs nothing of the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import config, resolve_device, round_up, true_f32
from ..data.dataset import CellData
from ..data.sparse import SparseCells
from ..registry import register
from .knn_kernel import knn_binned, knn_select


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
               refine: int = 0):
    """Exact kNN of the first ``n_query`` rows of ``query`` against the
    first ``n_cand`` rows of ``cand``.

    Returns (indices (n_query_padded, k) int32, distances float32),
    sorted by distance; cosine distance is ``1 - cos``, euclidean the L2
    distance.  ``n_query_padded`` rounds ``n_query`` up to
    ``min(config.row_block, 256)``, as the reference's fused kernel pads
    it; the padding rows hold id -1 and distance 0.  Ties go to the
    lower candidate id.  ``exclude_self`` drops the pair of equal ids
    (use only when query is cand).  Scores follow
    ``config.matmul_dtype``; ``refine > 0`` searches ``max(k, refine)``
    candidates and re-ranks them exactly in float32.  Under
    ``knn_impl="pallas_binned"`` the search keeps one candidate per bin
    of ``config.knn_bins`` (ties to the lower bin) and raises when the
    search width exceeds ``knn_bins``."""
    if metric not in ("cosine", "euclidean"):
        raise ValueError(f"unknown metric {metric!r}")
    impl = config.resolved_knn_impl()
    n_query = n_query or query.shape[0]
    n_cand = n_cand or cand.shape[0]
    k_search = max(k, refine) if refine else k
    mm = config.matmul_torch_dtype()
    q = _prep(query[:n_query], metric, mm)
    c = _prep(cand[:n_cand], metric, mm)
    if impl == "binned":
        vals, idx = knn_binned(q, c, k=k_search, n_bins=config.knn_bins,
                               metric=metric, exclude_self=exclude_self)
    else:
        vals, idx = knn_select(q, c, k=k_search, metric=metric,
                               exclude_self=exclude_self)
    if refine:
        idx, dist = _refine(query[:n_query], cand[:n_cand], idx, k=k,
                            metric=metric)
    else:
        dist = (1.0 - vals) if metric == "cosine" else torch.sqrt(
            torch.clamp(-vals, min=0.0))
    pad = round_up(n_query, min(config.row_block, 256)) - n_query
    idx = torch.cat([idx, torch.full((pad, k), -1, dtype=torch.int32,
                                      device=idx.device)])
    dist = torch.cat([dist, torch.zeros((pad, k), dtype=dist.dtype,
                                        device=dist.device)])
    return idx, dist


def _refine(query: torch.Tensor, cand: torch.Tensor, cand_idx: torch.Tensor,
            *, k: int, metric: str):
    """Exact float32 re-rank of per-query candidate lists ``cand_idx``
    (-1 = no candidate) per query block; the top ``k`` by exact score,
    ties to the earlier list position (``lax.top_k``'s rule)."""
    q = query.float()
    c = cand.float()
    if metric == "cosine":
        q = q / torch.clamp(torch.linalg.vector_norm(q, dim=1, keepdim=True),
                            min=1e-12)
        c = c / torch.clamp(torch.linalg.vector_norm(c, dim=1, keepdim=True),
                            min=1e-12)
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
            s = s.masked_fill(ib < 0, float("-inf"))
            v, sel = torch.sort(s, dim=1, descending=True, stable=True)
            v = v[:, :k]
            idx_out.append(torch.gather(ib, 1, sel[:, :k]))
            dist_out.append((1.0 - v) if metric == "cosine" else torch.sqrt(
                torch.clamp(-v, min=0.0)))
    return torch.cat(idx_out), torch.cat(dist_out)


def resolve_knn_chunk(chunk: int, n: int) -> int:
    """The query-chunk size :func:`iter_knn_chunks` uses: ``chunk``
    capped at ``n`` and rounded up to ``config.row_block``, so that
    every chunk but the last is whole."""
    return round_up(min(max(chunk, 1), n), config.row_block)


def iter_knn_chunks(scores: torch.Tensor, *, k: int, chunk: int,
                    metric: str = "cosine", refine: int = 0,
                    n: int | None = None):
    """Query-chunked self-kNN of the first ``n`` rows of ``scores``:
    yields ``(offset, nq, idx, dist)`` per chunk, ``idx`` and ``dist``
    trimmed to the chunk's ``nq`` valid rows.  Each chunk is one
    :func:`knn_arrays` call (one ``knn_select`` launch on the card)
    against all ``n`` candidates.  The consumer decides about budgets
    and early stops (it just stops iterating); one that times the
    chunks syncs the card itself."""
    n = n or int(scores.shape[0])
    chunk = resolve_knn_chunk(chunk, n)
    for off in range(0, n, chunk):
        nq = min(chunk, n - off)
        idx_c, dist_c = knn_arrays(scores[off:off + nq], scores, k=k,
                                   metric=metric, n_query=nq, n_cand=n,
                                   refine=refine)
        yield off, nq, idx_c[:nq], dist_c[:nq]


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
