"""``integrate.mnn`` — mutual-nearest-neighbour batch correction.

Counterpart of ``sctools_tpu/ops/mnn.py``: the published reducedMNN
recipe (Haghverdi et al. 2018; scanpy's ``external.pp.mnn_correct``) in
a reduced embedding:

1. order the batches largest first (ties as ``np.argsort``); the
   largest is the fixed reference;
2. for each further batch, the k nearest reference cells of each of its
   cells and the k nearest of its cells of each reference cell
   (euclidean); mutual pairs are edges in both lists;
3. each pair votes a correction vector (reference end − batch end),
   averaged per batch end, then smoothed over the batch by a Gaussian
   kernel on the distance to the nearest anchors, so that cells far
   from any anchor move with their neighbourhood;
4. the corrected batch joins the reference, and the next is merged
   against the enlarged set.

The three searches of a merge go through ``knn_arrays`` (one
``knn_select`` launch each on the card); the pair bookkeeping is host
numpy in float64, as in the reference.

One departure.  The smoothing's bandwidth is sigma × the median, over
the batch's cells, of the distance to the nearest anchor, and an
anchor's nearest anchor is itself.  When most cells are anchors (59 %
of the batch on ``tests/test_mnn.py``'s two-batch fixture), that
median is a self-distance.  The reference reads it from the float32
refine, |q|² − 2 q·c + |c|², which leaves rounding noise up to ~1e-2
in a fifth to a third of the self-distances, in places that depend on
the order of three float32 sums (another on the card).  The port
recomputes the smoothing distances in float64 from the differences of
the rows the search found, so a self-distance is 0 on every device.
On the tests' fixtures the port's X_mnn equals the reference's.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import resolve_device
from ..data.dataset import CellData
from ..registry import register
from .graph import _host
from .knn import knn_arrays


def _mutual_pairs(idx_b2r, idx_r2b):
    """(batch cell, reference cell) pairs present in both neighbour
    lists: ``idx_b2r`` (nB, k) reference ids of each batch cell,
    ``idx_r2b`` (nR, k) batch ids of each reference cell."""
    nB, k = idx_b2r.shape
    nR = idx_r2b.shape[0]
    # edge sets intersected on packed int64 keys b·nR + r; -1 padding
    # slots (k above the candidate count) are dropped before packing,
    # where b·nR − 1 would alias (b − 1)·nR + nR − 1 and make up pairs
    fwd = (np.repeat(np.arange(nB, dtype=np.int64), k) * nR
           + idx_b2r.ravel().astype(np.int64))
    fwd = fwd[idx_b2r.ravel() >= 0]
    rev = (idx_r2b.ravel().astype(np.int64) * nR
           + np.repeat(np.arange(nR, dtype=np.int64), idx_r2b.shape[1]))
    rev = rev[idx_r2b.ravel() >= 0]
    mutual = np.intersect1d(fwd, rev, assume_unique=False)
    return mutual // nR, mutual % nR


def _distances(x, y, idx) -> np.ndarray:
    """float64 euclidean distances of each row of ``x`` to the rows
    ``idx`` (n, m) of ``y``, by differences: a cell's distance to its
    own row is exactly 0 on every device.  In blocks of 4,096 rows."""
    out = np.empty(idx.shape, np.float64)
    for r0 in range(0, len(idx), 4096):
        sl = slice(r0, r0 + 4096)
        out[sl] = np.linalg.norm(x[sl, None, :] - y[idx[sl]], axis=2)
    return out


def _correct_one(ref, bat, k, sigma, knn):
    """The (nB, d) correction moving ``bat`` toward ``ref``."""
    k = min(k, len(ref), len(bat))  # tiny batches: no padded -1 ids
    idx_b2r, _ = knn(bat, ref, k)
    idx_r2b, _ = knn(ref, bat, k)
    bm, rm = _mutual_pairs(np.asarray(idx_b2r)[: len(bat)],
                           np.asarray(idx_r2b)[: len(ref)])
    if len(bm) == 0:
        raise ValueError(
            "integrate.mnn: no mutual pairs between batches — raise k "
            "or check that the batches share cell populations")
    # each batch end's mean pair vector
    vec = ref[rm] - bat[bm]
    uniq, inv = np.unique(bm, return_inverse=True)
    sums = np.zeros((len(uniq), bat.shape[1]), np.float64)
    np.add.at(sums, inv, vec)
    cnt = np.bincount(inv).astype(np.float64)
    anchor_vec = sums / cnt[:, None]
    anchors = bat[uniq]
    # smoothed over the batch: Gaussian weights on the distance to the
    # ksm nearest anchors, bandwidth sigma × the median nearest distance
    ksm = min(min(50, max(3 * k, 10)), len(uniq))
    a_idx, _ = knn(bat, anchors, ksm)
    a_idx = np.asarray(a_idx)[: len(bat)]
    a_d = _distances(bat, anchors, a_idx)
    med = np.median(a_d[:, 0]) + 1e-12
    h = sigma * med if sigma * med > 0 else 1.0
    w = np.exp(-0.5 * (a_d / h) ** 2) + 1e-12
    w /= w.sum(axis=1, keepdims=True)
    return np.einsum("ck,ckd->cd", w, anchor_vec[a_idx])


def search_on(dev):
    """The searches of a merge on ``dev``: ``knn(q, c, k)`` of host
    float64 rows → host (ids, distances), one exact euclidean
    ``knn_arrays`` with ``refine=max(k, 32)`` each."""

    def knn(q, c, kk):
        idx, d = knn_arrays(
            torch.from_numpy(q.astype(np.float32)).to(dev),
            torch.from_numpy(c.astype(np.float32)).to(dev), k=kk,
            metric="euclidean", n_query=len(q), n_cand=len(c),
            refine=max(kk, 32))
        return idx.cpu().numpy(), d.cpu().numpy()

    return knn


def _mnn(data: CellData, batch_key, use_rep, k, sigma, knn):
    n = data.n_cells
    labels = _host(data.obs[batch_key])[:n]
    Z = _host(data.obsm[use_rep]).astype(np.float64)[:n]
    levels, codes = np.unique(labels, return_inverse=True)
    if len(levels) < 2:
        raise ValueError("integrate.mnn: need at least 2 batches")
    order = np.argsort([-np.sum(codes == i) for i in range(len(levels))])
    out = Z.copy()
    ref_rows = np.where(codes == order[0])[0]
    for li in order[1:]:
        rows = np.where(codes == li)[0]
        out[rows] += _correct_one(out[ref_rows], out[rows], k, sigma, knn)
        ref_rows = np.concatenate([ref_rows, rows])
    return out.astype(np.float32), [str(levels[i]) for i in order]


@register("integrate.mnn")
def mnn(data: CellData, batch_key: str = "batch", use_rep: str = "X_pca",
        k: int = 20, sigma: float = 1.0, device=None) -> CellData:
    """Adds obsm ``X_mnn`` (the corrected embedding, n_cells rows) and
    uns ``mnn_merge_order``.  Each search is an exact euclidean
    ``knn_arrays`` with ``refine=max(k, 32)``: one ``knn_select``
    launch on the card, three a merge."""
    dev = resolve_device(device)
    if batch_key not in data.obs:
        raise KeyError(f"integrate.mnn: obs has no {batch_key!r}")
    data = data.to_device(dev)
    out, merge_order = _mnn(data, batch_key, use_rep, k, sigma,
                            search_on(dev))
    return data.with_obsm(X_mnn=torch.from_numpy(out).to(dev)).with_uns(
        mnn_merge_order=merge_order)
