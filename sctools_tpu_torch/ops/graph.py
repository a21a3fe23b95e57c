"""Neighbour-graph ops of the post-kNN tail: ``graph.connectivities``,
``graph.jaccard``, ``graph.diffusion_operator``, ``impute.magic``, the
diffusion map ``embed.spectral`` (alias ``embed.diffmap``),
``dpt.pseudotime``, the partition-based graph abstraction ``graph.paga``
and the locality pass ``graph.reorder`` / ``graph.restore_order``.

Counterpart of ``sctools_tpu/ops/graph.py``.  The kNN graph stays in
its padded (n, k) edge-list form, as ``neighbors.knn`` produces it;
per-edge work is plain torch, and the gathers along the k axis that
dominate (the diffusion steps of MAGIC, Jaccard) go through the
kernels of ``graph_kernels``.  The RCM permutation is a host pass on
scipy, as in the reference; the permutation itself is applied on the
device.  PAGA's group statistics are host numpy over the graph, as in
the reference.  The ``uns`` keys are the reference's.

Not ported yet (ROADMAP.md Queue 1 item 10): the reference's telemetry
gauges and counters.
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

_LAYOUT_STATS = ("graph_bandwidth", "graph_tile_density")
_LAYOUT_KEYS = ("graph_perm", "graph_perm_inv", *_LAYOUT_STATS,
                "graph_reorder_method")


def _require_knn(data: CellData):
    if "knn_indices" not in data.obsp:
        raise ValueError("run neighbors.knn first")
    n = data.n_cells
    return data.obsp["knn_indices"][:n], data.obsp["knn_distances"][:n]


def _band(data: CellData) -> int | None:
    band = data.uns.get("graph_bandwidth")
    return int(band) if band is not None else None


def _host(v) -> np.ndarray:
    return v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


# ----------------------------------------------------------------------
# graph.connectivities
# ----------------------------------------------------------------------


def connectivities_arrays(knn_idx: torch.Tensor, knn_dist: torch.Tensor,
                          mode: str = "umap") -> torch.Tensor:
    """Edge weights (n, k) float32 from kNN distances.

    "umap": the fuzzy-simplicial-set weights ``exp(-(d - rho)/sigma)``
    with rho the distance to the nearest neighbour and sigma bisected
    (20 fixed steps) so each row's weights sum to log2(k).
    "gaussian": ``exp(-d² / (2σ²))`` with σ the row's mean distance.
    Self edges and -1 slots get weight 0 and enter neither rho nor σ."""
    n, k = knn_idx.shape
    rows = torch.arange(n, device=knn_idx.device, dtype=knn_idx.dtype)
    is_self = knn_idx == rows[:, None]
    inf = torch.tensor(float("inf"), device=knn_dist.device)
    d = torch.where((knn_idx < 0) | is_self, inf, knn_dist.float())
    finite = torch.isfinite(d)
    if mode == "gaussian":
        sigma = torch.where(finite, d, 0.0).sum(dim=1) / torch.clamp(
            finite.sum(dim=1), min=1)
        w = torch.exp(-(d * d) / torch.clamp(2.0 * sigma[:, None] ** 2,
                                             min=1e-12))
        return torch.where(finite, w, 0.0)
    if mode != "umap":
        raise ValueError(f"unknown connectivity mode {mode!r}")
    target = torch.log2(torch.tensor(float(max(k, 2)), device=d.device))
    rho = torch.where(finite, d, inf).amin(dim=1)
    shifted = torch.clamp(d - rho[:, None], min=0.0)

    def weight_sum(sigma):
        w = torch.exp(-shifted / torch.clamp(sigma[:, None], min=1e-12))
        return torch.where(finite, w, 0.0).sum(dim=1)

    lo = torch.full((n,), 1e-6, device=d.device)
    hi = torch.full((n,), 1e3, device=d.device)
    for _ in range(20):
        mid = 0.5 * (lo + hi)
        too_small = weight_sum(mid) < target  # sigma must grow
        lo = torch.where(too_small, mid, lo)
        hi = torch.where(too_small, hi, mid)
    sigma = 0.5 * (lo + hi)
    w = torch.exp(-shifted / torch.clamp(sigma[:, None], min=1e-12))
    return torch.where(finite, w, 0.0)


@register("graph.connectivities", fusable=True)
def connectivities(data: CellData, mode: str = "umap",
                   device=None) -> CellData:
    """Adds obsp ``connectivities`` (aligned with ``knn_indices``) and
    uns ``connectivity_mode``."""
    data = data.to_device(resolve_device(device))
    idx, dist = _require_knn(data)
    w = connectivities_arrays(idx, dist, mode=mode)
    return data.with_obsp(connectivities=w).with_uns(connectivity_mode=mode)


# ----------------------------------------------------------------------
# graph.jaccard
# ----------------------------------------------------------------------


def jaccard_arrays(knn_idx: torch.Tensor, block: int = 1024) -> torch.Tensor:
    """Per-edge Jaccard similarity of neighbour lists, the plain form
    (``sctools_tpu/ops/graph.py:jaccard_arrays``): the same counts as
    ``graph_kernels.jaccard`` (duplicates count), 0 on -1 slots, by the
    kernel's plain version on any device."""
    return graph_kernels.jaccard_plain(knn_idx, block=block)


@register("graph.jaccard", mem_cost=3.0)
def jaccard(data: CellData, block: int = 1024, device=None) -> CellData:
    """Adds obsp ``jaccard`` (aligned with ``knn_indices``): PhenoGraph's
    neighbour-set Jaccard weights through ``graph_kernels.jaccard``.
    ``block`` is the reference's row tile; it is accepted for signature
    parity and has no effect (the result is the same for every value)."""
    del block
    data = data.to_device(resolve_device(device))
    idx, _ = _require_knn(data)
    return data.with_obsp(jaccard=graph_kernels.jaccard(
        idx, band_rows=_band(data)))


# ----------------------------------------------------------------------
# Diffusion operator and the sparse matvec on the edge list
# ----------------------------------------------------------------------


def knn_matvec(knn_idx: torch.Tensor, weights: torch.Tensor,
               x: torch.Tensor, band_rows: int | None = None
               ) -> torch.Tensor:
    """``P @ x`` for the (n, k) edge-list matrix P: the
    ``graph_kernels.matvec`` kernel on the card, its plain version on
    the CPU."""
    return graph_kernels.matvec(knn_idx, weights, x, band_rows=band_rows)


def knn_rmatvec(knn_idx: torch.Tensor, weights: torch.Tensor,
                x: torch.Tensor, n: int | None = None,
                band_rows: int | None = None, order=None) -> torch.Tensor:
    """``Pᵀ @ x``, the adjoint of ``knn_matvec``, with ``n`` output rows
    (default: the rows of ``knn_idx``): the ``graph_kernels.rmatvec``
    kernel on the card, its plain version on the CPU.  ``order`` is
    ``graph_kernels.rmatvec_order(knn_idx, n)``, for callers that apply
    one graph many times."""
    return graph_kernels.rmatvec(knn_idx, weights, x, n,
                                 band_rows=band_rows, order=order)


def _symmetrized_weights(idx: torch.Tensor, w: torch.Tensor,
                         block: int = 8192, mode: str = "average"
                         ) -> torch.Tensor:
    """Symmetrise edge weights on the kNN edge list, looking up the
    reverse edge j→i of each edge i→j in j's list (one (block, k, k)
    equality mask per row block).

    "average": (w_ij + w_ji)/2 where the reverse edge exists, else w_ij.
    "mutual": the same average, one-sided edges dropped (exactly
    symmetric).  "union": the t-conorm ``w + w' - w·w'``.
    "union_norm": the t-conorm over the edge's directed multiplicity
    (1 + has-reverse-edge)."""
    if mode not in ("average", "mutual", "union", "union_norm"):
        raise ValueError(f"unknown symmetrisation mode {mode!r}")
    n, k = idx.shape
    # row n of the tables is the sentinel a -1 slot maps to: its "ids"
    # (-2) never equal a real row, so padding fabricates no reverse edge
    ids = idx.long()
    safe_tab = torch.cat([torch.where(ids < 0, -2, ids),
                          torch.full((1, k), -2, dtype=ids.dtype,
                                     device=ids.device)])
    wf = w.float()
    w_tab = torch.cat([wf, torch.zeros((1, k), device=wf.device)])
    out = torch.empty((n, k), dtype=torch.float32, device=wf.device)
    for r0 in range(0, n, block):
        iblk = ids[r0:r0 + block]
        wblk = wf[r0:r0 + block]
        rows = torch.arange(r0, r0 + iblk.shape[0], device=ids.device)
        sblk = torch.where(iblk < 0, n, iblk)
        hit = safe_tab[sblk] == rows[:, None, None]  # (block, k, k)
        w_rev = torch.where(hit, w_tab[sblk], 0.0).sum(dim=2)
        has_rev = hit.any(dim=2)
        if mode == "mutual":
            res = torch.where(has_rev, 0.5 * (wblk + w_rev), 0.0)
        elif mode == "union":
            res = wblk + w_rev - wblk * w_rev
        elif mode == "union_norm":
            res = (wblk + w_rev - wblk * w_rev) / (1.0 + has_rev.float())
        else:
            res = torch.where(has_rev, 0.5 * (wblk + w_rev), wblk)
        out[r0:r0 + iblk.shape[0]] = res
    return out


@register("graph.diffusion_operator", fusable=True)
def diffusion_operator(data: CellData, symmetrize: bool = True,
                       device=None) -> CellData:
    """Adds obsp ``diffusion_weights``: the row-normalised (row-
    stochastic) transition weights from ``connectivities`` (computed
    first if missing), symmetrised on the edge pattern as
    ``_symmetrized_weights(mode="average")`` does."""
    data = data.to_device(resolve_device(device))
    if "connectivities" not in data.obsp:
        data = connectivities(data, device=device)
    idx, _ = _require_knn(data)
    w = data.obsp["connectivities"][: data.n_cells]
    if symmetrize:
        w = _symmetrized_weights(idx, w)
    w = torch.where(idx < 0, 0.0, w)
    row = w.sum(dim=1, keepdim=True)
    return data.with_obsp(diffusion_weights=w / torch.clamp(row, min=1e-12))


# ----------------------------------------------------------------------
# impute.magic
# ----------------------------------------------------------------------


@register("impute.magic")
def magic(data: CellData, t: int = 3, use_rep: str = "X",
          n_genes_out: int | None = None, mesh=None,
          strategy: str = "all_gather", device=None) -> CellData:
    """MAGIC-style imputation: ``t`` diffusion steps of the expression
    matrix along the cell graph, each one ``knn_matvec`` with
    ``diffusion_weights`` (computed first if missing).  Adds obsm
    ``X_magic`` (dense (n, n_genes_out or n_genes) float32) and uns
    ``magic_t``.  Densifies gene space: subset genes first.  ``mesh=``
    (a ``parallel.make_mesh`` mesh) runs the diffusion with the rows
    sharded over its devices (``parallel.diffuse_sharded``);
    ``strategy="ring"`` holds one chunk of x a device instead of all of
    it."""
    data = data.to_device(resolve_device(device))
    if "diffusion_weights" not in data.obsp:
        data = diffusion_operator(data, device=device)
    idx, _ = _require_knn(data)
    n = data.n_cells
    p = data.obsp["diffusion_weights"][:n]
    if use_rep == "X":
        X = data.X
        Xd = X.to_dense() if isinstance(X, SparseCells) else X[:n]
    else:
        Xd = data.obsm[use_rep][:n]
    if n_genes_out is not None:
        Xd = Xd[:, :n_genes_out]
    out = Xd.float().contiguous()
    if mesh is not None:
        from ..parallel.graph_multichip import (diffuse_sharded,
                                                pad_rows_for_mesh)

        idx_p, p_p, x_p, _ = pad_rows_for_mesh(
            mesh, idx=idx[:n], weights=p, x=out, who="impute.magic")
        out = diffuse_sharded(idx_p, p_p, x_p, mesh, t,
                              strategy=strategy)[:n].to(out.device)
        return data.with_obsm(X_magic=out).with_uns(magic_t=t)
    band = _band(data)
    for _ in range(t):
        out = knn_matvec(idx, p, out, band_rows=band)
    return data.with_obsm(X_magic=out).with_uns(magic_t=t)


# ----------------------------------------------------------------------
# embed.spectral / embed.diffmap / dpt.pseudotime
# ----------------------------------------------------------------------


def _sym_normalized_edges(idx: torch.Tensor, w: torch.Tensor):
    """Edge weights of S = D^-1/2 W_mutual D^-1/2, the degree vector and
    D^-1/2.  W_mutual is exactly symmetric (one-sided edges dropped), so
    S is symmetric with its spectrum in [-1, 1]."""
    wm = _symmetrized_weights(idx, w, mode="mutual")
    wm = torch.where(idx < 0, 0.0, wm)
    deg = wm.sum(dim=1)
    inv_sqrt = torch.where(deg > 0, 1.0 / torch.sqrt(torch.clamp(
        deg, min=1e-12)), 0.0)
    safe = torch.where(idx < 0, 0, idx).long()
    return wm * inv_sqrt[:, None] * inv_sqrt[safe], deg, inv_sqrt


def diffusion_eigs(knn_idx: torch.Tensor, s_edges: torch.Tensor,
                   n_comps: int = 15, n_iter: int = 60,
                   band_rows: int | None = None,
                   v0: torch.Tensor | None = None, seed: int = 0):
    """Leading eigenpairs of the symmetric operator S on the edge list,
    by subspace iteration on (S + I)/2 (its spectrum shifted to [0, 1],
    so the largest algebraic eigenvalues lead) with CholeskyQR2 and a
    Rayleigh–Ritz step; matrix-free, one ``knn_matvec`` per iteration
    plus one.  ``v0`` (n, n_comps + 5) is the start block (see
    ``carry.spectral_v0_from_numpy``); without it a standard normal
    block is drawn from a ``torch.Generator`` seeded with ``seed``.
    Returns ``(evals (n_comps,), vecs (n, n_comps))`` by descending
    eigenvalue."""
    from .pca import cholesky_qr

    n = knn_idx.shape[0]
    width = n_comps + 5
    dev = knn_idx.device
    if v0 is None:
        gen = torch.Generator(device=dev).manual_seed(seed)
        v0 = torch.randn((n, width), generator=gen, device=dev)
    elif tuple(v0.shape) != (n, width):
        raise ValueError(
            f"v0 has shape {tuple(v0.shape)}, expected {(n, width)}")
    V = cholesky_qr(v0.to(device=dev, dtype=torch.float32))
    for _ in range(n_iter):
        V = cholesky_qr(0.5 * (knn_matvec(knn_idx, s_edges, V,
                                          band_rows=band_rows) + V))
    SV = knn_matvec(knn_idx, s_edges, V, band_rows=band_rows)
    with true_f32():
        H = V.T @ SV
        evals, W = torch.linalg.eigh(0.5 * (H + H.T))
        order = torch.argsort(-evals, stable=True)[:n_comps]
        rot = V @ W  # the Ritz rotation
    return evals[order], rot[:, order]


@register("embed.spectral")
def spectral(data: CellData, n_comps: int = 15, seed: int = 0,
             drop_first: bool = True, v0=None, device=None) -> CellData:
    """Diffusion-map embedding from the symmetric normalised kernel of
    ``connectivities`` (computed first if missing); the eigenvectors are
    mapped back to the random-walk convention (ψ = D^-1/2 φ, each column
    unit-normalised).  Adds obsm ``X_diffmap`` and uns
    ``diffmap_evals``; the trivial top eigenvector is dropped by
    default.  ``v0`` is the (n, n_comps + drop_first + 5) start block of
    ``diffusion_eigs``."""
    data = data.to_device(resolve_device(device))
    if "connectivities" not in data.obsp:
        data = connectivities(data, device=device)
    idx, _ = _require_knn(data)
    w = data.obsp["connectivities"][: data.n_cells]
    s, _, inv_sqrt = _sym_normalized_edges(idx, w)
    extra = 1 if drop_first else 0
    evals, phi = diffusion_eigs(
        idx, s, n_comps=n_comps + extra, band_rows=_band(data),
        v0=None if v0 is None else torch.as_tensor(v0), seed=seed)
    psi = phi * inv_sqrt[:, None]
    psi = psi / torch.clamp(torch.linalg.vector_norm(psi, dim=0,
                                                     keepdim=True),
                            min=1e-12)
    if drop_first:
        evals, psi = evals[1:], psi[:, 1:]
    return data.with_obsm(X_diffmap=psi).with_uns(diffmap_evals=evals)


@register("embed.diffmap")
def diffmap(data: CellData, n_comps: int = 15, seed: int = 0,
            drop_first: bool = True, v0=None, device=None) -> CellData:
    """scanpy's name (``tl.diffmap``) for ``embed.spectral``: the same
    computation."""
    return spectral(data, n_comps=n_comps, seed=seed, drop_first=drop_first,
                    v0=v0, device=device)


@register("dpt.pseudotime")
def dpt(data: CellData, root: int = 0, device=None) -> CellData:
    """Diffusion pseudotime: the Euclidean distance to the root cell in
    the eigenvalue-rescaled diffusion map (DPT's closed form), scaled to
    [0, 1].  Runs ``embed.spectral`` first if ``X_diffmap`` is missing.
    Adds obs ``dpt_pseudotime`` and uns ``dpt_root``."""
    data = data.to_device(resolve_device(device))
    if "X_diffmap" not in data.obsm:
        data = spectral(data, device=device)
    V = data.obsm["X_diffmap"]
    ev = data.uns["diffmap_evals"]
    Z = V * (ev / torch.clamp(1.0 - ev, min=1e-6))[None, :]
    d = torch.linalg.vector_norm(Z - Z[root], dim=1)
    d = d / torch.clamp(d.max(), min=1e-12)
    return data.with_obs(dpt_pseudotime=d).with_uns(dpt_root=root)


# ----------------------------------------------------------------------
# graph.paga — partition-based graph abstraction
# ----------------------------------------------------------------------


def _paga_stats(idx, w, labels, n_groups):
    """Inter-group connectivity statistics on the weighted kNN edge list
    (host numpy; the group graph is tiny).  theta follows scanpy's
    ``tl.paga`` v1.2: the symmetrised inter-group edge weight over its
    random-wiring expectation ``(es_i·n_j + es_j·n_i)/(n−1)`` (``es_g``
    the edge weight incident to group g, ``n_g`` its size), clipped to
    [0, 1].  Returns (C, expected, theta float32)."""
    import scipy.sparse as sp

    n, k = idx.shape
    rows = np.repeat(labels, k)
    cols = idx.reshape(-1)
    wf = np.asarray(w, np.float64).reshape(-1)
    # self-edges carry no inter-group information and would inflate es
    keep = (cols >= 0) & (wf > 0) & (cols != np.repeat(np.arange(n), k))
    lj = labels[np.clip(cols, 0, n - 1)]
    W = sp.coo_matrix((wf[keep], (rows[keep], lj[keep])),
                      shape=(n_groups, n_groups)).toarray()
    C = W + W.T  # symmetrised inter-group weight
    np.fill_diagonal(C, 0.0)
    sizes = np.bincount(labels, minlength=n_groups).astype(np.float64)
    es = W.sum(axis=1) + W.sum(axis=0)  # total incident weight per group
    expected = (np.outer(es, sizes) + np.outer(sizes, es)) / max(n - 1, 1)
    np.fill_diagonal(expected, 1.0)
    theta = np.clip(C / np.maximum(expected, 1e-12), 0.0, 1.0)
    np.fill_diagonal(theta, 0.0)
    return C, expected, theta.astype(np.float32)


@register("graph.paga")
def paga(data: CellData, groups: str = "leiden", device=None) -> CellData:
    """PAGA (partition-based graph abstraction): the cluster-level
    connectivity map of ``obs[groups]`` over the kNN graph
    (``_paga_stats``), weighted by obsp ``connectivities`` when its
    shape matches the graph's (a stale one warns and unit weights are
    used).  Adds uns ``paga_connectivities`` (G × G float32),
    ``paga_edge_weights``, ``paga_groups`` and ``paga_groups_key``."""
    data = data.to_device(resolve_device(device))
    if groups not in data.obs:
        raise KeyError(
            f"obs has no {groups!r} — run cluster.leiden (or another "
            "clustering) first")
    idx, _ = _require_knn(data)
    n = data.n_cells
    idx = _host(idx)
    w = None
    if "connectivities" in data.obsp:
        cand = _host(data.obsp["connectivities"]).astype(np.float64)[:n]
        if cand.shape == idx.shape:
            w = cand
        else:
            warnings.warn(
                "graph.paga: obsp['connectivities'] shape "
                f"{cand.shape} does not match the current kNN graph "
                f"{idx.shape} (stale after a kNN rebuild?) — using "
                "unit edge weights", stacklevel=3)
    if w is None:
        w = np.ones_like(idx, np.float64)
    labels = _host(data.obs[groups])[:n]
    uniq, codes = np.unique(labels, return_inverse=True)
    C, _, theta = _paga_stats(idx, w, codes.astype(np.int64), len(uniq))
    return data.with_uns(
        paga_connectivities=theta,
        paga_edge_weights=C.astype(np.float32),
        paga_groups=uniq,
        paga_groups_key=groups)


# ----------------------------------------------------------------------
# graph.reorder / graph.restore_order: the locality pass
# ----------------------------------------------------------------------


def reorder_permutation(knn_idx, method: str = "rcm") -> np.ndarray:
    """Row permutation (new → old, int64) that gathers the kNN graph's
    edges near the diagonal: ``"rcm"`` is reverse Cuthill–McKee on the
    symmetrised edge pattern (scipy, on the host); ``"natural"`` is the
    identity."""
    idx = _host(knn_idx)
    n, k = idx.shape
    if method == "natural":
        return np.arange(n, dtype=np.int64)
    if method != "rcm":
        raise ValueError(f"unknown reorder method {method!r}; "
                         "use 'rcm' or 'natural'")
    import scipy.sparse as sp
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    rows = np.repeat(np.arange(n), k)
    cols = idx.reshape(-1)
    keep = cols >= 0
    W = sp.csr_matrix((np.ones(int(keep.sum()), np.float32),
                       (rows[keep], cols[keep])), shape=(n, n))
    W = (W + W.T).tocsr()
    perm = np.asarray(reverse_cuthill_mckee(W, symmetric_mode=True))
    return perm.astype(np.int64)


def graph_bandwidth(knn_idx) -> int:
    """Max |i − j| over the stored edges (0 for an edgeless graph)."""
    idx = _host(knn_idx)
    rows = np.repeat(np.arange(idx.shape[0]), idx.shape[1]).reshape(
        idx.shape)
    d = np.abs(idx - rows)[idx >= 0]
    return int(d.max()) if d.size else 0


def tile_density(knn_idx, block: int = 256) -> float:
    """Fraction of stored edges within ``block`` rows of the diagonal
    (1.0 for an edgeless graph)."""
    idx = _host(knn_idx)
    rows = np.repeat(np.arange(idx.shape[0]), idx.shape[1]).reshape(
        idx.shape)
    valid = idx >= 0
    if not valid.any():
        return 1.0
    close = (np.abs(idx - rows) < block) & valid
    return float(close.sum() / valid.sum())


def invalidate_graph_layout_stats(data: CellData) -> CellData:
    """Drop ``graph_bandwidth`` and ``graph_tile_density`` from uns.
    Every op that replaces ``obsp['knn_indices']`` calls it: the
    statistics describe the old graph.  The permutation stays: it
    describes the row layout, which a kNN rebuild does not change."""
    if not any(key in data.uns for key in _LAYOUT_STATS):
        return data
    return data.replace(uns={key: v for key, v in data.uns.items()
                             if key not in _LAYOUT_STATS})


def _remap_edge_values(arr: torch.Tensor, inv: torch.Tensor
                       ) -> torch.Tensor:
    """Old row ids → new row ids inside an index-valued obsp tensor
    (-1 padding kept)."""
    safe = torch.where(arr < 0, 0, arr).long()
    return torch.where(arr < 0, arr, inv[safe].to(arr.dtype))


def _apply_permutation(data: CellData, perm: np.ndarray) -> CellData:
    """Row-permute every per-cell field (new row i = old row
    ``perm[i]``) on its device, remapping index-valued obsp tensors
    (names ending ``indices``) into the new row space.  obsp is set
    aside around the ``data[perm]`` subset, which drops pairwise graphs:
    a permutation is the one subset that keeps them valid."""
    n = data.n_cells
    perm = np.asarray(perm, np.int64)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm), dtype=np.int64)
    obsp = data.obsp
    base = data.replace(obsp={})[perm]
    new_obsp = {}
    for key, v in obsp.items():
        a = v[:n]
        if key.endswith("indices") and not a.is_floating_point():
            a = _remap_edge_values(a, torch.from_numpy(inv).to(a.device))
        new_obsp[key] = a.index_select(0, torch.from_numpy(perm).to(
            a.device))
    return base.replace(obsp=new_obsp)


@register("graph.reorder")
def reorder(data: CellData, method: str = "rcm", block: int = 256,
            device=None) -> CellData:
    """One-shot locality pass: permute the cells so that kNN neighbours
    sit near each other, and record uns ``graph_perm`` /
    ``graph_perm_inv`` (int32), ``graph_bandwidth``,
    ``graph_tile_density`` (scored against ``block``) and
    ``graph_reorder_method``, so that ``graph.restore_order`` can undo
    it.  X, obs, obsm, layers and obsp are permuted (index-valued obsp
    remapped).  A second reorder warns and returns its input."""
    data = data.to_device(resolve_device(device))
    if "graph_perm" in data.uns:
        warnings.warn(
            "graph.reorder: data already carries a layout permutation "
            "(uns['graph_perm']); run graph.restore_order first; "
            "returning the input unchanged", stacklevel=2)
        return data
    idx, _ = _require_knn(data)
    perm = reorder_permutation(idx, method=method)
    out = _apply_permutation(data, perm)
    new_idx = _host(out.obsp["knn_indices"])
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm), dtype=np.int64)
    return out.with_uns(
        graph_perm=perm.astype(np.int32),
        graph_perm_inv=inv.astype(np.int32),
        graph_bandwidth=graph_bandwidth(new_idx),
        graph_tile_density=tile_density(new_idx, block=block),
        graph_reorder_method=str(method))


@register("graph.restore_order")
def restore_order(data: CellData, device=None) -> CellData:
    """Undo ``graph.reorder``: put every per-cell field back in the
    caller's row order (bit for bit) and drop the layout keys from uns.
    Returns its input unchanged when no permutation is recorded."""
    device = resolve_device(device)
    if "graph_perm" not in data.uns:
        return data
    data = data.to_device(device)
    out = _apply_permutation(data, _host(data.uns["graph_perm_inv"]))
    return out.replace(uns={key: v for key, v in out.uns.items()
                            if key not in _LAYOUT_KEYS})
