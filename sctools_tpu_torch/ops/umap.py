"""Graph layouts: ``embed.umap``, ``embed.force_directed`` and its
scanpy name ``embed.draw_graph``.

Counterpart of ``sctools_tpu/ops/umap.py``, with its full-batch
scheme: every epoch, every kNN edge pulls its two ends together at
once (a row gather along the k axis for the edge's source, and the
reaction summed onto its target), every cell draws ``n_neg`` uniform
negative samples that push it away, and the step size decays linearly.
The arithmetic is the reference's, term for term (clamped ``d²`` under
the negative power, clips at ±4 for UMAP and ±10 for ForceAtlas2,
``alpha = lr·(1 − step/n_epochs)`` in float32).

Two departures, both for repeatable bits:

* the negative samples come from ``negative_samples``, one
  ``(n, n_neg)`` int32 draw an epoch from a seeded CPU
  ``torch.Generator``: the same cells on every device, but not the
  reference's ``jax.random`` bits, which no port can reproduce (tests
  replace ``negative_samples`` by the reference's draws);
* the reaction on each edge's target is a fixed-order segment sum
  (``_Edges``: the directed edges sorted stably by target once, then
  ``cluster._segment_sum`` each epoch), the order of the reference's
  ``segment_sum`` on the CPU.  ``index_add_`` on the card would add in
  no fixed order, and a layout would not repeat.

The reference's numpy ``backend="cpu"`` layouts are its test oracles
and are not ported.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import resolve_device
from ..data.dataset import CellData
from ..registry import register
from .cluster import _row_sum, _segment_sum, segment_order
from .graph import (_require_knn, _symmetrized_weights, connectivities,
                    spectral)
from .graph_kernels import gather_rows

_EPS = 1e-3


def fit_ab(min_dist: float = 0.1, spread: float = 1.0):
    """The (a, b) of Φ(d) = 1/(1 + a·d^{2b}) fitted to exp(-(d -
    min_dist)/spread) beyond min_dist and 1 below it, by least squares
    on a grid (umap-learn's calibration); the canonical defaults are
    constants."""
    if abs(min_dist - 0.1) < 1e-9 and abs(spread - 1.0) < 1e-9:
        return 1.5769434, 0.8950608
    from scipy.optimize import curve_fit

    xv = np.linspace(0, spread * 3, 300)
    yv = np.where(xv < min_dist, 1.0, np.exp(-(xv - min_dist) / spread))
    (a, b), _ = curve_fit(lambda x, a, b: 1.0 / (1.0 + a * x ** (2 * b)),
                          xv, yv, p0=(1.5, 0.9), maxfev=10000)
    return float(a), float(b)


def negative_samples(seed: int, n_epochs: int, n: int, n_neg: int):
    """Yields each epoch's negative samples: an (n, n_neg) int32 CPU
    tensor of uniform cell ids, drawn from a CPU ``torch.Generator``
    seeded with ``seed``, so every device gets the same cells."""
    gen = torch.Generator().manual_seed(seed)
    for _ in range(n_epochs):
        yield torch.randint(0, n, (n, n_neg), generator=gen,
                            dtype=torch.int32)


class _Edges:
    """The directed edge list of a layout: weights with self edges and -1
    slots zeroed, the gather ids (-1 → 0), and the target order of the
    reaction's segment sum, built once for every epoch."""

    def __init__(self, knn_idx: torch.Tensor, weights: torch.Tensor):
        n, _ = knn_idx.shape
        rows = torch.arange(n, device=knn_idx.device)[:, None]
        dead = (knn_idx < 0) | (knn_idx == rows)
        self.n = n
        self.w = torch.where(dead, 0.0, weights.float())
        self.safe = torch.where(knn_idx < 0, 0, knn_idx).long()
        self.order = segment_order(self.safe.reshape(-1), n)

    def reaction(self, att: torch.Tensor) -> torch.Tensor:
        """Σ over the edges i→j of ``-att[i, slot]`` onto j, each target's
        edges added in edge order: (n, d)."""
        return _segment_sum((-att).reshape(-1, att.shape[2]), None, self.n,
                            order=self.order)


def _alphas(lr: float, n_epochs: int, device) -> torch.Tensor:
    """``lr·(1 − step/n_epochs)`` for every epoch, in float32 as the
    reference's scan computes it, on the CPU and then moved: the card
    divides by a scalar through its reciprocal, an ulp off."""
    steps = torch.arange(n_epochs, dtype=torch.float32)
    return (lr * (1.0 - steps / n_epochs)).to(device)


def _draws(seed, n_epochs, n, n_neg, device):
    for negs in negative_samples(seed, n_epochs, n, n_neg):
        yield negs.to(device).long()


def umap_layout_arrays(knn_idx: torch.Tensor, weights: torch.Tensor,
                       init: torch.Tensor, seed: int, n_epochs: int = 200,
                       n_neg: int = 5, a: float = 1.5769434,
                       b: float = 0.8950608, lr: float = 1.0,
                       repulsion_strength: float = 1.0) -> torch.Tensor:
    """Optimise the layout.  ``knn_idx``/``weights``: (n, k) symmetrised
    fuzzy graph (self edges and -1 slots weigh 0); ``init``: (n, d).
    Returns the final (n, d) float32 embedding on ``knn_idx``'s
    device."""
    dev = knn_idx.device
    e = _Edges(knn_idx, weights)
    w = e.w[:, :, None]
    y = init.to(device=dev, dtype=torch.float32)
    att_c = -2.0 * a * b
    rep_c = torch.tensor(2.0 * repulsion_strength * b, device=dev)
    alphas = _alphas(lr, n_epochs, dev)
    for step, negs in enumerate(_draws(seed, n_epochs, e.n, n_neg, dev)):
        diff = y[:, None, :] - gather_rows(y, e.safe)      # (n, k, d)
        d2 = (diff * diff).sum(dim=2)
        # attraction along the edges (d² clamped under the negative
        # power b - 1, not in the denominator), scaled by w
        coef = att_c * torch.clamp(d2, min=_EPS) ** (b - 1.0) \
            / (1.0 + a * d2 ** b)
        att = torch.clamp(coef[:, :, None] * diff, -4.0, 4.0) * w
        g = att.sum(dim=1) + e.reaction(att)
        diff_n = y[:, None, :] - gather_rows(y, negs)
        d2n = (diff_n * diff_n).sum(dim=2)
        # a true division: a Python number over a tensor would take
        # the reciprocal first
        coef_n = torch.div(rep_c, (_EPS + d2n) * (1.0 + a * d2n ** b))
        g = g + torch.clamp(coef_n[:, :, None] * diff_n, -4.0, 4.0).sum(
            dim=1)
        y = y + alphas[step] * g
    return y


def fa2_layout_arrays(knn_idx: torch.Tensor, weights: torch.Tensor,
                      init: torch.Tensor, seed: int, n_epochs: int = 300,
                      n_neg: int = 10, repulsion: float = 1.0,
                      gravity: float = 1.0, lr: float = 0.1
                      ) -> torch.Tensor:
    """ForceAtlas2-style layout on the kNN graph, full-batch: linear
    attraction ``-w·diff`` along the edges, repulsion
    ``(deg_i+1)(deg_j+1)/d²`` averaged over ``n_neg`` negative samples
    and scaled by ``repulsion``, gravity toward the origin, the step
    clipped to ±10.  The card repeats the CPU's bits: the sums over
    the k and ``n_neg`` axes add left to right (``cluster._row_sum``),
    and the norm's root is taken in float64, which rounds to the
    correctly rounded float32 root on every device."""
    dev = knn_idx.device
    e = _Edges(knn_idx, weights)
    w = e.w[:, :, None]
    deg = _row_sum(e.w) + 1.0
    y = init.to(device=dev, dtype=torch.float32)
    rep_scale = repulsion / max(n_neg, 1)
    alphas = _alphas(lr, n_epochs, dev)
    for step, negs in enumerate(_draws(seed, n_epochs, e.n, n_neg, dev)):
        diff = y[:, None, :] - gather_rows(y, e.safe)
        att = -(w * diff)
        g = _row_sum(att) + e.reaction(att)
        diff_n = y[:, None, :] - gather_rows(y, negs)
        d2n = (diff_n * diff_n).sum(dim=2)
        coef_n = (deg[:, None] * deg[negs]) / (_EPS + d2n)
        rep = torch.clamp(coef_n[:, :, None] * diff_n, -10.0, 10.0)
        g = g + rep_scale * _row_sum(rep)
        # ‖y_i‖ as jnp.linalg.norm computes it: the root of Σ y²
        norm = torch.sqrt((y * y).sum(dim=1, keepdim=True).double()).float()
        g = g - gravity * deg[:, None] * y / torch.clamp(norm, min=_EPS)
        y = y + alphas[step] * torch.clamp(g, -10.0, 10.0)
    return y


def _spectral_init(data: CellData, n_dims: int, seed: int, device,
                   scale: float = 10.0, v0=None) -> torch.Tensor:
    """UMAP's start: the leading diffusion-map coordinates
    (``embed.spectral`` at ``n_comps=n_dims``; ``v0`` its (n, n_dims +
    6) start block, e.g. the reference's through
    ``carry.spectral_v0_from_numpy``) rescaled to about [-scale, scale],
    plus the reference's host noise from ``np.random.default_rng(seed)``,
    bit for bit."""
    d = spectral(data, n_comps=n_dims, seed=seed, v0=v0, device=device)
    emb = d.obsm["X_diffmap"][: data.n_cells, :n_dims].cpu().numpy()
    emb = emb / max(np.abs(emb).max(), 1e-12) * scale
    rng = np.random.default_rng(seed)
    noisy = (emb + rng.normal(scale=1e-3, size=emb.shape)).astype(np.float32)
    return torch.from_numpy(noisy).to(device)


def _layout_start(data: CellData, n_dims: int, seed: int, init, device,
                  scale: float) -> torch.Tensor:
    if init is None:
        return _spectral_init(data, n_dims, seed, device, scale=scale)
    init = torch.as_tensor(init, dtype=torch.float32)
    n = data.n_cells
    if tuple(init.shape) != (n, n_dims):
        raise ValueError(
            f"init must have shape ({n}, {n_dims}), got "
            f"{tuple(init.shape)}")
    return init.to(device)


def _graph(data: CellData, device):
    """``data`` with connectivities (computed if missing), its kNN ids
    and the connectivities' rows."""
    if "connectivities" not in data.obsp:
        data = connectivities(data, device=device)
    n = data.n_cells
    idx, _ = _require_knn(data)
    return data, idx, data.obsp["connectivities"][:n].float()


@register("embed.umap")
def umap(data: CellData, n_dims: int = 2, min_dist: float = 0.1,
         spread: float = 1.0, n_epochs: int = 200, n_neg: int = 5,
         lr: float = 1.0, seed: int = 0, init=None,
         device=None) -> CellData:
    """Adds obsm ``X_umap`` and uns ``umap_min_dist``.  Needs
    neighbors.knn (connectivities are computed if missing).  The edges
    carry the fuzzy-set union of their two directions over the edge's
    directed multiplicity (``_symmetrized_weights(mode="union_norm")``),
    so with the reaction each end gets the union weight once.  ``init``
    replaces the spectral start by an (n, n_dims) layout."""
    device = resolve_device(device)
    data = data.to_device(device)
    data, idx, w = _graph(data, device)
    w = _symmetrized_weights(idx, w, mode="union_norm")
    y0 = _layout_start(data, n_dims, seed, init, device, scale=10.0)
    a, b = fit_ab(min_dist, spread)
    y = umap_layout_arrays(idx, w, y0, seed, n_epochs=n_epochs, n_neg=n_neg,
                           a=a, b=b, lr=lr)
    return data.with_obsm(X_umap=y).with_uns(umap_min_dist=min_dist)


@register("embed.force_directed")
def force_directed(data: CellData, n_dims: int = 2, n_epochs: int = 300,
                   n_neg: int = 10, repulsion: float = 1.0,
                   gravity: float = 1.0, lr: float = 0.1, seed: int = 0,
                   init=None, device=None) -> CellData:
    """ForceAtlas2-style graph layout (scanpy's ``tl.draw_graph``) on the
    directed connectivities.  Adds obsm ``X_draw_graph``.  Needs
    neighbors.knn.  The spectral start is scaled to about [-1, 1]."""
    device = resolve_device(device)
    data = data.to_device(device)
    data, idx, w = _graph(data, device)
    y0 = _layout_start(data, n_dims, seed, init, device, scale=1.0)
    y = fa2_layout_arrays(idx, w, y0, seed, n_epochs=n_epochs, n_neg=n_neg,
                          repulsion=repulsion, gravity=gravity, lr=lr)
    return data.with_obsm(X_draw_graph=y)


@register("embed.draw_graph")
def draw_graph(data: CellData, n_dims: int = 2, n_epochs: int = 300,
               n_neg: int = 10, repulsion: float = 1.0,
               gravity: float = 1.0, lr: float = 0.1, seed: int = 0,
               init=None, device=None) -> CellData:
    """scanpy's name for ``embed.force_directed``: the same computation
    and the same obsm ``X_draw_graph``."""
    return force_directed(data, n_dims=n_dims, n_epochs=n_epochs,
                          n_neg=n_neg, repulsion=repulsion, gravity=gravity,
                          lr=lr, seed=seed, init=init, device=device)
