"""RNA velocity (``velocity.*``): moments, the steady-state and
stochastic γ fits, the velocity graph and its embedding arrows, the
CellRank-style fate chain (terminal states, fate probabilities, lineage
drivers) and the dynamical model (``recover_dynamics``,
``latent_time``).

Counterpart of ``sctools_tpu/ops/velocity.py``, with its formulas,
thresholds and keys.  Every stage runs on the device of the data:

* the moments are ``knn_matvec`` steps (``graph_matvec`` on the card)
  over the union-symmetrised connectivities, or the cell-sharded
  ``smooth_layers_sharded`` with ``mesh=``;
* the γ fits are per-gene masked reductions in float32, their
  steady-state mask cut at ``torch.quantile`` per gene, as
  ``jnp.quantile`` cuts it;
* the velocity cosines are chunked gathers of the displacements along
  a flat edge list;
* the fate chain, host numpy in the reference, runs on the device in
  float64 with fixed-order sums, so that it repeats bit for bit: the
  union edges stay flat (``_Chain``: the reference pads every row to
  the largest in-degree, hundreds of slots at a hub), the stationary
  vector adds each cell's in-edges in edge order (a stable sort by
  target, built once), the absorption probabilities add each row's
  edges in slot order; each round reads its stop rule on the host, as
  the reference's loops do.  The connected components of the top cells
  stay a host search, as in the reference;
* the dynamical fit carries every gene's five parameters as one
  (g, 5) tensor: each gene's mean loss is summed, so autograd gives
  each gene its own gradient, and Adam runs by hand with the
  reference's constants.  Genes are fitted in chunks that bound the
  (n, genes) autograd state and the (n, genes, n_grid) assignment.

``velocity.embedding``'s softmax arrows, host float64 in the reference,
run on the device in float64.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import resolve_device, true_f32
from ..data.dataset import CellData
from ..data.sparse import SparseCells
from ..registry import register
from .cluster import _segment_sum, segment_order
from .graph import (_band, _host, _require_knn, _symmetrized_weights,
                    connectivities, knn_matvec)

_EDGE_CHUNK = 32768  # edges a chunk of the cosine gathers
_QUANTILE_ELEMS = 1 << 24  # elements a torch.quantile call
_DYN_ELEMS = 1 << 26  # (cells × genes) a chunk of the dynamical fit
_ASSIGN_ELEMS = 1 << 28  # (cells × genes × grid) a chunk of its assignment


def _dense_layer(data: CellData, name: str) -> torch.Tensor:
    if name not in data.layers:
        hint = ("run velocity.moments first" if name in ("Ms", "Mu")
                else "set layers['spliced']/layers['unspliced'] first")
        raise KeyError(f"velocity: layers has no {name!r} — {hint}")
    L = data.layers[name]
    n = data.n_cells
    if isinstance(L, SparseCells):
        return L.to_dense()[:n]
    return L[:n].float()


def _quantile_cols(t: torch.Tensor, q: float) -> torch.Tensor:
    """``jnp.quantile(t, q, axis=0, keepdims=True)``: (1, g), by
    ``torch.quantile`` over column blocks of at most 2^24 elements (a
    larger input raises on some torch builds)."""
    cols = max(1, _QUANTILE_ELEMS // max(t.shape[0], 1))
    return torch.cat([torch.quantile(t[:, c0:c0 + cols], q, dim=0,
                                     keepdim=True)
                      for c0 in range(0, t.shape[1], cols)], dim=1)


# ----------------------------------------------------------------------
# velocity.moments
# ----------------------------------------------------------------------


@register("velocity.moments", sharding="cells", collective=True)
def moments(data: CellData, second: bool = False, mesh=None,
            strategy: str = "all_gather", device=None) -> CellData:
    """Adds layers ``Ms``/``Mu``: spliced and unspliced smoothed over the
    kNN graph, ``(X + W X) / (1 + rowsum W)`` with W the fuzzy union of
    each edge's two directions (scVelo's ``pp.moments`` on scanpy's
    symmetric connectivities; computed first if missing).
    ``second=True`` also adds ``Mss``/``Mus`` (the smoothed S² and U·S)
    for the stochastic model.  ``mesh=`` (a ``parallel.make_mesh``
    mesh) smooths the gene-concatenated layers with the cells sharded
    over its devices, ``strategy="ring"`` holding one chunk a
    device."""
    device = resolve_device(device)
    data = data.to_device(device)
    n = data.n_cells
    # the layers first: a missing one must not cost the connectivities
    S = _dense_layer(data, "spliced")
    U = _dense_layer(data, "unspliced")
    if "connectivities" not in data.obsp:
        data = connectivities(data, device=device)
    idx, _ = _require_knn(data)
    w = _symmetrized_weights(idx, data.obsp["connectivities"][:n],
                             mode="union")
    w = torch.where(idx < 0, 0.0, w)
    if mesh is not None:
        from ..parallel.graph_multichip import (pad_rows_for_mesh,
                                                smooth_layers_sharded)

        mats = [S, U] + ([S * S, U * S] if second else [])
        # one sharded product over the gene-concatenated layers: the
        # smoothing is per gene, and one edge split serves all of them
        idx_p, w_p, big, _ = pad_rows_for_mesh(
            mesh, idx=idx, weights=w, x=torch.cat(mats, dim=1),
            who="velocity.moments")
        sm = smooth_layers_sharded(idx_p, w_p, [big], mesh,
                                   strategy=strategy)[0][:n].to(device)
        g = S.shape[1]
        out = {"Ms": sm[:, :g], "Mu": sm[:, g:2 * g]}
        if second:
            out["Mss"] = sm[:, 2 * g:3 * g]
            out["Mus"] = sm[:, 3 * g:]
        return data.with_layers(**out)
    denom = 1.0 + w.sum(dim=1, keepdim=True)
    band = _band(data)

    def smooth(X):
        return (X + knn_matvec(idx, w, X.contiguous(), band_rows=band)) \
            / denom

    out = {"Ms": smooth(S), "Mu": smooth(U)}
    if second:
        out["Mss"] = smooth(S * S)
        out["Mus"] = smooth(U * S)
    return data.with_layers(**out)


# ----------------------------------------------------------------------
# velocity.estimate
# ----------------------------------------------------------------------


def _steady_state_fit(Ms: torch.Tensor, Mu: torch.Tensor, q: float):
    """Per-gene γ through the origin over the extreme cells: Ms + Mu at
    or above its (1 − q) quantile, or at most 0 (the two presumed steady
    states).  Returns (γ, r², Mu − γ·Ms), float32."""
    t = Ms + Mu
    hi = _quantile_cols(t, 1.0 - q)
    wm = ((t >= hi) | (t <= 0.0)).float()
    sxy = (wm * Ms * Mu).sum(dim=0)
    sxx = (wm * Ms * Ms).sum(dim=0)
    gamma = sxy / torch.clamp(sxx, min=1e-12)
    resid = Mu - gamma[None, :] * Ms
    # r² of the through-origin fit on the extreme set
    ss_res = (wm * resid * resid).sum(dim=0)
    mu_mean = (wm * Mu).sum(dim=0) / torch.clamp(wm.sum(dim=0), min=1.0)
    ss_tot = (wm * (Mu - mu_mean[None, :]) ** 2).sum(dim=0)
    r2 = 1.0 - ss_res / torch.clamp(ss_tot, min=1e-12)
    return gamma, r2, resid


def _stochastic_fit(Ms, Mu, Mss, Mus, q: float):
    """scVelo's stochastic mode: γ of the stacked system [Mu; 2·Mus +
    Mu] = γ·[Ms; 2·Mss − Ms] over the extreme cells, by least squares
    weighted with each equation's inverse residual variance from the
    first-moment pre-fit.  Returns (γ, r², Mu − γ·Ms), float32 (the
    reference's device path)."""
    t = Ms + Mu
    hi = _quantile_cols(t, 1.0 - q)
    wm = ((t >= hi) | (t <= 0.0)).to(Ms.dtype)
    x2 = 2.0 * Mss - Ms
    y2 = 2.0 * Mus + Mu
    cnt = torch.clamp(wm.sum(dim=0), min=1.0)
    g0 = ((wm * Ms * Mu).sum(dim=0)
          / torch.clamp((wm * Ms * Ms).sum(dim=0), min=1e-12))
    r1 = wm * (Mu - g0[None, :] * Ms)
    r2_ = wm * (y2 - g0[None, :] * x2)
    v1 = torch.clamp((r1 * r1).sum(dim=0) / cnt, min=1e-12)
    v2 = torch.clamp((r2_ * r2_).sum(dim=0) / cnt, min=1e-12)
    del r1, r2_
    sxy = ((wm * Ms * Mu).sum(dim=0) / v1
           + (wm * x2 * y2).sum(dim=0) / v2)
    sxx = ((wm * Ms * Ms).sum(dim=0) / v1
           + (wm * x2 * x2).sum(dim=0) / v2)
    gamma = sxy / torch.clamp(sxx, min=1e-12)
    vel = Mu - gamma[None, :] * Ms
    resid2 = y2 - gamma[None, :] * x2
    ss_res = (wm * (vel * vel / v1[None, :]
                    + resid2 * resid2 / v2[None, :])).sum(dim=0)
    del resid2
    mu_m = (wm * Mu).sum(dim=0) / cnt
    y2_m = (wm * y2).sum(dim=0) / cnt
    ss_tot = (wm * ((Mu - mu_m[None, :]) ** 2 / v1[None, :]
                    + (y2 - y2_m[None, :]) ** 2
                    / v2[None, :])).sum(dim=0)
    r2 = 1.0 - ss_res / torch.clamp(ss_tot, min=1e-12)
    return gamma, r2, vel


@register("velocity.estimate")
def estimate(data: CellData, quantile: float = 0.05, min_r2: float = 0.01,
             mode: str = "deterministic", device=None) -> CellData:
    """Adds layers ``velocity`` (Mu − γ·Ms), var ``velocity_gamma``,
    ``velocity_r2`` and ``velocity_genes`` (r² > min_r2).
    ``mode="stochastic"`` fits γ on the stacked first- and second-moment
    system (scVelo's default mode; Mss/Mus are computed if missing)."""
    device = resolve_device(device)
    data = data.to_device(device)
    if mode == "stochastic" and "Mss" not in data.layers:
        data = moments(data, second=True, device=device)
    if "Ms" not in data.layers:
        data = moments(data, device=device)
    n = data.n_cells
    Ms = data.layers["Ms"][:n].float()
    Mu = data.layers["Mu"][:n].float()
    if mode == "stochastic":
        gamma, r2, vel = _stochastic_fit(
            Ms, Mu, data.layers["Mss"][:n].float(),
            data.layers["Mus"][:n].float(), quantile)
    else:
        gamma, r2, vel = _steady_state_fit(Ms, Mu, quantile)
    return (data.with_layers(velocity=vel)
            .with_var(velocity_gamma=gamma, velocity_r2=r2,
                      velocity_genes=r2 > min_r2))


# ----------------------------------------------------------------------
# velocity.graph
# ----------------------------------------------------------------------


def _edge_cosines(Ms: torch.Tensor, V: torch.Tensor, rows: torch.Tensor,
                  cols: torch.Tensor, chunk: int = _EDGE_CHUNK
                  ) -> torch.Tensor:
    """cos(V_i, Ms_j − Ms_i) for the edges (i, j) = (``rows``, ``cols``):
    (E,) float32, ``chunk`` edges at a time.  The dot products are
    elementwise products summed over the genes (no matrix product, so
    TF32 cannot round them)."""
    out = torch.empty(rows.shape[0], dtype=torch.float32, device=Ms.device)
    vn = torch.clamp(torch.linalg.vector_norm(V, dim=1), min=1e-12)
    for e0 in range(0, rows.shape[0], chunk):
        r, c = rows[e0:e0 + chunk], cols[e0:e0 + chunk]
        delta = Ms[c] - Ms[r]                                  # (e, g)
        num = (delta * V[r]).sum(dim=1)
        dn = torch.linalg.vector_norm(delta, dim=1) * vn[r]
        out[e0:e0 + chunk] = num / torch.clamp(dn, min=1e-12)
    return out


def _velocity_genes(data: CellData, n: int):
    """Ms and velocity (n, genes) over var ``velocity_genes`` (all genes
    without it)."""
    genes = data.var.get("velocity_genes")
    Ms = data.layers["Ms"][:n].float()
    V = data.layers["velocity"][:n].float()
    if genes is None:
        return Ms, V
    genes = torch.as_tensor(genes, device=Ms.device).bool()
    return Ms[:, genes], V[:, genes]


@register("velocity.graph")
def velocity_graph(data: CellData, device=None) -> CellData:
    """Adds obsp ``velocity_graph``: cos(velocity_i, Ms_j − Ms_i) over
    the kNN edges, aligned with obsp ``knn_indices`` (the padded (n, k)
    edge list, 0 on -1 slots, never an (n, n) matrix), over the velocity
    genes."""
    device = resolve_device(device)
    data = data.to_device(device)
    if "velocity" not in data.layers:
        raise KeyError("velocity.graph: run velocity.estimate first")
    n = data.n_cells
    Ms, V = _velocity_genes(data, n)
    idx = data.obsp["knn_indices"][:n]
    valid = idx >= 0
    rows, slots = valid.nonzero(as_tuple=True)
    cos = torch.zeros(idx.shape, dtype=torch.float32, device=device)
    cos[rows, slots] = _edge_cosines(Ms, V, rows, idx[rows, slots].long())
    return data.with_obsp(velocity_graph=cos)


# ----------------------------------------------------------------------
# velocity.embedding
# ----------------------------------------------------------------------


@register("velocity.embedding")
def embedding(data: CellData, basis: str = "umap", scale: float = 0.1,
              device=None) -> CellData:
    """Adds obsm ``velocity_<basis>``: each cell's arrow Σ_j (T_ij −
    1/k_i)(e_j − e_i), T the softmax of the velocity-graph cosines over
    the cell's edges, in float64 (subtracting the uniform expectation
    keeps a zero-velocity cell's arrow at about 0)."""
    device = resolve_device(device)
    data = data.to_device(device)
    key = f"X_{basis}" if not basis.startswith("X_") else basis
    if key not in data.obsm:
        raise KeyError(f"velocity.embedding: obsm has no {key!r}")
    if "velocity_graph" not in data.obsp:
        raise KeyError("velocity.embedding: run velocity.graph first")
    n = data.n_cells
    E = data.obsm[key][:n].double()
    idx = data.obsp["knn_indices"][:n]
    cos = data.obsp["velocity_graph"][:n].double()
    z = torch.where(idx < 0, float("-inf"), cos / scale)
    z = z - z.amax(dim=1, keepdim=True)
    T = torch.exp(z)
    T = T / torch.clamp(T.sum(dim=1, keepdim=True), min=1e-12)
    k_eff = torch.clamp((idx >= 0).sum(dim=1, keepdim=True), min=1)
    uniform = torch.where(idx >= 0, 1.0 / k_eff.double(), 0.0)
    safe = torch.where(idx < 0, 0, idx).long()
    delta = E[safe] - E[:, None, :]
    arrows = torch.einsum("ck,ckd->cd", T - uniform, delta)
    col = f"velocity_{basis.removeprefix('X_')}"
    return data.with_obsm(**{col: arrows.float()})


# ----------------------------------------------------------------------
# velocity.terminal_states / velocity.fate_probabilities
# ----------------------------------------------------------------------


def _sym_pairs(idx: np.ndarray, weights: np.ndarray | None = None):
    """The undirected edge list of ``sctools_tpu/ops/wishbone.py:
    _sym_edges`` (the port's copy, host numpy), flat instead of padded
    to the largest row: every directed kNN edge and its reverse, each
    pair once, sorted by source, then target.  Returns (sources,
    targets, edges a source), and with ``weights`` (n, k) each pair's
    weight as a fourth item: its first occurrence's, the forward edge's
    where there is one (the stable sort keeps the input order)."""
    n, k = idx.shape
    rows = np.repeat(np.arange(n), k)
    cols = idx.reshape(-1)
    keep = cols >= 0
    rows, cols = rows[keep], cols[keep]
    a = np.concatenate([rows, cols])
    b = np.concatenate([cols, rows])
    order = np.lexsort((b, a))
    a, b = a[order], b[order]
    first = np.ones(len(a), bool)
    first[1:] = (a[1:] != a[:-1]) | (b[1:] != b[:-1])
    a, b = a[first], b[first]
    if weights is None:
        return a, b, np.bincount(a, minlength=n)
    w = np.tile(np.asarray(weights).reshape(-1)[keep], 2)[order][first]
    return a, b, np.bincount(a, minlength=n), w


class _Chain:
    """The velocity-directed chain on the union edges, flat: ``rows``
    and ``cols`` (E,) sorted by row, then column (the slot order of
    ``_sym_edges``), ``lengths`` (n,) the edges of each row, ``T`` (E,)
    float64 row-stochastic.  A row's sum adds its edges in slot order
    (``torch.segment_reduce`` over the lengths, on every device)."""

    def __init__(self, rows, cols, lengths, T=None):
        self.rows, self.cols, self.lengths, self.T = rows, cols, lengths, T
        self.n = lengths.shape[0]

    def row_sums(self, x: torch.Tensor) -> torch.Tensor:
        """Σ over each row's edges of ``x`` (E,) or (E, d), in slot
        order: (n,) or (n, d)."""
        flat = x.dim() == 1
        out = torch.segment_reduce(x[:, None] if flat else x, "sum",
                                   lengths=self.lengths, axis=0)
        return out[:, 0] if flat else out

    def host_lists(self):
        """(cols, row starts) on the host, for the component search."""
        starts = np.zeros(self.n + 1, np.int64)
        np.cumsum(self.lengths.cpu().numpy(), out=starts[1:])
        return self.cols.cpu().numpy(), starts


def _velocity_transition(data: CellData, scale: float,
                         lambda_conn: float = 0.2) -> _Chain:
    """Row-stochastic T (float64) over the undirected union of the kNN
    edges: a (1 − λ)/λ blend of the velocity kernel exp(cos/scale) with
    a uniform walk (CellRank's kernel combination).  The union support
    keeps a branch reachable where only its reverse edge exists; the
    uniform part keeps a near-deterministic velocity kernel from
    funnelling all mass into one branch.  The edges stay flat: a hub's
    row (hundreds of in-edges) would pad every row to its length."""
    n = data.n_cells
    if "velocity" not in data.layers or "Ms" not in data.layers:
        raise KeyError("velocity fate mapping: run velocity.estimate "
                       "(and velocity.graph) first")
    if "knn_indices" not in data.obsp:
        raise KeyError("velocity fate mapping: run neighbors.knn first")
    a, b, counts = _sym_pairs(_host(data.obsp["knn_indices"])[:n])
    Ms, V = _velocity_genes(data, n)
    dev = Ms.device
    chain = _Chain(torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev),
                   torch.from_numpy(counts).to(dev))
    rows = chain.rows
    cos = _edge_cosines(Ms, V, rows, chain.cols).double()
    Tv = torch.exp(cos / scale)
    Tv = Tv / torch.clamp(chain.row_sums(Tv), min=1e-12)[rows]
    Tc = 1.0 / torch.clamp(chain.lengths.double(), min=1e-12)[rows]
    T = (1.0 - lambda_conn) * Tv + lambda_conn * Tc
    chain.T = T / torch.clamp(chain.row_sums(T), min=1e-12)[rows]
    return chain


def stationary(chain: _Chain, n_iter: int = 300) -> torch.Tensor:
    """The stationary distribution of the chain by power iteration of
    π ← πT (float64), renormalised each round; stops when max|Δπ| <
    1e-12, or keeps π when the mass vanishes.  Each cell's in-edges are
    added in edge order (sorted once by target)."""
    n = chain.n
    order = segment_order(chain.cols, n)
    pi = torch.full((n,), 1.0 / n, dtype=torch.float64,
                    device=chain.T.device)
    for _ in range(n_iter):
        nxt = _segment_sum(chain.T * pi[chain.rows], None, n, order=order)
        s = nxt.sum()
        nxt = nxt / s
        s_h, delta = torch.stack([s, (nxt - pi).abs().max()]).tolist()
        if s_h <= 0:
            break
        pi = nxt
        if delta < 1e-12:
            break
    return pi


def _top_components(pi: np.ndarray, chain: _Chain, quantile: float,
                    min_cells: int) -> np.ndarray:
    """Cells with π at or above its ``quantile``, grouped into connected
    components over the union edges (host search, each cell's edges in
    slot order); groups of fewer than ``min_cells`` dropped, the rest
    numbered in order of discovery.  Returns (n,) int32, -1 off the
    groups."""
    n = len(pi)
    cols, starts = chain.host_lists()
    thresh = np.quantile(pi, quantile)
    top = np.where(pi >= thresh)[0]
    top_set = set(top.tolist())
    label = {c: -1 for c in top.tolist()}
    gid = 0
    for c in top.tolist():
        if label[c] != -1:
            continue
        stack = [c]
        label[c] = gid
        while stack:
            u = stack.pop()
            for v in cols[starts[u]:starts[u + 1]].tolist():
                if v in top_set and label[v] == -1:
                    label[v] = gid
                    stack.append(v)
        gid += 1
    counts = np.bincount([label[c] for c in top.tolist()], minlength=gid)
    keep = {g for g in range(gid) if counts[g] >= min_cells}
    remap = {g: i for i, g in enumerate(sorted(keep))}
    out = np.full(n, -1, np.int32)
    for c in top.tolist():
        if label[c] in keep:
            out[c] = remap[label[c]]
    return out


@register("velocity.terminal_states")
def terminal_states(data: CellData, scale: float = 0.25,
                    quantile: float = 0.95, min_cells: int = 5,
                    n_iter: int = 300, device=None) -> CellData:
    """Absorbing regions of the velocity-directed chain: the stationary
    distribution (``stationary``) concentrates where flow converges;
    its top-quantile cells are grouped into connected components and
    small groups dropped.  Adds obs ``terminal_states`` (-1 = not
    terminal, else group id) and uns ``terminal_stationary``."""
    device = resolve_device(device)
    data = data.to_device(device)
    chain = _velocity_transition(data, scale)
    pi = stationary(chain, n_iter=n_iter)
    term = _top_components(pi.cpu().numpy(), chain, quantile, min_cells)
    return (data.with_obs(terminal_states=torch.from_numpy(term).to(device))
            .with_uns(terminal_stationary=pi.float()))


def absorption(chain: _Chain, term: torch.Tensor, n_groups: int,
               n_iter: int = 2000) -> torch.Tensor:
    """Absorption probabilities into each terminal group (float64, (n,
    n_groups)) by the iteration F ← T F with the terminal rows pinned,
    until max|ΔF| < 1e-10; each row's edges are added in slot order."""
    absorbed = term >= 0
    F = torch.zeros((chain.n, n_groups), dtype=torch.float64,
                    device=chain.T.device)
    F[absorbed, term[absorbed].long()] = 1.0
    F_abs = F[absorbed]
    Te = chain.T[:, None]
    for _ in range(n_iter):
        nxt = chain.row_sums(Te * F[chain.cols])
        nxt[absorbed] = F_abs
        delta = float((nxt - F).abs().max())
        F = nxt
        if delta < 1e-10:
            break
    return F


@register("velocity.fate_probabilities")
def fate_probabilities(data: CellData,
                       terminal_key: str = "terminal_states",
                       scale: float = 0.25, n_iter: int = 2000,
                       device=None) -> CellData:
    """Absorption probabilities of the velocity-directed chain into each
    terminal group (``absorption``).  Rows that reach no terminal state
    stay 0, the others are normalised; terminal rows are one-hot on
    their own group.  Adds obsm ``fate_probs`` (n × groups)."""
    device = resolve_device(device)
    data = data.to_device(device)
    n = data.n_cells
    if terminal_key not in data.obs:
        raise KeyError("velocity.fate_probabilities: run "
                       "velocity.terminal_states first")
    term = torch.as_tensor(data.obs[terminal_key])[:n].to(device).long()
    n_groups = int(term.max()) + 1
    if n_groups < 1:
        raise ValueError("velocity.fate_probabilities: no terminal "
                         "states found")
    F = absorption(_velocity_transition(data, scale), term, n_groups,
                   n_iter=n_iter)
    # normalise only where mass arrived; true orphans stay 0
    s = F.sum(dim=1, keepdim=True)
    F = torch.where(s > 1e-8, F / torch.clamp(s, min=1e-12), 0.0)
    absorbed = term >= 0
    F[absorbed] = 0.0
    F[absorbed, term[absorbed]] = 1.0
    return data.with_obsm(fate_probs=F.float())


# ----------------------------------------------------------------------
# velocity.lineage_drivers
# ----------------------------------------------------------------------


@register("velocity.lineage_drivers")
def lineage_drivers(data: CellData, layer: str = "Ms",
                    device=None) -> CellData:
    """Per-gene Pearson correlation with each lineage's fate probability
    over the transient cells (terminal rows are one-hot and would make
    any marker of a terminal cluster a driver): one centred cross
    product in true float32.  Adds varm ``lineage_drivers`` (genes ×
    lineages); zero-variance genes or lineages get 0."""
    device = resolve_device(device)
    data = data.to_device(device)
    if "fate_probs" not in data.obsm:
        raise KeyError("velocity.lineage_drivers: run "
                       "velocity.fate_probabilities first")
    n = data.n_cells
    F = data.obsm["fate_probs"][:n].float()
    mask = torch.as_tensor(data.obs["terminal_states"])[:n].to(device) < 0
    if int(mask.sum()) < 3:
        raise ValueError("velocity.lineage_drivers: fewer than 3 "
                         "transient cells")
    Xm = _dense_layer(data, layer)[mask]
    Fm = F[mask]
    Xc = Xm - Xm.mean(dim=0)
    Fc = Fm - Fm.mean(dim=0)
    with true_f32():
        num = Xc.T @ Fc
    den = (torch.linalg.vector_norm(Xc, dim=0)[:, None]
           * torch.linalg.vector_norm(Fc, dim=0)[None, :])
    corr = num / torch.clamp(den, min=1e-12)
    corr = torch.where(torch.isfinite(corr), corr, 0.0)
    return data.with_varm(lineage_drivers=corr)


# ----------------------------------------------------------------------
# velocity.recover_dynamics / velocity.latent_time
# ----------------------------------------------------------------------


def _dyn_traj(la, lb, lg, ts, t):
    """(u(t), s(t)) of the splicing ODE du/dt = α·[t < ts] − β·u, ds/dt
    = β·u − γ·s from (0, 0), for the genes along the last axis: the
    closed forms of the induction branch and, after the switch, of the
    repression branch from the switch-point state.  Rates in log space;
    γ is nudged off β (the removable singularity of the (γ − β)
    denominators)."""
    a, b = torch.exp(la), torch.exp(lb)
    g = torch.exp(lg)
    g = torch.where(torch.abs(g - b) < 1e-3 * b, b * 1.001, g)

    def state_on(t):
        u = a / b * (1.0 - torch.exp(-b * t))
        s = (a / g * (1.0 - torch.exp(-g * t))
             + a / (g - b) * (torch.exp(-g * t) - torch.exp(-b * t)))
        return u, s

    u_sw, s_sw = state_on(ts)
    # maximum/minimum, not clamp: at a tie their gradient is split in
    # half, as jnp.maximum/jnp.minimum split it
    tau = torch.maximum(t - ts, torch.zeros((), device=t.device))
    u_off = u_sw * torch.exp(-b * tau)
    # s(τ) = s_sw·e^{−γτ} + β·u_sw·(e^{−βτ} − e^{−γτ})/(γ − β)
    s_off = (s_sw * torch.exp(-g * tau)
             + b * u_sw / (g - b) * (torch.exp(-b * tau)
                                     - torch.exp(-g * tau)))
    u_on, s_on = state_on(torch.minimum(t, ts))
    on = t <= ts
    return torch.where(on, u_on, u_off), torch.where(on, s_on, s_off)


def _assign(u, s, params, half):
    """Each cell's nearest point of the fitted trajectory on a grid with
    half its points on each side of the switch (normalised (u, s)
    space, first on ties): the grid times, (n, genes)."""
    la, lb, lg, ta, lc = params.unbind(dim=1)
    ts = torch.sigmoid(ta)
    tgrid = torch.cat([ts[None, :] * half[:, None],
                       ts[None, :] + (1.0 - ts)[None, :] * half[:, None]])
    ut, st = _dyn_traj(la, lb, lg, ts, tgrid)             # (grid, genes)
    cu = (torch.exp(lc)[None, :] * ut).T                  # (genes, grid)
    st = st.T
    n, g = u.shape
    step = max(1, _ASSIGN_ELEMS // max(n * tgrid.shape[0], 1))
    picks = []
    for c0 in range(0, g, step):
        sl = slice(c0, c0 + step)
        d2 = ((u[:, sl, None] - cu[None, sl]) ** 2
              + (s[:, sl, None] - st[None, sl]) ** 2)
        picks.append(torch.argmin(d2, dim=2))
        del d2
    return torch.gather(tgrid, 0, torch.cat(picks, dim=1))


def _dyn_fit(u, s, slope, n_outer: int = 40, n_inner: int = 5,
             n_grid: int = 64, lr: float = 0.05):
    """The EM fit of the splicing ODE for the genes (columns) of ``u``,
    ``s`` (n, genes), float32, each gene on its own.

    E-step: each cell takes the nearest grid time on the current
    trajectory (``_assign``).  M-step: ``n_inner`` Adam steps on (log α,
    log β, log γ, switch logit, log scaling) against the mean squared
    distance at the assigned times.  Returns (params (genes, 6): α, β,
    γ, the ECDF-warped switch time, the u scaling, the geometric switch
    time; t_cells (n, genes) ECDF-warped; r² (genes,))."""
    dev = u.device
    half = torch.linspace(0.0, 1.0, n_grid // 2, device=dev)
    beta0 = 4.0
    gamma0 = torch.clamp(slope, 1e-2, 1e2) * beta0
    zeros = torch.zeros_like(gamma0)
    params = torch.stack([
        torch.log(beta0 * torch.clamp(u.amax(dim=0), min=1e-3)),
        torch.log(torch.full_like(gamma0, beta0)), torch.log(gamma0),
        zeros, zeros], dim=1)
    m = torch.zeros_like(params)
    v = torch.zeros_like(params)
    c09 = torch.tensor(0.9, device=dev)
    c0999 = torch.tensor(0.999, device=dev)
    for i in range(n_outer):
        with torch.no_grad():
            t_cells = _assign(u, s, params, half)
        for j in range(n_inner):
            p = params.detach().requires_grad_(True)
            la, lb, lg, ta, lc = p.unbind(dim=1)
            ut, st = _dyn_traj(la, lb, lg, torch.sigmoid(ta), t_cells)
            loss = ((u - torch.exp(lc) * ut) ** 2 + (s - st) ** 2).mean(
                dim=0)
            (gr,) = torch.autograd.grad(loss.sum(), p)
            with torch.no_grad():
                m = 0.9 * m + 0.1 * gr
                v = 0.999 * v + 0.001 * gr * gr
                step = torch.tensor(float(i * n_inner + j + 1), device=dev)
                mh = m / (1.0 - c09 ** step)
                vh = v / (1.0 - c0999 ** step)
                params = params - lr * mh / (torch.sqrt(vh) + 1e-8)
    with torch.no_grad():
        t_cells = _assign(u, s, params, half)
        la, lb, lg, ta, lc = params.unbind(dim=1)
        ts = torch.sigmoid(ta)
        ut, st = _dyn_traj(la, lb, lg, ts, t_cells)
        ss_res = ((u - torch.exp(lc) * ut) ** 2 + (s - st) ** 2).sum(dim=0)
        ss_tot = ((u - u.mean(dim=0)) ** 2
                  + (s - s.mean(dim=0)) ** 2).sum(dim=0)
        r2 = 1.0 - ss_res / torch.clamp(ss_tot, min=1e-12)
        # the uniform-latent-time prior as a monotone warp: each cell's
        # time (and the switch) through the ECDF of the assigned times
        # the count times the float32 reciprocal of n: the reference's
        # compiled division by a constant rounds so
        inv_n = torch.tensor(1.0 / t_cells.shape[0], device=dev)
        tc = t_cells.T.contiguous()
        t_sorted = torch.sort(tc, dim=1).values
        t_ecdf = (torch.searchsorted(t_sorted, tc, right=True).float()
                  * inv_n).T
        ts_ecdf = (torch.searchsorted(t_sorted, ts[:, None].contiguous(),
                                      right=True)[:, 0].float() * inv_n)
        out = torch.stack([torch.exp(la), torch.exp(lb), torch.exp(lg),
                           ts_ecdf, torch.exp(lc), ts], dim=1)
    return out, t_ecdf, r2


def _dyn_fit_all(un, sn, slope, n_outer: int):
    """``_dyn_fit`` over gene chunks of at most 2^26 (cells × genes)
    elements, of equal size."""
    n, g = un.shape
    parts = max(1, -(-n * g // _DYN_ELEMS))
    step = -(-g // parts)
    res = [_dyn_fit(un[:, c0:c0 + step], sn[:, c0:c0 + step],
                    slope[c0:c0 + step], n_outer=n_outer)
           for c0 in range(0, g, step)]
    return (torch.cat([r[0] for r in res]), torch.cat([r[1] for r in res],
                                                      dim=1),
            torch.cat([r[2] for r in res]))


@register("velocity.recover_dynamics")
def recover_dynamics(data: CellData, min_r2: float = 0.3,
                     n_outer: int = 40, device=None) -> CellData:
    """scVelo's dynamical model: per gene, the splicing ODE's (α, β, γ,
    switch time, u scaling) and each cell's latent time, fitted by EM
    (``_dyn_fit``) on the moments normalised to a unit 99th percentile
    per gene.  Simplifications (the reference's): a 64-point grid
    assignment, per-gene time scaled to [0, 1], no per-cell variances.
    Needs layers Ms/Mu.  Adds var ``fit_alpha``, ``fit_beta``,
    ``fit_gamma``, ``fit_t_switch`` (ECDF scale), ``fit_t_switch_geo``
    (ODE scale), ``fit_scaling``, ``fit_r2``, ``velocity_gamma`` (the
    raw-unit steady-state slope), ``velocity_r2``, ``velocity_genes``
    (fit_r2 > min_r2); layers ``fit_t`` and ``velocity`` (ds/dt in raw
    Ms units)."""
    device = resolve_device(device)
    data = data.to_device(device)
    Ms = _dense_layer(data, "Ms")
    Mu = _dense_layer(data, "Mu")
    su = torch.clamp(_quantile_cols(Mu, 0.99)[0], min=1e-6)
    ss = torch.clamp(_quantile_cols(Ms, 0.99)[0], min=1e-6)
    un = Mu / su[None, :]
    sn = Ms / ss[None, :]
    slope, _, _ = _steady_state_fit(sn, un, 0.05)
    params, t_cells, r2 = _dyn_fit_all(un, sn, slope, n_outer)
    alpha, beta, gamma, t_sw, scal, t_sw_geo = params.unbind(dim=1)
    vel = (beta[None, :] * un / torch.clamp(scal[None, :], min=1e-6)
           - gamma[None, :] * sn) * ss[None, :]
    gamma_slope = gamma / torch.clamp(beta, min=1e-12) * su * scal / ss
    out = data.with_var(
        fit_alpha=alpha, fit_beta=beta, fit_gamma=gamma,
        fit_t_switch=t_sw, fit_t_switch_geo=t_sw_geo, fit_scaling=scal,
        fit_r2=r2, velocity_gamma=gamma_slope, velocity_r2=r2,
        velocity_genes=r2 > min_r2)
    return out.with_layers(fit_t=t_cells, velocity=vel)


@register("velocity.latent_time")
def latent_time(data: CellData, min_r2: float = 0.3,
                device=None) -> CellData:
    """Gene-shared latent time: the fit-quality-weighted mean of the
    per-gene times, then two rounds that multiply each gene's weight by
    its positive correlation with the current shared time (a degenerate
    round keeps the first answer), scaled to [0, 1].  Needs
    velocity.recover_dynamics.  Adds obs ``latent_time``."""
    device = resolve_device(device)
    data = data.to_device(device)
    if "fit_t" not in data.layers:
        raise KeyError("velocity.latent_time: run "
                       "velocity.recover_dynamics first")
    n = data.n_cells
    T = data.layers["fit_t"][:n].float()
    r2 = torch.as_tensor(data.var["fit_r2"]).to(device).float()
    w0 = torch.clamp(r2, min=0.0) * (r2 > min_r2)
    if float(w0.sum()) <= 0:
        raise ValueError("velocity.latent_time: no gene passes the "
                         f"fit_r2 > {min_r2} gate")
    Tc = T - T.mean(dim=0, keepdim=True)
    tc_norm = torch.linalg.vector_norm(Tc, dim=0)
    with true_f32():
        w = w0
        lt = T @ w / w.sum()
        for _ in range(2):
            lc = lt - lt.mean()
            corr = (Tc * lc[:, None]).sum(dim=0) / torch.clamp(
                tc_norm * torch.linalg.vector_norm(lc), min=1e-12)
            w = w0 * torch.clamp(corr, min=0.0)
            if float(w.sum()) <= 0:  # degenerate: keep round 0's answer
                w = w0
                break
            lt = T @ w / w.sum()
    lo, hi = lt.min(), lt.max()
    lt = (lt - lo) / torch.clamp(hi - lo, min=1e-12)
    return data.with_obs(latent_time=lt)
