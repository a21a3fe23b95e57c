"""``embed.density`` and ``de.marker_gene_overlap``.

Counterpart of ``sctools_tpu/ops/density.py`` (scanpy's
``tl.embedding_density`` and ``tl.marker_gene_overlap``).

``embed.density``: each cell's Gaussian KDE in an embedding, scaled to
[0, 1] within its group.  As in the reference, the embedding is whitened
per group (host float64) and the kernel is isotropic with Scott's-rule
bandwidth (scanpy's ``gaussian_kde`` takes the full covariance: the
reference's documented divergence).  The KDE runs on the device in row
chunks of 4,096 (``kde_arrays``: one true-float32 matmul and one exp a
chunk, so the (n, n) distances never exist at once), with one padded
shape shared by every group.

``de.marker_gene_overlap``: each ranked group's top markers against
reference marker sets; host set algebra, the same on every device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import resolve_device, round_up, true_f32
from ..data.dataset import CellData
from ..registry import register
from .graph import _host

_CHUNK = 4096


def kde_arrays(E: torch.Tensor, h2: float, n_valid: int,
               chunk: int = _CHUNK) -> torch.Tensor:
    """Mean isotropic Gaussian kernel ``exp(-d²/(2 h2))`` of each row of
    ``E`` (n_pad, d) float32 to its first ``n_valid`` rows (the rest is
    padding), ``n_pad`` a multiple of ``chunk``; (n_pad,) float32."""
    n_pad = E.shape[0]
    nrm = (E * E).sum(dim=1)
    h2 = torch.tensor(h2, dtype=torch.float32, device=E.device)
    dens = torch.empty((n_pad,), dtype=torch.float32, device=E.device)
    for lo in range(0, n_pad, chunk):
        q = E[lo:lo + chunk]
        with true_f32():
            k = q @ E.T
        # in place, in the order of (|q|² − 2 q·e) + |e|², then
        # exp((−0.5·d²) / h2): one (chunk, n_pad) buffer a chunk
        k.mul_(-2.0).add_(nrm[lo:lo + chunk, None]).add_(nrm[None, :])
        k.mul_(-0.5).div_(h2).exp_()
        k[:, n_valid:] = 0.0
        dens[lo:lo + chunk] = k.sum(dim=1)
    return dens / max(n_valid, 1)


def _density_group(E: np.ndarray, dev, pad_to: int | None = None
                   ) -> np.ndarray:
    """[0, 1]-scaled KDE of one group's embedding rows ``E`` (n, d)
    float64 (host).  ``pad_to``: the padded size shared by the groups."""
    n, d = E.shape
    mu = E.mean(axis=0)
    sd = E.std(axis=0) + 1e-12
    W = (E - mu) / sd  # whitened
    h = n ** (-1.0 / (d + 4))  # Scott's rule on unit-variance data
    if n >= 2:
        chunk = min(_CHUNK, round_up(pad_to or n, 8))
        n_pad = round_up(pad_to or n, chunk)
        Wp = torch.zeros((n_pad, d), dtype=torch.float32, device=dev)
        Wp[:n] = torch.from_numpy(W.astype(np.float32)).to(dev)
        dens = kde_arrays(Wp, float(np.float32(h * h)), n,
                          chunk=chunk)[:n].cpu().numpy()
    else:
        dens = np.ones(n, np.float32)  # one cell: its own kernel, exp(0)
    lo, hi = float(dens.min()), float(dens.max())
    return ((dens - lo) / (hi - lo) if hi > lo
            else np.zeros_like(dens))


@register("embed.density")
def embedding_density(data: CellData, basis: str = "umap",
                      groupby: str | None = None, device=None) -> CellData:
    """Adds obs ``<basis>_density`` (or ``<basis>_density_<groupby>``)
    in [0, 1], float32: the KDE of each cell in obsm ``X_<basis>``
    within its ``groupby`` group (scanpy ``tl.embedding_density``
    semantics; the kernel is the module docstring's)."""
    dev = resolve_device(device)
    data = data.to_device(dev)
    key = f"X_{basis}" if not basis.startswith("X_") else basis
    if key not in data.obsm:
        raise KeyError(f"embed.density: obsm has no {key!r}")
    n = data.n_cells
    E = _host(data.obsm[key]).astype(np.float64)[:n]
    out_col = f"{basis.removeprefix('X_')}_density"
    dens = np.zeros(n, np.float32)
    if groupby is None:
        dens[:] = _density_group(E, dev)
    else:
        if groupby not in data.obs:
            raise KeyError(f"embed.density: obs has no {groupby!r}")
        labels = _host(data.obs[groupby])[:n]
        groups = np.unique(labels)
        pad_to = max(int((labels == g).sum()) for g in groups)
        for g in groups:
            m = labels == g
            dens[m] = _density_group(E[m], dev, pad_to=pad_to)
        out_col = f"{out_col}_{groupby}"
    return data.with_obs(**{out_col: torch.from_numpy(dens).to(dev)})


# ----------------------------------------------------------------------
# de.marker_gene_overlap
# ----------------------------------------------------------------------


def _overlap(found: set, ref: set, method: str) -> float:
    inter = len(found & ref)
    if method == "overlap_count":
        return float(inter)
    if method == "overlap_coef":
        return inter / max(min(len(found), len(ref)), 1)
    if method == "jaccard":
        return inter / max(len(found | ref), 1)
    raise ValueError(f"marker_gene_overlap: unknown method {method!r}")


@register("de.marker_gene_overlap")
def marker_gene_overlap(data: CellData, *, reference_markers: dict,
                        key: str = "rank_genes_groups",
                        method: str = "overlap_count",
                        top_n_markers: int = 100, device=None) -> CellData:
    """Compare each ranked group's top ``top_n_markers`` names against
    reference marker sets (scanpy ``tl.marker_gene_overlap``).  Adds
    uns ``<key>_overlap``: {"groups", "reference", "matrix" (n_ref ×
    n_groups) float64, "method", "top_n_markers"}.  Host set algebra;
    ``device`` only says where the data lives."""
    resolve_device(device)
    if key not in data.uns:
        raise KeyError(
            f"marker_gene_overlap: uns has no {key!r} — run "
            "de.rank_genes_groups first")
    if method not in ("overlap_count", "overlap_coef", "jaccard"):
        raise ValueError(f"marker_gene_overlap: unknown method {method!r}")
    res = data.uns[key]
    names = _host(res["names"])
    groups = [str(g) for g in res["groups"]]
    tops = [set(map(str, names[i][:top_n_markers]))
            for i in range(len(groups))]
    refs = {str(r): set(map(str, v)) for r, v in reference_markers.items()}
    mat = np.zeros((len(refs), len(tops)))
    for i, rv in enumerate(refs.values()):
        for j, t in enumerate(tops):
            mat[i, j] = _overlap(t, rv, method)
    return data.with_uns(**{f"{key}_overlap": {
        "groups": groups, "reference": list(refs), "matrix": mat,
        "method": method, "top_n_markers": top_n_markers}})
