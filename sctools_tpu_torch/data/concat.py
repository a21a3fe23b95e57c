"""``concat`` — AnnData-style concatenation of ``CellData`` along the
cell axis, the operation every multi-sample workflow starts with: merge
runs, tag each cell with its source, then integrate
(``integrate.harmony``, ``integrate.combat``, ``integrate.mnn`` and
``neighbors.bbknn`` read the ``label`` column this writes).

Counterpart of ``sctools_tpu/data/concat.py``, with its contract (the
public anndata one):

* ``join="inner"`` keeps the genes every input has (by
  ``var["gene_name"]`` when all inputs carry it, else by position,
  which needs equal widths), in the first input's order;
* ``join="outer"`` takes the union of genes, absent entries zero;
* obs takes the union of columns, missing entries NaN (numeric) or
  ``""`` (strings); obsm and layers keep only the keys every input
  has; obsp and uns are dropped;
* var keeps the first input's columns, reindexed onto the new gene
  axis; duplicate gene names are refused.

Host code: the inputs are fetched (``CellData.to_host``; a padded-ELL X
becomes CSR) and the result is a host ``CellData`` with a scipy CSR X,
packed for the device once, from the merged matrix, by ``to_device``.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from .dataset import CellData

__all__ = ["concat"]


def _gene_names(d: CellData):
    n = d.var.get("gene_name")
    return None if n is None else np.asarray(n).astype(str)


def _to_csr(X):
    """A host X (scipy sparse or dense numpy, as ``to_host`` leaves it)
    as CSR."""
    import scipy.sparse as sp

    if sp.issparse(X):
        return X.tocsr()
    return sp.csr_matrix(np.asarray(X))


def _reindex_csr(X, old_names, new_names):
    """Map the columns of X (labelled ``old_names``) onto the
    ``new_names`` axis; genes absent from ``old_names`` become empty
    (zero) columns."""
    import scipy.sparse as sp

    pos = {n: i for i, n in enumerate(new_names)}
    col_map = np.full(len(old_names), -1, np.int64)
    for i, n in enumerate(old_names):
        j = pos.get(n)
        if j is not None:
            col_map[i] = j
    X = X.tocoo()
    keep = col_map[X.col] >= 0
    return sp.csr_matrix(
        (X.data[keep], (X.row[keep], col_map[X.col[keep]])),
        shape=(X.shape[0], len(new_names)))


def concat(datas: Sequence[CellData], *, join: str = "inner",
           label: str | None = None,
           keys: Sequence[str] | None = None) -> CellData:
    """Concatenate along the cell axis.  ``label``/``keys`` add a
    per-cell source column (``"0"``, ``"1"``, … when ``keys`` is None),
    the ``batch_key`` that ``integrate.*`` and ``neighbors.bbknn`` read.
    Inputs on a device are fetched first; the result is on the host."""
    if join not in ("inner", "outer"):
        raise ValueError(f"concat: unknown join {join!r}")
    # on the host: device tensors fetched, padding rows trimmed,
    # cell-sharded blocks gathered
    datas = [d.to_host() for d in datas]
    if not datas:
        raise ValueError("concat: need at least one CellData")
    if keys is not None and label is None:
        raise ValueError(
            "concat: keys= without label= would be silently dropped — "
            "pass label='batch' (the obs column the keys become)")
    if keys is not None and len(keys) != len(datas):
        raise ValueError("concat: len(keys) != len(datas)")

    import scipy.sparse as sp

    names = [_gene_names(d) for d in datas]
    if all(n is not None for n in names):
        for i, nm in enumerate(names):
            if len(set(nm)) != len(nm):
                dup = next(g for g, c in zip(
                    *np.unique(nm, return_counts=True)) if c > 1)
                raise ValueError(
                    f"concat: input {i} has duplicate gene names "
                    f"(e.g. {dup!r}) — name-joined concatenation would "
                    "silently merge their counts; deduplicate "
                    "var['gene_name'] first (anndata: var_names_make_"
                    "unique)")
        if join == "inner":
            common = set(names[0])
            for n in names[1:]:
                common &= set(n)
            # the first input's gene order (anndata's)
            new_names = np.array([g for g in names[0] if g in common])
        else:
            seen = dict.fromkeys(names[0])
            for n in names[1:]:
                seen.update(dict.fromkeys(n))
            new_names = np.array(list(seen))
        mats = [_reindex_csr(_to_csr(d.X), nm, new_names)
                for d, nm in zip(datas, names)]
        # var: the first input's columns on the new gene axis (genes it
        # lacks get NaN or ""), as the positional path keeps its var whole
        new_var = {"gene_name": new_names}
        src_pos = {g: i for i, g in enumerate(names[0])}
        take = np.array([src_pos.get(g, -1) for g in new_names])
        for col, v in datas[0].var.items():
            if col == "gene_name":
                continue
            v = np.asarray(v)
            if v.shape[:1] != (len(names[0]),):
                continue
            if v.dtype.kind in "ifub":
                filled = np.full(len(new_names), np.nan)
                filled[take >= 0] = v[take[take >= 0]].astype(np.float64)
            else:
                filled = np.full(len(new_names), "", dtype=object)
                filled[take >= 0] = v[take[take >= 0]]
            new_var[col] = filled
    else:
        widths = {d.n_genes for d in datas}
        if len(widths) != 1:
            raise ValueError(
                f"concat: inputs have differing gene counts {widths} and "
                "not all carry var['gene_name'] to align by")
        new_names = None
        mats = [_to_csr(d.X) for d in datas]
        new_var = dict(datas[0].var)

    n_per = [m.shape[0] for m in mats]
    X = sp.vstack(mats, format="csr")

    # obs: the union of columns, filled where absent
    new_obs: dict = {}
    all_keys: dict = {}
    for d in datas:
        all_keys.update(dict.fromkeys(d.obs))
    for kcol in all_keys:
        parts = []
        numeric = all(
            np.asarray(d.obs[kcol]).dtype.kind in "ifub"
            for d in datas if kcol in d.obs)
        for d, n in zip(datas, n_per):
            if kcol in d.obs:
                parts.append(np.asarray(d.obs[kcol])[:n])
            elif numeric:
                parts.append(np.full(n, np.nan))
            else:
                parts.append(np.full(n, "", dtype=object))
        new_obs[kcol] = np.concatenate(parts)
    if label is not None:
        tags = ([str(k) for k in keys] if keys is not None
                else [str(i) for i in range(len(datas))])
        new_obs[label] = np.concatenate(
            [np.full(n, t, dtype=object) for n, t in zip(n_per, tags)])

    # obsm and layers: the keys every input has
    common_obsm = set(datas[0].obsm)
    common_layers = set(datas[0].layers)
    for d in datas[1:]:
        common_obsm &= set(d.obsm)
        common_layers &= set(d.layers)
    new_obsm = {kk: np.concatenate(
        [np.asarray(d.obsm[kk])[:n] for d, n in zip(datas, n_per)], axis=0)
        for kk in common_obsm}
    new_layers = {}
    for kk in common_layers:
        if new_names is not None:
            parts = [_reindex_csr(_to_csr(d.layers[kk]), nm, new_names)
                     for d, nm in zip(datas, names)]
        else:
            parts = [_to_csr(d.layers[kk]) for d in datas]
        new_layers[kk] = sp.vstack(parts, format="csr")

    return CellData(X, obs=new_obs, var=new_var, obsm=new_obsm,
                    layers=new_layers)
