"""``CellData`` — the AnnData-shaped container the port's transforms
operate on, with the fields of ``sctools_tpu/data/dataset.py``:

    X      — counts: SparseCells (padded-ELL tensors) or a dense
             (n_cells, n_genes) float32 tensor on a device, or a scipy
             CSR matrix on the host
    obs    — per-cell annotations (dict of (n_cells,) arrays)
    var    — per-gene annotations (dict of (n_genes,) arrays)
    obsm   — per-cell matrices (e.g. "X_pca")
    varm   — per-gene matrices (e.g. "PCs")
    obsp   — pairwise data (e.g. "knn_indices", "knn_distances")
    uns    — unstructured results
    layers — alternative X-shaped matrices

Transforms return a new ``CellData`` (``replace``/``with_*`` share the
unchanged fields).  Per-cell tensors produced on the device may carry
padded rows; ``to_host`` trims them to ``n_cells``.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from .sharded import ShardedRows, is_sharded
from .sparse import SparseCells, dense_gene_block

#: what an op that does not run on cell-sharded data says when given it
SHARDED_TODO = ("this op does not run on cell-sharded data yet (it would "
                "gather the blocks to one device): ROADMAP.md Queue 1 "
                "item 9; gather with to_host() first")


@dataclasses.dataclass
class CellData:
    X: Any
    obs: dict = dataclasses.field(default_factory=dict)
    var: dict = dataclasses.field(default_factory=dict)
    obsm: dict = dataclasses.field(default_factory=dict)
    varm: dict = dataclasses.field(default_factory=dict)
    obsp: dict = dataclasses.field(default_factory=dict)
    uns: dict = dataclasses.field(default_factory=dict)
    layers: dict = dataclasses.field(default_factory=dict)

    @property
    def n_cells(self) -> int:
        X = self.X
        return (X.n_cells if isinstance(X, (SparseCells, ShardedRows))
                else X.shape[0])

    @property
    def n_genes(self) -> int:
        X = self.X
        return (X.n_genes if isinstance(X, (SparseCells, ShardedRows))
                else X.shape[1])

    @property
    def shape(self):
        return (self.n_cells, self.n_genes)

    # anndata's names for the same things (adata.n_obs, adata.var_names):
    # the name arrays fall back to positional string ids, as a fresh
    # AnnData's index does
    @property
    def n_obs(self) -> int:
        return self.n_cells

    @property
    def n_vars(self) -> int:
        return self.n_genes

    @property
    def obs_names(self) -> np.ndarray:
        for key in ("cell_name", "barcode"):
            if key in self.obs:
                return np.asarray(self.obs[key]).astype(str)
        return np.arange(self.n_cells).astype(str)

    @property
    def var_names(self) -> np.ndarray:
        if "gene_name" in self.var:
            return np.asarray(self.var["gene_name"]).astype(str)
        return np.arange(self.n_genes).astype(str)

    def replace(self, **kw) -> "CellData":
        return dataclasses.replace(self, **kw)

    def with_X(self, X) -> "CellData":
        return self.replace(X=X)

    def with_obs(self, **entries) -> "CellData":
        return self.replace(obs={**self.obs, **entries})

    def with_var(self, **entries) -> "CellData":
        return self.replace(var={**self.var, **entries})

    def var_names_make_unique(self, join: str = "-") -> "CellData":
        """``var["gene_name"]`` with each repeat suffixed ``-1``, ``-2``,
        … (``join`` before the count) and the first occurrence unchanged,
        as anndata's ``var_names_make_unique`` (10x references repeat
        gene symbols).  A suffixed name that already exists anywhere, or
        was already issued, is bumped to the next count.  Returns a new
        ``CellData`` (``self`` when the names are absent or unique)::

            data = data.var_names_make_unique()
        """
        names = self.var.get("gene_name")
        if names is None:
            return self
        names = np.asarray(names).astype(str)
        if len(np.unique(names)) == len(names):
            return self
        # a list, not the '<U..' array: 'A-1' written into '<U1' is 'A'
        existing = set(names.tolist())
        seen: dict = {}
        out: list = []
        for nm in names:
            k = seen.get(nm, 0)
            if k:
                new = f"{nm}{join}{k}"
                while new in existing or new in seen:
                    k += 1
                    new = f"{nm}{join}{k}"
                out.append(new)
                seen[new] = 1
            else:
                out.append(nm)
            seen[nm] = k + 1
        return self.with_var(gene_name=np.asarray(out))

    def with_obsm(self, **entries) -> "CellData":
        return self.replace(obsm={**self.obsm, **entries})

    def with_varm(self, **entries) -> "CellData":
        return self.replace(varm={**self.varm, **entries})

    def with_obsp(self, **entries) -> "CellData":
        return self.replace(obsp={**self.obsp, **entries})

    def with_uns(self, **entries) -> "CellData":
        return self.replace(uns={**self.uns, **entries})

    def with_layers(self, **entries) -> "CellData":
        return self.replace(layers={**self.layers, **entries})

    # ------------------------------------------------------------------
    def to_device(self, device) -> "CellData":
        """Move to ``device``: a scipy CSR X (and layers) is packed to
        ``SparseCells`` first, a dense numpy X becomes a float32 tensor;
        numeric arrays become tensors; strings and objects stay on the
        host.  Data already there is not copied.  Cell-sharded data
        raises ``NotImplementedError``: gathering it to one device is
        never done quietly (``to_host()`` gathers on request)."""
        import scipy.sparse as sp

        if is_sharded(self):
            raise NotImplementedError(SHARDED_TODO)
        device = torch.device(device)

        def put_matrix(v):
            if sp.issparse(v):
                return SparseCells.from_scipy_csr(v, device=device)
            if isinstance(v, SparseCells):
                return v.to(device)
            if isinstance(v, torch.Tensor):
                return v.to(device)
            return torch.from_numpy(
                np.ascontiguousarray(v, dtype=np.float32)).to(device)

        def put(v):
            if isinstance(v, torch.Tensor):
                return v.to(device)
            arr = np.asarray(v)
            if arr.dtype.kind in "biuf":
                return torch.from_numpy(np.ascontiguousarray(arr)).to(device)
            return v

        def put_all(d):
            return {k: put(v) for k, v in d.items()}

        return CellData(
            put_matrix(self.X), put_all(self.obs), put_all(self.var),
            put_all(self.obsm), put_all(self.varm), put_all(self.obsp),
            {k: v.to(device) if isinstance(v, torch.Tensor) else v
             for k, v in self.uns.items()},
            {k: put_matrix(v) for k, v in self.layers.items()},
        )

    def to_host(self) -> "CellData":
        """Fetch to numpy/scipy.  Per-cell arrays longer than
        ``n_cells`` carry padding rows and are trimmed; cell-sharded
        arrays (``data/sharded.py``) are gathered in row order."""
        n = self.n_cells

        def fetch(v, trim=False):
            if isinstance(v, ShardedRows):
                v, trim = v.gather("cpu"), True
            if isinstance(v, SparseCells):
                return v.to_scipy_csr()
            if isinstance(v, torch.Tensor):
                v = v.cpu().numpy()
            if (trim and isinstance(v, np.ndarray) and v.ndim >= 1
                    and v.shape[0] > n):
                v = v[:n]
            return v

        return CellData(
            fetch(self.X),
            {k: fetch(v, trim=True) for k, v in self.obs.items()},
            {k: fetch(v) for k, v in self.var.items()},
            {k: fetch(v, trim=True) for k, v in self.obsm.items()},
            {k: fetch(v) for k, v in self.varm.items()},
            {k: fetch(v, trim=True) for k, v in self.obsp.items()},
            {k: fetch(v) for k, v in self.uns.items()},
            {k: fetch(v, trim=True) for k, v in self.layers.items()},
        )

    def obs_vector(self, key: str) -> np.ndarray:
        """anndata's ``obs_vector``: an obs column, or the expression of
        the gene named ``key`` (``var["gene_name"]``, first match) across
        the cells, as a host numpy array.  On a padded-ELL X on the card
        only that gene's column is fetched."""
        if key in self.obs:
            return _host(self.obs[key])[: self.n_cells]
        names = self.var.get("gene_name")
        if names is not None:
            pos = np.nonzero(np.asarray(names).astype(str) == key)[0]
            if len(pos):
                return _gene_column(self.X, int(pos[0]), self.n_cells)
        raise KeyError(
            f"obs_vector: {key!r} is neither an obs column nor a gene "
            "name")

    def var_vector(self, key) -> np.ndarray:
        """anndata's ``var_vector``: a var column, or the expression of
        the cell at integer position ``key`` across the genes, as a host
        numpy array."""
        if key in self.var:
            return _host(self.var[key])[: self.n_genes]
        if isinstance(key, (int, np.integer)):
            row = int(_axis_index(key, self.n_cells, None, "cell")[0])
            return _cell_row(self.X, row, self.n_genes)
        raise KeyError(f"var_vector: {key!r} is not a var column")

    def __getitem__(self, key) -> "CellData":
        """AnnData-style subsetting: ``d[cells]``, ``d[:, genes]`` or
        ``d[cells, genes]``.  Selectors: a slice, a boolean mask (longer
        than ``n_cells`` on the cell axis: per-cell tensors may carry
        padded rows, whose entries are dropped), an int or an int array
        (negative ids count from the end), and on the gene axis gene
        names matched against ``var["gene_name"]``.  X, obs/var,
        obsm/varm and every layer are sliced consistently
        (``ops.hvg.select_genes_device``, ``ops.qc.select_cells_device``);
        obsp is dropped on a cell subset."""
        if is_sharded(self):
            raise NotImplementedError(SHARDED_TODO)
        if isinstance(key, tuple):
            if len(key) > 2:
                raise IndexError("CellData supports at most 2 axes")
            ckey = key[0]
            gkey = key[1] if len(key) > 1 else slice(None)
        else:
            ckey, gkey = key, slice(None)
        gidx = _axis_index(gkey, self.n_genes, self.var.get("gene_name"),
                           "gene")
        cidx = _axis_index(ckey, self.n_cells, None, "cell")
        out = self
        if gidx is not None:
            from ..ops.hvg import select_genes_device

            out = select_genes_device(out, gidx)
        if cidx is not None:
            from ..ops.qc import select_cells_device

            out = select_cells_device(out, cidx)
        return out

    def __repr__(self):
        def ks(d):
            return ", ".join(sorted(d)) or "-"

        return (
            f"CellData(n_cells={self.n_cells}, n_genes={self.n_genes},\n"
            f"  X={type(self.X).__name__},\n"
            f"  obs: {ks(self.obs)}\n  var: {ks(self.var)}\n"
            f"  obsm: {ks(self.obsm)}\n  varm: {ks(self.varm)}\n"
            f"  obsp: {ks(self.obsp)}\n  layers: {ks(self.layers)}\n"
            f"  uns: {ks(self.uns)})"
        )


def _host(v) -> np.ndarray:
    return v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _gene_column(X, gene: int, n: int) -> np.ndarray:
    """Column ``gene`` of X over the first ``n`` cells, on the host."""
    if isinstance(X, ShardedRows):
        raise NotImplementedError(SHARDED_TODO)
    if isinstance(X, SparseCells):
        return dense_gene_block(X, gene, 1)[:, 0].cpu().numpy()
    if hasattr(X, "toarray"):
        return X.tocsr()[:, gene].toarray().ravel()[:n]
    return _host(X[:n, gene])


def _cell_row(X, row: int, n_genes: int) -> np.ndarray:
    """Row ``row`` of X over the genes, on the host (entries of one gene
    stored twice in a row add up, as in ``SparseCells.to_dense``)."""
    if isinstance(X, ShardedRows):
        raise NotImplementedError(SHARDED_TODO)
    if isinstance(X, SparseCells):
        out = torch.zeros(n_genes + 1, dtype=X.data.dtype, device=X.device)
        out.scatter_add_(0, X.indices[row].long(), X.data[row])
        return out[:n_genes].cpu().numpy()
    if hasattr(X, "toarray"):
        return X.tocsr()[row].toarray().ravel()
    return _host(X[row])[:n_genes]


def _axis_index(key, n: int, names, axis: str):
    """Selector → int64 id array, or None for the full-axis no-op (the
    rules of ``sctools_tpu/data/dataset.py:_normalize_axis_key``)."""
    if isinstance(key, slice):
        if key == slice(None):
            return None
        return np.arange(*key.indices(n))
    if isinstance(key, (int, np.integer)):
        if not -n <= key < n:
            raise IndexError(f"{axis} index {key} out of range for {n}")
        return np.array([key % n])
    if isinstance(key, torch.Tensor):
        key = key.cpu().numpy()
    arr = np.asarray(key)
    if arr.size == 0:
        return np.empty(0, np.int64)
    if arr.ndim != 1:
        raise IndexError(
            f"{axis} selector must be 1-D, got shape {arr.shape}")
    if arr.dtype.kind == "b":
        # only the cell axis takes a longer mask (padded per-cell rows)
        if len(arr) != n and not (axis == "cell" and len(arr) > n):
            raise IndexError(
                f"boolean {axis} mask has length {len(arr)}, expected {n}")
        return np.nonzero(arr[:n])[0]
    if arr.dtype.kind in "iu":
        if arr.max() >= n or arr.min() < -n:
            raise IndexError(f"{axis} indices out of range for {n}")
        return arr.astype(np.int64) % n
    if arr.dtype.kind in "US":
        if names is None:
            raise KeyError(
                "name-based selection is only supported on the gene axis "
                "(via var['gene_name']); select cells by mask or index "
                "instead" if axis == "cell" else
                "gene-name selection needs var['gene_name']")
        pos = {g: i for i, g in enumerate(np.asarray(names).astype(str))}
        missing = [g for g in arr.astype(str) if g not in pos]
        if missing:
            raise KeyError(f"unknown {axis} names: {missing[:5]}")
        return np.array([pos[g] for g in arr.astype(str)], np.int64)
    raise TypeError(f"unsupported {axis} selector of dtype {arr.dtype}")
