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
from .sparse import SparseCells

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

    def replace(self, **kw) -> "CellData":
        return dataclasses.replace(self, **kw)

    def with_X(self, X) -> "CellData":
        return self.replace(X=X)

    def with_obs(self, **entries) -> "CellData":
        return self.replace(obs={**self.obs, **entries})

    def with_var(self, **entries) -> "CellData":
        return self.replace(var={**self.var, **entries})

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
