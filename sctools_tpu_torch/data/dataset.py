"""``CellData`` — the AnnData-shaped container the port's transforms
operate on, with the fields of ``sctools_tpu/data/dataset.py``:

    X      — counts: SparseCells (padded-ELL tensors) on a device, or a
             scipy CSR matrix on the host
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

from .sparse import SparseCells


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
        return X.n_cells if isinstance(X, SparseCells) else X.shape[0]

    @property
    def n_genes(self) -> int:
        X = self.X
        return X.n_genes if isinstance(X, SparseCells) else X.shape[1]

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
        ``SparseCells`` first; numeric arrays become tensors; strings
        and objects stay on the host.  Data already there is not
        copied."""
        import scipy.sparse as sp

        device = torch.device(device)

        def put_matrix(v):
            if sp.issparse(v):
                return SparseCells.from_scipy_csr(v, device=device)
            if isinstance(v, SparseCells):
                return v.to(device)
            return put(v)

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
        ``n_cells`` carry padding rows and are trimmed."""
        n = self.n_cells

        def fetch(v, trim=False):
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
