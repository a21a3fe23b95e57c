"""Host IO: the readers and writers of the formats users bring, the
in-memory entry points, and the streamed path's shard-store chunk files
and h5ad shard reader.

Counterparts of ``sctools_tpu/data/io.py``, with the same arguments,
on-disk layouts and results:

* ``read_h5ad`` / ``write_h5ad`` — AnnData HDF5 (CSR, CSC or dense X,
  obs/var columns, categoricals, obsm/varm, obsp, layers, nested uns);
* ``read_10x_mtx`` — a 10x directory (``matrix.mtx[.gz]``, v2
  ``genes.tsv`` or v3 ``features.tsv[.gz]``, ``barcodes.tsv[.gz]``),
  read by ``scipy.io.mmread`` into float32;
* ``read_10x_h5`` — CellRanger ``.h5`` (v3 ``/matrix`` and v2 per
  genome); ``read_loom`` / ``write_loom`` — loom, with its layers;
* ``read_csv``, ``read_text``, ``read_mtx`` and ``read`` (by suffix);
* ``from_scipy`` / ``from_dense``, ``write_csr_chunk`` /
  ``read_csr_chunk``, ``shard_iter``.

``h5py`` is imported inside the functions that read or write HDF5 (the
h5ad, loom and 10x-h5 readers and writers and ``shard_iter``), so the
package imports where it is not installed.  A ``CellData`` on a device
(``SparseCells`` or tensors in X or layers) is written through
``to_host()``.
"""

from __future__ import annotations

import gzip
import os
from typing import Iterator

import numpy as np
import torch

from ..config import config, round_up
from ..utils.checkpoint import (_read_arrays, load_npz_verified,
                                save_npz_verified)
from .dataset import CellData
from .sharded import ShardedRows
from .sparse import SparseCells


def from_scipy(X, obs=None, var=None, **kw) -> CellData:
    """A host ``CellData`` over a scipy sparse matrix (as CSR)."""
    return CellData(X.tocsr(), obs=obs or {}, var=var or {}, **kw)


def from_dense(X, obs=None, var=None, **kw) -> CellData:
    """A host ``CellData`` over a dense array."""
    return CellData(np.asarray(X), obs=obs or {}, var=var or {}, **kw)


# ----------------------------------------------------------------------
# h5ad
# ----------------------------------------------------------------------


def _encoding(node) -> str:
    enc = node.attrs.get("encoding-type", b"")
    return enc.decode() if isinstance(enc, bytes) else str(enc)


def _read_h5_matrix(h5, path="X"):
    """A dense dataset as numpy, a CSR/CSC group as scipy CSR."""
    import h5py
    import scipy.sparse as sp

    node = h5[path]
    if isinstance(node, h5py.Dataset):
        return node[...]
    shape = tuple(node.attrs["shape"]) if "shape" in node.attrs else None
    data = node["data"][...]
    indices = node["indices"][...]
    indptr = node["indptr"][...]
    if _encoding(node).startswith("csc"):
        return sp.csc_matrix((data, indices, indptr), shape=shape).tocsr()
    return sp.csr_matrix((data, indices, indptr), shape=shape)


def _decode(arr):
    """Bytes and objects as str arrays (HDF5 gives strings back as
    bytes); other arrays unchanged."""
    arr = np.asarray(arr)
    if arr.dtype.kind in ("S", "O"):
        return np.array(
            [x.decode() if isinstance(x, bytes) else x for x in arr.ravel()]
        ).reshape(arr.shape)
    return arr


def _read_h5_frame(h5, path):
    """An AnnData obs/var group (or an old-style structured array) as a
    dict of numpy arrays; categoricals as their category strings, code
    -1 as ""."""
    import h5py

    out = {}
    if path not in h5:
        return out
    node = h5[path]
    if isinstance(node, h5py.Dataset):
        arr = node[...]
        if arr.dtype.names:
            for name in arr.dtype.names:
                out[name] = _decode(arr[name])
        return out
    for key in node:
        if key.startswith("_") or key == "__categories":
            continue
        child = node[key]
        if isinstance(child, h5py.Dataset):
            out[key] = _decode(child[...])
        elif "categories" in child and "codes" in child:
            cats = _decode(child["categories"][...])
            codes = child["codes"][...]
            out[key] = np.where(codes >= 0, cats[np.maximum(codes, 0)], "")
    return out


def _read_h5_tree(node):
    """uns/obsp-style groups: CSR/CSC subgroups as scipy CSR, other
    groups as dicts, datasets decoded."""
    import h5py

    if isinstance(node, h5py.Dataset):
        return _decode(node[...])
    if _encoding(node).startswith(("csr", "csc")):
        return _read_h5_matrix(node.parent, node.name.rsplit("/", 1)[-1])
    return {k: _read_h5_tree(node[k]) for k in node}


def read_h5ad(path: str, load_obsm: bool = True, load_layers: bool = True,
              load_obsp: bool = True) -> CellData:
    """Read an AnnData ``.h5ad`` file into a host ``CellData`` (X as
    scipy CSR or dense numpy).  ``load_obsm`` (obsm and varm),
    ``load_layers`` and ``load_obsp`` skip those groups when False: the
    layers of velocity files and the pairwise matrices can each be as
    large as X.  A var column ``_index``, ``index``, ``gene_symbols`` or
    ``gene_ids`` (the first found) becomes ``gene_name`` when that is
    absent."""
    import h5py

    with h5py.File(path, "r") as h5:
        X = _read_h5_matrix(h5, "X")
        obs = _read_h5_frame(h5, "obs")
        var = _read_h5_frame(h5, "var")
        obsm, varm, layers, obsp, uns = {}, {}, {}, {}, {}
        if load_obsm:
            for name, out in (("obsm", obsm), ("varm", varm)):
                if name in h5:
                    for key in h5[name]:
                        out[key] = h5[name][key][...]
        if load_layers and "layers" in h5:
            for key in h5["layers"]:
                layers[key] = _read_h5_matrix(h5["layers"], key)
        if load_obsp and "obsp" in h5:
            for key in h5["obsp"]:
                obsp[key] = _read_h5_tree(h5["obsp"][key])
        if "uns" in h5:
            for key in h5["uns"]:
                uns[key] = _read_h5_tree(h5["uns"][key])
    if "gene_name" not in var:
        for cand in ("_index", "index", "gene_symbols", "gene_ids"):
            if cand in var:
                var["gene_name"] = var.pop(cand)
                break
    return CellData(X, obs=obs, var=var, obsm=obsm, varm=varm,
                    layers=layers, obsp=obsp, uns=uns)


def h5py_str():
    """h5py's variable-length string dtype."""
    import h5py

    return h5py.string_dtype()


def _on_device(data: CellData) -> bool:
    """X or a layer held as a ``SparseCells``, a tensor or cell-sharded
    blocks: such data is written through ``to_host()``."""
    return any(isinstance(v, (SparseCells, ShardedRows, torch.Tensor))
               for v in (data.X, *data.layers.values()))


def write_h5ad(data: CellData, path: str) -> None:
    """AnnData-compatible writer: sparse matrices as CSR groups, dense
    ones as datasets, obs/var/obsm/varm/obsp/uns as groups (a dict in uns
    as a subgroup, ``None`` as "", strings as variable-length)."""
    import h5py
    import scipy.sparse as sp

    host = data.to_host() if _on_device(data) else data

    def write_matrix(parent, name, M):
        if sp.issparse(M):
            M = M.tocsr()
            g = parent.create_group(name)
            g.attrs["encoding-type"] = "csr_matrix"
            g.attrs["encoding-version"] = "0.1.0"
            g.attrs["shape"] = np.array(M.shape, dtype=np.int64)
            g.create_dataset("data", data=M.data)
            g.create_dataset("indices", data=M.indices)
            g.create_dataset("indptr", data=M.indptr)
        else:
            parent.create_dataset(name, data=np.asarray(M))

    def write_value(g, k, v):
        if isinstance(v, dict):
            sub = g.create_group(str(k))
            for kk, vv in v.items():
                write_value(sub, kk, vv)
            return
        if sp.issparse(v):
            write_matrix(g, str(k), v)
            return
        if v is None:  # scanpy's uns["log1p"] = {"base": None}
            v = np.asarray("", dtype=object)
        v = np.asarray(v)
        if v.dtype.kind in ("U", "O"):
            v = v.astype(h5py_str())
        g.create_dataset(str(k), data=v)

    with h5py.File(path, "w") as h5:
        write_matrix(h5, "X", host.X)
        if host.layers:
            lg = h5.create_group("layers")
            for k, v in host.layers.items():
                write_matrix(lg, k, v)
        for name, d in (("obs", host.obs), ("var", host.var),
                        ("obsm", host.obsm), ("varm", host.varm),
                        ("obsp", host.obsp), ("uns", host.uns)):
            g = h5.create_group(name)
            for k, v in d.items():
                write_value(g, k, v)


# ----------------------------------------------------------------------
# 10x
# ----------------------------------------------------------------------


def read_10x_mtx(path: str) -> CellData:
    """Read a 10x directory: ``matrix.mtx[.gz]`` (genes × cells on disk,
    transposed to cells × genes here), ``features.tsv[.gz]`` or
    ``genes.tsv[.gz]`` (``var["gene_ids"]``, ``var["gene_name"]``) and
    ``barcodes.tsv[.gz]`` (``obs["barcode"]``).  The matrix, plain or
    gzipped, is read by ``scipy.io.mmread``; X holds float32."""
    import scipy.io
    import scipy.sparse as sp

    def find(*names):
        for n in names:
            for suff in ("", ".gz"):
                p = os.path.join(path, n + suff)
                if os.path.exists(p):
                    return p
        return None

    def lines(p):
        with (gzip.open if p.endswith(".gz") else open)(p, "rt") as fh:
            return list(fh)

    mtx = find("matrix.mtx")
    if mtx is None:
        raise FileNotFoundError(f"no matrix.mtx[.gz] under {path}")
    m = scipy.io.mmread(mtx).tocoo()  # a ".gz" path is unzipped by scipy
    X = sp.coo_matrix((m.data.astype(np.float32), (m.col, m.row)),
                      shape=m.shape[::-1]).tocsr()  # cells × genes

    var: dict = {}
    feats = find("features.tsv", "genes.tsv")
    if feats:
        fields = [ln.rstrip("\n").split("\t") for ln in lines(feats)]
        var["gene_ids"] = np.array([f[0] for f in fields])
        var["gene_name"] = np.array([f[1] if len(f) > 1 else f[0]
                                     for f in fields])
    obs: dict = {}
    bars = find("barcodes.tsv")
    if bars:
        obs["barcode"] = np.array([ln.strip() for ln in lines(bars)])
    return CellData(X, obs=obs, var=var)


def read_10x_h5(path: str, genome: str | None = None) -> CellData:
    """Read a CellRanger ``.h5``: v3's ``/matrix`` group (``features``:
    ``id``, ``name``, ``feature_type`` or ``feature_types``) or v2's group
    per genome (``genes``, ``gene_names``; ``genome=`` picks one, and is
    required when there are several).  The stored features × barcodes
    CSC is the CSR of cells × genes as it lies."""
    import h5py
    import scipy.sparse as sp

    with h5py.File(path, "r") as f:
        if "matrix" in f:
            g = f["matrix"]
            feat = g["features"]
            var = {"gene_ids": np.asarray(feat["id"]).astype(str),
                   "gene_name": np.asarray(feat["name"]).astype(str)}
            for ft in ("feature_type", "feature_types"):
                if ft in feat:
                    var["feature_type"] = np.asarray(feat[ft]).astype(str)
                    break
        else:
            groups = [k for k in f.keys() if isinstance(f[k], h5py.Group)]
            if not groups:
                raise ValueError(f"read_10x_h5: no matrix group in {path!r}")
            if genome is None and len(groups) > 1:
                raise ValueError(
                    f"read_10x_h5: multiple genome groups {groups} in "
                    f"{path!r}; pass genome= to pick one")
            name = genome or groups[0]
            if name not in f:
                raise ValueError(
                    f"read_10x_h5: genome {name!r} not in {groups}")
            g = f[name]
            var = {"gene_ids": np.asarray(g["genes"]).astype(str),
                   "gene_name": np.asarray(g["gene_names"]).astype(str)}
        n_genes, n_cells = (int(x) for x in g["shape"][:])
        X = sp.csr_matrix((np.asarray(g["data"], np.float32),
                           np.asarray(g["indices"]),
                           np.asarray(g["indptr"])),
                          shape=(n_cells, n_genes))
        obs = {"barcode": np.asarray(g["barcodes"]).astype(str)}
    return CellData(X, obs=obs, var=var)


# ----------------------------------------------------------------------
# loom
# ----------------------------------------------------------------------


def read_loom(path: str, sparse: bool = True, obs_names: str = "CellID",
              var_names: str = "Gene") -> CellData:
    """Read a ``.loom`` file (genes × cells on disk, transposed here),
    with its layers (velocyto's ``spliced``/``unspliced``/``ambiguous``).
    ``sparse`` builds CSR block by block of 4,096 genes, so the dense
    matrix never lies in memory whole; else dense float32.  The
    ``obs_names`` column attribute becomes ``obs["cell_id"]``, the
    ``var_names`` row attribute ``var["gene_name"]``."""
    import h5py
    import scipy.sparse as sp

    def to_cells_by_genes(dset):
        g = dset.shape[0]
        if not sparse:
            return np.asarray(dset[:], np.float32).T
        step = max(1, min(g, 4096))
        return sp.hstack([sp.csr_matrix(np.asarray(dset[lo: lo + step],
                                                   np.float32).T)
                          for lo in range(0, g, step)], format="csr")

    with h5py.File(path, "r") as f:
        X = to_cells_by_genes(f["matrix"])
        layers = {}
        if "layers" in f:
            for name in f["layers"]:
                layers[name] = to_cells_by_genes(f["layers"][name])
        obs, var = {}, {}
        for attrs, out, names_key, rename in (
                (f.get("col_attrs"), obs, obs_names, "cell_id"),
                (f.get("row_attrs"), var, var_names, "gene_name")):
            if attrs is None:
                continue
            for k in attrs:
                v = np.asarray(attrs[k])
                if v.dtype.kind in "SO":
                    v = v.astype(str)
                out[rename if k == names_key else k] = v
    return CellData(X, obs=obs, var=var, layers=layers)


def write_loom(data: CellData, path: str) -> None:
    """Write a ``.loom`` file (dense genes × cells float32, layers
    included; obs columns as column attributes, ``cell_id`` as
    ``CellID``, var columns as row attributes, ``gene_name`` as
    ``Gene``): :func:`read_loom` reads it back."""
    import h5py
    import scipy.sparse as sp

    host = data.to_host() if _on_device(data) else data

    def dense_T(M):
        if sp.issparse(M):
            M = M.toarray()
        return np.asarray(M, np.float32).T

    def attr(v):
        return v.astype("S") if v.dtype.kind in "US" else v

    n = host.n_cells
    with h5py.File(path, "w") as f:
        f.create_dataset("matrix", data=dense_T(host.X))
        if host.layers:
            lay = f.create_group("layers")
            for k, v in host.layers.items():
                lay.create_dataset(k, data=dense_T(v))
        ca = f.create_group("col_attrs")
        for k, v in host.obs.items():
            ca.create_dataset("CellID" if k == "cell_id" else k,
                              data=attr(np.asarray(v)[:n]))
        ra = f.create_group("row_attrs")
        for k, v in host.var.items():
            ra.create_dataset("Gene" if k == "gene_name" else k,
                              data=attr(np.asarray(v)))


# ----------------------------------------------------------------------
# Text and MatrixMarket readers, and the dispatch by suffix
# ----------------------------------------------------------------------


def _is_num(s: str) -> bool:
    try:
        float(s)
        return True
    except ValueError:
        return False


def read_csv(path: str, delimiter: str | None = ",",
             first_column_names: bool | None = None,
             dtype=np.float32) -> CellData:
    """Read a dense delimited cells × genes table (``.gz`` too).  The
    first row is gene names (``var["gene_name"]``) when it is not all
    numbers; the first column is cell names (``obs["cell_name"]``) when
    ``first_column_names`` is True or, when None, when the first data
    row's first entry is not a number.  ``delimiter=None`` splits on
    whitespace."""
    import csv

    with (gzip.open if path.endswith(".gz") else open)(path, "rt") as fh:
        if delimiter is None:
            rows = [ln.split() for ln in fh if ln.strip()]
        else:
            rows = [r for r in csv.reader(fh, delimiter=delimiter) if r]
    if not rows:
        raise ValueError(f"read_csv: {path} is empty")
    header = rows[0]
    has_header = not all(_is_num(c) for c in header[1:] or header)
    body = rows[1:] if has_header else rows
    if not body:
        raise ValueError(f"read_csv: {path} has a header but no data")
    if first_column_names is None:
        first_column_names = not _is_num(body[0][0])
    obs: dict = {}
    if first_column_names:
        obs["cell_name"] = np.array([r[0] for r in body])
        body = [r[1:] for r in body]
        if has_header and len(header) == len(body[0]) + 1:
            header = header[1:]
    X = np.array(body, dtype=dtype)  # ragged rows raise ValueError
    var: dict = {}
    if has_header:
        if len(header) != X.shape[1]:
            raise ValueError(
                f"read_csv: header has {len(header)} names for "
                f"{X.shape[1]} data columns")
        var["gene_name"] = np.array(header)
    return CellData(X, obs=obs, var=var)


def read_text(path: str, delimiter: str | None = None,
              first_column_names: bool | None = None,
              dtype=np.float32) -> CellData:
    """:func:`read_csv` splitting on whitespace by default."""
    return read_csv(path, delimiter=delimiter,
                    first_column_names=first_column_names, dtype=dtype)


def read_mtx(path: str, transpose: bool = False) -> CellData:
    """Read one MatrixMarket file (``.gz`` too) as stored, rows as cells
    (``transpose=True`` for a genes × cells file), by
    ``scipy.io.mmread``; X as scipy CSR."""
    import scipy.io
    import scipy.sparse as sp

    if path.endswith(".gz"):
        with gzip.open(path, "rb") as fh:
            m = scipy.io.mmread(fh)
    else:
        m = scipy.io.mmread(path)
    return CellData(sp.csr_matrix(m.T if transpose else m))


def read(path: str, **kw) -> CellData:
    """Read by suffix (``.gz`` looked through): ``.h5ad``, ``.loom``,
    ``.mtx``, ``.csv``, ``.txt`` / ``.data`` (whitespace), ``.tsv`` /
    ``.tab`` (tab), ``.h5`` (10x).  ``kw`` go to that reader."""
    base = path[:-3] if path.endswith(".gz") else path
    ext = os.path.splitext(base)[1].lower()
    if ext == ".h5ad":
        return read_h5ad(path, **kw)
    if ext == ".loom":
        return read_loom(path, **kw)
    if ext == ".mtx":
        return read_mtx(path, **kw)
    if ext == ".csv":
        return read_csv(path, **kw)
    if ext in (".txt", ".tsv", ".tab", ".data"):
        kw.setdefault("delimiter", "\t" if ext in (".tsv", ".tab") else None)
        return read_text(path, **kw)
    if ext == ".h5":
        return read_10x_h5(path, **kw)
    raise ValueError(
        f"read: unknown extension {ext!r} for {path!r} (use read_h5ad/"
        f"read_loom/read_mtx/read_csv/read_text/read_10x_h5 directly)")


# ----------------------------------------------------------------------
# Shard-store chunk files and the h5ad shard reader
# ----------------------------------------------------------------------


def write_csr_chunk(path: str, data, indices, indptr, shape,
                    fingerprint: str | None = None) -> str:
    """Write one shard-store chunk: a CSR row slice as a checksummed
    ``.npz`` (content digest, schema, identity ``fingerprint``), atomic
    by rename.  Returns the content digest, which the store's manifest
    records."""
    arrays = {
        "data": np.ascontiguousarray(data),
        "indices": np.ascontiguousarray(indices, np.int32),
        "indptr": np.ascontiguousarray(indptr, np.int64),
        "shape": np.asarray(shape, np.int64),
    }
    return save_npz_verified(path, fingerprint=fingerprint, **arrays)


def read_csr_chunk(path: str, expect_fingerprint: str | None = None,
                   expect_digest: str | None = None,
                   verify: bool = True) -> tuple:
    """Read (and with ``verify``, re-hash and check) a chunk written by
    :func:`write_csr_chunk`.  Returns ``(data, indices, indptr,
    shape)``.  Unreadable bytes, a digest, schema or fingerprint
    mismatch, missing integrity keys or a digest other than
    ``expect_digest`` raise ``CheckpointCorruptError`` with its
    ``.reason``."""
    if verify:
        arrays = load_npz_verified(
            path, expect_fingerprint=expect_fingerprint,
            require_digest=True, expect_digest=expect_digest)
    else:
        arrays = _read_arrays(path)
    return (arrays["data"], arrays["indices"], arrays["indptr"],
            tuple(int(x) for x in arrays["shape"]))


def shard_iter(path: str, shard_rows: int, capacity: int | None = None,
               start_row: int = 0) -> Iterator[SparseCells]:
    """Stream the X of an h5ad file as host padded-ELL shards of
    ``shard_rows`` cells without loading the whole matrix.  Every shard
    shares one ``capacity`` (without one: twice the first shard's max
    nnz per row; a later row over it raises).  ``start_row`` (a
    ``shard_rows`` multiple) seeks straight to that shard."""
    import h5py
    import scipy.sparse as sp

    if start_row % shard_rows:
        raise ValueError(
            f"start_row={start_row} must be a multiple of "
            f"shard_rows={shard_rows}")

    def pack(sub):
        nonlocal capacity
        if capacity is None:
            nnz_max = int(np.diff(sub.indptr).max()) if sub.shape[0] else 1
            capacity = round_up(max(nnz_max * 2, 1),
                                config.capacity_multiple)
        return SparseCells.from_scipy_csr(sub, capacity=capacity)

    with h5py.File(path, "r") as h5:
        node = h5["X"]
        if isinstance(node, h5py.Dataset):
            n = node.shape[0]
            for s in range(start_row, n, shard_rows):
                yield pack(sp.csr_matrix(node[s: min(n, s + shard_rows)]))
            return
        enc = node.attrs.get("encoding-type", b"csr_matrix")
        enc = enc.decode() if isinstance(enc, bytes) else enc
        if not str(enc).startswith("csr"):
            raise NotImplementedError(
                f"shard_iter requires CSR-encoded X, got {enc!r}")
        indptr = node["indptr"][...]
        shape = tuple(node.attrs["shape"])
        n = shape[0]
        for s in range(start_row, n, shard_rows):
            e = min(n, s + shard_rows)
            lo, hi = indptr[s], indptr[e]
            yield pack(sp.csr_matrix(
                (node["data"][lo:hi], node["indices"][lo:hi],
                 indptr[s: e + 1] - lo), shape=(e - s, shape[1])))
