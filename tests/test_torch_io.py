"""The port's readers and writers (``sctools_tpu_torch/data/io.py``),
``CellData``'s name helpers and ``synthetic_ell`` against the
reference's.

Every file is made here from numpy seeds: by the reference's writer, by
the port's, or by hand with h5py in the layouts of
``tests/test_io_native.py`` (categoricals, CSC X, old-style frames,
CellRanger v2 and v3, velocyto loom).  Each is read by both packages and
the two ``CellData`` must be equal exactly: X as CSR (row pointers, ids,
value bits and dtypes), obs, var, obsm, varm, obsp, layers and nested
uns.  The one difference by design: the port reads every ``matrix.mtx``
with ``scipy.io.mmread`` into float32, the reference a plain one with its
native parse into float32 when its git-ignored ``csrc/libscio.so`` is
built, and otherwise (and every gzipped one) with ``mmread`` in scipy's
dtypes; the port's values are then the reference's rounded to float32.
"""

import gzip
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import scipy.io
import scipy.sparse as sp
import torch

import sctools_tpu as ref
import sctools_tpu_torch as sctt
from sctools_tpu.data.sparse import SparseCells as RefSparseCells
from sctools_tpu.data.synthetic import synthetic_ell as ref_synthetic_ell
from sctools_tpu.native import have_native as ref_have_native
from sctools_tpu_torch.data.sparse import SparseCells
from sctools_tpu_torch.data.synthetic import synthetic_counts, synthetic_ell

torch.set_num_threads(2)

_ROOT = Path(__file__).resolve().parents[1]
READERS = ("read", "read_h5ad", "write_h5ad", "read_10x_mtx", "read_10x_h5",
           "read_csv", "read_text", "read_mtx", "read_loom", "write_loom")


def _same(a, b, path="", float32_values=False):
    """Equal exactly: dicts key by key, sparse matrices as CSR arrays,
    arrays by dtype and bits (strings by value)."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), path
        for k in a:
            _same(a[k], b[k], f"{path}.{k}", float32_values)
        return
    if sp.issparse(a):
        assert sp.issparse(b), path
        a, b = a.tocsr(), b.tocsr()
        assert a.shape == b.shape, path
        assert np.array_equal(a.indptr, b.indptr), path
        assert np.array_equal(a.indices, b.indices), path
        if float32_values:
            assert b.data.dtype == np.float32, path
            a = a.astype(np.float32)
        _same(a.data, b.data, path + ".data")
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (path, a.dtype,
                                                       b.dtype)
    if a.dtype.kind in "USO":
        assert a.tolist() == b.tolist(), path
    else:
        assert a.tobytes() == b.tobytes(), path


def _same_data(a, b, **kw):
    _same(a.X, b.X, "X", **kw)
    for name in ("obs", "var", "obsm", "varm", "obsp", "uns", "layers"):
        _same(getattr(a, name), getattr(b, name), name)


def _content(seed=1, n=60, g=40):
    """The fields of a rich CellData, host numpy and scipy, from seeds."""
    rng = np.random.default_rng(seed)
    base = synthetic_counts(n, g, density=0.2, n_clusters=3, seed=seed)
    conn = sp.random(n, n, density=0.05, format="csr", random_state=rng,
                     dtype=np.float32)
    return dict(
        X=base.X,
        obs={"cluster_true": base.obs["cluster_true"],
             "cell_name": np.array([f"c{i}" for i in range(n)]),
             "score": rng.normal(size=n).astype(np.float32),
             "kept": rng.random(n) < 0.5},
        var={"gene_name": base.var["gene_name"], "mito": base.var["mito"]},
        obsm={"X_pca": rng.normal(size=(n, 5)).astype(np.float32)},
        varm={"PCs": rng.normal(size=(g, 5)).astype(np.float32)},
        obsp={"knn_indices": rng.integers(0, n, (n, 4)).astype(np.int32),
              "connectivities": conn},
        uns={"dendrogram_label": {
                 "linkage": rng.normal(size=(2, 4)),
                 "categories_ordered": np.array(["a", "b", "c"])},
             "log1p": {"base": None}, "n_top": 3, "flavor": "seurat_v3",
             "paga": {"connectivities": conn[:3, :3]}},
        layers={"counts": base.X.copy(),
                "spliced": rng.random((n, g)).astype(np.float32)})


def _pair(content):
    return ref.CellData(**content), sctt.CellData(**content)


# ----------------------------------------------------------------------
# h5ad
# ----------------------------------------------------------------------


@pytest.mark.parametrize("writer", ["reference", "port"])
@pytest.mark.parametrize("lean", [False, True])
def test_h5ad_written_by_either_reads_the_same_in_both(tmp_path, writer,
                                                       lean):
    pytest.importorskip("h5py")
    r, p = _pair(_content())
    path = str(tmp_path / "x.h5ad")
    (ref.write_h5ad(r, path) if writer == "reference"
     else sctt.write_h5ad(p, path))
    kw = (dict(load_obsm=False, load_layers=False, load_obsp=False)
          if lean else {})
    a, b = ref.read_h5ad(path, **kw), sctt.read_h5ad(path, **kw)
    assert isinstance(b, sctt.CellData)
    _same_data(a, b)
    if lean:
        assert b.obsm == b.varm == b.layers == b.obsp == {}
    else:
        _same(b.X, p.X)
        _same(b.layers["counts"], p.layers["counts"])
        assert b.uns["log1p"]["base"] == "" and b.uns["flavor"] == "seurat_v3"


def test_h5ad_files_of_both_writers_are_read_alike(tmp_path):
    pytest.importorskip("h5py")
    r, p = _pair(_content(seed=2))
    ref.write_h5ad(r, str(tmp_path / "r.h5ad"))
    sctt.write_h5ad(p, str(tmp_path / "p.h5ad"))
    _same_data(sctt.read_h5ad(str(tmp_path / "r.h5ad")),
               sctt.read_h5ad(str(tmp_path / "p.h5ad")))


def test_h5ad_from_device_data_equals_its_host_copy(tmp_path):
    """A ``to_device("cpu")`` CellData (padded-ELL X and layers, tensors
    in obs/obsm, padded rows in the op's outputs) is written through
    ``to_host()``; the reference writes its ``device_put()`` copy of the
    same content, and both files read alike."""
    pytest.importorskip("h5py")
    content = _content(seed=3)
    content["layers"] = {"counts": content["layers"]["counts"]}
    r, p = _pair(content)
    dev = sctt.apply("qc.per_cell_metrics", p.to_device("cpu"),
                     device="cpu")
    assert isinstance(dev.X, SparseCells)
    sctt.write_h5ad(dev, str(tmp_path / "dev.h5ad"))
    sctt.write_h5ad(dev.to_host(), str(tmp_path / "host.h5ad"))
    a = sctt.read_h5ad(str(tmp_path / "dev.h5ad"))
    _same_data(a, sctt.read_h5ad(str(tmp_path / "host.h5ad")))
    _same_data(a, ref.read_h5ad(str(tmp_path / "dev.h5ad")))
    _same(a.X.data, content["X"].data)
    assert np.array_equal(a.X.indices, content["X"].indices)
    assert a.obs["total_counts"].shape == (60,)

    # the reference's device_put turns a scipy obsp entry into a 0-d
    # object array, which its writer then refuses (ROADMAP Queue 3); the
    # port keeps it a scipy matrix (written above), so the two are
    # compared without it
    r = r.replace(obsp={"knn_indices": content["obsp"]["knn_indices"]})
    p = p.replace(obsp=dict(r.obsp))
    ref.write_h5ad(r.device_put(), str(tmp_path / "ref_dev.h5ad"))
    sctt.write_h5ad(p.to_device("cpu"), str(tmp_path / "port_dev.h5ad"))
    _same_data(ref.read_h5ad(str(tmp_path / "ref_dev.h5ad")),
               sctt.read_h5ad(str(tmp_path / "port_dev.h5ad")))


def _anndata_style(path, x_layout):
    """An AnnData-layout file by hand: CSC, CSR or dense X, a categorical
    with code -1, ``_index`` var names, a CSR obsp, a dense layer."""
    import h5py

    rng = np.random.default_rng(4)
    dense = ((rng.random((12, 7)) < 0.4)
             * rng.integers(1, 9, (12, 7))).astype(np.float32)
    with h5py.File(path, "w") as f:
        if x_layout == "dense":
            f.create_dataset("X", data=dense)
        else:
            M = (sp.csc_matrix if x_layout == "csc" else sp.csr_matrix)(dense)
            g = f.create_group("X")
            g.attrs["encoding-type"] = f"{x_layout}_matrix"
            g.attrs["shape"] = np.array(dense.shape)
            for k in ("data", "indices", "indptr"):
                g.create_dataset(k, data=getattr(M, k))
        obs = f.create_group("obs")
        obs.create_dataset("_index", data=np.array(
            [f"cell{i}".encode() for i in range(12)]))
        cat = obs.create_group("louvain")
        cat.create_dataset("categories", data=np.array([b"T", b"B", b"NK"]))
        cat.create_dataset("codes", data=np.array(
            [0, 1, 2, -1, 0, 0, 1, 2, 2, -1, 1, 0], np.int8))
        obs.create_dataset("n_genes", data=np.arange(12, dtype=np.int64))
        var = f.create_group("var")
        var.create_dataset("_index", data=np.array(
            [f"G{i}".encode() for i in range(7)]))
        var.create_dataset("gene_ids", data=np.array(
            [f"ENSG{i}".encode() for i in range(7)]))
        f.create_group("layers").create_dataset("dense", data=dense * 2)
        conn = sp.csr_matrix(np.eye(12, dtype=np.float32))
        og = f.create_group("obsp").create_group("connectivities")
        og.attrs["encoding-type"] = "csr_matrix"
        og.attrs["shape"] = np.array([12, 12])
        for k in ("data", "indices", "indptr"):
            og.create_dataset(k, data=getattr(conn, k))
        u = f.create_group("uns").create_group("neighbors")
        u.create_dataset("method", data="umap")
        u.create_group("params").create_dataset("n_neighbors", data=15)
    return dense


@pytest.mark.parametrize("x_layout", ["csr", "csc", "dense"])
def test_anndata_layouts_read_the_same_in_both(tmp_path, x_layout):
    pytest.importorskip("h5py")
    path = str(tmp_path / "a.h5ad")
    dense = _anndata_style(path, x_layout)
    a, b = ref.read_h5ad(path), sctt.read_h5ad(path)
    _same_data(a, b)
    X = b.X.toarray() if sp.issparse(b.X) else b.X
    assert np.array_equal(X, dense)
    # a frame's "_"-keys are skipped, so gene_ids, not _index, names genes
    assert b.var["gene_name"][3] == "ENSG3" and "_index" not in b.var
    assert b.obs["louvain"].tolist()[:4] == ["T", "B", "NK", ""]
    assert b.uns["neighbors"]["params"]["n_neighbors"] == 15


def test_old_style_structured_obs_reads_the_same(tmp_path):
    import h5py

    path = str(tmp_path / "old.h5ad")
    arr = np.zeros(5, dtype=[("index", "S8"), ("n_counts", "<f4")])
    arr["index"] = [f"c{i}".encode() for i in range(5)]
    arr["n_counts"] = np.arange(5)
    with h5py.File(path, "w") as f:
        f.create_dataset("X", data=np.eye(5, 3, dtype=np.float32))
        f.create_dataset("obs", data=arr)
    _same_data(ref.read_h5ad(path), sctt.read_h5ad(path))


# ----------------------------------------------------------------------
# loom
# ----------------------------------------------------------------------


def _velocyto_loom(path):
    import h5py

    rng = np.random.default_rng(5)
    g, c = 40, 25
    spliced = ((rng.random((g, c)) < 0.3)
               * rng.integers(1, 6, (g, c))).astype(np.float32)
    unspliced = ((rng.random((g, c)) < 0.2)
                 * rng.integers(1, 4, (g, c))).astype(np.float32)
    with h5py.File(path, "w") as f:
        f.create_dataset("matrix", data=spliced)
        lay = f.create_group("layers")
        lay.create_dataset("spliced", data=spliced)
        lay.create_dataset("unspliced", data=unspliced)
        ca = f.create_group("col_attrs")
        ca.create_dataset("CellID", data=np.array(
            [f"cell{i}".encode() for i in range(c)]))
        ca.create_dataset("batch", data=rng.integers(0, 2, c))
        ra = f.create_group("row_attrs")
        ra.create_dataset("Gene", data=np.array(
            [f"g{i}".encode() for i in range(g)]))
        ra.create_dataset("Accession", data=np.array(
            [f"ENSG{i}".encode() for i in range(g)]))
    return spliced, unspliced


@pytest.mark.parametrize("sparse", [True, False])
def test_velocyto_loom_reads_the_same_in_both(tmp_path, sparse):
    pytest.importorskip("h5py")
    path = str(tmp_path / "v.loom")
    spliced, unspliced = _velocyto_loom(path)
    a, b = ref.read_loom(path, sparse=sparse), sctt.read_loom(path,
                                                              sparse=sparse)
    _same_data(a, b)
    U = b.layers["unspliced"]
    assert np.array_equal(U.toarray() if sparse else U, unspliced.T)
    assert b.obs["cell_id"][0] == "cell0" and b.var["gene_name"][2] == "g2"


@pytest.mark.parametrize("writer", ["reference", "port", "port_device"])
def test_loom_written_by_either_reads_the_same_in_both(tmp_path, writer):
    pytest.importorskip("h5py")
    rng = np.random.default_rng(6)
    dense = ((rng.random((15, 8)) < 0.4)
             * rng.integers(1, 5, (15, 8))).astype(np.float32)
    content = dict(
        X=sp.csr_matrix(dense),
        obs={"cell_id": np.array([f"c{i}" for i in range(15)]),
             "n_counts": dense.sum(1)},
        var={"gene_name": np.array([f"g{i}" for i in range(8)])},
        layers={"spliced": sp.csr_matrix(dense * 2),
                "unspliced": sp.csr_matrix(dense * 3)})
    r, p = _pair(content)
    path = str(tmp_path / "rt.loom")
    if writer == "reference":
        ref.write_loom(r, path)
    else:
        sctt.write_loom(p.to_device("cpu") if writer == "port_device" else p,
                        path)
    a, b = ref.read_loom(path), sctt.read_loom(path)
    _same_data(a, b)
    _same(b.X, content["X"])
    _same(b.layers["unspliced"], content["layers"]["unspliced"])


# ----------------------------------------------------------------------
# 10x h5
# ----------------------------------------------------------------------


def _tenx_h5(path, layout, feature_key="feature_type"):
    import h5py

    rng = np.random.default_rng(7)
    n_cells, n_genes = 30, 50
    dense = ((rng.random((n_cells, n_genes)) < 0.2)
             * rng.integers(1, 9, (n_cells, n_genes))).astype(np.float32)
    X = sp.csr_matrix(dense)

    def common(g):
        g.create_dataset("data", data=X.data.astype(np.int32))
        g.create_dataset("indices", data=X.indices.astype(np.int64))
        g.create_dataset("indptr", data=X.indptr.astype(np.int64))
        g.create_dataset("shape", data=np.array([n_genes, n_cells]))
        g.create_dataset("barcodes", data=np.array(
            [f"AAAC-{i}".encode() for i in range(n_cells)]))

    with h5py.File(path, "w") as f:
        if layout == "v3":
            g = f.create_group("matrix")
            common(g)
            feat = g.create_group("features")
            feat.create_dataset("id", data=np.array(
                [f"ENSG{i:04d}".encode() for i in range(n_genes)]))
            feat.create_dataset("name", data=np.array(
                [f"G{i % 45}".encode() for i in range(n_genes)]))
            feat.create_dataset(feature_key, data=np.array(
                [b"Gene Expression"] * n_genes))
        else:
            for genome in (("GRCh38",) if layout == "v2" else
                           ("GRCh38", "mm10")):
                g = f.create_group(genome)
                common(g)
                g.create_dataset("genes", data=np.array(
                    [f"{genome}-{i:04d}".encode() for i in range(n_genes)]))
                g.create_dataset("gene_names", data=np.array(
                    [f"G{i}".encode() for i in range(n_genes)]))
    return dense


@pytest.mark.parametrize("layout,key", [("v3", "feature_type"),
                                        ("v3", "feature_types"),
                                        ("v2", None)])
def test_10x_h5_reads_the_same_in_both(tmp_path, layout, key):
    pytest.importorskip("h5py")
    path = str(tmp_path / "m.h5")
    dense = _tenx_h5(path, layout, key)
    a, b = ref.read_10x_h5(path), sctt.read_10x_h5(path)
    _same_data(a, b)
    assert np.array_equal(b.X.toarray(), dense)
    if layout == "v3":
        assert b.var["feature_type"][0] == "Gene Expression"
        u = b.var_names_make_unique()
        _same(u.var["gene_name"], a.var_names_make_unique().var["gene_name"])
        assert len(set(u.var_names)) == 50


def test_10x_h5_genome_choice_is_the_reference_s(tmp_path):
    pytest.importorskip("h5py")
    path = str(tmp_path / "two.h5")
    _tenx_h5(path, "v2x2")
    for pkg in (ref, sctt):
        with pytest.raises(ValueError, match="multiple genome groups"):
            pkg.read_10x_h5(path)
        with pytest.raises(ValueError, match="not in"):
            pkg.read_10x_h5(path, genome="hg19")
    _same_data(ref.read_10x_h5(path, genome="mm10"),
               sctt.read_10x_h5(path, genome="mm10"))
    assert sctt.read_10x_h5(path, genome="mm10").var["gene_ids"][0] == \
        "mm10-0000"


# ----------------------------------------------------------------------
# 10x mtx, text and MatrixMarket readers
# ----------------------------------------------------------------------


def _tenx_dir(d, version, gz_matrix, field):
    """A 10x directory: genes × cells matrix, v2 genes.tsv (plain) or v3
    features.tsv.gz with repeated symbols, and barcodes."""
    rng = np.random.default_rng(8)
    n_genes, n_cells = 60, 35
    M = sp.random(n_genes, n_cells, density=0.2, format="coo",
                  random_state=rng)
    if field == "integer":
        M.data = rng.integers(1, 50, M.nnz).astype(np.float64)
    if field == "pattern":
        M.data[:] = 1.0
    d.mkdir()
    scipy.io.mmwrite(str(d / "matrix.mtx"), M, field=field)
    if gz_matrix:
        with open(d / "matrix.mtx", "rb") as src, \
                gzip.open(d / "matrix.mtx.gz", "wb") as dst:
            dst.write(src.read())
        os.remove(d / "matrix.mtx")
    rows = [f"ENSG{i:05d}\tGENE{i % 50}\tGene Expression"
            for i in range(n_genes)]
    bars = [f"AAACCTG-{i}" for i in range(n_cells)]
    if version == "v2":
        (d / "genes.tsv").write_text("\n".join(r.rsplit("\t", 1)[0]
                                               for r in rows) + "\n")
        (d / "barcodes.tsv").write_text("\n".join(bars) + "\n")
    else:
        with gzip.open(d / "features.tsv.gz", "wt") as fh:
            fh.write("\n".join(rows) + "\n")
        with gzip.open(d / "barcodes.tsv.gz", "wt") as fh:
            fh.write("\n".join(bars) + "\n")
    return M.tocsr().T.tocsr()


@pytest.mark.parametrize("field", ["integer", "real", "pattern"])
@pytest.mark.parametrize("gz", [False, True])
@pytest.mark.parametrize("version", ["v2", "v3"])
def test_10x_mtx_directories_read_the_same_in_both(tmp_path, version, gz,
                                                   field):
    d = tmp_path / "tenx"
    want = _tenx_dir(d, version, gz, field)
    a, b = ref.read_10x_mtx(str(d)), sctt.read_10x_mtx(str(d))
    if not gz and ref_have_native():
        _same_data(a, b)  # the native parse's float32 is mmread's rounded
    else:
        _same_data(a, b, float32_values=True)
    assert b.shape == (35, 60)
    assert np.array_equal(b.X.toarray(), want.toarray().astype(np.float32))
    assert b.X.dtype == np.float32
    assert b.obs["barcode"][1] == "AAACCTG-1"
    assert b.var["gene_ids"][0] == "ENSG00000"
    u = b.var_names_make_unique()
    _same(u.var["gene_name"], a.var_names_make_unique().var["gene_name"])
    assert u.var["gene_name"][50] == "GENE0-1"


def test_10x_mtx_without_a_matrix_raises_in_both(tmp_path):
    for pkg in (ref, sctt):
        with pytest.raises(FileNotFoundError, match="matrix.mtx"):
            pkg.read_10x_mtx(str(tmp_path))


def _text_files(tmp):
    files = {
        "named.csv": "g1,g2,g3\nc1,1,2,3\nc2,4,5,6\n",
        "corner.csv": "cell,g1,g2\nc1,1.5,2\nc2,3,4\n",
        "bare.csv": "1,2\n3,4\n",
        "ws.txt": "g1 g2\n1 2\n3 4\n",
        "tabbed.tsv": "g1\tg2\nc1\t7\t8\nc2\t9\t10\n",
        "tabbed.tab": "g1\tg2\n1\t2\n",
        "plain.data": "1 2 3\n4 5 6\n",
    }
    for name, text in files.items():
        (tmp / name).write_text(text)
    with gzip.open(tmp / "packed.csv.gz", "wt") as fh:
        fh.write(files["named.csv"])
    M = sp.random(5, 3, density=0.6, format="coo", random_state=0)
    scipy.io.mmwrite(str(tmp / "m.mtx"), M)
    with open(tmp / "m.mtx", "rb") as src, \
            gzip.open(tmp / "z.mtx.gz", "wb") as dst:
        dst.write(src.read())
    return [*files, "packed.csv.gz", "m.mtx", "z.mtx.gz"]


def test_text_readers_and_dispatch_read_the_same_in_both(tmp_path):
    for name in _text_files(tmp_path):
        path = str(tmp_path / name)
        _same_data(ref.read(path), sctt.read(path))
    for reader, kw in (("read_csv", {}), ("read_csv",
                                          {"first_column_names": False}),
                       ("read_text", {"delimiter": ","}),
                       ("read_csv", {"dtype": np.float64})):
        path = str(tmp_path / "named.csv")
        if kw.get("first_column_names") is False:
            path = str(tmp_path / "bare.csv")
        _same_data(getattr(ref, reader)(path, **kw),
                   getattr(sctt, reader)(path, **kw))
    for t in (False, True):
        _same_data(ref.read_mtx(str(tmp_path / "m.mtx"), transpose=t),
                   sctt.read_mtx(str(tmp_path / "m.mtx"), transpose=t))
        _same_data(ref.read(str(tmp_path / "z.mtx.gz"), transpose=t),
                   sctt.read(str(tmp_path / "z.mtx.gz"), transpose=t))
    d = sctt.read(str(tmp_path / "tabbed.tsv"))
    assert d.obs["cell_name"].tolist() == ["c1", "c2"]
    assert d.var["gene_name"].tolist() == ["g1", "g2"]


def test_text_readers_refuse_what_the_reference_refuses(tmp_path):
    (tmp_path / "empty.csv").write_text("")
    (tmp_path / "head.csv").write_text("g1,g2\n")
    (tmp_path / "wide.csv").write_text("g1,g2,g3,g4\n1,2\n")
    for pkg in (ref, sctt):
        with pytest.raises(ValueError, match="is empty"):
            pkg.read_csv(str(tmp_path / "empty.csv"))
        with pytest.raises(ValueError, match="no data"):
            pkg.read_csv(str(tmp_path / "head.csv"))
        with pytest.raises(ValueError, match="header has 4 names"):
            pkg.read_csv(str(tmp_path / "wide.csv"))
        with pytest.raises(ValueError, match="unknown extension"):
            pkg.read("file.xyz")


# ----------------------------------------------------------------------
# CellData's name helpers, synthetic_ell, the package surface
# ----------------------------------------------------------------------


@pytest.mark.parametrize("names,join", [
    (["A", "A", "A-1", "B", "A", "A-2", "B"], "-"),
    (["A", "A", "A", "A_1"], "_"),
    (["x", "y", "x-1", "x", "x-1"], "-")])
def test_var_names_make_unique_is_the_reference_s(names, join):
    X = sp.csr_matrix(np.ones((2, len(names)), np.float32))
    var = {"gene_name": np.array(names)}
    a = ref.CellData(X, var=dict(var)).var_names_make_unique(join)
    b = sctt.CellData(X, var=dict(var)).var_names_make_unique(join)
    _same(a.var["gene_name"], b.var["gene_name"])
    assert len(set(b.var["gene_name"].tolist())) == len(names)
    assert b.var["gene_name"][0] == names[0]


def test_name_helpers_without_names_and_when_unique():
    X = sp.csr_matrix(np.ones((3, 2), np.float32))
    bare = sctt.CellData(X)
    assert bare.var_names_make_unique() is bare
    assert (bare.n_obs, bare.n_vars) == (3, 2)
    assert bare.obs_names.tolist() == ["0", "1", "2"]
    assert bare.var_names.tolist() == ["0", "1"]
    named = sctt.CellData(X, obs={"barcode": np.array(["a", "b", "c"])},
                          var={"gene_name": np.array(["g", "h"])})
    assert named.var_names_make_unique() is named
    assert named.obs_names.tolist() == ["a", "b", "c"]
    assert named.var_names.tolist() == ["g", "h"]
    both = named.with_obs(cell_name=np.array(["x", "y", "z"]))
    assert both.obs_names.tolist() == ref.CellData(
        X, obs=both.obs).obs_names.tolist() == ["x", "y", "z"]


@pytest.mark.parametrize("form", ["scipy", "dense", "ell", "tensor"])
def test_obs_and_var_vectors_are_the_reference_s(form):
    ds = synthetic_counts(30, 20, density=0.3, n_clusters=2, seed=11)
    var = {"gene_name": np.array([f"G{i % 18}" for i in range(20)]),
           "mito": ds.var["mito"]}
    obs = {"cluster_true": ds.obs["cluster_true"]}
    r = ref.CellData(ds.X, obs=obs, var=var)
    p = sctt.CellData(ds.X, obs=obs, var=var)
    if form == "dense":
        p = p.with_X(ds.X.toarray())
    elif form in ("ell", "tensor"):
        p = p.to_device("cpu")
        if form == "tensor":
            p = p.with_X(torch.from_numpy(ds.X.toarray()))
    for key in ("G3", "G1", "cluster_true"):  # G1: genes 1 and 19
        _same(r.obs_vector(key), p.obs_vector(key), key)
    for key in (0, 7, -1, "mito", "gene_name"):
        _same(r.var_vector(key), p.var_vector(key), str(key))
    with pytest.raises(KeyError, match="neither"):
        p.obs_vector("NOPE")
    with pytest.raises(KeyError, match="not a var column"):
        p.var_vector("nope")
    with pytest.raises(IndexError):
        p.var_vector(30)


def test_ell_vectors_add_repeated_gene_ids_as_the_reference_does():
    """synthetic_ell may store one gene twice in a cell: both packages'
    vectors add the two counts."""
    ell = synthetic_ell(40, 25, nnz_per_cell=12, n_clusters=3, seed=12)
    r = ref.CellData(RefSparseCells(ell["indices"], ell["data"], 40, 25))
    p = sctt.CellData(SparseCells(torch.from_numpy(ell["indices"]),
                                  torch.from_numpy(ell["data"]), 40, 25))
    for cell in (0, 5, 39):
        _same(r.var_vector(cell), p.var_vector(cell))
    dup = [g for g in range(25)
           if (ell["indices"][:40] == g).sum(axis=1).max() > 1]
    assert dup  # the case is exercised
    names = np.array([f"g{i}" for i in range(25)])
    r, p = r.with_var(gene_name=names), p.with_var(gene_name=names)
    for g in dup[:3]:
        _same(r.obs_vector(f"g{g}"), p.obs_vector(f"g{g}"))


@pytest.mark.parametrize("kw", [
    dict(n_cells=100, n_genes=300, nnz_per_cell=40, n_clusters=4, seed=3),
    dict(n_cells=37, n_genes=90, nnz_per_cell=20, n_clusters=2, seed=5,
         rows_padded=48, capacity=256, dtype=np.float64)])
def test_synthetic_ell_is_bit_for_bit_the_reference_s(kw):
    a, b = ref_synthetic_ell(**kw), synthetic_ell(**kw)
    assert sorted(a) == sorted(b)
    for k in a:
        _same(a[k], b[k], k)


def test_the_package_exports_the_reference_s_readers():
    for name in READERS:
        assert name in sctt.__all__
        assert callable(getattr(sctt, name)) and hasattr(ref, name)
    assert sctt.read_h5ad is sctt.data.io.read_h5ad


def test_import_loads_no_h5py():
    """The card's machine has no h5py: the port imports it only inside
    the functions that read or write HDF5."""
    code = ("import sys, sctools_tpu_torch, sctools_tpu_torch.data.io\n"
            "print('h5py' in sys.modules)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(_ROOT)
    r = subprocess.run([sys.executable, "-c", code], cwd=str(_ROOT),
                       env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "False"
