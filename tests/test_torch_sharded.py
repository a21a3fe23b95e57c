"""Cell-sharded in-memory data: ``parallel.shard_celldata`` and the five
ops that run on it, on 8 CPU shards (``make_mesh(devices=["cpu"] *
8)``), against the reference's own sharded runs on the 8 virtual host
devices of ``tests/conftest.py`` (``tests/test_mesh.py:33-60``,
``tests/test_multichip.py:75-115``).

Tolerances are the reference's: ``total_counts`` rtol 1e-4, ``hvg_score``
rtol and atol 1e-3, ``highly_variable`` equal; the PCA's explained
variance rtol 5e-2 of ``pca.exact`` and the smallest singular value of
the first 5 components' overlap > 0.95.  The round trip of
``shard_celldata`` is bit for bit; an op that does not run on sharded
data raises ``NotImplementedError`` naming ROADMAP Queue 1 item 9."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import sctools_tpu as sct
from sctools_tpu.data.synthetic import synthetic_counts
from sctools_tpu.parallel import make_mesh as ref_make_mesh
from sctools_tpu.parallel import shard_celldata as ref_shard_celldata
import sctools_tpu_torch as sctt
from sctools_tpu_torch.data.dataset import CellData
from sctools_tpu_torch.data.sharded import ShardedRows, is_sharded
from sctools_tpu_torch.parallel import make_mesh, shard_celldata

torch.set_num_threads(2)

PIPE = [("qc.per_cell_metrics", {}),
        ("normalize.library_size", {"target_sum": 1e4}),
        ("normalize.log1p", {}),
        ("hvg.select", {"n_top": 64})]


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(devices=["cpu"] * 8)


def _host(ds) -> CellData:
    """The reference's host CellData as the port's (scipy X, numpy
    fields)."""
    return CellData(ds.X, dict(ds.obs), dict(ds.var))


def test_shard_celldata_round_trip_bitwise_sparse(mesh):
    host = synthetic_counts(300, 64, density=0.1, n_clusters=3, seed=1)
    sharded = shard_celldata(_host(host), mesh)
    X = sharded.X
    assert isinstance(X, ShardedRows) and len(X.blocks) == 8
    assert [b.device for b in X.blocks] == list(mesh.devices)
    assert X.rows_padded % 64 == 0 and sharded.n_cells == 300
    back = sharded.to_host()
    A, B = host.X.tocsr(), back.X.tocsr()
    assert A.shape == B.shape
    assert np.array_equal(A.toarray(), B.toarray())
    for k in host.obs:
        assert np.array_equal(np.asarray(host.obs[k]),
                              np.asarray(back.obs[k])), k


def test_shard_celldata_round_trip_dense(mesh):
    host = synthetic_counts(200, 32, density=0.2, n_clusters=2, seed=2)
    dense = np.asarray(host.X.toarray(), np.float32)
    sharded = shard_celldata(CellData(dense), mesh)
    X = sharded.X.gather().numpy()
    assert X.shape[0] % 8 == 0 and X.shape[0] >= 200
    assert np.array_equal(X[:200], dense)
    assert not X[200:].any()  # padding rows are zero
    assert np.array_equal(sharded.to_host().X, dense)


def test_shard_celldata_pads_like_the_reference(mesh):
    host = synthetic_counts(300, 64, density=0.1, n_clusters=3, seed=1)
    ref = ref_shard_celldata(host, ref_make_mesh(8))
    port = shard_celldata(_host(host), mesh)
    assert port.X.rows_padded == ref.X.rows_padded
    assert port.X.capacity == ref.X.capacity


def test_sharded_pipeline_matches_reference(mesh):
    ds = synthetic_counts(256, 128, n_clusters=2, seed=10)
    ref = sct.Pipeline(PIPE).run(ref_shard_celldata(ds, ref_make_mesh(8)),
                                 backend="tpu").to_host()
    out = sctt.Pipeline(PIPE).run(shard_celldata(_host(ds), mesh),
                                  device="cpu")
    assert is_sharded(out)  # Pipeline.run kept it sharded
    assert isinstance(out.obs["total_counts"], ShardedRows)
    got = out.to_host()
    np.testing.assert_allclose(got.obs["total_counts"],
                               ref.obs["total_counts"], rtol=1e-4)
    np.testing.assert_allclose(got.var["hvg_score"], ref.var["hvg_score"],
                               rtol=1e-3, atol=1e-3)
    np.testing.assert_array_equal(got.var["highly_variable"],
                                  ref.var["highly_variable"])


def test_sharded_pipeline_matches_single_device(mesh):
    """The blocks and their fixed-order sums against the port's single
    device: per-cell outputs bit for bit (row-local), X bit for bit,
    the HVG scores within float32 reordering."""
    ds = synthetic_counts(256, 128, n_clusters=2, seed=10)
    one = sctt.Pipeline(PIPE).run(_host(ds), device="cpu").to_host()
    got = sctt.Pipeline(PIPE).run(shard_celldata(_host(ds), mesh),
                                  device="cpu").to_host()
    for k in ("total_counts", "n_genes", "pct_counts_mt", "library_size"):
        assert np.array_equal(got.obs[k], one.obs[k]), k
    assert (got.X != one.X).nnz == 0
    np.testing.assert_allclose(got.var["hvg_score"], one.var["hvg_score"],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(got.var["highly_variable"],
                                  one.var["highly_variable"])


def test_sharded_ops_repeat_bit_for_bit(mesh):
    ds = synthetic_counts(256, 128, n_clusters=2, seed=10)
    runs = [sctt.Pipeline(PIPE + [("pca.randomized", {"n_components": 8})])
            .run(shard_celldata(_host(ds), mesh), device="cpu").to_host()
            for _ in range(2)]
    assert np.array_equal(runs[0].var["hvg_score"], runs[1].var["hvg_score"])
    assert np.array_equal(runs[0].obsm["X_pca"], runs[1].obsm["X_pca"])


def test_one_block_mesh_is_the_single_device_path():
    """A mesh of one device holds the whole X as one block, and the
    block code (the mesh-order sums, the Gram-reduced CholeskyQR2) is
    then the single-device code step for step: the five ops give the
    same bits."""
    ds = synthetic_counts(256, 128, n_clusters=2, seed=10)
    steps = PIPE + [("pca.randomized", {"n_components": 8})]
    one = sctt.Pipeline(steps).run(_host(ds), device="cpu").to_host()
    got = sctt.Pipeline(steps).run(
        shard_celldata(_host(ds), make_mesh(devices=["cpu"])),
        device="cpu").to_host()
    for k in ("total_counts", "n_genes", "pct_counts_mt", "library_size"):
        assert np.array_equal(got.obs[k], one.obs[k]), k
    for k in ("hvg_score", "means", "variances"):
        assert np.array_equal(got.var[k], one.var[k]), k
    assert np.array_equal(got.obsm["X_pca"], one.obsm["X_pca"])
    assert np.array_equal(got.uns["pca_explained_variance"],
                          one.uns["pca_explained_variance"])

def test_sharded_pca_cholesky_qr(mesh):
    """CholeskyQR2 over row blocks: the exact oracle's subspace and
    explained variance (the reference's own bars), and the reference's
    sharded run's."""
    ds = synthetic_counts(256, 128, n_clusters=3, seed=11)
    prep = sct.Pipeline([
        ("normalize.library_size", {"target_sum": 1e4}),
        ("normalize.log1p", {}),
    ]).run(ds, backend="cpu")
    exact = sct.apply("pca.exact", prep, backend="cpu", n_components=10)
    ref = sct.apply("pca.randomized", ref_shard_celldata(prep,
                                                         ref_make_mesh(8)),
                    backend="tpu", n_components=10, n_iter=4,
                    qr_method="cholesky").to_host()
    out = sctt.apply("pca.randomized", shard_celldata(_host(prep), mesh),
                     device="cpu", n_components=10, n_iter=4,
                     qr_method="cholesky")
    assert isinstance(out.obsm["X_pca"], ShardedRows)
    got = out.to_host()
    assert got.obsm["X_pca"].shape == (256, 10)
    ev_e = np.asarray(exact.uns["pca_explained_variance"])
    for ev in (np.asarray(got.uns["pca_explained_variance"]),):
        np.testing.assert_allclose(ev, ev_e, rtol=5e-2)
    np.testing.assert_allclose(
        got.uns["pca_explained_variance"],
        np.asarray(ref.uns["pca_explained_variance"]), rtol=5e-2)
    Ve = np.asarray(exact.varm["PCs"])[:, :5]
    Vr = np.asarray(got.varm["PCs"])[:, :5]
    s = np.linalg.svd(Ve.T @ Vr, compute_uv=False)
    assert s.min() > 0.95, f"subspace misaligned: {s}"


def test_sharded_dense_ops_match_single_device(mesh):
    """A dense X in row blocks (zero padding rows masked): the same
    five ops against the port's single device."""
    ds = synthetic_counts(200, 48, density=0.3, n_clusters=2, seed=3)
    dense = CellData(np.asarray(ds.X.toarray(), np.float32), dict(ds.obs),
                     dict(ds.var))
    steps = [("qc.per_cell_metrics", {}),
             ("normalize.library_size", {"target_sum": None}),
             ("normalize.log1p", {}), ("hvg.select", {"n_top": 16}),
             ("pca.randomized", {"n_components": 6})]
    one = sctt.Pipeline(steps).run(dense, device="cpu").to_host()
    got = sctt.Pipeline(steps).run(shard_celldata(dense, mesh),
                                   device="cpu").to_host()
    for k in ("total_counts", "n_genes", "library_size"):
        assert np.array_equal(got.obs[k], one.obs[k]), k
    assert np.array_equal(got.X, one.X)
    np.testing.assert_array_equal(got.var["highly_variable"],
                                  one.var["highly_variable"])
    np.testing.assert_allclose(got.uns["pca_explained_variance"],
                               one.uns["pca_explained_variance"], rtol=1e-3)


def test_sharded_hvg_subset_keeps_blocks(mesh):
    ds = synthetic_counts(256, 128, n_clusters=2, seed=10)
    out = sctt.Pipeline(PIPE[:3] + [("hvg.select", {"n_top": 32,
                                                    "subset": True})]).run(
        shard_celldata(_host(ds), mesh), device="cpu")
    assert is_sharded(out) and out.n_genes == 32
    one = sctt.Pipeline(PIPE[:3] + [("hvg.select", {"n_top": 32,
                                                    "subset": True})]).run(
        _host(ds), device="cpu")
    assert (out.to_host().X != one.to_host().X).nnz == 0


@pytest.mark.parametrize("op,kw", [
    ("neighbors.knn", {}), ("qc.filter_cells", {"min_genes": 1}),
    ("normalize.scale", {}), ("hvg.select", {"flavor": "dispersion"}),
    ("pca.randomized", {"qr_method": "householder"}),
    ("normalize.library_size", {"exclude_highly_expressed": True})])
def test_other_ops_raise_on_sharded_data(mesh, op, kw):
    ds = synthetic_counts(64, 32, n_clusters=2, seed=0)
    sharded = shard_celldata(_host(ds), mesh)
    with pytest.raises(NotImplementedError, match="Queue 1 item 9"):
        sctt.apply(op, sharded, device="cpu", **kw)


def test_direct_calls_and_subsets_never_gather(mesh):
    from sctools_tpu_torch.ops.qc import filter_genes

    ds = synthetic_counts(64, 32, n_clusters=2, seed=0)
    sharded = shard_celldata(_host(ds), mesh)
    with pytest.raises(NotImplementedError, match="Queue 1 item 9"):
        filter_genes(sharded, device="cpu")
    with pytest.raises(NotImplementedError, match="Queue 1 item 9"):
        sharded[:10]
    with pytest.raises(NotImplementedError, match="Queue 1 item 9"):
        sctt.Pipeline(["normalize.log1p", "neighbors.knn"]).run(
            sharded, device="cpu")


def test_sharded_data_refuses_a_device_of_another_kind(mesh):
    ds = synthetic_counts(64, 32, n_clusters=2, seed=0)
    sharded = shard_celldata(_host(ds), mesh)
    with pytest.raises(ValueError, match="sharded over cpu"):
        sctt.Pipeline(["normalize.log1p"]).run(sharded, device="meta")
    with pytest.raises(ValueError, match="already sharded"):
        shard_celldata(sharded, mesh)
    assert sp.issparse(sharded.to_host().X)
