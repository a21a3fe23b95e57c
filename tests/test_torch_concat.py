"""``concat`` of the port against the JAX reference's on the same inputs.

Every case of ``tests/test_concat.py`` is run through both packages
and the outputs compared: X (CSR, as a dense array), obs, var, obsm
and layers equal exactly (both are the same host scipy/numpy code on
the same values, so no tolerance is needed), and the refusals raise
the same errors.  The port also takes inputs on a device (a padded-ELL
or dense tensor X, tensor obs and obsm), fetched first: the result is
the host concat of the fetched inputs.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import sctools_tpu as sct
from sctools_tpu.data.dataset import CellData as RefCellData
from sctools_tpu.data.synthetic import synthetic_counts
import sctools_tpu_torch as sctt

torch.set_num_threads(2)


def _both(dense, genes, **obs):
    """The same small input as a reference and a port ``CellData``."""
    X = sp.csr_matrix(np.asarray(dense, np.float32))
    obs = {k: np.asarray(v) for k, v in obs.items()}
    var = {"gene_name": np.asarray(genes)} if genes is not None else {}
    return (RefCellData(X.copy(), obs=dict(obs), var=dict(var)),
            sctt.CellData(X.copy(), obs=dict(obs), var=dict(var)))


def _with(pair, method, **kw):
    return tuple(getattr(d, method)(**kw) for d in pair)


def _assert_same(port, ref):
    assert port.shape == ref.shape
    assert sp.issparse(port.X) and port.X.format == "csr"
    np.testing.assert_array_equal(port.X.toarray(), ref.X.toarray())
    for field in ("obs", "var", "obsm"):
        p, r = getattr(port, field), getattr(ref, field)
        assert sorted(p) == sorted(r), field
        for key in r:
            a, b = np.asarray(p[key]), np.asarray(r[key])
            assert a.dtype == b.dtype, (field, key, a.dtype, b.dtype)
            np.testing.assert_array_equal(a, b, err_msg=f"{field} {key}")
    assert sorted(port.layers) == sorted(ref.layers)
    for key in ref.layers:
        np.testing.assert_array_equal(port.layers[key].toarray(),
                                      ref.layers[key].toarray())
    assert port.obsp == {} and port.uns == {}


def _concat_both(pairs, **kw):
    got = sctt.concat([p for _, p in pairs], **kw)
    want = sct.concat([r for r, _ in pairs], **kw)
    _assert_same(got, want)
    return got


def test_inner_join_aligns_by_gene_name():
    a = _both([[1, 2, 3], [4, 5, 6]], ["g1", "g2", "g3"], depth=[1.0, 2.0])
    b = _both([[7, 8], [9, 10]], ["g3", "g1"], depth=[3.0, 4.0])
    out = _concat_both([a, b], join="inner", label="batch",
                       keys=["s1", "s2"])
    assert list(out.var["gene_name"]) == ["g1", "g3"]  # the first's order
    np.testing.assert_array_equal(
        out.X.toarray(), np.array([[1, 3], [4, 6], [8, 7], [10, 9]],
                                  np.float32))
    assert list(out.obs["batch"]) == ["s1", "s1", "s2", "s2"]


def test_outer_join_fills_zero():
    a = _both([[1, 2]], ["g1", "g2"])
    b = _both([[5]], ["g3"])
    out = _concat_both([a, b], join="outer")
    assert list(out.var["gene_name"]) == ["g1", "g2", "g3"]
    np.testing.assert_array_equal(out.X.toarray(), [[1, 2, 0], [0, 0, 5]])


def test_obs_union_and_obsm_intersection():
    a = _with(_both([[1, 2]], ["g1", "g2"], score=[0.5]), "with_obsm",
              X_pca=np.ones((1, 4)), only_a=np.ones((1, 2)))
    b = _with(_both([[3, 4]], ["g1", "g2"], other=["x"]), "with_obsm",
              X_pca=np.zeros((1, 4)))
    out = _concat_both([a, b])
    assert np.isnan(out.obs["score"][1])
    assert list(out.obs["other"]) == ["", "x"]
    assert set(out.obsm) == {"X_pca"}


def test_layers_reindexed_like_X():
    a = _with(_both([[1, 2]], ["g1", "g2"]), "with_layers",
              counts=sp.csr_matrix(np.array([[10, 20]], np.float32)))
    b = _with(_both([[3, 4]], ["g2", "g1"]), "with_layers",
              counts=sp.csr_matrix(np.array([[30, 40]], np.float32)))
    out = _concat_both([a, b], join="inner")
    np.testing.assert_array_equal(out.layers["counts"].toarray(),
                                  [[10, 20], [40, 30]])


def test_positional_when_no_gene_names():
    a = _both(np.eye(2, 3), None)
    b = _both(np.ones((1, 3)), None)
    assert _concat_both([a, b]).shape == (3, 3)
    c = _both(np.ones((1, 4)), None)
    for fn, pair in ((sctt.concat, 1), (sct.concat, 0)):
        with pytest.raises(ValueError, match="differing gene counts"):
            fn([a[pair], c[pair]])


@pytest.mark.parametrize("kw,match", [
    (dict(keys=["s1", "s2"]), "label="),
    (dict(label="b", keys=["s1"]), "len\\(keys\\)"),
    (dict(join="left"), "unknown join")])
def test_refusals(kw, match):
    a = _both([[1, 2]], ["g1", "g2"])
    for fn, pair in ((sctt.concat, 1), (sct.concat, 0)):
        with pytest.raises(ValueError, match=match):
            fn([a[pair], a[pair]], **kw)
    with pytest.raises(ValueError, match="at least one"):
        sctt.concat([])


def test_rejects_duplicate_gene_names():
    a = _both([[1, 2]], ["g1", "g1"])
    b = _both([[3, 4]], ["g1", "g2"])
    for fn, pair in ((sctt.concat, 1), (sct.concat, 0)):
        with pytest.raises(ValueError, match="duplicate gene names"):
            fn([a[pair], b[pair]])


def test_preserves_first_var_columns():
    a = _with(_both([[1, 2]], ["g1", "g2"]), "with_var",
              highly_variable=np.array([True, False]),
              feature_type=np.array(["gex", "gex"]))
    b = _both([[3, 4, 5]], ["g2", "g3", "g1"])
    out = _concat_both([a, b], join="outer")
    hv = out.var["highly_variable"]
    assert hv[0] == 1.0 and hv[1] == 0.0 and np.isnan(hv[2])
    assert list(out.var["feature_type"]) == ["gex", "gex", ""]


def test_default_keys_and_many_inputs():
    parts = [_both(np.full((i + 1, 3), i + 1.0), ["g1", "g2", "g3"],
                   depth=np.arange(i + 1.0)) for i in range(4)]
    out = _concat_both(parts, label="src")
    assert list(out.obs["src"]) == ["0", "1", "1", "2", "2", "2", "3", "3",
                                    "3", "3"]


def test_feeds_integration():
    """The label column drives ``integrate.harmony`` in both packages."""
    full = synthetic_counts(400, 300, density=0.1, n_clusters=3, seed=0)
    X = full.X.tocsr()
    halves = [tuple(cls(X[s].copy(), obs={k: v[s] for k, v in
                                          full.obs.items()},
                        var=dict(full.var))
                    for cls in (RefCellData, sctt.CellData))
              for s in (slice(0, 200), slice(200, 400))]
    merged = _concat_both(halves, label="sample", keys=["runA", "runB"])
    out = sctt.Pipeline([
        ("normalize.library_size", {}), ("normalize.log1p", {}),
        ("pca.randomized", {"n_components": 10}),
        ("integrate.harmony", {"batch_key": "sample", "n_clusters": 5}),
    ]).run(merged, device="cpu")
    assert tuple(out.obsm["X_harmony"].shape) == (400, 10)
    assert list(out.uns["harmony_batches"]) == ["runA", "runB"]


def test_inputs_on_a_device_are_fetched():
    """Padded-ELL and dense tensor X, tensor obs and obsm: the concat of
    the fetched inputs (padding rows of per-cell tensors dropped)."""
    full = synthetic_counts(96, 40, density=0.2, n_clusters=2, seed=5)
    X = full.X.tocsr()
    host = [sctt.CellData(X[s].copy(), obs={"depth": np.arange(
        s.start, s.stop, dtype=np.float32)}, var=dict(full.var),
        obsm={"X_pca": np.full((s.stop - s.start, 3), s.start,
                               np.float32)})
        for s in (slice(0, 50), slice(50, 96))]
    dev = [host[0].to_device("cpu"),
           host[1].to_device("cpu").with_X(torch.from_numpy(
               X[50:].toarray()))]
    assert isinstance(dev[0].X, sctt.SparseCells)
    assert dev[0].obs["depth"].shape[0] == 50  # no padding on obs here
    padded = dev[0].X.rows_padded
    dev[0] = dev[0].with_obsm(X_pca=torch.cat([
        dev[0].obsm["X_pca"], torch.zeros((padded - 50, 3))]))
    got = sctt.concat(dev, label="batch")
    want = sctt.concat(host, label="batch")
    _assert_same(got, want)
    ref = sct.concat([RefCellData(h.X, obs=h.obs, var=h.var, obsm=h.obsm)
                      for h in host], label="batch")
    _assert_same(got, ref)


def test_from_scipy_and_from_dense():
    from sctools_tpu.data import io as rio

    X = sp.random(6, 5, density=0.4, format="coo", random_state=0,
                  dtype=np.float32)
    obs = {"a": np.arange(6)}
    for port_fn, ref_fn, arg in ((sctt.from_scipy, rio.from_scipy, X),
                                 (sctt.from_dense, rio.from_dense,
                                  X.toarray())):
        p, r = port_fn(arg, obs=obs), ref_fn(arg, obs=obs)
        assert type(p.X) is type(r.X) and p.shape == r.shape
        got = p.X.toarray() if sp.issparse(p.X) else p.X
        want = r.X.toarray() if sp.issparse(r.X) else r.X
        np.testing.assert_array_equal(got, want)
        assert p.obs.keys() == r.obs.keys() and p.var == r.var == {}
    assert sctt.data.io.from_scipy(X).X.format == "csr"
