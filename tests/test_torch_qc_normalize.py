"""The recipes' ops of the port against the JAX reference on the same
inputs: ``qc.per_gene_metrics``, ``qc.filter_cells``/``filter_genes``,
``qc.subsample``, ``util.snapshot_layer``, ``normalize.scale``/
``pearson_residuals``/``regress_out``/``clr``/``downsample_counts``,
``pca.exact``, the gene axis of ``CellData.__getitem__``, dense X, and
every ``hvg.select`` flavor with and without ``batch_key``.

Both packages start from the reference's ``synthetic_counts`` (600 ×
800, its padded-ELL planes carried by ``carry.cells_from_numpy``); the
reference runs ``backend="tpu"`` on the CPU.  Tolerances:

* integer QC columns, the kept cells and genes, the ``subsample`` rows
  and every gene subset: exact;
* float columns and the values of ``scale``, ``pearson_residuals``,
  ``regress_out`` and ``clr``: rtol 1e-5, atol 1e-5 (float32 sums in
  another order);
* HVG sets of every flavor, and with ``batch_key``: identical, but for
  genes within 1e-5 (relative) of the cutoff score in both runs, which
  the test prints (on the dense X, cell_ranger's median/MAD scores tie
  at exactly 1.0 up to float32 rounding of the moments); the scores
  within rtol 1e-4, atol 1e-5, the dispersion flavors' within 1e-3 ×
  the largest for the dispersion and cell_ranger flavors (their float32
  bin variance cancels, or they divide by a bin's MAD); with
  ``batch_key`` the number of batches exact and the median rank equal
  for ≥ 95 % of the genes (near-ties past the cutoff swap ranks);
* ``pca.exact``: explained variance rtol 1e-4, scores and components
  within 1e-3 (× max|score| for the scores) after aligning each
  column's sign; ``pca.randomized`` on a dense X with the reference's
  sketch carried in: the same (the tolerances of
  tests/test_torch_pca.py);
* ``downsample_counts`` draws other random bits than
  ``jax.random.binomial``, so it is held to invariants: values floored,
  cells at or under the target untouched, no value above the original,
  thinned zeros become sentinel slots, the mean total within 5 % of
  the target.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sctools_tpu as sct
from sctools_tpu.data.synthetic import synthetic_counts as ref_counts
from sctools_tpu.ops.pca import _sketch_omega
import sctools_tpu_torch as sctt
from sctools_tpu_torch import Pipeline
from sctools_tpu_torch.carry import cells_from_numpy, pca_omega_from_numpy
from sctools_tpu_torch.data.sparse import SparseCells
from sctools_tpu_torch.registry import apply

torch.set_num_threads(2)

N_CELLS, N_GENES, N_TOP = 600, 800, 200
TOL = dict(rtol=1e-5, atol=1e-5)
NEW_NAMES = [
    "qc.per_gene_metrics", "qc.filter_cells", "qc.filter_genes",
    "qc.subsample", "util.snapshot_layer", "normalize.scale",
    "normalize.pearson_residuals", "normalize.regress_out",
    "normalize.clr", "normalize.downsample_counts", "pca.exact",
    "recipe.zheng17", "recipe.seurat", "recipe.pearson_residuals",
    "recipe.weinreb17"]


def _np(v):
    if isinstance(v, SparseCells):
        v = v.to_dense()
    elif hasattr(v, "to_dense"):  # the reference's SparseCells
        v = v.to_dense()
    if isinstance(v, torch.Tensor):
        return v.cpu().numpy()
    return np.asarray(v)


@pytest.fixture(scope="module")
def both():
    host = ref_counts(N_CELLS, N_GENES, density=0.05, n_clusters=3, seed=2)
    rng = np.random.default_rng(7)
    obs = {"batch": np.array(["a", "b", "c"])[rng.integers(0, 3, N_CELLS)],
           "score": rng.normal(size=N_CELLS).astype(np.float32)}
    host = host.replace(obs={**host.obs, **obs})
    ref = host.device_put()
    port = cells_from_numpy(np.asarray(ref.X.indices),
                            np.asarray(ref.X.data), ref.n_cells,
                            ref.n_genes, obs=host.obs, var=host.var)
    return ref, port


@pytest.fixture(scope="module")
def dense(both):
    """The same data with a dense X: the reference's log1p'd values."""
    ref, port = both
    ref_log = sct.Pipeline([("normalize.library_size", {}),
                            ("normalize.log1p", {})]).run(ref,
                                                          backend="tpu")
    Xd = np.asarray(ref_log.X.to_dense())
    return ref.replace(X=jnp.asarray(Xd)), port.replace(
        X=torch.from_numpy(Xd.copy()))


@pytest.fixture(params=["sparse", "dense"])
def pair(request, both, dense):
    return both if request.param == "sparse" else dense


def test_registry_holds_the_new_names():
    names = sctt.names()
    for name in NEW_NAMES:
        assert name in names, name
    assert len(names) == 76


# ------------------------------------------------------------------ qc


def test_per_gene_metrics(pair):
    ref, port = pair
    r = sct.apply("qc.per_gene_metrics", ref, backend="tpu")
    p = apply("qc.per_gene_metrics", port, device="cpu")
    assert p.var["n_cells"].dtype == torch.int32
    np.testing.assert_array_equal(_np(p.var["n_cells"]),
                                  _np(r.var["n_cells"]))
    for key in ("total_counts", "mean_counts"):
        np.testing.assert_allclose(_np(p.var[key]), _np(r.var[key]),
                                   **TOL, err_msg=key)


def test_per_cell_metrics_dense(dense):
    ref, port = dense
    r = sct.apply("qc.per_cell_metrics", ref, backend="tpu",
                  percent_top=(5,))
    p = apply("qc.per_cell_metrics", port, device="cpu", percent_top=(5,))
    np.testing.assert_array_equal(_np(p.obs["n_genes"]),
                                  _np(r.obs["n_genes"]))
    for key in ("total_counts", "pct_counts_mt",
                "pct_counts_in_top_5_genes"):
        np.testing.assert_allclose(_np(p.obs[key]), _np(r.obs[key]),
                                   **TOL, err_msg=key)


def _bounds(r, which):
    ng = np.asarray(r.obs["n_genes"])[:N_CELLS]
    tc = np.asarray(r.obs["total_counts"])[:N_CELLS]
    return {
        "min_genes": dict(min_genes=int(np.median(ng))),
        "counts": dict(min_counts=float(np.quantile(tc, 0.2)),
                       max_counts=float(np.quantile(tc, 0.9))),
        "max_genes_mt": dict(max_genes=int(np.quantile(ng, 0.8)),
                             max_pct_mt=float(np.quantile(
                                 np.asarray(r.obs["pct_counts_mt"])[
                                     :N_CELLS], 0.7))),
    }[which]


@pytest.mark.parametrize("which", ["min_genes", "counts", "max_genes_mt"])
def test_filter_cells(pair, which):
    ref, port = pair
    r = sct.Pipeline([("util.snapshot_layer", {}),
                      ("qc.per_cell_metrics", {})]).run(ref, backend="tpu")
    p = Pipeline([("util.snapshot_layer", {}),
                  ("qc.per_cell_metrics", {})]).run(port, device="cpu")
    kw = _bounds(r, which)
    r = sct.apply("qc.filter_cells", r, backend="tpu", **kw)
    p = apply("qc.filter_cells", p, device="cpu", **kw)
    assert 0 < p.n_cells == r.n_cells < N_CELLS
    np.testing.assert_array_equal(_np(p.obs["cluster_true"]),
                                  _np(r.obs["cluster_true"])[:r.n_cells])
    np.testing.assert_array_equal(_np(p.obs["batch"]),
                                  np.asarray(r.obs["batch"]))
    np.testing.assert_array_equal(_np(p.X), _np(r.X))
    np.testing.assert_array_equal(_np(p.layers["counts"]), _np(p.X))


@pytest.mark.parametrize("kw", [
    dict(min_cells=20), dict(min_cells=None, min_counts=30.0),
    dict(min_cells=3, max_cells=100, max_counts=400.0)])
def test_filter_genes(pair, kw):
    ref, port = pair
    r = sct.apply("qc.filter_genes", ref, backend="tpu", **kw)
    p = apply("qc.filter_genes", port, device="cpu", **kw)
    assert 0 < p.n_genes == r.n_genes < N_GENES
    np.testing.assert_array_equal(p.var["gene_name"],
                                  np.asarray(r.var["gene_name"]))
    np.testing.assert_array_equal(_np(p.X), _np(r.X))
    if isinstance(p.X, SparseCells):  # the same ELL planes
        assert p.X.capacity == r.X.capacity
        np.testing.assert_array_equal(_np(p.X.indices), _np(r.X.indices))


@pytest.mark.parametrize("kw", [dict(fraction=0.3, seed=0),
                                dict(n_obs=123, seed=5)])
def test_subsample_picks_the_reference_rows(pair, kw):
    ref, port = pair
    r = sct.apply("qc.subsample", ref, backend="tpu", **kw)
    p = apply("qc.subsample", port, device="cpu", **kw)
    assert p.n_cells == r.n_cells
    np.testing.assert_array_equal(_np(p.X), _np(r.X))
    np.testing.assert_array_equal(_np(p.obs["score"]),
                                  _np(r.obs["score"]))
    with pytest.raises(ValueError, match="exactly one"):
        apply("qc.subsample", port, device="cpu")


def test_snapshot_layer_shares_x(both):
    _, port = both
    p = apply("util.snapshot_layer", port, device="cpu", layer="raw")
    assert p.layers["raw"] is p.X
    out = apply("normalize.log1p", p, device="cpu")
    assert torch.equal(out.layers["raw"].data, port.X.data)


# ------------------------------------------------------------ gene axis


@pytest.mark.parametrize("key", ["slice", "mask", "ids", "names"])
def test_gene_axis_subset(pair, key):
    ref, port = pair
    rng = np.random.default_rng(3)
    sel = {"slice": slice(10, 700, 3),
           "mask": rng.random(N_GENES) < 0.3,
           "ids": rng.choice(N_GENES, 50, replace=False),
           "names": np.asarray(ref.var["gene_name"])[
               rng.choice(N_GENES, 40, replace=False)]}[key]
    cells = np.arange(0, N_CELLS, 7)
    port = port.with_layers(counts=port.X).with_varm(
        w=torch.arange(N_GENES, dtype=torch.float32)[:, None])
    ref = ref.with_layers(counts=ref.X).with_varm(
        w=jnp.arange(N_GENES, dtype=jnp.float32)[:, None])
    for r, p in ((ref[:, sel], port[:, sel]),
                 (ref[cells, sel], port[cells, sel])):
        assert p.shape == r.shape
        np.testing.assert_array_equal(_np(p.X), _np(r.X))
        np.testing.assert_array_equal(_np(p.layers["counts"]), _np(p.X))
        np.testing.assert_array_equal(p.var["gene_name"],
                                      np.asarray(r.var["gene_name"]))
        np.testing.assert_array_equal(_np(p.varm["w"]), _np(r.varm["w"]))
        np.testing.assert_array_equal(_np(p.var["mito"]),
                                      _np(r.var["mito"]))


def test_gene_axis_rejects_what_the_reference_rejects(both):
    _, port = both
    with pytest.raises(IndexError):
        port[:, np.ones(N_GENES + 1, bool)]
    with pytest.raises(IndexError):
        port[:, np.array([N_GENES])]
    with pytest.raises(KeyError, match="unknown gene names"):
        port[:, np.array(["no-such-gene"])]
    with pytest.raises(KeyError, match="gene axis"):
        port[np.array(["a"])]


# ------------------------------------------------------------ normalize


def test_library_size_and_log1p_dense(dense):
    ref, port = dense
    for kw in (dict(target_sum=1e4), dict(target_sum=None),
               dict(exclude_highly_expressed=True, max_fraction=0.1)):
        steps = [("normalize.library_size", kw), ("normalize.log1p", {})]
        r = sct.Pipeline(steps).run(ref, backend="tpu")
        p = Pipeline(steps).run(port, device="cpu")
        np.testing.assert_allclose(_np(p.X), _np(r.X), **TOL)
        np.testing.assert_allclose(_np(p.obs["library_size"]),
                                   _np(r.obs["library_size"]), **TOL)


@pytest.mark.parametrize("kw", [dict(max_value=10.0), dict(max_value=None),
                                dict(max_value=1.0),
                                dict(max_value=None, zero_center=False)])
def test_scale(pair, kw):
    ref, port = pair
    r = sct.apply("normalize.scale", ref, backend="tpu", **kw)
    p = apply("normalize.scale", port, device="cpu", **kw)
    assert isinstance(p.X, torch.Tensor) and p.X.shape == (N_CELLS,
                                                           N_GENES)
    np.testing.assert_allclose(_np(p.X), _np(r.X), **TOL)
    for key in ("scale_mean", "scale_std"):
        np.testing.assert_allclose(_np(p.var[key]), _np(r.var[key]),
                                   **TOL, err_msg=key)
    if kw["max_value"] is not None:
        assert np.abs(_np(p.X)).max() <= kw["max_value"]


@pytest.mark.parametrize("kw", [dict(), dict(theta=10.0),
                                dict(theta=50.0, clip=3.0)])
def test_pearson_residuals(both, kw):
    ref, port = both
    r = sct.apply("normalize.pearson_residuals", ref, backend="tpu", **kw)
    p = apply("normalize.pearson_residuals", port, device="cpu", **kw)
    np.testing.assert_allclose(_np(p.X), _np(r.X), **TOL)
    assert p.uns["pearson_theta"] == r.uns["pearson_theta"]


@pytest.mark.parametrize("keys", [("score",), ("batch",),
                                  ("score", "batch")])
def test_regress_out(pair, keys):
    ref, port = pair
    pre = [("qc.per_cell_metrics", {})]
    r = sct.Pipeline(pre).run(ref, backend="tpu")
    p = Pipeline(pre).run(port, device="cpu")
    r = sct.apply("normalize.regress_out", r, backend="tpu", keys=keys)
    p = apply("normalize.regress_out", p, device="cpu", keys=keys)
    np.testing.assert_allclose(_np(p.X), _np(r.X), **TOL)
    with pytest.raises(KeyError, match="no key"):
        apply("normalize.regress_out", port, device="cpu", keys=("nope",))


@pytest.mark.parametrize("axis", ["cell", "gene"])
def test_clr(pair, axis):
    ref, port = pair
    r = sct.apply("normalize.clr", ref, backend="tpu", axis=axis)
    p = apply("normalize.clr", port, device="cpu", axis=axis)
    if isinstance(p.X, SparseCells):
        np.testing.assert_array_equal(_np(p.X.indices), _np(r.X.indices))
    np.testing.assert_allclose(_np(p.X), _np(r.X), **TOL)


@pytest.mark.parametrize("target", [50.0, 2000.0])
def test_downsample_counts_invariants(pair, target):
    _, port = pair
    before = _np(port.X)
    floored = np.floor(before)
    p = apply("normalize.downsample_counts", port, device="cpu",
              target_total=target, seed=3)
    again = apply("normalize.downsample_counts", port, device="cpu",
                  target_total=target, seed=3)
    after = _np(p.X)
    np.testing.assert_array_equal(after, _np(again.X))  # seeded
    np.testing.assert_array_equal(after, np.floor(after))
    assert (after <= floored).all() and (after >= 0).all()
    totals = floored.sum(axis=1)
    under = totals <= target
    np.testing.assert_array_equal(after[under], floored[under])
    over = ~under
    if over.any():
        got = after[over].sum(axis=1).mean()
        assert abs(got - target) <= 0.05 * target, (got, target)
    if isinstance(p.X, SparseCells):
        ind = p.X.indices.numpy()
        dat = p.X.data.numpy()
        assert (dat[ind == p.X.sentinel] == 0).all()
        assert (dat[ind != p.X.sentinel] > 0).all()
    np.testing.assert_array_equal(_np(port.X), before)  # input untouched


# ------------------------------------------------------------------ pca


def _align_signs(a, b):
    s = np.sign(np.sum(a * b, axis=0))
    s[s == 0] = 1.0
    return a * s


def _same_pca(p, r, n_rows):
    rs = _np(r.obsm["X_pca"])[:n_rows]
    ps = _np(p.obsm["X_pca"])[:n_rows]
    np.testing.assert_allclose(_np(p.uns["pca_explained_variance"]),
                               _np(r.uns["pca_explained_variance"]),
                               rtol=1e-4)
    np.testing.assert_allclose(_align_signs(ps, rs), rs,
                               atol=1e-3 * np.abs(rs).max(), rtol=0)
    np.testing.assert_allclose(_align_signs(_np(p.varm["PCs"]),
                                            _np(r.varm["PCs"])),
                               _np(r.varm["PCs"]), atol=1e-3, rtol=0)
    np.testing.assert_allclose(_np(p.uns["pca_mean"]),
                               _np(r.uns["pca_mean"]), **TOL)


@pytest.mark.parametrize("center", [True, False])
def test_pca_exact(pair, center):
    ref, port = pair
    r = sct.apply("pca.exact", ref, backend="tpu", n_components=10,
                  center=center)
    p = apply("pca.exact", port, device="cpu", n_components=10,
              center=center)
    assert p.obsm["X_pca"].shape == (N_CELLS, 10)
    _same_pca(p, r, N_CELLS)


def test_pca_randomized_dense_with_the_reference_sketch(dense):
    ref, port = dense
    L = 20 + 10
    omega = np.asarray(_sketch_omega(jax.random.PRNGKey(0), N_GENES, L,
                                     jnp.float32))
    r = sct.apply("pca.randomized", ref, backend="tpu", n_components=20)
    p = apply("pca.randomized", port, device="cpu", n_components=20,
              omega=pca_omega_from_numpy(omega))
    assert p.obsm["X_pca"].shape == (N_CELLS, 20)
    _same_pca(p, r, N_CELLS)


# ------------------------------------------------------------------ hvg


FLAVORS = ["seurat_v3", "dispersion", "seurat", "cell_ranger",
           "pearson_residuals"]


NEAR_TIE = 1e-5  # relative distance of a near-tie to the cutoff score


def _same_set_but_near_ties(p_hv, r_hv, p_score, r_score, what,
                            n_top=N_TOP):
    """The two HVG sets are equal, or differ only in genes whose score
    lies within NEAR_TIE (relative) of the cutoff score in both runs
    (printed)."""
    diff = np.flatnonzero(p_hv != r_hv)
    if not len(diff):
        return
    print(f"{what}: HVG sets differ in near-ties {diff.tolist()}, scores "
          f"{p_score[diff].tolist()} / {r_score[diff].tolist()}")
    for s in (p_score, r_score):
        cut = np.sort(s)[::-1][n_top - 1]
        assert (np.abs(s[diff] - cut) <= NEAR_TIE * abs(cut)).all(), (
            what, diff, s[diff], cut)


@pytest.mark.parametrize("flavor", FLAVORS)
def test_hvg_flavor_sets(pair, flavor):
    ref, port = pair
    step = ("hvg.select", {"n_top": N_TOP, "flavor": flavor})
    r = sct.Pipeline([step]).run(ref, backend="tpu")
    p = Pipeline([step]).run(port, device="cpu")
    hv = _np(p.var["highly_variable"])
    assert hv.sum() == N_TOP
    r_score = _np(r.var["hvg_score"])
    p_score = _np(p.var["hvg_score"])
    _same_set_but_near_ties(hv, _np(r.var["highly_variable"]), p_score,
                            r_score, flavor)
    # the dispersion z-scores divide by a float32 bin variance
    # s/cnt − mean², which cancels (in the reference too), and
    # cell_ranger's by a bin's MAD: ulps of the moments grow to ~1e-4
    # of the largest score
    atol = (1e-3 * np.abs(r_score).max()
            if flavor in ("dispersion", "seurat", "cell_ranger") else 1e-5)
    np.testing.assert_allclose(p_score, r_score, rtol=1e-4, atol=atol)
    for key in ("means", "variances"):
        np.testing.assert_allclose(_np(p.var[key]), _np(r.var[key]),
                                   rtol=1e-5, atol=1e-7, err_msg=key)


@pytest.mark.parametrize("flavor", ["seurat_v3", "dispersion",
                                    "cell_ranger", "pearson_residuals"])
def test_hvg_batch_key(both, flavor):
    ref, port = both
    step = ("hvg.select", {"n_top": N_TOP, "flavor": flavor,
                           "batch_key": "batch", "subset": True})
    r = sct.Pipeline([step]).run(ref, backend="tpu")
    p = Pipeline([step]).run(port, device="cpu")
    assert p.n_genes == r.n_genes == N_TOP
    np.testing.assert_array_equal(p.var["gene_name"],
                                  np.asarray(r.var["gene_name"]))
    np.testing.assert_array_equal(_np(p.var["highly_variable_nbatches"]),
                                  _np(r.var["highly_variable_nbatches"]))
    # a near-tie past the cutoff may swap ranks within a batch, which
    # moves a gene's median rank
    same = _np(p.var["hvg_score"]) == _np(r.var["hvg_score"])
    assert same.mean() >= 0.95, same.mean()
    np.testing.assert_array_equal(_np(p.X), _np(r.X))


def test_hvg_subset_on_dense_x(dense):
    ref, port = dense
    step = [("hvg.select", {"n_top": N_TOP, "flavor": "dispersion",
                            "subset": True})]
    r = sct.Pipeline(step).run(ref, backend="tpu")
    p = Pipeline(step).run(port, device="cpu")
    assert isinstance(p.X, torch.Tensor) and p.n_genes == N_TOP
    np.testing.assert_array_equal(_np(p.X), _np(r.X))
