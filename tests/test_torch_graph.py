"""The port's graph tail (``sctools_tpu_torch/ops/graph.py``, the cell
subset behind ``CellData.__getitem__`` and the ``graph_tail`` recipe)
against the JAX package's ops (``backend="tpu"``, on the CPU).

Both packages start from one dataset: the reference's log1p'd ELL
planes carried with ``carry.cells_from_numpy``, its X_pca, and its kNN
graph carried with ``carry.graph_from_numpy``.

Tolerances: permutations, remapped ids, subsets and round trips are
bitwise (they move values, they compute none); Jaccard is exact
(integer counts, one IEEE division); edge weights, diffusion weights
and X_magic are held at rtol 1e-5, atol 1e-6 — the same float32
formulas with sums over the k slots in another order (and ``exp``
from another library)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sctools_tpu as sct
from sctools_tpu.data.synthetic import synthetic_counts as ref_counts
from sctools_tpu.ops import graph as ref_graph
from sctools_tpu.recipes import recipe_pipeline as ref_recipe
import sctools_tpu_torch as sctt
from sctools_tpu_torch.carry import cells_from_numpy, graph_from_numpy
from sctools_tpu_torch.ops import graph as port_graph
from sctools_tpu_torch.registry import apply

torch.set_num_threads(2)

N_CELLS, N_GENES, K = 384, 96, 8
TOL = dict(rtol=1e-5, atol=1e-6)


def _np(v):
    return v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


@pytest.fixture(scope="module")
def both():
    host = ref_counts(N_CELLS, N_GENES, density=0.1, n_clusters=4, seed=0)
    d = host.device_put()
    d = sct.apply("normalize.log1p", d, backend="tpu")
    d = sct.apply("pca.randomized", d, backend="tpu", n_components=12)
    d = sct.apply("neighbors.knn", d, backend="tpu", k=K)
    p = cells_from_numpy(np.asarray(d.X.indices), np.asarray(d.X.data),
                         d.n_cells, d.n_genes, obs=host.obs, var=host.var)
    p = p.with_obsm(X_pca=torch.from_numpy(np.array(d.obsm["X_pca"])))
    p = graph_from_numpy(p, d.obsp["knn_indices"], d.obsp["knn_distances"],
                         knn_k=K, knn_metric="cosine")
    return d, p


def _field(data, where, key):
    return _np(getattr(data, where)[key])[: data.n_cells]


def _same_planes(a, b):
    """Two packages' (or two runs') SparseCells X, plane for plane."""
    assert (a.n_cells, a.n_genes) == (b.n_cells, b.n_genes)
    np.testing.assert_array_equal(_np(a.indices), _np(b.indices))
    np.testing.assert_array_equal(_np(a.data), _np(b.data))


# ------------------------------------------------------------- graph ops


@pytest.mark.parametrize("mode", ["umap", "gaussian"])
def test_connectivities(both, mode):
    d, p = both
    r = sct.apply("graph.connectivities", d, backend="tpu", mode=mode)
    o = apply("graph.connectivities", p, device="cpu", mode=mode)
    np.testing.assert_allclose(_field(o, "obsp", "connectivities"),
                               _field(r, "obsp", "connectivities"), **TOL)
    assert o.uns["connectivity_mode"] == mode


@pytest.mark.parametrize("mode", ["average", "mutual", "union",
                                  "union_norm"])
def test_symmetrized_weights(both, mode):
    d, p = both
    idx = np.array(_field(d, "obsp", "knn_indices"))
    w = np.random.default_rng(3).random(idx.shape).astype(np.float32)
    ref = np.asarray(ref_graph._symmetrized_weights(
        jnp.asarray(idx), jnp.asarray(w), mode=mode))
    out = port_graph._symmetrized_weights(
        torch.from_numpy(idx), torch.from_numpy(w), block=100, mode=mode)
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


def test_symmetrized_weights_rejects_unknown_mode():
    idx = torch.zeros((4, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="mode"):
        port_graph._symmetrized_weights(idx, torch.ones((4, 2)),
                                        mode="max")


@pytest.mark.parametrize("symmetrize", [True, False])
def test_diffusion_operator(both, symmetrize):
    d, p = both
    r = sct.apply("graph.diffusion_operator", d, backend="tpu",
                  symmetrize=symmetrize)
    o = apply("graph.diffusion_operator", p, device="cpu",
              symmetrize=symmetrize)
    got = _field(o, "obsp", "diffusion_weights")
    np.testing.assert_allclose(got, _field(r, "obsp", "diffusion_weights"),
                               **TOL)
    np.testing.assert_allclose(got.sum(axis=1), 1.0, rtol=1e-5)


@pytest.mark.parametrize("t", [1, 3])
def test_magic(both, t):
    d, p = both
    r = sct.apply("impute.magic", d, backend="tpu", t=t)
    o = apply("impute.magic", p, device="cpu", t=t)
    got = _field(o, "obsm", "X_magic")
    assert got.shape == (N_CELLS, N_GENES) and got.dtype == np.float32
    np.testing.assert_allclose(got, _field(r, "obsm", "X_magic"), **TOL)
    assert o.uns["magic_t"] == t


def test_magic_mesh_is_not_ported(both):
    """``mesh=`` is ported now: over 3 CPU shards (rows padded), both
    strategies give the single-device X_magic within 1e-5."""
    from sctools_tpu_torch.parallel import make_mesh

    _, p = both
    one = _field(apply("impute.magic", p, device="cpu", t=2), "obsm",
                 "X_magic")
    mesh = make_mesh(devices=["cpu"] * 3)
    for strategy in ("all_gather", "ring"):
        o = apply("impute.magic", p, device="cpu", t=2, mesh=mesh,
                  strategy=strategy)
        np.testing.assert_allclose(_field(o, "obsm", "X_magic"), one,
                                   atol=1e-5, err_msg=strategy)


def test_jaccard_op_is_exact(both):
    d, p = both
    r = sct.apply("graph.jaccard", d, backend="tpu")
    o = apply("graph.jaccard", p, device="cpu", block=64)
    np.testing.assert_array_equal(_field(o, "obsp", "jaccard"),
                                  _field(r, "obsp", "jaccard"))


def test_ops_need_a_knn_graph():
    ds = sctt.data.synthetic.synthetic_counts(20, 10, seed=0)
    with pytest.raises(ValueError, match="neighbors.knn"):
        apply("graph.connectivities", ds, device="cpu")


# ------------------------------------------------------- reorder / restore


def test_reorder_is_the_references_bit_for_bit(both):
    d, p = both
    r = sct.apply("graph.reorder", d, backend="tpu")
    o = apply("graph.reorder", p, device="cpu")
    for key in ("graph_perm", "graph_perm_inv"):
        np.testing.assert_array_equal(_np(o.uns[key]), np.asarray(r.uns[key]))
        assert _np(o.uns[key]).dtype == np.int32
    for key in ("graph_bandwidth", "graph_tile_density",
                "graph_reorder_method"):
        assert o.uns[key] == r.uns[key], key
    for key in ("knn_indices", "knn_distances"):
        np.testing.assert_array_equal(_field(o, "obsp", key),
                                      _field(r, "obsp", key))
    _same_planes(o.X, r.X)
    np.testing.assert_array_equal(_field(o, "obsm", "X_pca"),
                                  _field(r, "obsm", "X_pca"))
    np.testing.assert_array_equal(_field(o, "obs", "cluster_true"),
                                  _field(r, "obs", "cluster_true"))


def test_reorder_shrinks_the_band(both):
    _, p = both
    idx = _field(p, "obsp", "knn_indices")
    o = apply("graph.reorder", p, device="cpu")
    assert o.uns["graph_bandwidth"] < port_graph.graph_bandwidth(idx)
    new_idx = _field(o, "obsp", "knn_indices")
    assert port_graph.tile_density(new_idx, 64) > \
        port_graph.tile_density(idx, 64)
    assert np.array_equal(port_graph.reorder_permutation(idx, "natural"),
                          np.arange(N_CELLS))
    with pytest.raises(ValueError):
        port_graph.reorder_permutation(idx, method="sorted")


def test_reorder_restore_round_trip_is_bitwise(both):
    _, p = both
    r = apply("graph.reorder", p, device="cpu")
    back = apply("graph.restore_order", r, device="cpu")
    assert not any(key.startswith("graph_") for key in back.uns)
    _same_planes(back.X, p.X)
    for where, key in (("obsp", "knn_indices"), ("obsp", "knn_distances"),
                       ("obsm", "X_pca"), ("obs", "cluster_true")):
        np.testing.assert_array_equal(_field(back, where, key),
                                      _field(p, where, key))


@pytest.mark.parametrize("op,kwargs,field,where", [
    ("graph.jaccard", {}, "jaccard", "obsp"),
    ("graph.connectivities", {}, "connectivities", "obsp"),
    ("graph.diffusion_operator", {}, "diffusion_weights", "obsp"),
    ("impute.magic", {"t": 2}, "X_magic", "obsm"),
])
def test_reorder_op_restore_is_bitwise_identical(both, op, kwargs, field,
                                                 where):
    """reorder → op → restore equals the op in the natural order, bit
    for bit, on the plain path: each row's result depends on its own
    edges only, and a permutation moves rows."""
    _, p = both
    nat = apply(op, p, device="cpu", **kwargs)
    r = apply("graph.reorder", p, device="cpu")
    back = apply("graph.restore_order",
                 apply(op, r, device="cpu", **kwargs), device="cpu")
    np.testing.assert_array_equal(_field(back, where, field),
                                  _field(nat, where, field))


def test_knn_rebuild_drops_the_stale_band(both):
    """A kNN rebuild after a reorder replaces the graph the band was
    measured on: the statistics go, the permutation stays (the row
    layout is unchanged) and restore still undoes it."""
    _, p = both
    r = apply("graph.reorder", p, device="cpu")
    assert "graph_bandwidth" in r.uns
    r2 = apply("neighbors.knn", r, device="cpu", k=6)
    assert "graph_bandwidth" not in r2.uns
    assert "graph_tile_density" not in r2.uns
    assert "graph_perm" in r2.uns
    back = apply("graph.restore_order", r2, device="cpu")
    assert "graph_perm" not in back.uns
    _same_planes(back.X, p.X)


def test_restore_on_natural_layout_is_a_noop(both):
    _, p = both
    assert apply("graph.restore_order", p, device="cpu") is p


def test_double_reorder_warns_and_returns_its_input(both):
    _, p = both
    r = apply("graph.reorder", p, device="cpu")
    with pytest.warns(UserWarning, match="already carries"):
        r2 = apply("graph.reorder", r, device="cpu")
    assert r2.uns["graph_perm"] is r.uns["graph_perm"]


# ------------------------------------------------------------ cell subset


@pytest.mark.parametrize("kind", ["slice", "mask", "ids", "padded_mask"])
def test_cell_subset_equals_the_references(both, kind):
    d, p = both
    rng = np.random.default_rng(4)
    sel = {
        "slice": slice(5, 300, 3),
        "mask": rng.random(N_CELLS) < 0.4,
        "ids": np.concatenate([rng.permutation(N_CELLS)[:100], [-1, -2]]),
        # per-cell arrays from device ops carry padded rows
        "padded_mask": np.concatenate([rng.random(N_CELLS) < 0.5,
                                       np.ones(8, bool)]),
    }[kind]
    r, o = d[sel], p[sel]
    assert o.n_cells == r.n_cells and o.obsp == {} and r.obsp == {}
    _same_planes(o.X, r.X)
    np.testing.assert_array_equal(_np(o.obsm["X_pca"]),
                                  np.asarray(r.obsm["X_pca"]))
    np.testing.assert_array_equal(_np(o.obs["cluster_true"]),
                                  np.asarray(r.obs["cluster_true"]))
    np.testing.assert_array_equal(_np(o.var["gene_name"]),
                                  np.asarray(r.var["gene_name"]))
    assert p[:] is p and p[:, :] is p


def test_cell_subset_trims_padded_rows_and_pads_empty():
    ds = sctt.data.synthetic.synthetic_counts(30, 12, seed=1)
    ds = apply("qc.per_cell_metrics", ds, device="cpu")
    assert ds.X.rows_padded == 32
    sub = ds[np.array([3, 29, 0])]
    assert sub.X.rows_padded == 8 and sub.X.n_cells == 3
    assert (sub.X.indices[3:] == sub.X.sentinel).all()
    assert (sub.X.data[3:] == 0).all()
    assert sub.obs["total_counts"].shape == (3,)
    torch.testing.assert_close(sub.obs["total_counts"],
                               ds.obs["total_counts"][[3, 29, 0]])


def test_cell_subset_rejects_what_it_does_not_take(both):
    _, p = both
    assert p[:, :10].n_genes == 10  # the gene axis is ported
    with pytest.raises(IndexError):
        p[np.array([N_CELLS])]
    with pytest.raises(IndexError):
        p[np.ones(N_CELLS - 1, bool)]
    with pytest.raises(KeyError, match="gene axis"):
        p[np.array(["a"])]
    with pytest.raises(TypeError):
        p[np.array([0.5])]


def test_graph_from_numpy_checks_its_input(both):
    _, p = both
    idx = _field(p, "obsp", "knn_indices")
    dist = _field(p, "obsp", "knn_distances")
    with pytest.raises(ValueError, match="one"):
        graph_from_numpy(p, idx, dist[:, :3])
    with pytest.raises(ValueError, match="ids outside"):
        graph_from_numpy(p, np.full_like(idx, N_CELLS), dist)
    with pytest.raises(ValueError, match="cannot hold"):
        graph_from_numpy(p, idx[:10], dist[:10])


# ------------------------------------------------------- the whole slice


def test_graph_tail_recipe_matches_the_reference(both):
    d, p = both
    r = ref_recipe("graph_tail", t=3, jaccard=True).run(d)
    o = sctt.recipe_pipeline("graph_tail", t=3, jaccard=True).run(
        p, device="cpu")
    assert set(o.uns) - set(p.uns) == set(r.uns) - set(d.uns)
    np.testing.assert_array_equal(_field(o, "obsp", "knn_indices"),
                                  _field(p, "obsp", "knn_indices"))
    np.testing.assert_array_equal(_field(o, "obsp", "knn_indices"),
                                  _field(r, "obsp", "knn_indices"))
    _same_planes(o.X, p.X)
    np.testing.assert_array_equal(_field(o, "obsp", "jaccard"),
                                  _field(r, "obsp", "jaccard"))
    for where, key in (("obsp", "connectivities"),
                       ("obsp", "diffusion_weights"), ("obsm", "X_magic")):
        np.testing.assert_allclose(_field(o, where, key),
                                   _field(r, where, key), **TOL,
                                   err_msg=key)


def test_recipe_pipeline_names_what_is_not_ported():
    with pytest.raises(KeyError, match="one-call only"):
        sctt.recipe_pipeline("weinreb17")
    steps = [t.name for t in sctt.recipe_pipeline("graph_tail",
                                                  reorder=False)]
    assert steps == ["graph.connectivities", "graph.diffusion_operator",
                     "impute.magic"]
