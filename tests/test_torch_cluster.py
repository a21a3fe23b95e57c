"""The port's clustering and PAGA (``sctools_tpu_torch/ops/cluster.py``,
``graph.paga``) against the JAX package's (``backend="tpu"``, on the
CPU).

Two fixtures: the blob graph of ``tests/test_leiden.py`` (600 points,
5 blobs, k = 12, the reference's CPU connectivities) and
``synthetic_counts(384, 96, n_clusters=4)`` through the reference's
log1p, PCA and kNN (k = 8) with its connectivities.  The port gets the
reference's kNN graph and connectivities bit for bit
(``carry.graph_from_numpy``, then the weights): its own
``graph.connectivities`` agrees only within rtol 1e-5, enough to move a
support tie.  Jaccard weights are exact in both and are recomputed.

Tolerances: labels equal (so ARI 1.0); modularity and the other ``uns``
floats rtol 1e-5; PAGA and the dendrogram bit for bit (host float64 on
equal labels); k-means centroids and inertia rtol 1e-5 (the assignment's
matrix product is another library's).  k-means is held label for label
from the reference's own starting centroids (its ``jax.random`` draw,
repeated here); the port's seeded start draws other bits and is held to
invariants."""

import sys
import warnings
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sctools_tpu as sct
from sctools_tpu.data.synthetic import gaussian_blobs
from sctools_tpu.data.synthetic import synthetic_counts as ref_counts
from sctools_tpu.ops import cluster as ref_cluster
import sctools_tpu_torch as sctt
from sctools_tpu_torch.carry import graph_from_numpy
from sctools_tpu_torch.ops import cluster as port_cluster
from sctools_tpu_torch.registry import apply

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_leiden import _blob_data, _ring_of_cliques  # noqa: E402

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=0.0)
FIXTURES = ["blobs", "counts"]


def _np(v):
    return v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _port_from(ref) -> "sctt.CellData":
    """The port's CellData on the reference's graph, connectivities and
    X_pca, bit for bit."""
    n = ref.n_cells
    emb = np.array(ref.obsm["X_pca"], dtype=np.float32)
    p = sctt.CellData(torch.zeros((n, 4)), obsm={
        "X_pca": torch.from_numpy(emb)})
    p = graph_from_numpy(p, ref.obsp["knn_indices"], ref.obsp["knn_distances"],
                         knn_k=ref.uns["knn_k"],
                         knn_metric=ref.uns["knn_metric"])
    conn = np.array(ref.obsp["connectivities"], dtype=np.float32)
    return p.with_obsp(connectivities=torch.from_numpy(conn))


def _build(name):
    if name == "blobs":
        ref, truth = _blob_data()
        # the same draw _blob_data searched, as the embedding
        pts, _ = gaussian_blobs(600, 10, 5, spread=0.25, seed=7)
        # float32 weights in both packages (the CPU oracle's are float64)
        ref = ref.with_obsm(X_pca=pts.astype(np.float32)).with_obsp(
            connectivities=np.asarray(ref.obsp["connectivities"],
                                      np.float32))
    else:
        host = ref_counts(384, 96, density=0.1, n_clusters=4, seed=0)
        truth = np.asarray(host.obs["cluster_true"])
        ref = host.device_put()
        ref = sct.apply("normalize.log1p", ref, backend="tpu")
        ref = sct.apply("pca.randomized", ref, backend="tpu",
                        n_components=12)
        ref = sct.apply("neighbors.knn", ref, backend="tpu", k=8)
        ref = sct.apply("graph.connectivities", ref, backend="tpu")
    return ref, _port_from(ref), truth


@pytest.fixture(scope="module", params=FIXTURES)
def pair(request):
    return _build(request.param)


def _graph(ref):
    n = ref.n_cells
    idx = np.array(ref.obsp["knn_indices"])[:n]
    w = np.array(ref.obsp["connectivities"])[:n]
    return idx, w


def _sym(ref):
    idx, w = _graph(ref)
    return ref_cluster._symmetrize_knn(idx, w.astype(np.float64))


# --------------------------------------------------- the device arrays


@pytest.mark.parametrize("weights", ["connectivities", "ones"])
@pytest.mark.parametrize("n_iter", [1, 3, 30])
def test_label_propagation_arrays(pair, weights, n_iter):
    ref, _, _ = pair
    idx, w = _graph(ref)
    if weights == "ones":
        w = np.ones_like(w)
    r = np.asarray(ref_cluster.label_propagation_arrays(
        jnp.asarray(idx), jnp.asarray(w), n_iter=n_iter))
    p = port_cluster.label_propagation_arrays(
        torch.from_numpy(idx), torch.from_numpy(w), n_iter=n_iter)
    assert p.dtype == torch.int32
    np.testing.assert_array_equal(_np(p), r)


def _coarse_graph(ref):
    """The aggregated graph of the reference's label propagation: the
    coarse branch's input (self-loops carrying internal weight, wider
    rows)."""
    idx, w = _graph(ref)
    lab = ref_cluster._compact_labels(np.asarray(
        ref_cluster.label_propagation_arrays(
            jnp.asarray(idx), jnp.asarray(w), n_iter=2)))
    return ref_cluster._coarse_ell(lab, idx, w)


@pytest.mark.parametrize("graph", ["symmetrized", "coarse"])
@pytest.mark.parametrize("resolution,n_rounds", [(1.0, 1), (1.0, 20),
                                                 (0.25, 20), (4.0, 20)])
def test_louvain_moves_arrays(pair, graph, resolution, n_rounds):
    ref, _, _ = pair
    idx2, w2 = _sym(ref) if graph == "symmetrized" else _coarse_graph(ref)
    n = idx2.shape[0]
    r = np.asarray(ref_cluster.louvain_moves_arrays(
        jnp.asarray(idx2), jnp.asarray(w2), jnp.arange(n, dtype=jnp.int32),
        resolution=resolution, n_rounds=n_rounds))
    p = port_cluster.louvain_moves_arrays(
        torch.from_numpy(idx2), torch.from_numpy(w2),
        torch.arange(n, dtype=torch.int32), resolution=resolution,
        n_rounds=n_rounds)
    assert p.dtype == torch.int32
    np.testing.assert_array_equal(_np(p), r)


@pytest.mark.parametrize("max_communities", [4096, 8])
def test_modularity_merge_both_branches(pair, max_communities):
    """The dense matching merge, and the coarse branch (moves on the
    aggregated graph, recursing) reached through a small cap."""
    ref, _, _ = pair
    idx, w = _graph(ref)
    lab = np.asarray(ref_cluster.label_propagation_arrays(
        jnp.asarray(idx), jnp.asarray(w), n_iter=2))
    if max_communities == 8:
        assert len(np.unique(lab)) > max_communities
    r = ref_cluster._modularity_merge(lab, idx, w,
                                      max_communities=max_communities)
    p = port_cluster._modularity_merge(lab, idx, w,
                                       max_communities=max_communities,
                                       device="cpu")
    np.testing.assert_array_equal(p, r)


def test_merge_beyond_the_dense_cap_on_a_ring_of_cliques():
    """tests/test_leiden.py's ring of 5,000 cliques: the first level
    leaves more than 4,096 communities, so the merge takes the coarse
    branch at its default cap."""
    idx, w = _ring_of_cliques(5000, 4)
    n = idx.shape[0]
    first_r = np.asarray(ref_cluster.louvain_moves_arrays(
        jnp.asarray(idx), jnp.asarray(w), jnp.arange(n, dtype=jnp.int32),
        n_rounds=8))
    first_p = _np(port_cluster.louvain_moves_arrays(
        torch.from_numpy(idx), torch.from_numpy(w),
        torch.arange(n, dtype=torch.int32), n_rounds=8))
    np.testing.assert_array_equal(first_p, first_r)
    assert len(np.unique(first_p)) > 4096
    merged_r = ref_cluster._modularity_merge(first_r, idx, w)
    merged_p = port_cluster._modularity_merge(first_p, idx, w, device="cpu")
    np.testing.assert_array_equal(merged_p, merged_r)
    assert len(np.unique(merged_p)) < len(np.unique(first_p))


@pytest.mark.parametrize("n_cliques,clique", [(3000, 4), (2000, 6),
                                               (5000, 5)])
def test_moves_where_two_m_differs_in_its_last_bit(n_cliques, clique):
    """2m is a float64 sum rounded once in the port and a float32 XLA
    sum in the reference.  On these rings of cliques (ring weight 0.1)
    the two differ by an ulp, which moves every gain by about an ulp:
    the labels must still be the reference's, and on the 5,000-clique
    ring so must the coarse merge's (5,000 communities, past 4,096)."""
    idx, w = _ring_of_cliques(n_cliques, clique)
    n = idx.shape[0]
    deg = np.where(idx < 0, 0.0, w).sum(axis=1, dtype=np.float32)
    m2_ref = np.float32(jnp.sum(jnp.asarray(deg)))
    assert m2_ref != np.float32(deg.astype(np.float64).sum())
    r = np.asarray(ref_cluster.louvain_moves_arrays(
        jnp.asarray(idx), jnp.asarray(w), jnp.arange(n, dtype=jnp.int32)))
    p = _np(port_cluster.louvain_moves_arrays(
        torch.from_numpy(idx), torch.from_numpy(w),
        torch.arange(n, dtype=torch.int32)))
    np.testing.assert_array_equal(p, r)
    if len(np.unique(r)) > 4096:
        np.testing.assert_array_equal(
            port_cluster._modularity_merge(p, idx, w, device="cpu"),
            ref_cluster._modularity_merge(r, idx, w))


@pytest.mark.parametrize("helper", ["symmetrize", "coarse_ell", "modularity",
                                    "ari", "compact"])
def test_host_helpers_are_the_reference_s(pair, helper):
    ref, _, truth = pair
    idx, w = _graph(ref)
    lab = np.asarray(ref_cluster.label_propagation_arrays(
        jnp.asarray(idx), jnp.asarray(w), n_iter=2))
    if helper == "symmetrize":
        for cap in (None, 8):
            for a, b in zip(port_cluster._symmetrize_knn(idx, w, cap),
                            ref_cluster._symmetrize_knn(idx, w, cap)):
                np.testing.assert_array_equal(a, b)
    elif helper == "coarse_ell":
        lab = ref_cluster._compact_labels(lab)
        for cap in (1024, 3):
            for a, b in zip(port_cluster._coarse_ell(lab, idx, w, cap),
                            ref_cluster._coarse_ell(lab, idx, w, cap)):
                np.testing.assert_array_equal(a, b)
    elif helper == "modularity":
        idx2, w2 = _sym(ref)
        for g in (0.5, 1.0):
            assert port_cluster.modularity(idx2, w2, lab, g) == \
                ref_cluster.modularity(idx2, w2, lab, g)
    elif helper == "ari":
        assert port_cluster.adjusted_rand_index(lab, truth) == \
            ref_cluster.adjusted_rand_index(lab, truth)
    else:
        np.testing.assert_array_equal(port_cluster._compact_labels(lab),
                                      ref_cluster._compact_labels(lab))


# ------------------------------------------------------- the ops


COMMUNITY_OPS = [("cluster.leiden", "leiden"), ("cluster.louvain", "louvain"),
                 ("cluster.leiden_like", "leiden_like"),
                 ("cluster.phenograph", "phenograph")]


@pytest.mark.parametrize("op,key", COMMUNITY_OPS)
def test_community_ops_label_for_label(pair, op, key):
    ref, port, _ = pair
    r = sct.apply(op, ref, backend="tpu")
    p = apply(op, port, device="cpu")
    n = ref.n_cells
    got, want = _np(p.obs[key]), np.asarray(r.obs[key])[:n]
    assert p.obs[key].dtype == torch.int32
    np.testing.assert_array_equal(got, want)
    assert port_cluster.adjusted_rand_index(got, want) == 1.0
    for k in r.uns:
        if k.startswith(key + "_"):
            assert p.uns[k].dtype == np.float32
            np.testing.assert_allclose(p.uns[k], np.asarray(r.uns[k]), **TOL)
    if op == "cluster.phenograph":
        np.testing.assert_array_equal(_np(p.obsp["jaccard"])[:n],
                                      np.asarray(r.obsp["jaccard"])[:n])
        assert "leiden_like" not in p.obs


@pytest.mark.parametrize("kw", [dict(resolution=0.5), dict(resolution=2.0),
                                dict(n_levels=1), dict(n_rounds=3),
                                dict(weight_key="absent",
                                     key_added="unweighted")])
def test_leiden_parameters(pair, kw):
    ref, port, _ = pair
    r = sct.apply("cluster.leiden", ref, backend="tpu", **kw)
    p = apply("cluster.leiden", port, device="cpu", **kw)
    key = kw.get("key_added", "leiden")
    np.testing.assert_array_equal(_np(p.obs[key]),
                                  np.asarray(r.obs[key])[: ref.n_cells])
    for suffix in ("_modularity", "_resolution"):
        np.testing.assert_allclose(p.uns[key + suffix],
                                   np.asarray(r.uns[key + suffix]), **TOL)


@pytest.mark.parametrize("op,kw,key", [
    ("cluster.leiden_like", dict(n_iter=2), "leiden_like"),
    ("cluster.leiden_like", dict(weight_key="absent"), "leiden_like"),
    ("cluster.phenograph", dict(n_iter=3, jaccard_block=64), "phenograph")])
def test_propagation_ops_parameters(pair, op, kw, key):
    ref, port, _ = pair
    r = sct.apply(op, ref, backend="tpu", **kw)
    p = apply(op, port, device="cpu", **kw)
    np.testing.assert_array_equal(_np(p.obs[key]),
                                  np.asarray(r.obs[key])[: ref.n_cells])


def test_phenograph_keeps_the_caller_s_columns(pair):
    """A present obsp["jaccard"] is used as is; the caller's own
    obs["leiden_like"] survives."""
    ref, port, _ = pair
    mine = torch.full((port.n_cells,), 7, dtype=torch.int32)
    p = apply("cluster.phenograph", port.with_obs(leiden_like=mine),
              device="cpu")
    assert torch.equal(p.obs["leiden_like"], mine)
    again = apply("cluster.phenograph", p, device="cpu")
    assert torch.equal(again.obs["phenograph"], p.obs["phenograph"])


# ------------------------------------------------------------ k-means


@partial(jax.jit, static_argnames=("n_clusters",))
def _ref_init_draw(points, key, n_clusters):
    """The reference's k-means++-lite draw
    (``sctools_tpu/ops/cluster.py:51-56``), repeated call for call."""
    n = points.shape[0]
    pts = jnp.asarray(points, jnp.float32)
    i0 = jax.random.choice(key, n, (1,))
    c0 = pts[i0]
    d2 = jnp.sum((pts - c0) ** 2, axis=1)
    probs = d2 / jnp.maximum(d2.sum(), 1e-12)
    rest = jax.random.choice(key, n, (n_clusters - 1,), replace=False,
                             p=probs)
    return jnp.concatenate([c0, pts[rest]], axis=0)


def _ref_init(points, seed, n_clusters):
    return np.array(_ref_init_draw(
        jnp.asarray(points), jax.random.PRNGKey(seed), n_clusters))


@pytest.mark.parametrize("n_clusters,n_iter", [(5, 1), (5, 3), (5, 25),
                                               (8, 25)])
def test_kmeans_lloyd_from_the_reference_start(pair, n_clusters, n_iter):
    ref, _, _ = pair
    pts = np.array(ref.obsm["X_pca"], np.float32)[: ref.n_cells]
    lab_r, cen_r, inert_r = ref_cluster.kmeans_arrays(
        jnp.asarray(pts), jax.random.PRNGKey(0), n_clusters=n_clusters,
        n_iter=n_iter)
    c0 = _ref_init(pts, 0, n_clusters)
    lab_p, cen_p, inert_p = port_cluster.kmeans_lloyd(
        torch.from_numpy(pts), torch.from_numpy(c0), n_iter=n_iter)
    assert lab_p.dtype == torch.int32
    np.testing.assert_array_equal(_np(lab_p), np.asarray(lab_r))
    np.testing.assert_allclose(_np(cen_p), np.asarray(cen_r), **TOL)
    np.testing.assert_allclose(float(inert_p), float(inert_r), **TOL)


def test_kmeans_op_with_the_reference_start(pair, monkeypatch):
    """The whole op, its start replaced by the reference's own draw."""
    ref, port, _ = pair
    r = sct.apply("cluster.kmeans", ref, backend="tpu", n_clusters=6,
                  seed=3)
    seen = []

    def ref_start(points, n_clusters, seed=0):
        seen.append((n_clusters, seed))
        return torch.from_numpy(_ref_init(_np(points), seed, n_clusters))

    monkeypatch.setattr(port_cluster, "kmeans_init", ref_start)
    p = apply("cluster.kmeans", port, device="cpu", n_clusters=6, seed=3)
    assert seen == [(6, 3)]
    np.testing.assert_array_equal(_np(p.obs["kmeans"]),
                                  np.asarray(r.obs["kmeans"]))
    np.testing.assert_allclose(_np(p.uns["kmeans_centroids"]),
                               np.asarray(r.uns["kmeans_centroids"]), **TOL)
    np.testing.assert_allclose(float(p.uns["kmeans_inertia"]),
                               float(r.uns["kmeans_inertia"]), **TOL)


def test_kmeans_seeded_start_is_reproducible_and_recovers_blobs():
    pts, truth = gaussian_blobs(900, 8, 5, spread=0.2, seed=4)
    d = sctt.CellData(torch.zeros((900, 2)),
                      obsm={"X_pca": torch.from_numpy(pts)})
    a = apply("cluster.kmeans", d, device="cpu", n_clusters=5, seed=11)
    b = apply("cluster.kmeans", d, device="cpu", n_clusters=5, seed=11)
    assert torch.equal(a.obs["kmeans"], b.obs["kmeans"])
    assert torch.equal(a.uns["kmeans_centroids"], b.uns["kmeans_centroids"])
    assert port_cluster.adjusted_rand_index(_np(a.obs["kmeans"]),
                                            truth) > 0.95
    c0 = port_cluster.kmeans_init(torch.from_numpy(pts), 5, seed=11)
    rows = [np.flatnonzero((pts == _np(c)).all(axis=1)) for c in c0]
    assert all(len(r) for r in rows)  # the start is 5 of the points
    assert len({int(r[0]) for r in rows}) == 5


# ------------------------------------------------- dendrogram and PAGA


def _with_labels(ref, port, key, labels):
    return (ref.with_obs(**{key: labels}),
            port.with_obs(**{key: torch.from_numpy(labels)}))


@pytest.mark.parametrize("method", ["complete", "average"])
def test_dendrogram_is_the_reference_s(pair, method):
    ref, port, _ = pair
    r0 = sct.apply("cluster.leiden", ref, backend="tpu")
    labels = np.asarray(r0.obs["leiden"])[: ref.n_cells]
    ref, port = _with_labels(ref, port, "leiden", labels)
    r = sct.apply("cluster.dendrogram", ref, backend="tpu", method=method)
    p = apply("cluster.dendrogram", port, device="cpu", method=method)
    dr, dp = r.uns["dendrogram_leiden"], p.uns["dendrogram_leiden"]
    assert sorted(dr) == sorted(dp)
    for k in dr:
        if isinstance(dr[k], np.ndarray):
            assert dp[k].dtype == dr[k].dtype
            np.testing.assert_array_equal(dp[k], dr[k])
        else:
            assert dp[k] == dr[k]


@pytest.mark.parametrize("weights", ["connectivities", "unit", "stale"])
def test_paga_is_the_reference_s(pair, weights):
    ref, port, _ = pair
    r0 = sct.apply("cluster.leiden", ref, backend="tpu")
    labels = np.asarray(r0.obs["leiden"])[: ref.n_cells]
    ref, port = _with_labels(ref, port, "grp", labels)
    if weights == "unit":
        ref = ref.replace(obsp={k: v for k, v in ref.obsp.items()
                                if k != "connectivities"})
        port = port.replace(obsp={k: v for k, v in port.obsp.items()
                                  if k != "connectivities"})
    elif weights == "stale":
        c = np.asarray(ref.obsp["connectivities"])[:, :3]
        ref = ref.with_obsp(connectivities=c)
        port = port.with_obsp(connectivities=torch.from_numpy(c.copy()))
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        r = sct.apply("graph.paga", ref, backend="tpu", groups="grp")
        p = apply("graph.paga", port, device="cpu", groups="grp")
    stale = [w for w in seen if "does not match" in str(w.message)]
    assert len(stale) == (2 if weights == "stale" else 0)
    for k in ("paga_connectivities", "paga_edge_weights", "paga_groups"):
        assert p.uns[k].dtype == np.asarray(r.uns[k]).dtype
        np.testing.assert_array_equal(p.uns[k], np.asarray(r.uns[k]))
    assert p.uns["paga_groups_key"] == "grp"


# ------------------------------------------------------------- errors


@pytest.mark.parametrize("op", ["cluster.leiden", "cluster.louvain",
                                "cluster.leiden_like", "cluster.phenograph",
                                "graph.paga"])
def test_ops_need_a_knn_graph(op):
    d = sctt.CellData(torch.zeros((10, 4)),
                      obs={"leiden": torch.zeros(10, dtype=torch.int32)})
    with pytest.raises(ValueError, match="neighbors.knn"):
        apply(op, d, device="cpu")
    with pytest.raises(ValueError, match="neighbors.knn"):
        sct.apply(op, sct.CellData(np.zeros((10, 4), np.float32),
                                   obs={"leiden": np.zeros(10, np.int32)}),
                  backend="tpu")


def test_paga_needs_the_group_column(pair):
    _, port, _ = pair
    with pytest.raises(KeyError, match="cluster.leiden"):
        apply("graph.paga", port, device="cpu", groups="missing")


def test_dendrogram_needs_two_groups(pair):
    ref, port, _ = pair
    ref, port = _with_labels(ref, port, "one",
                             np.zeros(ref.n_cells, np.int32))
    with pytest.raises(ValueError, match="at least 2"):
        apply("cluster.dendrogram", port, device="cpu", groupby="one")
    with pytest.raises(ValueError, match="at least 2"):
        sct.apply("cluster.dendrogram", ref, backend="tpu", groupby="one")
