"""The port's single-process mesh (``sctools_tpu_torch/parallel``) on 8
CPU shards against the reference's ``sctools_tpu.parallel`` on the 8
virtual host devices that ``tests/conftest.py`` sets up.

Tolerances: kNN ids identical but for near-ties and scores within 1e-5
(``tests/test_torch_knn.py``'s rule); distances against the float64
oracle within the reference's own rtol 1e-3, atol 5e-3
(``tests/test_multichip.py``); the sharded graph products within atol
1e-5 and MAGIC within 1e-4, the reference's bars, since each strategy
adds the edges' products in another order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sctools_tpu as sct
from sctools_tpu.data.synthetic import synthetic_counts as ref_counts
from sctools_tpu.parallel import graph_multichip as ref_gm
from sctools_tpu.parallel import knn_multichip_arrays as ref_multichip
from sctools_tpu.parallel import make_mesh as ref_make_mesh
from sctools_tpu_torch.carry import cells_from_numpy, graph_from_numpy
from sctools_tpu_torch.data.dataset import CellData
from sctools_tpu_torch.data.synthetic import gaussian_blobs
from sctools_tpu_torch.ops import knn as port_knn
from sctools_tpu_torch.ops.graph_kernels import matvec_plain
from sctools_tpu_torch.parallel import (active_mesh, graph_multichip,
                                        knn_multichip_arrays, make_mesh,
                                        mesh_signature)
from sctools_tpu_torch.parallel.mesh import Mesh, ring
from sctools_tpu_torch.registry import apply
from test_torch_knn import assert_same_neighbours

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def meshes():
    assert jax.device_count() >= 8
    return ref_make_mesh(8), make_mesh(devices=["cpu"] * 8)


def _both(meshes, pts, **kw):
    r = ref_multichip(jnp.asarray(pts), mesh=meshes[0], **kw)
    p = knn_multichip_arrays(torch.from_numpy(pts), mesh=meshes[1], **kw)
    return [np.asarray(a) for a in r], [a.numpy() for a in p]


# ------------------------------------------------------------ the kNN


@pytest.mark.parametrize("metric", ["cosine", "euclidean"])
@pytest.mark.parametrize("strategy", ["ring", "all_gather"])
def test_multichip_knn_matches_reference(meshes, metric, strategy):
    pts, _ = gaussian_blobs(500, 16, n_clusters=5, seed=6)
    if metric == "euclidean":
        pts = pts / np.float32(4.0)  # norms near 1, as test_torch_knn
    (r_idx, r_dist), (p_idx, p_dist) = _both(
        meshes, pts, k=10, metric=metric, n_valid=500, block=32,
        strategy=strategy)
    assert p_idx.shape == r_idx.shape == (512, 10)
    assert (p_idx[500:] == -1).all()
    assert_same_neighbours(p_idx[:500], p_dist[:500], r_idx[:500],
                           r_dist[:500], metric, 1e-5)
    oracle_idx, oracle_dist = port_knn.knn_numpy(pts, pts, k=10,
                                                 metric=metric)
    assert port_knn.recall_at_k(p_idx[:500], oracle_idx) >= 0.999
    np.testing.assert_allclose(np.sort(p_dist[:500], axis=1),
                               np.sort(oracle_dist, axis=1), rtol=1e-3,
                               atol=5e-3)
    # and the port's single-device search
    one_i, one_d = port_knn.knn_arrays(torch.from_numpy(pts),
                                       torch.from_numpy(pts), k=10,
                                       metric=metric)
    assert_same_neighbours(p_idx[:500], p_dist[:500], one_i.numpy()[:500],
                           one_d.numpy()[:500], metric, 1e-5)


@pytest.mark.parametrize("strategy", ["ring", "all_gather"])
def test_multichip_knn_exclude_self(meshes, strategy):
    pts, _ = gaussian_blobs(200, 8, n_clusters=3, seed=7)
    pts = pts / np.float32(3.0)
    (r_idx, r_dist), (p_idx, p_dist) = _both(
        meshes, pts, k=5, metric="euclidean", n_valid=200, block=16,
        exclude_self=True, strategy=strategy)
    assert not (p_idx[:200] == np.arange(200)[:, None]).any()
    assert_same_neighbours(p_idx[:200], p_dist[:200], r_idx[:200],
                           r_dist[:200], "euclidean", 1e-5)
    one_i, one_d = port_knn.knn_arrays(
        torch.from_numpy(pts), torch.from_numpy(pts), k=5,
        metric="euclidean", exclude_self=True)
    assert_same_neighbours(p_idx[:200], p_dist[:200], one_i.numpy()[:200],
                           one_d.numpy()[:200], "euclidean", 1e-5)


def test_all_gather_self_drop_on_exact_ties():
    """Duplicated points: a row's own id ties with its twin's.  The
    k + 1 search and the drop must keep the twin, as the single-device
    exclusion does."""
    base, _ = gaussian_blobs(40, 4, n_clusters=2, seed=8)
    pts = np.concatenate([base, base])
    mesh = make_mesh(devices=["cpu"] * 4)
    one_i, _ = port_knn.knn_arrays(torch.from_numpy(pts),
                                   torch.from_numpy(pts), k=3,
                                   exclude_self=True)
    for strategy in ("ring", "all_gather"):
        p_idx, _ = knn_multichip_arrays(torch.from_numpy(pts), k=3,
                                        mesh=mesh, block=8,
                                        exclude_self=True,
                                        strategy=strategy)
        np.testing.assert_array_equal(p_idx.numpy()[:80],
                                      one_i.numpy()[:80])
        twin = (np.arange(80) + 40) % 80
        assert (p_idx.numpy()[:80, 0] == twin).all()


@pytest.mark.parametrize("strategy", ["ring", "all_gather"])
def test_multichip_uneven_padding(meshes, strategy):
    """n = 333 over 8 shards of 16-row blocks: padded rows never
    appear, and the shards past the data are skipped."""
    pts, _ = gaussian_blobs(333, 12, n_clusters=4, seed=8)
    (r_idx, r_dist), (p_idx, p_dist) = _both(
        meshes, pts, k=7, metric="cosine", n_valid=333, block=16,
        strategy=strategy)
    assert p_idx.shape == (384, 7)
    assert p_idx[:333].max() < 333 and (p_idx[333:] == -1).all()
    assert_same_neighbours(p_idx[:333], p_dist[:333], r_idx[:333],
                           r_dist[:333], "cosine", 1e-5)
    oracle, _ = port_knn.knn_numpy(pts, pts, k=7, metric="cosine")
    assert port_knn.recall_at_k(p_idx[:333], oracle) >= 0.999


def test_multichip_launch_count_and_order(monkeypatch):
    """P² searches of one shard against one chunk in the ring, P of one
    shard against all rows under all_gather."""
    from sctools_tpu_torch.parallel import knn_multichip as KM

    pts, _ = gaussian_blobs(96, 6, n_clusters=3, seed=9)
    mesh = make_mesh(devices=["cpu"] * 3)
    seen = []
    real = KM.knn_select
    monkeypatch.setattr(KM, "knn_select", lambda q, c, **kw:
                        seen.append((q.shape[0], c.shape[0]))
                        or real(q, c, **kw))
    knn_multichip_arrays(torch.from_numpy(pts), k=4, mesh=mesh, block=8)
    assert seen == [(32, 32)] * 9
    seen.clear()
    knn_multichip_arrays(torch.from_numpy(pts), k=4, mesh=mesh, block=8,
                         strategy="all_gather")
    assert seen == [(32, 96)] * 3


def test_multichip_op_matches_reference_op(meshes):
    ds = ref_counts(300, 200, n_clusters=3, seed=9)
    dev = sct.apply("pca.exact", ds.device_put(), backend="tpu",
                    n_components=10)
    ref = sct.apply("neighbors.knn_multichip", dev, backend="tpu", k=8,
                    metric="cosine", block=16, mesh=meshes[0]).to_host()
    pca = np.array(dev.obsm["X_pca"])
    port = CellData(torch.zeros((300, 2)), obsm={
        "X_pca": torch.from_numpy(pca)})
    out = apply("neighbors.knn_multichip", port, device="cpu", k=8,
                block=16, mesh=meshes[1])
    got = out.obsp["knn_indices"].numpy()
    assert got.shape == (384, 8) and out.uns["knn_k"] == 8  # 8 × 16 rows
    assert out.uns["knn_metric"] == "cosine"
    r_idx = np.asarray(ref.obsp["knn_indices"])[:300]
    r_dist = np.asarray(ref.obsp["knn_distances"])[:300]
    assert_same_neighbours(got[:300], out.obsp["knn_distances"].numpy()
                           [:300], r_idx, r_dist, "cosine", 1e-5)


def test_multichip_rejects_bad_arguments():
    mesh = make_mesh(devices=["cpu"] * 2)
    x = torch.zeros((8, 3))
    with pytest.raises(ValueError, match="strategy"):
        knn_multichip_arrays(x, k=2, mesh=mesh, strategy="tree")
    with pytest.raises(ValueError, match="metric"):
        knn_multichip_arrays(x, k=2, mesh=mesh, metric="manhattan")


# ------------------------------------------------- the graph products


def _edges(n=64 * 8, k=7, d=12, seed=0):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, n, (n, k)).astype(np.int32)
    idx[rng.random((n, k)) < 0.1] = -1
    w = rng.random((n, k)).astype(np.float32)
    x = rng.normal(0, 1, (n, d)).astype(np.float32)
    return idx, w, x


@pytest.mark.parametrize("strategy", ["all_gather", "ring"])
def test_knn_matvec_sharded_matches_reference(meshes, strategy):
    idx, w, x = _edges()
    want = np.asarray(ref_gm.knn_matvec_sharded(
        jnp.asarray(idx), jnp.asarray(w), jnp.asarray(x), meshes[0],
        strategy=strategy))
    got = graph_multichip.knn_matvec_sharded(
        torch.from_numpy(idx), torch.from_numpy(w), torch.from_numpy(x),
        meshes[1], strategy=strategy)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    single = matvec_plain(*map(torch.from_numpy, (idx, w, x)))
    np.testing.assert_allclose(got.numpy(), single.numpy(), atol=1e-5)
    with pytest.raises(ValueError, match="divide"):
        graph_multichip.knn_matvec_sharded(
            torch.from_numpy(idx[:100]), torch.from_numpy(w[:100]),
            torch.from_numpy(x[:100]), meshes[1], strategy=strategy)


@pytest.mark.parametrize("strategy", ["all_gather", "ring"])
def test_smooth_layers_sharded_matches_reference(meshes, strategy):
    idx, w, x = _edges(seed=1)
    want = np.asarray(ref_gm.smooth_layers_sharded(
        jnp.asarray(idx), jnp.asarray(w), [jnp.asarray(x)], meshes[0],
        strategy=strategy)[0])
    got = graph_multichip.smooth_layers_sharded(
        torch.from_numpy(idx), torch.from_numpy(w), [torch.from_numpy(x)],
        meshes[1], strategy=strategy)[0]
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


@pytest.mark.parametrize("strategy", ["all_gather", "ring"])
def test_diffuse_sharded_matches_reference(meshes, strategy):
    idx, w, x = _edges(seed=2)
    w = w / w.sum(axis=1, keepdims=True)  # a diffusion operator
    want = np.asarray(ref_gm.diffuse_sharded(
        jnp.asarray(idx), jnp.asarray(w), jnp.asarray(x), meshes[0], 3,
        strategy=strategy))
    got = graph_multichip.diffuse_sharded(
        torch.from_numpy(idx), torch.from_numpy(w), torch.from_numpy(x),
        meshes[1], 3, strategy=strategy)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_pad_rows_for_mesh_and_axis_guard(meshes):
    idx, w, x = _edges(n=250, seed=3)
    ti, tw, tx, n = graph_multichip.pad_rows_for_mesh(
        meshes[1], idx=torch.from_numpy(idx), weights=torch.from_numpy(w),
        x=torch.from_numpy(x))
    assert n == 250 and ti.shape[0] == tw.shape[0] == tx.shape[0] == 256
    assert (ti[250:] == -1).all() and (tw[250:] == 0).all()
    assert (tx[250:] == 0).all()
    other = make_mesh(devices=["cpu"] * 2, axis_name="genes")
    with pytest.raises(ValueError, match="'cells' axis"):
        graph_multichip.require_cell_axis(other, "diffuse_sharded")


# ------------------------------------------------ impute.magic(mesh=)


@pytest.fixture(scope="module")
def magic_both():
    d = ref_counts(210, 60, density=0.2, n_clusters=3, seed=5).device_put()
    d = sct.apply("normalize.library_size", d, backend="tpu")
    d = sct.apply("normalize.log1p", d, backend="tpu")
    d = sct.apply("pca.randomized", d, backend="tpu", n_components=8)
    d = sct.apply("neighbors.knn", d, backend="tpu", k=8)
    p = cells_from_numpy(np.asarray(d.X.indices), np.asarray(d.X.data),
                         d.n_cells, d.n_genes)
    p = graph_from_numpy(p, d.obsp["knn_indices"], d.obsp["knn_distances"],
                         knn_k=8, knn_metric="cosine")
    return d, p


@pytest.mark.parametrize("strategy", ["all_gather", "ring"])
def test_magic_over_mesh_matches_reference(meshes, magic_both, strategy):
    d, p = magic_both
    ref = sct.apply("impute.magic", d, backend="tpu", t=3, mesh=meshes[0],
                    strategy=strategy)
    one = apply("impute.magic", p, device="cpu", t=3)
    got = apply("impute.magic", p, device="cpu", t=3, mesh=meshes[1],
                strategy=strategy)
    out = got.obsm["X_magic"].numpy()
    assert out.shape == (210, 60) and got.uns["magic_t"] == 3
    np.testing.assert_allclose(out, np.asarray(ref.obsm["X_magic"]),
                               atol=1e-4)
    np.testing.assert_allclose(out, one.obsm["X_magic"].numpy(), atol=1e-4)


# ------------------------------------------------------- the mesh itself


@pytest.mark.parametrize("p", [1, 3, 8])
def test_ring_chunk_provenance(p):
    """At step t shard i holds the chunk that started on (i − t) mod P;
    every shard sees every chunk once, and the chunks given are never
    written."""
    mesh = make_mesh(devices=["cpu"] * p)
    chunks = [torch.full((2, 3), float(i)) for i in range(p)]
    seen = []

    def step(t, i, src, chunk):
        assert src == (i - t) % p
        assert (chunk == src).all()
        seen.append((i, src))

    ring(mesh, chunks, step)
    assert sorted(seen) == [(i, s) for i in range(p) for s in range(p)]
    assert all((c == i).all() for i, c in enumerate(chunks))


def test_make_mesh_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh(devices=["cuda:0"] * 4)


def test_mesh_surface():
    mesh = make_mesh(devices=["cpu"] * 4)
    assert mesh.size == 4 and mesh.shape == {"cells": 4}
    assert mesh_signature(mesh) == mesh_signature(
        make_mesh(devices=["cpu"] * 4))
    assert mesh_signature(mesh) != mesh_signature(
        make_mesh(devices=["cpu"] * 2))
    assert active_mesh() is None
    with mesh:
        assert active_mesh() is mesh
    assert active_mesh() is None
    with pytest.raises(ValueError, match="not both"):
        make_mesh(2, devices=["cpu"])
    with pytest.raises(ValueError, match="one kind"):
        Mesh(("cpu", "meta"))
