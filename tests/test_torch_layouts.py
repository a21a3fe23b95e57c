"""The port's graph layouts (``sctools_tpu_torch/ops/umap.py``:
``embed.umap``, ``embed.force_directed``, ``embed.draw_graph``) against
the JAX package's (``backend="tpu"``, on the CPU).

Both packages start from one graph: the reference's kNN arrays on the
400-point blobs of ``tests/test_umap.py``, carried with
``carry.graph_from_numpy``.  The negative samples are the reference's
``jax.random`` draws, rebuilt per epoch from the same key split and put
in place of ``negative_samples`` (eager ``split`` + ``randint`` give
the same bits as the reference's draws inside its scan).

Tolerances:

* ``fit_ab``: equal (the same constants, the same scipy fit);
* the spectral start: within 1e-4 of its scale 10 after each column's
  sign is matched (``eigh`` picks either sign of an eigenvector) on a
  connected graph (one blob), started from the reference's block
  (``carry.spectral_v0_from_numpy``); the noise is numpy's, bit for bit;
* a layout from the same start and the same negatives: within 1e-3 of
  the reference after 5 epochs (layouts of scale 5 to 18).  ``pow`` and
  ``exp`` differ by an ulp between the two libraries, and each epoch
  multiplies such a difference (5.5e-5 after 5 epochs, 6.6e-4 after 10,
  order 1 after 50 on this fixture);
* a full run from the port's own start and draws: the reference tests'
  separation ratios, > 3 (UMAP, 150 epochs) and > 2 (ForceAtlas2, 200);
* two runs, and ``draw_graph`` against ``force_directed``: equal bits."""

import jax
import numpy as np
import pytest
import torch

import sctools_tpu as sct
from sctools_tpu.data.synthetic import gaussian_blobs
from sctools_tpu.ops import umap as ref_umap
import sctools_tpu_torch as sctt
from sctools_tpu_torch.carry import graph_from_numpy, spectral_v0_from_numpy
from sctools_tpu_torch.ops import umap as port_umap
from sctools_tpu_torch.registry import apply

torch.set_num_threads(2)

N = 400


def _np(v):
    return v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _sep_ratio(y, labels):
    """between-cluster / within-cluster mean centroid distance (as
    ``tests/test_umap.py`` measures it)."""
    y = np.asarray(y, np.float64)
    cents = np.stack([y[labels == c].mean(0) for c in np.unique(labels)])
    within = np.mean([np.linalg.norm(y[labels == c] - cents[i],
                                     axis=1).mean()
                      for i, c in enumerate(np.unique(labels))])
    d = np.linalg.norm(cents[:, None] - cents[None, :], axis=2)
    between = d[np.triu_indices(len(cents), 1)].mean()
    return between / max(within, 1e-12)


def _pair(n_clusters, spread):
    pts, labels = gaussian_blobs(N, 10, n_clusters=n_clusters,
                                 spread=spread, seed=11)
    ds = sct.CellData(pts, obsm={"X_pca": pts},
                      obs={"cluster_true": labels})
    ds = sct.apply("neighbors.knn", ds, backend="tpu", k=15,
                   metric="euclidean")
    tp = torch.from_numpy(np.asarray(pts))
    p = graph_from_numpy(sctt.CellData(tp, obsm={"X_pca": tp}),
                         ds.obsp["knn_indices"], ds.obsp["knn_distances"],
                         knn_k=15, knn_metric="euclidean")
    return ds, p, labels


@pytest.fixture(scope="module")
def blobs():
    return _pair(4, 0.15)


@pytest.fixture(scope="module")
def one_blob():
    return _pair(1, 2.0)


def _ref_negatives(seed, n_epochs, n, n_neg):
    """The reference's per-epoch draws (``umap.py:89``, ``:262``)."""
    for key in jax.random.split(jax.random.PRNGKey(seed), n_epochs):
        yield torch.from_numpy(np.array(
            jax.random.randint(key, (n, n_neg), 0, n)))


@pytest.fixture
def ref_draws(monkeypatch):
    monkeypatch.setattr(port_umap, "negative_samples", _ref_negatives)


@pytest.mark.parametrize("min_dist,spread", [(0.1, 1.0), (0.5, 1.0),
                                             (0.05, 2.0)])
def test_fit_ab(min_dist, spread):
    assert port_umap.fit_ab(min_dist, spread) == ref_umap.fit_ab(
        min_dist, spread)


@pytest.mark.parametrize("scale", [10.0, 1.0])
def test_spectral_start_matches_reference(one_blob, scale):
    ds, p, _ = one_blob
    ref = ref_umap._spectral_init(
        sct.apply("graph.connectivities", ds, backend="tpu"), 2, 0, "tpu",
        scale=scale)
    v0 = jax.random.normal(jax.random.PRNGKey(0), (N, 2 + 1 + 5))
    got = _np(port_umap._spectral_init(
        p, 2, 0, torch.device("cpu"), scale=scale,
        v0=spectral_v0_from_numpy(np.asarray(v0))))
    assert got.dtype == np.float32 and got.shape == (N, 2)
    noise = np.random.default_rng(0).normal(scale=1e-3, size=(N, 2))
    for j in range(2):
        # eigh's sign is arbitrary: flip the noise-free part
        sign = np.sign(np.dot(got[:, j] - noise[:, j],
                              ref[:, j] - noise[:, j]))
        np.testing.assert_allclose(
            sign * (got[:, j] - noise[:, j]) + noise[:, j], ref[:, j],
            rtol=0, atol=1e-4 * scale)


def _ref_start(ds, scale):
    return ref_umap._spectral_init(
        sct.apply("graph.connectivities", ds, backend="tpu"), 2, 0, "tpu",
        scale=scale)


@pytest.mark.parametrize("op,key,scale", [
    ("embed.umap", "X_umap", 10.0),
    ("embed.force_directed", "X_draw_graph", 1.0),
    ("embed.draw_graph", "X_draw_graph", 1.0)])
def test_short_run_matches_reference(blobs, ref_draws, op, key, scale):
    ds, p, _ = blobs
    init = _ref_start(ds, scale)
    for epochs in (1, 5):
        r = sct.apply(op, ds, backend="tpu", n_epochs=epochs, seed=2,
                      init=init)
        o = apply(op, p, device="cpu", n_epochs=epochs, seed=2, init=init)
        want = np.asarray(r.obsm[key])[:N]
        got = _np(o.obsm[key])
        assert got.dtype == np.float32 and got.shape == (N, 2)
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-5 if epochs == 1 else 1e-3)
    if op == "embed.umap":
        assert o.uns["umap_min_dist"] == r.uns["umap_min_dist"]


def test_umap_separates_blobs(blobs):
    _, p, labels = blobs
    y = _np(apply("embed.umap", p, device="cpu", n_epochs=150,
                  seed=0).obsm["X_umap"])
    assert y.shape == (N, 2) and np.isfinite(y).all()
    assert _sep_ratio(y, labels) > 3.0


@pytest.mark.parametrize("op", ["embed.force_directed", "embed.draw_graph"])
def test_force_directed_separates_blobs(blobs, op):
    _, p, labels = blobs
    y = _np(apply(op, p, device="cpu", n_epochs=200,
                  seed=0).obsm["X_draw_graph"])
    assert y.shape == (N, 2) and np.isfinite(y).all()
    assert _sep_ratio(y, labels) > 2.0


@pytest.mark.parametrize("op,key", [("embed.umap", "X_umap"),
                                    ("embed.force_directed",
                                     "X_draw_graph")])
def test_layouts_repeat_bit_for_bit(blobs, op, key):
    _, p, _ = blobs
    a = apply(op, p, device="cpu", n_epochs=30, seed=3)
    b = apply(op, p, device="cpu", n_epochs=30, seed=3)
    assert torch.equal(a.obsm[key], b.obsm[key])
    c = apply(op, p, device="cpu", n_epochs=30, seed=4)
    assert not torch.equal(a.obsm[key], c.obsm[key])


def test_draw_graph_is_force_directed(blobs):
    _, p, _ = blobs
    a = apply("embed.force_directed", p, device="cpu", n_epochs=40, seed=1)
    b = apply("embed.draw_graph", p, device="cpu", n_epochs=40, seed=1)
    assert torch.equal(a.obsm["X_draw_graph"], b.obsm["X_draw_graph"])


def test_umap_3d_and_custom_init(blobs):
    _, p, _ = blobs
    init = np.random.default_rng(0).normal(size=(N, 3)).astype(np.float32)
    out = apply("embed.umap", p, device="cpu", n_dims=3, n_epochs=20,
                init=init)
    assert tuple(out.obsm["X_umap"].shape) == (N, 3)
    with pytest.raises(ValueError, match="init must have shape"):
        apply("embed.umap", p, device="cpu", n_dims=2, init=init)
    with pytest.raises(ValueError, match="init must have shape"):
        apply("embed.force_directed", p, device="cpu", n_dims=2, init=init)


def test_negative_samples_are_seeded_int32():
    a = list(port_umap.negative_samples(5, 3, 50, 7))
    b = list(port_umap.negative_samples(5, 3, 50, 7))
    assert len(a) == 3
    for x, y in zip(a, b):
        assert x.dtype == torch.int32 and tuple(x.shape) == (50, 7)
        assert x.device.type == "cpu"
        assert int(x.min()) >= 0 and int(x.max()) < 50
        assert torch.equal(x, y)
    assert not torch.equal(a[0], a[1])


def test_reaction_adds_in_edge_order():
    """The reaction term equals an index-ordered scatter (numpy's
    ``add.at``) bit for bit, -1 slots and self edges included."""
    rng = np.random.default_rng(0)
    idx = rng.integers(-1, 30, (30, 6)).astype(np.int32)
    w = rng.random((30, 6)).astype(np.float32)
    att = rng.normal(size=(30, 6, 2)).astype(np.float32)
    e = port_umap._Edges(torch.from_numpy(idx), torch.from_numpy(w))
    got = _np(e.reaction(torch.from_numpy(att)))
    want = np.zeros((30, 2), np.float32)
    np.add.at(want, np.where(idx < 0, 0, idx).reshape(-1),
              -att.reshape(-1, 2))
    np.testing.assert_array_equal(got, want)
