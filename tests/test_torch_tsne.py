"""The port's ``embed.tsne`` (``sctools_tpu_torch/ops/tsne.py``) against
the JAX package's.

* ``_prep_p``: bitwise — the same numpy and scipy code on the same
  graph;
* ``tsne_layout_arrays`` against the reference's with
  ``graph_impl="xla"`` (its blocked two-matmul repulsion), 1 and 5
  iterations: atol 1e-5 × max|y|, relative to the layout's extent —
  the layout grows from 1e-4 to ~10 within 5 steps, where one float32
  ulp is ~1e-6; the sums over all pairs and over the edges run in
  another order, and the reference's sweep keeps the self pair and
  subtracts 1 from Z where the port masks it.  Few steps on purpose:
  the optimisation is chaotic, and ulp differences grow into
  different, equally valid layouts;
* ``embed.tsne`` end to end on the 600-point blobs of
  tests/test_tsne.py: label purity of the layout's 15-NN > 0.95."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sctools_tpu.data.synthetic import gaussian_blobs as ref_blobs
from sctools_tpu.ops import tsne as ref_tsne
from sctools_tpu.ops.knn import knn_numpy as ref_knn_numpy
from sctools_tpu_torch.data.dataset import CellData
from sctools_tpu_torch.ops import tsne as port_tsne
from sctools_tpu_torch.ops.knn import knn_numpy
from sctools_tpu_torch.registry import apply

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def blobs():
    n = 600
    pts, truth = ref_blobs(n, 10, 5, spread=0.2, seed=3)
    idx, dist = ref_knn_numpy(pts, pts, k=15, metric="euclidean",
                              exclude_self=True)
    return idx, dist, truth


def _layout_inputs(n=192, k=8, seed=0):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, n, (n, k)).astype(np.int32)
    idx[rng.random((n, k)) < 0.05] = -1
    P = rng.random((n, k)).astype(np.float32)
    P = P / P.sum()
    init = (rng.standard_normal((n, 2)) * 1e-4).astype(np.float32)
    return idx, P, init


@pytest.mark.parametrize("n_iter", [1, 5])
def test_layout_matches_reference_xla_sweep(n_iter):
    idx, P, init = _layout_inputs()
    kw = dict(n_iter=n_iter, exaggeration_iter=3)
    ref = np.asarray(ref_tsne.tsne_layout_arrays(
        jnp.asarray(idx), jnp.asarray(P), jnp.asarray(init), block=64,
        graph_impl="xla", **kw))
    out = port_tsne.tsne_layout_arrays(
        torch.from_numpy(idx), torch.from_numpy(P), torch.from_numpy(init),
        **kw)
    assert out.shape == init.shape and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())
    assert np.abs(out.numpy() - init).max() > 1e-5  # the layout moved


def test_prep_p_is_the_references_bit_for_bit(blobs):
    idx, dist, _ = blobs
    idx = idx.copy()
    idx[::9, -1] = -1  # padding slots
    dist = dist.copy()
    dist[::9, -1] = 0.0
    P, eff = port_tsne._prep_p(idx, dist, 30.0 / 6)
    R, reff = ref_tsne._prep_p(idx, dist, 30.0 / 6)
    np.testing.assert_array_equal(P, R)
    assert eff == reff
    assert port_tsne._exag_iters(500) == ref_tsne._exag_iters(500) == 100
    assert port_tsne._exag_iters(40) == ref_tsne._exag_iters(40) == 10


def test_prep_p_caps_the_perplexity(blobs):
    idx, dist, _ = blobs
    with pytest.warns(UserWarning, match="perplexity"):
        _, eff = port_tsne._prep_p(idx, dist, 30.0)
    assert eff == 5.0


def _purity(emb, truth, k=15):
    emb = np.asarray(emb, np.float64)
    nn, _ = knn_numpy(emb, emb, k=k, metric="euclidean", exclude_self=True)
    return float((truth[nn] == truth[:, None]).mean())


def test_tsne_separates_blobs(blobs):
    idx, dist, truth = blobs
    n = len(truth)
    d = CellData(np.zeros((n, 4), np.float32)).with_obsp(
        knn_indices=idx, knn_distances=dist).with_uns(knn_k=15)
    with pytest.warns(UserWarning, match="perplexity"):
        out = apply("embed.tsne", d, device="cpu", n_iter=350)
    emb = out.obsm["X_tsne"].numpy()
    assert emb.shape == (n, 2) and np.isfinite(emb).all()
    assert out.uns["tsne_perplexity"] == 5.0
    assert _purity(emb, truth) > 0.95


def test_tsne_requires_knn():
    d = CellData(np.zeros((10, 4), np.float32))
    with pytest.raises(ValueError, match="neighbors.knn"):
        apply("embed.tsne", d, device="cpu")
