"""``embed.phate`` of the port against the JAX reference.

The fixture is the reference's curve (``tests/test_phate.py``, rebuilt):
400 cells along a noisy 1-D curve in 10-D, its 12-NN graph given to
both packages (``carry.graph_from_numpy``).  The reference's ``tpu``
backend draws the subspace iteration's start with ``jax.random.normal``;
``carry.phate_sketch_from_numpy`` hands the same block to the port.
Held:

* the diffusion operator within 1e-7 of the reference's float64 host
  kernel (float64 here too) and 1e-6 in float32;
* the automatic t equal to the reference's;
* with the sketch carried, the geometry (pairwise distances of 300
  random pairs) with Spearman > 0.99 against the reference's ``tpu``
  and ``cpu`` embeddings, and the first component ordering the curve
  (|Spearman| > 0.9);
* the port's own seeded sketch: the same geometry within Spearman
  > 0.99.
"""

import jax
import numpy as np
import pytest
import torch

import sctools_tpu as sct
from sctools_tpu.data.dataset import CellData as RefCellData
from sctools_tpu.ops import phate as rphate
import sctools_tpu_torch as sctt
from sctools_tpu_torch.carry import graph_from_numpy, phate_sketch_from_numpy
from sctools_tpu_torch.data.dataset import CellData
from sctools_tpu_torch.ops import phate as pphate

torch.set_num_threads(2)

N = 400
T = 80


def _spearman(a, b):
    ra = np.argsort(np.argsort(a)).astype(np.float64)
    rb = np.argsort(np.argsort(b)).astype(np.float64)
    ra -= ra.mean()
    rb -= rb.mean()
    return float((ra * rb).sum()
                 / np.sqrt((ra * ra).sum() * (rb * rb).sum()))


def _geometry(a, b):
    rng = np.random.default_rng(0)
    ii, jj = rng.integers(0, N, 300), rng.integers(0, N, 300)
    da = np.linalg.norm(a[ii] - a[jj], axis=1)
    db = np.linalg.norm(b[ii] - b[jj], axis=1)
    return _spearman(da, db)


@pytest.fixture(scope="module")
def curve():
    rng = np.random.default_rng(0)
    tt = np.sort(rng.random(N))
    base = np.stack([np.cos(2 * tt), np.sin(2 * tt)] + [tt * 2] * 2,
                    axis=1)
    E = np.concatenate([base, rng.normal(0, 0.03, (N, 6))],
                       axis=1).astype(np.float32)
    ref = sct.apply("neighbors.knn", RefCellData(
        np.zeros((N, 1), np.float32), obsm={"X_pca": E}), backend="cpu",
        k=12, metric="euclidean")
    port = graph_from_numpy(CellData(torch.zeros((N, 1))),
                            np.asarray(ref.obsp["knn_indices"]),
                            np.asarray(ref.obsp["knn_distances"]))
    return ref, port, tt


def _sketch(n_components=2):
    return phate_sketch_from_numpy(np.asarray(jax.random.normal(
        jax.random.PRNGKey(0), (N, n_components + 8))))


def test_kernel_matches_reference(curve):
    ref, port, _ = curve
    idx = np.asarray(ref.obsp["knn_indices"])[:N]
    dist = np.asarray(ref.obsp["knn_distances"])[:N]
    want = rphate._kernel(idx, dist.astype(np.float64), 5, np, 2.0)
    it, dt = port.obsp["knn_indices"][:N], port.obsp["knn_distances"][:N]
    np.testing.assert_allclose(
        pphate.kernel_matrix(it, dt.double(), 5).numpy(), want, atol=1e-7)
    np.testing.assert_allclose(
        pphate.kernel_matrix(it, dt.float(), 5).numpy(), want, atol=1e-6)


def test_auto_t_matches_reference(curve):
    ref, port, _ = curve
    want = sct.apply("embed.phate", ref, backend="cpu")
    got = sctt.apply("embed.phate", port, device="cpu")
    assert got.uns["phate_t"] == want.uns["phate_t"]
    assert 2 <= got.uns["phate_t"] <= 100
    assert got.obsm["X_phate"].shape == (N, 2)


@pytest.mark.parametrize("backend", ["tpu", "cpu"])
def test_geometry_matches_reference(curve, backend):
    ref, port, tt = curve
    want = np.asarray(sct.apply("embed.phate", ref, backend=backend,
                                t=T).obsm["X_phate"], np.float64)
    got = sctt.apply("embed.phate", port, device="cpu", t=T,
                     sketch=_sketch()).obsm["X_phate"]
    assert got.dtype == torch.float32 and bool(torch.isfinite(got).all())
    got = got.numpy().astype(np.float64)
    assert _geometry(got, want) > 0.99
    assert abs(_spearman(got[:, 0], tt)) > 0.9


def test_seeded_sketch_gives_the_same_geometry(curve):
    ref, port, _ = curve
    carried = sctt.apply("embed.phate", port, device="cpu", t=T,
                         sketch=_sketch()).obsm["X_phate"].numpy()
    a = sctt.apply("embed.phate", port, device="cpu", t=T, seed=1)
    b = sctt.apply("embed.phate", port, device="cpu", t=T, seed=1)
    assert torch.equal(a.obsm["X_phate"], b.obsm["X_phate"])
    assert _geometry(a.obsm["X_phate"].numpy().astype(np.float64),
                     carried.astype(np.float64)) > 0.99
    with pytest.raises(ValueError, match="sketch"):
        sctt.apply("embed.phate", port, device="cpu", t=T,
                   sketch=torch.zeros((N, 3)))


def test_phate_requires_graph():
    d = CellData(torch.zeros((5, 2)))
    with pytest.raises(KeyError, match="neighbors.knn"):
        sctt.apply("embed.phate", d, device="cpu")
