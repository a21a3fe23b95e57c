"""``integrate.mnn`` of the port against the JAX reference on the same
inputs.

The reference runs ``backend="tpu"`` on the CPU (its ``knn_arrays``
searches, refine 32) and its float64 oracle ``backend="cpu"``.  On the
fixtures of ``tests/test_mnn.py`` (continuous Gaussian clusters: no
distance ties) the port's searches return the reference's neighbour
lists (as sets: two ids at one distance may swap places), so the mutual
pairs and the merge order are equal, and X_mnn agrees within 1e-5 with
the reference's steps (``sctools_tpu/ops/mnn.py:_mnn``, its own
searches) once their smoothing distances are the float64 differences
the port takes.  Against the plain reference op X_mnn agrees within
1e-5 on the fixtures where the reference's float32 self-distance noise
cannot change a weight; where the median nearest-anchor distance is 0
(most cells anchors) that noise decides whether an anchor keeps its own
correction or takes its neighbourhood's (``ops/mnn.py``'s docstring),
so there only the reference's own assertions hold.  ``k`` above a tiny
batch pads no -1 id into a pair.
"""

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sctools_tpu as sct
from sctools_tpu.data.dataset import CellData as RefCellData
from sctools_tpu.ops import mnn as ref_mnn
from sctools_tpu.ops.knn import knn_arrays as ref_knn_arrays
import sctools_tpu_torch as sctt
from sctools_tpu_torch.ops import mnn as port_mnn
from sctools_tpu_torch.ops.knn import knn_arrays

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_mnn import _two_batch  # noqa: E402

torch.set_num_threads(2)

TOL = 1e-5


def _port(d) -> "sctt.CellData":
    return sctt.CellData(torch.zeros((d.n_cells, 1)), obs=dict(d.obs),
                         obsm={k: torch.from_numpy(np.array(v, np.float32))
                               for k, v in d.obsm.items()})


def _three_batch():
    """``tests/test_mnn.py``'s three batches of 150, 100 and 50 cells."""
    rng = np.random.default_rng(2)
    Z = rng.normal(0, 3, (300, 8))
    batch = np.array(["big"] * 150 + ["mid"] * 100 + ["small"] * 50)
    Z[batch == "mid"] += 2.0
    Z[batch == "small"] -= 2.0
    return RefCellData(np.zeros((300, 1), np.float32), obs={"batch": batch},
                       obsm={"X_pca": Z.astype(np.float32)})


def _tiny():
    """``tests/test_mnn.py``'s 22 + 8 cells, k = 20 above batch B."""
    rng = np.random.default_rng(3)
    Z = rng.normal(0, 2, (30, 6)).astype(np.float32)
    batch = np.array(["A"] * 22 + ["B"] * 8)
    Z[batch == "B"] += 1.0
    return RefCellData(np.zeros((30, 1), np.float32), obs={"batch": batch},
                       obsm={"X_pca": Z})


FIXTURES = {"two_batch_0": (lambda: _two_batch(seed=0), 15),
            "two_batch_1": (lambda: _two_batch(seed=1), 15),
            "two_batch_k20": (lambda: _two_batch(seed=2), 20),
            "three_batch": (_three_batch, 10),
            "tiny": (_tiny, 20)}


def _search_pair(q, c, k):
    kw = dict(k=k, metric="euclidean", n_query=len(q), n_cand=len(c),
              refine=max(k, 32))
    ri, rd = ref_knn_arrays(jnp.asarray(q), jnp.asarray(c), **kw)
    pi, pd = knn_arrays(torch.from_numpy(q), torch.from_numpy(c), **kw)
    return ((np.asarray(ri)[: len(q)], np.asarray(rd)[: len(q)]),
            (pi.numpy()[: len(q)], pd.numpy()[: len(q)]))


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_first_merge_has_the_reference_s_lists_and_pairs(name):
    make, k = FIXTURES[name]
    d = make()
    Z = np.asarray(d.obsm["X_pca"], np.float32)
    labels = np.asarray(d.obs["batch"])
    levels, codes = np.unique(labels, return_inverse=True)
    order = np.argsort([-np.sum(codes == i) for i in range(len(levels))])
    ref, bat = Z[codes == order[0]], Z[codes == order[1]]
    k = min(k, len(ref), len(bat))
    (rb, rbd), (pb, pbd) = _search_pair(bat, ref, k)
    (rr, _), (pr, _) = _search_pair(ref, bat, k)
    # the same lists as sets (two ids of one distance may swap places)
    np.testing.assert_array_equal(np.sort(pb, axis=1), np.sort(rb, axis=1))
    np.testing.assert_array_equal(np.sort(pr, axis=1), np.sort(rr, axis=1))
    np.testing.assert_allclose(pbd, rbd, rtol=1e-5, atol=1e-5)
    for got, want in zip(port_mnn._mutual_pairs(pb, pr),
                         ref_mnn._mutual_pairs(rb, rr)):
        np.testing.assert_array_equal(got, want)


def _ref_steps_exact(d, k):
    """The reference's ``_mnn`` with its own searches (``knn_arrays``,
    refine max(k, 32)) and the smoothing distances taken as float64
    differences of the rows found, as the port takes them."""
    calls = []

    def knn(q, c, kk):
        idx, dist = ref_knn_arrays(
            jnp.asarray(q, jnp.float32), jnp.asarray(c, jnp.float32), k=kk,
            metric="euclidean", n_query=len(q), n_cand=len(c),
            refine=max(kk, 32))
        idx, dist = np.asarray(idx), np.asarray(dist, np.float64)
        calls.append(len(calls))
        if len(calls) % 3 == 0:  # the third search of a merge: smoothing
            dist[: len(q)] = np.linalg.norm(
                q[:, None, :] - c[idx[: len(q)]], axis=2)
        return idx, dist

    return ref_mnn._mnn(d, "batch", "X_pca", k, 1.0, knn)


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_mnn_matches_the_reference(name):
    make, k = FIXTURES[name]
    d = make()
    got = sctt.apply("integrate.mnn", _port(d), device="cpu", k=k)
    Z1 = got.obsm["X_mnn"].numpy()
    assert Z1.dtype == np.float32 and Z1.shape == d.obsm["X_pca"].shape
    want = _ref_steps_exact(d, k)
    assert got.uns["mnn_merge_order"] == want.uns["mnn_merge_order"]
    np.testing.assert_allclose(Z1, np.asarray(want.obsm["X_mnn"]), rtol=TOL,
                               atol=TOL)
    if name in ("two_batch_0", "two_batch_1", "tiny"):
        # here the reference's rounding noise cannot change a weight
        plain = sct.apply("integrate.mnn", d, backend="tpu", k=k)
        np.testing.assert_allclose(Z1, np.asarray(plain.obsm["X_mnn"]),
                                   rtol=TOL, atol=TOL)
    # the reference batch never moves
    b = np.asarray(d.obs["batch"])
    first = want.uns["mnn_merge_order"][0]
    np.testing.assert_array_equal(Z1[b == first],
                                  np.asarray(d.obsm["X_pca"])[b == first])


def test_mnn_against_the_float64_oracle():
    d = _two_batch(seed=1)
    got = sctt.apply("integrate.mnn", _port(d), device="cpu", k=15)
    oracle = sct.apply("integrate.mnn", d, backend="cpu", k=15)
    # the reference test's own bound between its two backends
    assert np.median(np.abs(got.obsm["X_mnn"].numpy()
                            - np.asarray(oracle.obsm["X_mnn"]))) < 0.05
    assert got.uns["mnn_merge_order"] == oracle.uns["mnn_merge_order"]


def test_mnn_removes_a_constant_batch_shift():
    d = _two_batch()
    Z0 = np.asarray(d.obsm["X_pca"], np.float64)
    Z1 = sctt.apply("integrate.mnn", _port(d), device="cpu",
                    k=15).obsm["X_mnn"].numpy().astype(np.float64)
    b = np.asarray(d.obs["batch"])
    gap0 = np.linalg.norm(Z0[b == "A"].mean(0) - Z0[b == "B"].mean(0))
    gap1 = np.linalg.norm(Z1[b == "A"].mean(0) - Z1[b == "B"].mean(0))
    assert gap1 < 0.35 * gap0


def test_mutual_pairs_drop_padding_before_packing():
    """-1 slots (k above the candidate count) make no pair: b·nR − 1
    would alias (b − 1)·nR + nR − 1."""
    b2r = np.array([[2, -1], [0, -1], [1, 2]])
    r2b = np.array([[1, -1, -1], [2, -1, -1], [0, 2, -1]])
    got = port_mnn._mutual_pairs(b2r, r2b)
    want = ref_mnn._mutual_pairs(b2r, r2b)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert sorted(zip(*got)) == [(0, 2), (1, 0), (2, 1), (2, 2)]


def test_tiny_batch_moves_toward_the_reference():
    d = _tiny()
    Z = np.asarray(d.obsm["X_pca"], np.float64)
    b = np.asarray(d.obs["batch"])
    Z1 = sctt.apply("integrate.mnn", _port(d), device="cpu",
                    k=20).obsm["X_mnn"].numpy().astype(np.float64)
    np.testing.assert_allclose(Z1[b == "A"], Z[b == "A"], atol=1e-5)
    g0 = np.linalg.norm(Z[b == "A"].mean(0) - Z[b == "B"].mean(0))
    g1 = np.linalg.norm(Z1[b == "A"].mean(0) - Z1[b == "B"].mean(0))
    assert g1 < g0


def test_smoothing_distances_are_exact_differences():
    rng = np.random.default_rng(7)
    x = rng.normal(size=(9000, 5))
    idx = rng.integers(0, 40, size=(9000, 6))
    idx[:40, 0] = np.arange(40)  # each of the first rows against itself
    got = port_mnn._distances(x, x[:40], idx)
    want = np.linalg.norm(x[:, None, :] - x[:40][idx], axis=2)
    np.testing.assert_array_equal(got, want)
    assert (got[:40, 0] == 0).all()


def test_mnn_validates():
    d = _port(_two_batch())
    with pytest.raises(KeyError, match="nope"):
        sctt.apply("integrate.mnn", d, device="cpu", batch_key="nope")
    one = d.with_obs(batch=np.full(400, "A"))
    with pytest.raises(ValueError, match="at least 2"):
        sctt.apply("integrate.mnn", one, device="cpu")
