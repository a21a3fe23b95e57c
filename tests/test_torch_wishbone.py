"""``wishbone.run`` of the port against the JAX reference.

The fixture is the reference's Y (``tests/test_wishbone.py``, rebuilt):
a trunk and two arms in 10-D, its 10-NN graph given to both packages
(``carry.graph_from_numpy``).  Held:

* the symmetrised edge list equal to the reference's ``_sym_edges``;
* the port's min-plus Bellman–Ford (on the CPU here, the card's code)
  equal to scipy's ``dijkstra`` within rtol 1e-5 (float32 path sums
  against float64), past the 128-sweep round on a 500-cell path graph,
  and with unreachable cells;
* on the CPU the op runs ``dijkstra`` as the reference's ``cpu`` backend
  does: waypoints, trajectory, branches and branch time equal;
* the trajectory from the min-plus distances within 2e-3 of the
  reference's ``tpu`` backend (its test's tolerance), waypoints equal.
"""

import numpy as np
import pytest
import torch

import sctools_tpu as sct
from sctools_tpu.data.dataset import CellData as RefCellData
from sctools_tpu.ops import wishbone as rwb
import sctools_tpu_torch as sctt
from sctools_tpu_torch.carry import graph_from_numpy
from sctools_tpu_torch.data.dataset import CellData
from sctools_tpu_torch.ops import wishbone as pwb

torch.set_num_threads(2)


def _spearman(a, b):
    ra = np.argsort(np.argsort(a)).astype(np.float64)
    rb = np.argsort(np.argsort(b)).astype(np.float64)
    return float(np.corrcoef(ra, rb)[0, 1])


@pytest.fixture(scope="module")
def ydata():
    rng = np.random.default_rng(0)
    n_trunk = n_arm = 150
    d = 10
    t_trunk = np.linspace(0, 1, n_trunk)
    t_arm = np.linspace(0, 1, n_arm)
    dir_trunk = np.zeros(d)
    dir_trunk[0] = 1.0
    dir_a = np.zeros(d)
    dir_a[0], dir_a[1] = 0.7, 0.7
    dir_b = np.zeros(d)
    dir_b[0], dir_b[1] = 0.7, -0.7
    E = np.vstack([np.outer(t_trunk, dir_trunk),
                   dir_trunk + np.outer(t_arm, dir_a),
                   dir_trunk + np.outer(t_arm, dir_b)])
    E = (E + rng.normal(0, 0.02, E.shape)).astype(np.float32)
    truth_t = np.concatenate([t_trunk, 1 + t_arm, 1 + t_arm])
    truth_b = np.concatenate([np.zeros(n_trunk), np.ones(n_arm),
                              np.full(n_arm, 2)]).astype(int)
    ref = sct.apply("neighbors.knn", RefCellData(
        np.zeros((len(E), 1), np.float32), obsm={"X_pca": E}),
        backend="cpu", k=10, metric="euclidean")
    port = graph_from_numpy(
        CellData(torch.zeros((len(E), 1)),
                 obsm={"X_pca": torch.from_numpy(E)}),
        np.asarray(ref.obsp["knn_indices"]),
        np.asarray(ref.obsp["knn_distances"]))
    return ref, port, truth_t, truth_b


def _graph(ref):
    n = ref.n_cells
    return (np.asarray(ref.obsp["knn_indices"])[:n],
            np.asarray(ref.obsp["knn_distances"], np.float64)[:n])


def test_sym_edges_match_reference(ydata):
    ref, _, _, _ = ydata
    idx, dist = _graph(ref)
    for got, want in zip(pwb.sym_edges(idx, dist),
                         rwb._sym_edges(idx, dist)):
        np.testing.assert_array_equal(got, want)


def test_minplus_matches_dijkstra(ydata):
    ref, _, _, _ = ydata
    idx2, w2 = pwb.sym_edges(*_graph(ref))
    sources = np.array([0, 17, 160, 449, 300, 5])
    D = pwb.minplus_distances(torch.from_numpy(idx2), torch.from_numpy(w2),
                              sources)
    want = pwb.dijkstra_distances(idx2, w2, sources)
    np.testing.assert_allclose(D, want, rtol=1e-5)
    np.testing.assert_allclose(D, rwb._distances_tpu(idx2, w2, sources),
                               rtol=1e-5)


def test_minplus_converges_past_the_round_cap():
    """A path of 500 cells (hop diameter 499 > one 128-sweep round),
    plus 3 cells unreachable from it."""
    n = 503
    idx = np.full((n, 2), -1, np.int32)
    dist = np.zeros((n, 2), np.float32)
    idx[:499, 0] = np.arange(1, 500)
    dist[:499, 0] = 1.0
    idx[500, 0], dist[500, 0] = 501, 0.5
    idx2, w2 = pwb.sym_edges(idx, dist)
    sources = np.array([0, 499, 500])
    D = pwb.minplus_distances(torch.from_numpy(idx2), torch.from_numpy(w2),
                              sources)
    want = pwb.dijkstra_distances(idx2, w2, sources)
    fin = np.isfinite(want)
    np.testing.assert_allclose(D[fin], want[fin], rtol=1e-5)
    assert (D[~fin] > 1e37).all()
    assert D[499, 0] == pytest.approx(499.0)


@pytest.mark.parametrize("kw", [dict(n_waypoints=80),
                                dict(n_waypoints=40, branch=False),
                                dict(n_waypoints=60, seed=5, n_iter=5)])
def test_wishbone_matches_reference_oracle(ydata, kw):
    ref, port, _, _ = ydata
    want = sct.apply("wishbone.run", ref, backend="cpu", start_cell=0, **kw)
    got = sctt.apply("wishbone.run", port, device="cpu", start_cell=0, **kw)
    np.testing.assert_array_equal(got.uns["wishbone_waypoints"],
                                  want.uns["wishbone_waypoints"])
    np.testing.assert_array_equal(got.obs["wishbone_trajectory"].numpy(),
                                  np.asarray(want.obs["wishbone_trajectory"]))
    if kw.get("branch", True):
        np.testing.assert_array_equal(got.obs["wishbone_branch"].numpy(),
                                      np.asarray(want.obs["wishbone_branch"]))
        assert got.uns["wishbone_branch_time"] == \
            want.uns["wishbone_branch_time"]
    else:
        assert "wishbone_branch" not in got.obs


def test_minplus_trajectory_matches_reference_device(ydata, monkeypatch):
    """The op on the card's route (min-plus distances, forced here on the
    CPU) against the reference's ``tpu`` backend."""
    ref, port, truth_t, truth_b = ydata
    want = sct.apply("wishbone.run", ref, backend="tpu", start_cell=0,
                     n_waypoints=40)
    monkeypatch.setattr(pwb, "dijkstra_distances",
                        lambda idx2, w2, src: pwb.minplus_distances(
                            torch.from_numpy(idx2), torch.from_numpy(w2),
                            src))
    got = sctt.apply("wishbone.run", port, device="cpu", start_cell=0,
                     n_waypoints=40)
    np.testing.assert_array_equal(got.uns["wishbone_waypoints"],
                                  want.uns["wishbone_waypoints"])
    tt = got.obs["wishbone_trajectory"].numpy().astype(np.float64)
    np.testing.assert_allclose(
        tt, np.asarray(want.obs["wishbone_trajectory"], np.float64),
        rtol=2e-3, atol=2e-3)
    assert _spearman(tt, truth_t) > 0.95
    br = got.obs["wishbone_branch"].numpy()
    assert (br[truth_b == 0] == 0).mean() > 0.9


def test_wishbone_validates(ydata):
    _, port, _, _ = ydata
    with pytest.raises(ValueError, match="start_cell"):
        sctt.apply("wishbone.run", port, device="cpu", start_cell=10**6)
    bare = CellData(torch.zeros((5, 2)))
    with pytest.raises(KeyError, match="neighbors.knn"):
        sctt.apply("wishbone.run", bare, device="cpu", start_cell=0)
