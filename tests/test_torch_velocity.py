"""The port's RNA velocity (``sctools_tpu_torch/ops/velocity.py``, the
nine ``velocity.*`` ops) against the JAX package's (``backend="tpu"``,
on the CPU), on the fixtures of ``tests/test_velocity.py``: the 500 ×
40 induction trajectory, the 300-cell Y flow, the 150-cell line and the
400 × 12 cells drawn from the splicing ODE.

Both packages start from the reference's kNN graph, carried with
``carry.graph_from_numpy``; where a stage is compared alone, its inputs
are the reference's outputs of the stages before it, so that an ulp of
an earlier stage cannot move a threshold (the steady-state mask, the
top-quantile cells) in a later one.  Tolerances:

* moments: rtol 1e-5, atol 1e-6 (float32 sums over the k slots in
  another order); over CPU shards of a mesh (ring and all_gather)
  against the unsharded port: the same;
* ``estimate``: the steady-state mask is the same (``torch.quantile``
  gives ``jnp.quantile``'s bits), γ, r² and the velocity within rtol
  1e-4 (float32 sums over the cells in another order; the stochastic
  mode's sums hold fourth moments), the gene mask equal;
* the velocity graph: atol 1e-5 (cosines); its arrows: atol 1e-6;
* terminal states equal, the stationary vector within rtol 1e-9
  (float64 sums in another order), fate probabilities within 2e-3, the
  reference's own tolerance (``tests/test_velocity.py:200``), lineage
  drivers within 1e-5;
* ``recover_dynamics``: from the same start, one round (5 Adam steps)
  gives the same cell times and parameters within 4e-5; but Adam's
  first steps move each parameter by about ±lr whatever the gradient's
  size, so an ulp of the steady-state slope that seeds γ moves a step.
  At ``n_outer=2`` the parameters agree within rtol 2e-3, the ECDF
  switch time within 3 cells' steps (3/400), and 95 % of the cell times
  within 1e-3 (measured: 7.5e-4, 1 cell, 98.4 %); at its default 40
  rounds the reference test's own gates hold on both packages;
* ``latent_time`` from the reference's fits: within 1e-5.

The fate chain runs in float64 with fixed-order sums: two runs give
equal bits."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from scipy.stats import spearmanr

import sctools_tpu as sct
from sctools_tpu.data.dataset import CellData as RefCellData
import sctools_tpu_torch as sctt
from sctools_tpu_torch.carry import graph_from_numpy
from sctools_tpu_torch.ops import velocity as port_vel
from sctools_tpu_torch.parallel import make_mesh
from sctools_tpu_torch.registry import apply

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_velocity import _velocity_fixture  # noqa: E402

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-6)


def _np(v):
    return v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _port(ref, layers=(), obsm=(), var=(), obs=(), obsp=()):
    """The port's CellData on the reference's X and kNN graph, with the
    named reference fields carried as they are."""
    n = ref.n_cells
    X = torch.from_numpy(np.array(ref.X, np.float32))
    p = sctt.CellData(
        X, layers={k: torch.from_numpy(np.array(ref.layers[k]))[:n]
                   for k in layers},
        obsm={k: torch.from_numpy(np.array(ref.obsm[k]))[:n] for k in obsm},
        var={k: torch.from_numpy(np.array(ref.var[k])) for k in var},
        obs={k: torch.from_numpy(np.array(ref.obs[k]))[:n] for k in obs},
        obsp={k: torch.from_numpy(np.array(ref.obsp[k]))[:n]
              for k in obsp})
    return graph_from_numpy(p, ref.obsp["knn_indices"],
                            ref.obsp["knn_distances"])


@pytest.fixture(scope="module")
def vdata():
    return _velocity_fixture()


def _layer(d, k):
    return np.asarray(d.layers[k])[: d.n_cells]


# ------------------------------------------------------------- moments


@pytest.mark.parametrize("second", [False, True])
def test_moments(vdata, second):
    d, _, _ = vdata
    r = sct.apply("velocity.moments", d, backend="tpu", second=second)
    o = apply("velocity.moments", _port(d, layers=("spliced", "unspliced")),
              device="cpu", second=second)
    keys = ("Ms", "Mu") + (("Mss", "Mus") if second else ())
    for k in keys:
        np.testing.assert_allclose(_np(o.layers[k]), _layer(r, k), **TOL)
    assert ("Mss" in o.layers) == second


@pytest.mark.parametrize("strategy", ["all_gather", "ring"])
@pytest.mark.parametrize("shards", [3, 4])
def test_moments_over_a_mesh(vdata, strategy, shards):
    d, _, _ = vdata
    p = _port(d, layers=("spliced", "unspliced"))
    base = apply("velocity.moments", p, device="cpu", second=True)
    mesh = make_mesh(devices=["cpu"] * shards)
    o = apply("velocity.moments", p, device="cpu", second=True, mesh=mesh,
              strategy=strategy)
    for k in ("Ms", "Mu", "Mss", "Mus"):
        got = _np(o.layers[k])
        assert got.shape == (d.n_cells, d.n_genes)
        np.testing.assert_allclose(got, _np(base.layers[k]), **TOL)


def test_moments_need_the_layers(vdata):
    d, _, _ = vdata
    p = _port(d)
    with pytest.raises(KeyError, match="spliced"):
        apply("velocity.moments", p, device="cpu")
    with pytest.raises(KeyError, match="velocity.estimate"):
        apply("velocity.graph", p, device="cpu")


# ------------------------------------------------------------- estimate


@pytest.mark.parametrize("mode", ["deterministic", "stochastic"])
def test_estimate(vdata, mode):
    d, _, _ = vdata
    m = sct.apply("velocity.moments", d, backend="tpu", second=True)
    r = sct.apply("velocity.estimate", m, backend="tpu", mode=mode)
    o = apply("velocity.estimate",
              _port(m, layers=("Ms", "Mu", "Mss", "Mus")), device="cpu",
              mode=mode)
    for k in ("velocity_gamma", "velocity_r2"):
        np.testing.assert_allclose(_np(o.var[k]), np.asarray(r.var[k]),
                                   rtol=1e-4, atol=1e-6)
    np.testing.assert_array_equal(_np(o.var["velocity_genes"]),
                                  np.asarray(r.var["velocity_genes"]))
    vel = _layer(r, "velocity")
    np.testing.assert_allclose(_np(o.layers["velocity"]), vel, rtol=1e-4,
                               atol=1e-4 * np.abs(vel).max())


def test_steady_state_mask_is_the_references(monkeypatch):
    """The cells at or above the per-gene quantile, on a grid with ties
    at the cut: ``torch.quantile`` gives ``jnp.quantile``'s bits, in
    gene blocks too."""
    import jax.numpy as jnp

    rng = np.random.default_rng(3)
    t = np.round(rng.random((1001, 7)) * 50).astype(np.float32)
    for q in (0.95, 0.9, 0.5):
        want = np.asarray(jnp.quantile(jnp.asarray(t), q, axis=0,
                                       keepdims=True))
        got = _np(port_vel._quantile_cols(torch.from_numpy(t), q))
        np.testing.assert_array_equal(got, want)
    whole = port_vel._quantile_cols(torch.from_numpy(t), 0.95)
    monkeypatch.setattr(port_vel, "_QUANTILE_ELEMS", 2 * 1001)
    np.testing.assert_array_equal(_np(port_vel._quantile_cols(
        torch.from_numpy(t), 0.95)), _np(whole))


def test_stochastic_mode_computes_second_moments_if_missing():
    rng = np.random.default_rng(1)
    n, g = 200, 4
    S = rng.poisson(2.0, (n, g)).astype(np.float32)
    U = rng.poisson(1.0, (n, g)).astype(np.float32)
    d = RefCellData(S, obsm={"X_pca": rng.normal(
        0, 1, (n, 4)).astype(np.float32)})
    d = d.with_layers(spliced=S, unspliced=U)
    d = sct.apply("neighbors.knn", d, backend="cpu", k=8,
                  metric="euclidean")
    r = sct.apply("velocity.estimate", d, backend="tpu", mode="stochastic",
                  min_r2=-10)
    o = apply("velocity.estimate", _port(d, layers=("spliced", "unspliced")),
              device="cpu", mode="stochastic", min_r2=-10)
    assert {"Ms", "Mu", "Mss", "Mus", "velocity"} <= set(o.layers)
    np.testing.assert_allclose(_np(o.var["velocity_gamma"]),
                               np.asarray(r.var["velocity_gamma"]),
                               rtol=1e-3)


# ------------------------------------------------ graph and embedding


def test_velocity_graph_and_embedding(vdata):
    d, _, _ = vdata
    e = sct.apply("velocity.estimate", d, backend="tpu")
    r = sct.apply("velocity.graph", e, backend="tpu")
    o = apply("velocity.graph",
              _port(e, layers=("Ms", "velocity"), var=("velocity_genes",)),
              device="cpu")
    cos = np.asarray(r.obsp["velocity_graph"])[: d.n_cells]
    np.testing.assert_allclose(_np(o.obsp["velocity_graph"]), cos, rtol=0,
                               atol=1e-5)
    ra = sct.apply("velocity.embedding", r, backend="tpu", basis="umap")
    oa = apply("velocity.embedding",
               _port(r, obsm=("X_umap",), obsp=("velocity_graph",)),
               device="cpu", basis="umap")
    want = np.asarray(ra.obsm["velocity_umap"])
    got = _np(oa.obsm["velocity_umap"])
    assert got.dtype == np.float32 and got.shape == (d.n_cells, 2)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    with pytest.raises(KeyError, match="X_tsne"):
        apply("velocity.embedding", oa, device="cpu", basis="tsne")


# ------------------------------------------------------------ fate chain


def _y_flow():
    """``tests/test_velocity.py``'s Y-shaped flow: a trunk into two arms,
    the velocity the local flow direction."""
    rng = np.random.default_rng(0)
    n_t, n_a = 100, 100
    t_tr = np.linspace(0, 1, n_t)
    t_ar = np.linspace(0, 1, n_a)
    trunk = np.stack([t_tr, np.zeros(n_t)], axis=1)
    arm_a = np.stack([1 + t_ar, t_ar], axis=1)
    arm_b = np.stack([1 + t_ar, -t_ar], axis=1)
    E = np.vstack([trunk, arm_a, arm_b]) + rng.normal(0, 0.02, (300, 2))
    V = np.vstack([np.tile([1.0, 0.0], (n_t, 1)),
                   np.tile([1.0, 1.0], (n_a, 1)) / np.sqrt(2),
                   np.tile([1.0, -1.0], (n_a, 1)) / np.sqrt(2)])
    d = RefCellData(E.astype(np.float32),
                    obsm={"X_pca": np.asarray(
                        np.hstack([E, rng.normal(0, 0.01, (300, 4))]),
                        np.float32)})
    d = d.with_layers(Ms=E.astype(np.float32),
                      velocity=V.astype(np.float32))
    d = d.with_var(velocity_genes=np.ones(2, bool))
    d = sct.apply("neighbors.knn", d, backend="cpu", k=10,
                  metric="euclidean")
    return sct.apply("velocity.graph", d, backend="cpu"), E, rng


def _line():
    """``tests/test_velocity.py``'s 150-cell line flowing one way."""
    rng = np.random.default_rng(1)
    n = 150
    t = np.linspace(0, 1, n)
    E = np.stack([t, np.zeros(n)], axis=1) + rng.normal(0, 0.01, (n, 2))
    V = np.tile([1.0, 0.0], (n, 1))
    d = RefCellData(E.astype(np.float32),
                    obsm={"X_pca": np.asarray(
                        np.hstack([E, rng.normal(0, 0.01, (n, 3))]),
                        np.float32)})
    d = d.with_layers(Ms=E.astype(np.float32),
                      velocity=V.astype(np.float32))
    d = d.with_var(velocity_genes=np.ones(2, bool))
    d = sct.apply("neighbors.knn", d, backend="cpu", k=8,
                  metric="euclidean")
    return sct.apply("velocity.graph", d, backend="cpu")


@pytest.fixture(scope="module", params=["y_flow", "line"])
def chain(request):
    if request.param == "y_flow":
        d, _, _ = _y_flow()
        return d, 0.93
    return _line(), 0.95


def test_terminal_states_and_fates(chain):
    d, quantile = chain
    r = sct.apply("velocity.terminal_states", d, backend="tpu",
                  quantile=quantile)
    p = _port(d, layers=("Ms", "velocity"), var=("velocity_genes",))
    o = apply("velocity.terminal_states", p, device="cpu",
              quantile=quantile)
    term = np.asarray(r.obs["terminal_states"])
    np.testing.assert_array_equal(_np(o.obs["terminal_states"]), term)
    assert term.max() >= 0
    np.testing.assert_allclose(_np(o.uns["terminal_stationary"]),
                               np.asarray(r.uns["terminal_stationary"]),
                               rtol=1e-6)
    rf = sct.apply("velocity.fate_probabilities", r, backend="tpu")
    of = apply("velocity.fate_probabilities", o, device="cpu")
    F = _np(of.obsm["fate_probs"])
    assert F.dtype == np.float32
    np.testing.assert_allclose(F, np.asarray(rf.obsm["fate_probs"]),
                               rtol=0, atol=2e-3)
    # the same bits twice (fixed-order float64 sums)
    again = apply("velocity.fate_probabilities", o, device="cpu")
    assert torch.equal(again.obsm["fate_probs"], of.obsm["fate_probs"])


def test_stationary_vector_against_the_references_loop(chain):
    """The port's power iteration against the reference's host loop
    (``velocity.py:561-575``, ``np.add.at`` over the edges) on the
    port's own transition matrix."""
    d, _ = chain
    p = _port(d, layers=("Ms", "velocity"), var=("velocity_genes",))
    ch = port_vel._velocity_transition(p, 0.25)
    rows, cols, T = _np(ch.rows), _np(ch.cols), _np(ch.T)
    n = p.n_cells
    np.testing.assert_allclose(np.bincount(rows, weights=T, minlength=n),
                               1.0, rtol=1e-12)
    pi = np.full(n, 1.0 / n)
    for _ in range(300):
        nxt = np.zeros(n)
        np.add.at(nxt, cols, T * pi[rows])
        nxt /= nxt.sum()
        if np.abs(nxt - pi).max() < 1e-12:
            pi = nxt
            break
        pi = nxt
    np.testing.assert_allclose(_np(port_vel.stationary(ch)), pi,
                               rtol=1e-9, atol=0)


def test_union_edges_are_wishbones():
    """``_sym_pairs`` is ``wishbone._sym_edges`` unpadded: row by row
    the same targets in the same slots."""
    from sctools_tpu.ops.wishbone import _sym_edges

    rng = np.random.default_rng(2)
    idx = rng.integers(-1, 40, (40, 6)).astype(np.int32)
    a, b, counts = port_vel._sym_pairs(idx)
    idx2, _ = _sym_edges(idx, rng.random((40, 6)))
    assert counts.max() == idx2.shape[1]
    valid = idx2 >= 0
    np.testing.assert_array_equal(valid.sum(axis=1), counts)
    np.testing.assert_array_equal(np.nonzero(valid)[0], a)
    np.testing.assert_array_equal(idx2[valid], b)


def test_fate_chain_on_the_y_flow_and_lineage_drivers():
    d, E, rng = _y_flow()
    p = _port(d, layers=("Ms", "velocity"), var=("velocity_genes",))
    o = apply("velocity.terminal_states", p, device="cpu", quantile=0.93)
    o = apply("velocity.fate_probabilities", o, device="cpu")
    term = _np(o.obs["terminal_states"])
    assert len(set(term[term >= 0].tolist())) == 2
    assert E[term >= 0, 0].min() > 1.4
    F = _np(o.obsm["fate_probs"])
    early = np.where(E[:, 0] < 0.3)[0]
    assert (F[early].sum(axis=1) > 0.99).all()
    assert 0.2 < F[early, 0].mean() < 0.8
    # the reference's drivers fixture: gene 0 tracks arm A, gene 1 arm B
    r = sct.apply("velocity.terminal_states", d, backend="tpu",
                  quantile=0.93)
    r = sct.apply("velocity.fate_probabilities", r, backend="tpu")
    Fr = np.asarray(r.obsm["fate_probs"])
    ga = np.bincount(term[term >= 0][E[term >= 0, 1] > 0],
                     minlength=2).argmax()
    Ms = np.stack([Fr[:, ga] + rng.normal(0, 0.05, 300),
                   Fr[:, 1 - ga] + rng.normal(0, 0.05, 300),
                   rng.normal(0, 1.0, 300)], axis=1).astype(np.float32)
    r = r.with_layers(Ms=Ms)
    want = np.asarray(sct.apply("velocity.lineage_drivers", r,
                                backend="tpu").varm["lineage_drivers"])
    got = _np(apply("velocity.lineage_drivers",
                    _port(r, layers=("Ms",), obsm=("fate_probs",),
                          obs=("terminal_states",)),
                    device="cpu").varm["lineage_drivers"])
    assert got.shape == (3, 2)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert got[:, ga].argmax() == 0 and got[0, ga] > 0.6
    assert got[:, 1 - ga].argmax() == 1 and got[1, 1 - ga] > 0.6


def test_fate_ops_validate_their_inputs(vdata):
    d, _, _ = vdata
    p = _port(d)
    with pytest.raises(KeyError, match="velocity.estimate"):
        apply("velocity.terminal_states", p, device="cpu")
    with pytest.raises(KeyError, match="terminal_states first"):
        apply("velocity.fate_probabilities", p, device="cpu")
    with pytest.raises(KeyError, match="fate_probabilities first"):
        apply("velocity.lineage_drivers", p, device="cpu")
    with pytest.raises(KeyError, match="recover_dynamics first"):
        apply("velocity.latent_time", p, device="cpu")


# ------------------------------------------------------ dynamical model


def _ode_cells():
    """``tests/test_velocity.py``'s cells from the exact splicing ODE
    (RK4 on a fine grid), 400 × 12, with their true times and rates."""
    rng = np.random.default_rng(0)
    n, g = 400, 12
    t_true = rng.uniform(0, 1, n).astype(np.float32)
    alpha = rng.uniform(2, 5, g)
    beta = rng.uniform(3, 8, g)
    gamma = beta * rng.uniform(0.3, 3.0, g)
    ts = rng.uniform(0.45, 0.8, g)
    grid = np.linspace(0.0, 1.0, 4097)
    h = grid[1] - grid[0]
    U = np.zeros((n, g), np.float32)
    S = np.zeros((n, g), np.float32)
    for j in range(g):
        def f(t_, y):
            a_t = alpha[j] if t_ <= ts[j] else 0.0
            return np.array([a_t - beta[j] * y[0],
                             beta[j] * y[0] - gamma[j] * y[1]])

        ys = np.zeros((len(grid), 2))
        y = np.zeros(2)
        for i_, t_ in enumerate(grid[:-1]):
            ys[i_] = y
            k1 = f(t_, y)
            k2 = f(t_ + h / 2, y + h / 2 * k1)
            k3 = f(t_ + h / 2, y + h / 2 * k2)
            k4 = f(t_ + h, y + h * k3)
            y = y + h / 6 * (k1 + 2 * k2 + 2 * k3 + k4)
        ys[-1] = y
        U[:, j] = np.interp(t_true, grid, ys[:, 0]) * (
            1 + rng.normal(0, 0.03, n))
        S[:, j] = np.interp(t_true, grid, ys[:, 1]) * (
            1 + rng.normal(0, 0.03, n))
    d = RefCellData(S).with_layers(Ms=S, Mu=U)
    return d, t_true, beta, gamma, ts


@pytest.fixture(scope="module")
def ode():
    return _ode_cells()


def _port_ode(d):
    return sctt.CellData(torch.from_numpy(np.array(d.X)), layers={
        k: torch.from_numpy(np.array(d.layers[k])) for k in ("Ms", "Mu")})


FIT_KEYS = ("fit_alpha", "fit_beta", "fit_gamma", "fit_t_switch",
            "fit_t_switch_geo", "fit_scaling", "fit_r2", "velocity_gamma")


def test_recover_dynamics_two_rounds_match_reference(ode):
    d = ode[0]
    r = sct.apply("velocity.recover_dynamics", d, backend="tpu", n_outer=2)
    o = apply("velocity.recover_dynamics", _port_ode(d), device="cpu",
              n_outer=2)
    for k in FIT_KEYS:
        # the switch time is an ECDF value: 1/400 a cell on either side
        tol = (dict(rtol=0, atol=3 / 400) if k == "fit_t_switch"
               else dict(rtol=2e-3, atol=1e-5))
        np.testing.assert_allclose(_np(o.var[k]), np.asarray(r.var[k]),
                                   err_msg=k, **tol)
    np.testing.assert_array_equal(_np(o.var["velocity_genes"]),
                                  np.asarray(r.var["velocity_genes"]))
    t_r = _layer(r, "fit_t")
    t_p = _np(o.layers["fit_t"])
    assert (np.abs(t_p - t_r) <= 1e-3).mean() >= 0.95
    vel = _layer(r, "velocity")
    close = np.isclose(_np(o.layers["velocity"]), vel, rtol=2e-3,
                       atol=2e-3 * np.abs(vel).max())
    assert close.mean() >= 0.99


def test_one_round_from_the_same_start_matches_reference(ode):
    """``_dyn_fit`` against the reference's vmapped fit, both seeded
    with the reference's steady-state slope: the same cell times, the
    parameters within 4e-5 after 5 Adam steps."""
    import jax.numpy as jnp

    from sctools_tpu.ops import velocity as ref_vel

    d = ode[0]
    Ms, Mu = _layer(d, "Ms"), _layer(d, "Mu")
    un = Mu / np.maximum(np.percentile(Mu, 99, axis=0), 1e-6)[None]
    sn = Ms / np.maximum(np.percentile(Ms, 99, axis=0), 1e-6)[None]
    slope, _, _ = ref_vel._steady_state_fit(jnp.asarray(sn),
                                            jnp.asarray(un), 0.05)
    for n_outer in (0, 1):
        pr, tr, r2r = ref_vel._dyn_fit_all(jnp.asarray(un), jnp.asarray(sn),
                                           slope, n_outer)
        pp, tp, r2p = port_vel._dyn_fit(
            torch.from_numpy(un), torch.from_numpy(sn),
            torch.from_numpy(np.array(slope)), n_outer=n_outer)
        np.testing.assert_array_equal(_np(tp), np.asarray(tr).T)
        np.testing.assert_allclose(_np(pp), np.asarray(pr), rtol=4e-5,
                                   atol=0)
        np.testing.assert_allclose(_np(r2p), np.asarray(r2r), rtol=1e-4,
                                   atol=1e-6)


def _dynamics_gates(d, t_true, beta, gamma, ts):
    """``tests/test_velocity.py::test_recover_dynamics_on_true_ode_data``'s
    gates on one package's host outputs."""
    r2 = np.asarray(d.var["fit_r2"])
    assert (r2 > 0.5).mean() >= 0.8, r2
    T = np.asarray(d.layers["fit_t"])
    rhos = [abs(spearmanr(T[:, j], t_true).statistic)
            for j in range(T.shape[1]) if r2[j] > 0.5]
    assert np.median(rhos) > 0.7, rhos
    lt = np.asarray(d.obs["latent_time"])
    rho = spearmanr(lt, t_true).statistic
    assert abs(rho) > 0.8, rho
    keep = r2 > 0.5
    t_fit = np.asarray(d.var["fit_t_switch"])
    assert spearmanr(t_fit[keep], ts[keep]).statistic > 0.5
    assert np.median(np.abs(t_fit[keep] - ts[keep])) < 0.15
    V = np.asarray(d.layers["velocity"])
    U, S = np.asarray(d.layers["Mu"]), np.asarray(d.layers["Ms"])
    true_v = beta[None, :] * U - gamma[None, :] * S
    for j in range(T.shape[1]):
        if r2[j] <= 0.5:
            continue
        big = np.abs(true_v[:, j]) > 0.2 * np.abs(true_v[:, j]).max()
        agree = (np.sign(V[big, j]) == np.sign(true_v[big, j])).mean()
        assert agree > 0.8, (j, agree)
    return rho


def test_recover_dynamics_meets_the_reference_gates(ode):
    d, t_true, beta, gamma, ts = ode
    r = sct.apply("velocity.recover_dynamics", d, backend="tpu")
    r = sct.apply("velocity.latent_time", r, backend="tpu")
    o = apply("velocity.recover_dynamics", _port_ode(d), device="cpu")
    o = apply("velocity.latent_time", o, device="cpu")
    rho_r = _dynamics_gates(r, t_true, beta, gamma, ts)
    rho_p = _dynamics_gates(o.to_host(), t_true, beta, gamma, ts)
    print(f"latent time Spearman: reference {rho_r:.4f}, port {rho_p:.4f}")


def test_latent_time_from_the_references_fits(ode):
    d = ode[0]
    r = sct.apply("velocity.recover_dynamics", d, backend="tpu", n_outer=4)
    want = np.asarray(sct.apply("velocity.latent_time", r,
                                backend="tpu").obs["latent_time"])
    p = _port(r.with_obsp(knn_indices=np.zeros((400, 1), np.int32),
                          knn_distances=np.zeros((400, 1), np.float32)),
              layers=("fit_t",), var=("fit_r2",))
    got = _np(apply("velocity.latent_time", p, device="cpu").obs[
        "latent_time"])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="fit_r2"):
        apply("velocity.latent_time", p, device="cpu", min_r2=2.0)
