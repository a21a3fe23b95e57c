"""The port's diffusion map, DPT and Palantir (``ops/graph.py:
embed.spectral/embed.diffmap/dpt.pseudotime`` and ``ops/palantir.py``)
against the JAX package's, on the CPU.

Both packages start from the reference's kNN graph on its branching
trajectory (tests/test_palantir.py:11-48), carried with
``carry.graph_from_numpy``; the spectral tests also start both
subspace iterations from the reference's ``jax.random`` block
(``carry.spectral_v0_from_numpy``), and the Palantir tests attach the
reference's ``X_diffmap`` and ``diffmap_evals`` to both packages, so
that only the Palantir stages are compared.  Tolerances:

* eigenvalues within 1e-4 and the eigenvector subspaces within 1e-3
  (the spectral norm of the part of one orthonormalised basis outside
  the other's span), at the largest eigengap and for all 15 components:
  60 float32 iterations in another summation order;
* ``dpt.pseudotime`` within 1e-4 (float32 norms of the same vectors);
* ``shortest_path_arrays`` within rtol 1e-6 (float32 sums of the same
  edge lengths and minima; in fact identical);
* ``directed_chain_arrays`` within 1e-5, on a graph with rows of an even
  number of valid slots (numpy's median averages the two middle values;
  ``torch.nanmedian`` would not);
* ``stationary_arrays`` within 1e-5 of the largest mass (100 power steps
  summed in another order);
* ``fate_probs_arrays`` with fixed terminal states within 1e-4, and at
  a 3,000-cell fixture its step count equal to that of a copy of the
  reference's loop with a counter (the reference returns B alone), at
  tol 1e-6 (both run to the 5,000-step cap) and 2e-4 (both stop on it);
* ``palantir.run``: the same terminal states, pseudotime within 1e-4,
  fate probabilities within 1e-3."""

import sys
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sctools_tpu as sct
from sctools_tpu.ops import palantir as ref_pal
import sctools_tpu_torch as sctt
from sctools_tpu_torch.carry import graph_from_numpy, spectral_v0_from_numpy
from sctools_tpu_torch.ops import graph_kernels
from sctools_tpu_torch.ops import palantir as port_pal
from sctools_tpu_torch.registry import apply

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_palantir import _branching_data  # noqa: E402

torch.set_num_threads(2)


def _np(v):
    return v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


@pytest.fixture(scope="module")
def branching():
    """The reference's branching fixture with its kNN graph and diffusion
    map, and the port's CellData on the same graph."""
    pts, t, branch = _branching_data()
    ds = sct.CellData(pts, obsm={"X_pca": pts})
    ds = sct.apply("neighbors.knn", ds, backend="tpu", k=15,
                   metric="euclidean")
    ds = sct.apply("embed.spectral", ds, backend="tpu")
    tp = torch.from_numpy(pts)
    p = graph_from_numpy(sctt.CellData(tp, obsm={"X_pca": tp}),
                         ds.obsp["knn_indices"], ds.obsp["knn_distances"],
                         knn_k=15, knn_metric="euclidean")
    return ds, p, t, branch


def _with_ref_diffmap(p, ds):
    n = p.n_cells
    return p.with_obsm(X_diffmap=torch.from_numpy(
        np.array(ds.obsm["X_diffmap"])[:n])).with_uns(
        diffmap_evals=torch.from_numpy(np.array(ds.uns["diffmap_evals"])))


def _subspace_gap(a, b):
    qa = np.linalg.qr(a)[0]
    qb = np.linalg.qr(b)[0]
    return float(np.linalg.norm(qa - qb @ (qb.T @ qa), 2))


# ---------------------------------------------------------- diffusion map


@pytest.mark.parametrize("op", ["embed.spectral", "embed.diffmap"])
def test_spectral_matches_reference_from_one_start_block(branching, op):
    ds, p, _, _ = branching
    n = p.n_cells
    v0 = jax.random.normal(jax.random.PRNGKey(0), (n, 15 + 1 + 5),
                           jnp.float32)
    ref = sct.apply(op, ds, backend="tpu")
    out = apply(op, p, device="cpu", v0=spectral_v0_from_numpy(v0))
    ev_r = np.asarray(ref.uns["diffmap_evals"])
    ev_p = _np(out.uns["diffmap_evals"])
    assert ev_p.shape == (15,) and (np.diff(ev_p) <= 0).all()
    np.testing.assert_allclose(ev_p, ev_r, atol=1e-4, rtol=0)
    X_r = np.asarray(ref.obsm["X_diffmap"])[:n]
    X_p = _np(out.obsm["X_diffmap"])
    assert X_p.shape == (n, 15)
    np.testing.assert_allclose(np.linalg.norm(X_p, axis=0), 1.0, rtol=1e-5)
    gap = int(np.argmax(ev_r[:-1] - ev_r[1:])) + 1
    assert _subspace_gap(X_p[:, :gap], X_r[:, :gap]) <= 1e-3
    assert _subspace_gap(X_p, X_r) <= 1e-3


def test_spectral_without_v0_draws_a_seeded_block(branching):
    _, p, _, _ = branching
    a = apply("embed.spectral", p, device="cpu", seed=3, n_comps=5)
    b = apply("embed.spectral", p, device="cpu", seed=3, n_comps=5)
    assert torch.equal(a.obsm["X_diffmap"], b.obsm["X_diffmap"])
    assert a.obsm["X_diffmap"].shape == (p.n_cells, 5)
    with pytest.raises(ValueError, match="v0"):
        apply("embed.spectral", p, device="cpu", v0=torch.zeros((4, 21)))


def test_dpt_matches_reference(branching):
    ds, p, _, _ = branching
    n = p.n_cells
    ref = sct.apply("dpt.pseudotime", ds, backend="tpu", root=7)
    out = apply("dpt.pseudotime", _with_ref_diffmap(p, ds), device="cpu",
                root=7)
    np.testing.assert_allclose(_np(out.obs["dpt_pseudotime"]),
                               np.asarray(ref.obs["dpt_pseudotime"])[:n],
                               atol=1e-4, rtol=0)
    assert out.uns["dpt_root"] == 7


# --------------------------------------------------------- Palantir stages


@pytest.fixture(scope="module")
def stages(branching):
    """Shared inputs of the stage tests: the graph with some rows cut to
    an even number of valid slots, the reference's multiscale space,
    edge lengths and pseudotime."""
    ds, _, t, _ = branching
    n = len(t)
    idx = np.array(ds.obsp["knn_indices"])[:n]
    idx[::3, -1] = -1  # 14 valid slots
    idx[::7, -3:] = -1  # 12 or 13
    ms = ref_pal.multiscale_space(np.asarray(ds.uns["diffmap_evals"]),
                                  np.asarray(ds.obsm["X_diffmap"])[:n])
    elen = ref_pal._edge_lengths(idx, ms)
    root = int(np.argmin(t))
    d = np.asarray(ref_pal.shortest_path_arrays(jnp.asarray(idx),
                                                jnp.asarray(elen), root))
    pt = d / d[np.isfinite(d)].max()
    p_ref = np.array(ref_pal.directed_chain_arrays(
        jnp.asarray(idx), jnp.asarray(ms), jnp.asarray(pt)))
    return idx, ms, elen, root, d, pt.astype(np.float32), p_ref


def test_multiscale_space_and_edge_lengths_equal_reference(branching,
                                                           stages):
    ds, _, t, _ = branching
    idx, ms, elen, _, _, _, _ = stages
    n = len(t)
    ev, vecs = np.asarray(ds.uns["diffmap_evals"]), np.asarray(
        ds.obsm["X_diffmap"])[:n]
    for n_eigs in (None, 4):
        np.testing.assert_array_equal(
            port_pal.multiscale_space(ev, vecs, n_eigs=n_eigs),
            ref_pal.multiscale_space(ev, vecs, n_eigs=n_eigs))
    np.testing.assert_array_equal(port_pal._edge_lengths(idx, ms), elen)


def test_shortest_path_matches_reference(stages):
    idx, _, elen, root, d, _, _ = stages
    out = port_pal.shortest_path_arrays(torch.from_numpy(idx),
                                        torch.from_numpy(elen), root)
    np.testing.assert_allclose(out.numpy(), d, rtol=1e-6)
    assert np.isfinite(d).all() and out[root] == 0


def test_directed_chain_matches_reference(stages):
    idx, ms, _, _, _, pt, p_ref = stages
    valid = (idx >= 0).sum(axis=1)
    assert (valid % 2 == 0).any() and (valid % 2 == 1).any()
    out = port_pal.directed_chain_arrays(
        torch.from_numpy(idx), torch.from_numpy(ms), torch.from_numpy(pt))
    np.testing.assert_allclose(out.numpy(), p_ref, atol=1e-5, rtol=0)
    assert (out.numpy()[idx < 0] == 0).all()


def test_nanmedian_is_numpys_rule():
    x = torch.tensor([[1.0, 4.0, float("nan"), 2.0, 8.0],
                      [3.0, float("nan"), 1.0, float("nan"), 2.0],
                      [float("nan")] * 5])
    np.testing.assert_array_equal(port_pal._nanmedian(x).numpy()[:2],
                                  [3.0, 2.0])
    assert torch.isnan(port_pal._nanmedian(x)[2])
    np.testing.assert_allclose(port_pal._nanstd(x).numpy()[:2],
                               np.nanstd(x.numpy()[:2], axis=1), rtol=1e-6)


def test_stationary_matches_reference(stages):
    idx, _, _, _, _, _, p_ref = stages
    ref = np.asarray(ref_pal.stationary_arrays(jnp.asarray(idx),
                                               jnp.asarray(p_ref)))
    out = port_pal.stationary_arrays(torch.from_numpy(idx),
                                     torch.from_numpy(p_ref)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5 * ref.max(), rtol=0)
    np.testing.assert_allclose(out.sum(), 1.0, rtol=1e-5)


def test_fate_probs_match_reference(branching, stages):
    _, _, t, branch = branching
    idx, _, _, _, _, _, p_ref = stages
    n = len(t)
    tips = [int(np.argmax(np.where(branch == b, t, -1))) for b in (1, 2)]
    onehot = np.zeros((n, 2), np.float32)
    onehot[tips, [0, 1]] = 1.0
    is_term = np.zeros(n, bool)
    is_term[tips] = True
    ref = np.asarray(ref_pal.fate_probs_arrays(
        jnp.asarray(idx), jnp.asarray(p_ref), jnp.asarray(onehot),
        jnp.asarray(is_term)))
    before = graph_kernels.matvec.launches
    out, steps = port_pal.fate_probs_arrays(
        torch.from_numpy(idx), torch.from_numpy(p_ref),
        torch.from_numpy(onehot), torch.from_numpy(is_term))
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4, rtol=0)
    assert 1 < steps <= 5000
    assert graph_kernels.matvec.launches == before  # plain on the CPU


def test_palantir_run_matches_reference(branching):
    ds, p, t, _ = branching
    n = len(t)
    root = int(np.argmin(t))
    ref = sct.apply("palantir.run", ds, backend="tpu", root=root).to_host()
    out = apply("palantir.run", _with_ref_diffmap(p, ds), device="cpu",
                root=root)
    np.testing.assert_array_equal(out.uns["palantir_terminal_states"],
                                  ref.uns["palantir_terminal_states"])
    assert len(out.uns["palantir_terminal_states"]) >= 1
    np.testing.assert_allclose(
        _np(out.obs["palantir_pseudotime"]),
        np.asarray(ref.obs["palantir_pseudotime"])[:n], atol=1e-4, rtol=0)
    B = _np(out.obsm["palantir_fate_probs"])
    np.testing.assert_allclose(
        B, np.asarray(ref.obsm["palantir_fate_probs"])[:n], atol=1e-3,
        rtol=0)
    np.testing.assert_allclose(B.sum(axis=1), 1.0, atol=1e-5)
    ent = _np(out.obs["palantir_entropy"])
    assert np.isfinite(ent).all()
    np.testing.assert_allclose(ent, np.asarray(
        ref.obs["palantir_entropy"])[:n], atol=1e-3, rtol=0)


def test_palantir_warns_on_cells_unreachable_from_the_root(branching):
    """Two copies of the trajectory far apart: no path joins them, so
    the deeper rerun still leaves half the cells unreachable; both
    packages warn, clamp their pseudotime to 1 and pick no terminal
    state among them."""
    ds, _, t, _ = branching
    n = len(t)
    idx = np.array(ds.obsp["knn_indices"])[:n]
    two = np.concatenate([idx, np.where(idx < 0, -1, idx + n)])
    dist = np.tile(np.array(ds.obsp["knn_distances"])[:n], (2, 1))
    X = np.concatenate([np.asarray(ds.X), np.asarray(ds.X) + 100.0])
    dm = np.tile(np.asarray(ds.obsm["X_diffmap"])[:n], (2, 1))
    ev = torch.from_numpy(np.array(ds.uns["diffmap_evals"]))
    p = graph_from_numpy(sctt.CellData(torch.from_numpy(X)), two, dist,
                         knn_k=15).with_obsm(
        X_diffmap=torch.from_numpy(dm)).with_uns(diffmap_evals=ev)
    root = int(np.argmin(t))
    with pytest.warns(UserWarning, match="unreachable"):
        out = apply("palantir.run", p, device="cpu", root=root,
                    sp_rounds=16)
    pt = _np(out.obs["palantir_pseudotime"])
    np.testing.assert_array_equal(pt[n:], 1.0)
    assert (out.uns["palantir_terminal_states"] < n).all()
    r = sct.CellData(X, obsm={"X_diffmap": dm},
                     obsp={"knn_indices": two, "knn_distances": dist},
                     uns={"diffmap_evals": np.asarray(ds.uns[
                         "diffmap_evals"])})
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        ref = sct.apply("palantir.run", r, backend="tpu", root=root,
                        sp_rounds=16).to_host()
    assert any("unreachable" in str(w.message) for w in caught)
    np.testing.assert_array_equal(out.uns["palantir_terminal_states"],
                                  ref.uns["palantir_terminal_states"])


def _ref_fate_loop_with_steps(knn_idx, p_edges, onehot, is_terminal,
                              n_iter: int = 5000, tol: float = 1e-6):
    """A copy of the reference's fate loop
    (``sctools_tpu/ops/palantir.py:fate_probs_arrays``) that also
    returns its step count: the reference returns B alone."""
    from sctools_tpu.ops.graph import knn_matvec

    self_mass = 1.0 - jnp.sum(jnp.where(knn_idx < 0, 0.0, p_edges), axis=1)
    B0 = onehot.astype(jnp.float32)

    def cond(carry):
        _, i, delta = carry
        return (i < n_iter) & (delta > tol)

    def step(carry):
        B, i, _ = carry
        Bn = knn_matvec(knn_idx, p_edges, B) + self_mass[:, None] * B
        Bn = jnp.where(is_terminal[:, None], onehot, Bn)
        return Bn, i + 1, jnp.max(jnp.abs(Bn - B))

    B, steps, _ = jax.jit(lambda: jax.lax.while_loop(
        cond, step, (B0, jnp.int32(0), jnp.float32(jnp.inf))))()
    return np.asarray(B), int(steps)


@pytest.fixture(scope="module")
def mid_chain():
    """The reference's directed chain on a 3,000-cell branching fixture,
    with the two branch tips as terminal states."""
    pts, t, branch = _branching_data(n=3000, seed=1)
    ds = sct.CellData(pts, obsm={"X_pca": pts})
    ds = sct.apply("neighbors.knn", ds, backend="tpu", k=15,
                   metric="euclidean")
    ds = sct.apply("embed.spectral", ds, backend="tpu")
    n = len(t)
    idx = np.array(ds.obsp["knn_indices"])[:n]
    ms = ref_pal.multiscale_space(np.asarray(ds.uns["diffmap_evals"]),
                                  np.asarray(ds.obsm["X_diffmap"])[:n])
    root = int(np.argmin(t))
    d = np.asarray(ref_pal.shortest_path_arrays(
        jnp.asarray(idx), jnp.asarray(ref_pal._edge_lengths(idx, ms)),
        root))
    pt = (d / d[np.isfinite(d)].max()).astype(np.float32)
    p_ref = np.array(ref_pal.directed_chain_arrays(
        jnp.asarray(idx), jnp.asarray(ms), jnp.asarray(pt)))
    tips = [int(np.argmax(np.where(branch == b, t, -1))) for b in (1, 2)]
    onehot = np.zeros((n, 2), np.float32)
    onehot[tips, [0, 1]] = 1.0
    is_term = np.zeros(n, bool)
    is_term[tips] = True
    return idx, p_ref, onehot, is_term


@pytest.mark.parametrize("tol, stop", [(1e-6, "cap"), (2e-4, "tol")])
def test_fate_loop_stops_at_the_reference_step(mid_chain, tol, stop):
    """At a mid-size fixture (3,000 cells) the port's fate loop takes the
    reference's number of steps and reaches its B: at the default tol
    both run to the 5,000-step cap (as at 68,579 cells on the card), at
    a looser tol both stop on it."""
    idx, p_ref, onehot, is_term = mid_chain
    args = [jnp.asarray(a) for a in (idx, p_ref, onehot, is_term)]
    ref_B, ref_steps = _ref_fate_loop_with_steps(*args, tol=tol)
    np.testing.assert_array_equal(  # the copy is the reference's loop
        ref_B, np.asarray(ref_pal.fate_probs_arrays(*args, tol=tol)))
    B, steps = port_pal.fate_probs_arrays(
        *[torch.from_numpy(a) for a in (idx, p_ref, onehot, is_term)],
        tol=tol)
    print(f"fate loop at tol {tol}: reference {ref_steps} steps, port "
          f"{steps}")
    assert (ref_steps == 5000) == (stop == "cap")
    assert steps == ref_steps
    np.testing.assert_allclose(B.numpy(), ref_B, atol=1e-4, rtol=0)
