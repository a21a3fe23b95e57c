"""``qc.doublet_score`` of the port against the JAX reference, and the
exact kNN's plain version at the k the doublet search takes.

Both packages take the reference's fixture (``tests/test_doublet.py``,
rebuilt here): ``synthetic_counts(600, 400, n_clusters=4)`` with 60
cross-cluster doublets appended, as the same padded-ELL planes
(``carry.cells_from_numpy``).  The reference runs ``backend="tpu"`` on
the CPU and its float64 oracle ``backend="cpu"``.  Tolerances:

* the doublet projection within 1e-5 (rtol, atol 1e-5): the same
  float32 merge, log1p and contraction, summed in another order;
* the whole op with the reference's PCA sketch carried in
  (``carry.pca_omega_from_numpy``): the embeddings within 1e-4 of their
  scale, and the scores equal to the reference oracle's
  ``_neighbor_scores`` on the port's embeddings (both float64
  ``knn_numpy``), and within rtol 1e-6 of the reference's ``tpu`` scores
  (float32 likelihood there, float64 here);
* ``knn_select_plain`` at k = 300 and 393 against ``knn_numpy``: sorted
  distances within rtol 1e-5, ids equal but for near-ties (recall
  ≥ 0.999).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import sctools_tpu as sct
from sctools_tpu.data.sparse import SparseCells as RefSparse
from sctools_tpu.data.synthetic import synthetic_counts as ref_counts
from sctools_tpu.ops import doublet as rdoublet
from sctools_tpu.ops.pca import _sketch_omega
import sctools_tpu_torch as sctt
from sctools_tpu_torch.carry import cells_from_numpy, pca_omega_from_numpy
from sctools_tpu_torch.ops import doublet as pdoublet
from sctools_tpu_torch.ops import knn_kernel
from sctools_tpu_torch.ops.knn import knn_numpy, recall_at_k

torch.set_num_threads(2)

N_COMPONENTS = 20


def _auc(pos, neg):
    """Rank-based AUC: P(score_pos > score_neg)."""
    all_s = np.concatenate([pos, neg])
    order = np.argsort(np.argsort(all_s))
    r_pos = order[: len(pos)] + 1
    return (r_pos.sum() - len(pos) * (len(pos) + 1) / 2) / (
        len(pos) * len(neg))


@pytest.fixture(scope="module")
def doublet_data():
    """(reference CellData, port CellData on the CPU, is_doublet): the
    counts with 60 injected cross-cluster doublets appended."""
    base = ref_counts(600, 400, n_clusters=4, density=0.08, seed=3)
    X = base.X.tocsr()
    labels = np.asarray(base.obs["cluster_true"])
    rng = np.random.default_rng(7)
    n_dbl = 60
    i = rng.integers(0, X.shape[0], size=4 * n_dbl)
    j = rng.integers(0, X.shape[0], size=4 * n_dbl)
    keep = np.flatnonzero(labels[i] != labels[j])[:n_dbl]
    Xall = sp.vstack([X, X[i[keep]] + X[j[keep]]]).tocsr()
    is_doublet = np.zeros(Xall.shape[0], bool)
    is_doublet[X.shape[0]:] = True
    ref = sct.CellData(Xall, var=dict(base.var))
    ell = RefSparse.from_scipy_csr(Xall)
    port = cells_from_numpy(np.asarray(ell.indices), np.asarray(ell.data),
                            Xall.shape[0], Xall.shape[1])
    return ref, port, is_doublet


def _omega(n_genes: int, n_cells: int) -> torch.Tensor:
    L = min(N_COMPONENTS + 10, n_genes, n_cells)
    return pca_omega_from_numpy(np.asarray(_sketch_omega(
        jax.random.PRNGKey(0), n_genes, L, jnp.float32)))


def test_projection_matches_reference(doublet_data):
    ref, port, _ = doublet_data
    n, G = ref.shape
    rng = np.random.default_rng(0)
    comps = (rng.standard_normal((G, 16)) * 0.1).astype(np.float32)
    mu = (rng.standard_normal(G) * 0.1).astype(np.float32)
    pairs = rdoublet._sample_pairs(n, 256, seed=1)
    np.testing.assert_array_equal(pairs, pdoublet._sample_pairs(n, 256, 1))
    ell = ref.device_put().X
    want = np.asarray(rdoublet._project_doublets(
        ell.indices, ell.data, jnp.asarray(pairs), jnp.asarray(comps),
        jnp.asarray(mu), 1e4, block=128))
    got = pdoublet.project_doublets(
        port.X, torch.from_numpy(pairs), torch.from_numpy(comps),
        torch.from_numpy(mu), 1e4, block=128).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # and the exact CSR sums in float64
    X = ref.X
    dbl = X[pairs[:, 0]] + X[pairs[:, 1]]
    tot = np.asarray(dbl.sum(axis=1)).ravel()
    dbl = sp.diags(np.where(tot > 0, 1e4 / tot, 0.0)) @ dbl
    dbl.data = np.log1p(dbl.data)
    np.testing.assert_allclose(got, dbl @ comps - mu @ comps, rtol=2e-4,
                               atol=2e-4)


@pytest.fixture(scope="module")
def both_runs(doublet_data):
    ref, port, _ = doublet_data
    r = sct.apply("qc.doublet_score", ref.device_put(), backend="tpu",
                  n_components=N_COMPONENTS, seed=0).to_host()
    p = sctt.apply("qc.doublet_score", port, device="cpu",
                   n_components=N_COMPONENTS, seed=0,
                   omega=_omega(ref.n_genes, ref.n_cells))
    return r, p


def test_doublet_score_matches_reference(doublet_data, both_runs):
    ref, port, _ = doublet_data
    r, p = both_runs
    got = p.obs["doublet_score"].numpy()
    np.testing.assert_allclose(got, np.asarray(r.obs["doublet_score"]),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(p.uns["doublet_sim_scores"].numpy(),
                               np.asarray(r.uns["doublet_sim_scores"]),
                               rtol=1e-6, atol=1e-7)
    assert p.uns["doublet_expected_rate"] == 0.06
    # the scores are the reference oracle's on the port's embeddings
    obs, sim = pdoublet.doublet_embeddings(
        port.X, n_components=N_COMPONENTS,
        omega=_omega(ref.n_genes, ref.n_cells))
    n = ref.n_cells
    _, _, k_adj = rdoublet._resolve_params(n, 2.0, None)
    want_obs, want_sim = rdoublet._neighbor_scores(
        obs.numpy(), sim.numpy(), n, sim.shape[0], k_adj, "euclidean",
        0.06, backend="cpu")
    np.testing.assert_array_equal(got, want_obs)
    np.testing.assert_array_equal(p.uns["doublet_sim_scores"].numpy(),
                                  want_sim)


def test_embeddings_match_reference(doublet_data):
    """The observed PCA (sketch carried) and the simulated projection
    against the reference's, component signs matched."""
    ref, port, _ = doublet_data
    from sctools_tpu.ops.normalize import _library_size_sparse
    from sctools_tpu.ops.pca import randomized_pca_arrays

    dev = ref.device_put()
    x_scaled, _ = _library_size_sparse(dev.X, 1e4)
    x_norm = x_scaled.with_data(jnp.log1p(x_scaled.data))
    r_obs, comps, _, mu = randomized_pca_arrays(
        x_norm, jax.random.PRNGKey(0), n_components=N_COMPONENTS)
    n = ref.n_cells
    n_sim = rdoublet._resolve_params(n, 2.0, None)[0]
    r_sim = rdoublet._project_doublets(
        dev.X.indices, dev.X.data,
        jnp.asarray(rdoublet._sample_pairs(n, n_sim, 0)), comps, mu, 1e4)
    obs, sim = pdoublet.doublet_embeddings(
        port.X, n_components=N_COMPONENTS,
        omega=_omega(ref.n_genes, ref.n_cells))
    r_obs, r_sim = np.asarray(r_obs)[:n], np.asarray(r_sim)
    sign = np.sign((r_obs * obs.numpy()).sum(axis=0))
    scale = np.abs(r_obs).max()
    np.testing.assert_allclose(obs.numpy() * sign, r_obs,
                               atol=1e-4 * scale)
    np.testing.assert_allclose(sim.numpy() * sign, r_sim,
                               atol=1e-4 * scale)


def test_doublet_separation(doublet_data, both_runs):
    _, _, is_doublet = doublet_data
    _, p = both_runs
    s = p.obs["doublet_score"].numpy()
    assert np.all((s >= 0) & (s <= 1))
    assert _auc(s[is_doublet], s[~is_doublet]) > 0.75
    assert p.uns["doublet_sim_scores"].numpy().mean() > s[~is_doublet].mean()


def test_threshold_prediction(doublet_data):
    _, port, _ = doublet_data
    out = sctt.apply("qc.doublet_score", port, device="cpu", threshold=0.5,
                     n_components=N_COMPONENTS)
    pred = out.obs["predicted_doublet"]
    assert pred.dtype == torch.bool and pred.shape[0] == port.n_cells
    assert out.uns["doublet_threshold"] == 0.5
    assert torch.equal(pred, out.obs["doublet_score"] > 0.5)


def test_doublet_validates(doublet_data):
    ref, _, _ = doublet_data
    dense = sctt.CellData(torch.from_numpy(ref.X.toarray()))
    with pytest.raises(TypeError, match="sparse raw counts"):
        sctt.apply("qc.doublet_score", dense, device="cpu")
    with pytest.raises(TypeError):
        sct.apply("qc.doublet_score", ref.replace(
            X=jnp.asarray(ref.X.toarray())), backend="tpu")


@pytest.mark.parametrize("k,metric", [(300, "euclidean"), (393, "euclidean"),
                                      (393, "cosine"), (600, "euclidean")])
def test_knn_select_plain_at_large_k(k, metric):
    """The plain version of the exact kernel at k above the register
    lists' 256 (600: past the former cap of 512, the doublet search's
    k_adj at k = 200), self excluded, against the float64 oracle."""
    rng = np.random.default_rng(k)
    x = rng.normal(size=(700, 12)).astype(np.float32)
    q = torch.from_numpy(x)
    if metric == "cosine":
        q = q / torch.linalg.vector_norm(q, dim=1, keepdim=True)
    vals, ids = knn_kernel.knn_select(q, q, k=k, metric=metric,
                                      exclude_self=True)
    assert vals.shape == (700, k) and ids.dtype == torch.int32
    want_i, want_d = knn_numpy(x, x, k=k, metric=metric, exclude_self=True)
    got_d = (torch.sqrt(torch.clamp(-vals, min=0.0)) if metric ==
             "euclidean" else 1.0 - vals).numpy()
    np.testing.assert_allclose(got_d, want_d, rtol=1e-5, atol=1e-5)
    assert recall_at_k(ids.numpy(), want_i) >= 0.999
    assert not (ids.numpy() == np.arange(700)[:, None]).any()
