"""The whole slice — QC → normalize → log1p → HVG → PCA → cosine kNN —
through both packages' ``Pipeline`` on the same synthetic counts, with
the reference's PCA sketch carried over.

Checks: the same HVG set; X_pca within the PCA tolerance (1e-3 ×
max|score| after aligning signs); kNN neighbour sets agreeing on ≥ 0.99
of (row, neighbour) pairs (near-ties in the last bits of the scores may
swap the k-th neighbour); recall@10 = 1.0 against the float64 oracle on
the port's own X_pca; and a run from the reference's ELL planes
(``carry.cells_from_numpy``) equal to a run from the port's own
packing."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sctools_tpu as sct
from sctools_tpu.data.synthetic import synthetic_counts as ref_counts
from sctools_tpu.ops.pca import _sketch_omega
from sctools_tpu_torch import Pipeline
from sctools_tpu_torch.carry import cells_from_numpy, pca_omega_from_numpy
from sctools_tpu_torch.data.synthetic import synthetic_counts
from sctools_tpu_torch.ops.knn import knn_numpy, recall_at_k

torch.set_num_threads(2)

N_CELLS, N_GENES, N_TOP, N_PCS, K = 600, 800, 200, 20, 10


def _steps(omega=None):
    pca = {"n_components": N_PCS}
    if omega is not None:
        pca["omega"] = omega
    return [("qc.per_cell_metrics", {}),
            ("normalize.library_size", {"target_sum": 1e4}),
            ("normalize.log1p", {}),
            ("hvg.select", {"n_top": N_TOP, "subset": True}),
            ("pca.randomized", pca),
            ("neighbors.knn", {"k": K, "metric": "cosine"})]


@pytest.fixture(scope="module")
def runs():
    host = ref_counts(N_CELLS, N_GENES, density=0.05, n_clusters=3, seed=6)
    ref = sct.Pipeline(_steps()).run(host.device_put(),
                                     backend="tpu").to_host()
    L = min(N_PCS + 10, N_TOP, N_CELLS)
    omega = pca_omega_from_numpy(np.asarray(
        _sketch_omega(jax.random.PRNGKey(0), N_TOP, L, jnp.float32)))
    pipe = Pipeline(_steps(omega))
    own = pipe.run(synthetic_counts(N_CELLS, N_GENES, density=0.05,
                                    n_clusters=3, seed=6), device="cpu")
    planes = host.device_put().X
    carried = pipe.run(cells_from_numpy(
        np.asarray(planes.indices), np.asarray(planes.data),
        planes.n_cells, planes.n_genes, obs=host.obs, var=host.var),
        device="cpu")
    return ref, own.to_host(), carried.to_host()


def test_same_hvg_set(runs):
    ref, port, _ = runs
    np.testing.assert_array_equal(port.var["gene_name"],
                                  ref.var["gene_name"])
    assert port.n_genes == N_TOP


def test_qc_columns(runs):
    ref, port, _ = runs
    np.testing.assert_array_equal(port.obs["n_genes"], ref.obs["n_genes"])
    np.testing.assert_allclose(port.obs["pct_counts_mt"],
                               ref.obs["pct_counts_mt"], rtol=1e-6,
                               atol=1e-6)


def test_x_pca_within_pca_tolerance(runs):
    ref, port, _ = runs
    r, p = ref.obsm["X_pca"], port.obsm["X_pca"]
    assert p.shape == r.shape == (N_CELLS, N_PCS)
    sign = np.sign(np.sum(p * r, axis=0))
    np.testing.assert_allclose(p * sign, r, rtol=0,
                               atol=1e-3 * np.abs(r).max())
    np.testing.assert_allclose(port.uns["pca_explained_variance"],
                               ref.uns["pca_explained_variance"], rtol=1e-4)


def test_knn_agrees_with_reference_and_oracle(runs):
    ref, port, _ = runs
    p_idx = port.obsp["knn_indices"]
    assert p_idx.shape == (N_CELLS, K) and p_idx.dtype == np.int32
    assert recall_at_k(p_idx, ref.obsp["knn_indices"]) >= 0.99
    oracle, _ = knn_numpy(port.obsm["X_pca"], port.obsm["X_pca"], k=K,
                          metric="cosine")
    assert recall_at_k(p_idx, oracle, k=10) == 1.0
    d = port.obsp["knn_distances"]
    assert np.isfinite(d).all() and (np.diff(d, axis=1) >= 0).all()


def test_carried_planes_give_the_same_run(runs):
    _, own, carried = runs
    assert (own.X != carried.X).nnz == 0
    for key in ("X_pca",):
        np.testing.assert_array_equal(own.obsm[key], carried.obsm[key])
    for key in ("knn_indices", "knn_distances"):
        np.testing.assert_array_equal(own.obsp[key], carried.obsp[key])
