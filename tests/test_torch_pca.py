"""Randomized PCA of the port against the JAX reference.

With the reference's own sketch carried over (``carry.pca_omega_from_
numpy``) both packages run the same arithmetic: explained variance
within rtol 1e-4 and scores within 1e-3 × max|score| after aligning each
component's sign (float32 CholeskyQR2 and SVD in two libraries).  With
the port's own ``torch.Generator`` sketch the numbers differ, so the
subspace is compared, on a matrix whose top 10 components are
separated from the rest: principal angles to the reference's top 10
components under 1e-2 rad."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import sctools_tpu as sct
from sctools_tpu.data import sparse as ref_sparse
from sctools_tpu.data.synthetic import synthetic_counts as ref_counts
from sctools_tpu.ops.pca import _sketch_omega
from sctools_tpu_torch.carry import cells_from_numpy, pca_omega_from_numpy
from sctools_tpu_torch.data import dataset as port_dataset
from sctools_tpu_torch.data import sparse as port_sparse
from sctools_tpu_torch.ops import pca as port_pca
from sctools_tpu_torch.registry import apply

torch.set_num_threads(2)

N_PCS = 20


@pytest.fixture(scope="module")
def both():
    """Normalised, log1p'd, HVG-subset data in both packages."""
    ref = sct.Pipeline([
        ("normalize.library_size", {"target_sum": 1e4}),
        ("normalize.log1p", {}),
        ("hvg.select", {"n_top": 200, "subset": True}),
    ]).run(ref_counts(600, 800, density=0.05, n_clusters=3,
                      seed=4).device_put(), backend="tpu")
    port = cells_from_numpy(np.asarray(ref.X.indices),
                            np.asarray(ref.X.data), ref.n_cells,
                            ref.n_genes)
    return ref, port


def _ref_pca(ref, seed=0):
    out = sct.apply("pca.randomized", ref, backend="tpu",
                    n_components=N_PCS, seed=seed)
    return (np.asarray(out.obsm["X_pca"]), np.asarray(out.varm["PCs"]),
            np.asarray(out.uns["pca_explained_variance"]))


def _align_signs(a, b):
    """Flip the columns of ``a`` to point along those of ``b``."""
    s = np.sign(np.sum(a * b, axis=0))
    s[s == 0] = 1.0
    return a * s


def test_injected_sketch_matches_reference(both):
    ref, port = both
    G = ref.n_genes
    L = min(N_PCS + 10, G, ref.n_cells)
    omega = np.asarray(_sketch_omega(jax.random.PRNGKey(0), G, L,
                                     jnp.float32))
    r_scores, r_comps, r_expl = _ref_pca(ref, seed=0)
    out = apply("pca.randomized", port, device="cpu", n_components=N_PCS,
                omega=pca_omega_from_numpy(omega))
    p_scores = out.obsm["X_pca"].numpy()
    p_comps = out.varm["PCs"].numpy()
    np.testing.assert_allclose(out.uns["pca_explained_variance"].numpy(),
                               r_expl, rtol=1e-4)
    assert p_scores.shape == r_scores.shape
    tol = 1e-3 * np.abs(r_scores).max()
    np.testing.assert_allclose(_align_signs(p_scores, r_scores), r_scores,
                               atol=tol, rtol=0)
    np.testing.assert_allclose(_align_signs(p_comps, r_comps), r_comps,
                               atol=1e-3, rtol=0)
    # padding rows of the scores stay zero
    assert not p_scores[ref.n_cells:].any()


def _principal_angles(a, b):
    qa, _ = np.linalg.qr(a)
    qb, _ = np.linalg.qr(b)
    s = np.linalg.svd(qa.T @ qb, compute_uv=False)
    return np.arccos(np.clip(s, -1.0, 1.0))


@pytest.fixture(scope="module")
def low_rank():
    """A matrix whose top 10 components are well separated from the rest
    (singular values 100..55 over noise of ~3): there the top-10
    subspace is determined, whatever the sketch.  On the synthetic
    counts above the spectrum is flat past the third component, and two
    randomized PCAs from different sketches disagree on it."""
    rng = np.random.default_rng(5)
    n, G, r = 600, 200, 10
    U, _ = np.linalg.qr(rng.normal(size=(n, r)))
    V, _ = np.linalg.qr(rng.normal(size=(G, r)))
    S = np.linspace(100.0, 55.0, r)
    X = ((U * S) @ V.T + 0.1 * rng.normal(size=(n, G))).astype(np.float32)
    csr = sp.csr_matrix(X)
    ref = sct.CellData(ref_sparse.SparseCells.from_scipy_csr(csr)
                       .device_put())
    port = port_dataset.CellData(
        port_sparse.SparseCells.from_scipy_csr(csr))
    return ref, port


@pytest.mark.parametrize("seed", [0, 1])
def test_own_sketch_spans_reference_subspace(low_rank, seed):
    ref, port = low_rank
    _, r_comps, r_expl = _ref_pca(ref)
    out = apply("pca.randomized", port, device="cpu", n_components=N_PCS,
                seed=seed)
    p_comps = out.varm["PCs"].numpy()
    angles = _principal_angles(p_comps[:, :10], r_comps[:, :10])
    assert angles.max() < 1e-2, angles
    np.testing.assert_allclose(
        out.uns["pca_explained_variance"].numpy()[:10], r_expl[:10],
        rtol=1e-4)


def test_cholesky_qr_orthonormalises():
    y = torch.from_numpy(np.random.default_rng(0).normal(
        size=(300, 30)).astype(np.float32))
    q = port_pca.cholesky_qr(y)
    np.testing.assert_allclose((q.T @ q).numpy(), np.eye(30), atol=1e-5)
    # same column space as y
    assert _principal_angles(q.numpy(), y.numpy()).max() < 1e-3


def test_householder_and_bad_omega(both):
    _, port = both
    a = port_pca.randomized_pca_arrays(port.X, n_components=8,
                                       qr_method="householder")
    b = port_pca.randomized_pca_arrays(port.X, n_components=8)
    np.testing.assert_allclose(a[2].numpy(), b[2].numpy(), rtol=1e-4)
    with pytest.raises(ValueError, match="omega"):
        port_pca.randomized_pca_arrays(port.X, n_components=8,
                                       omega=torch.zeros((3, 3)))
