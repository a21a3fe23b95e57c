"""``integrate.ingest`` of the port against the JAX reference on the same
inputs.

The fixture is ``tests/test_ingest.py``'s: one generative process of
1,500 cells, library-size normalised and log1p'd, split into a
1,200-cell reference (``pca.exact``, 20 components) and a 300-cell
query; the query's padded-ELL planes are carried to the port
(``carry.cells_from_numpy``).  The reference runs ``backend="tpu"`` on
the CPU.  Tolerances, and why:

* X_pca: rtol 1e-5 with an atol of 2e-5 (1.5e-6 of the scale) for
  scores near zero: each is a float32 sum over a row's stored slots
  minus μ·PCs, added in another order by each package (1.2e-5 apart
  at most here);
* the transferred labels: equal (the same neighbours; a vote decided
  by a near-tie of two float32 distances would be the only exception,
  and none occurs);
* confidences, the numeric column and the interpolated embedding:
  within 1e-6 (float64 sums of weights from float32 distances that
  agree within ~1e-7).
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import sctools_tpu as sct
from sctools_tpu.data.synthetic import synthetic_counts
import sctools_tpu_torch as sctt
from sctools_tpu_torch.carry import cells_from_numpy

torch.set_num_threads(2)

X_PCA_TOL = dict(rtol=1e-5, atol=2e-5)
VALUE_TOL = 1e-6


def _prepped(n, seed, n_clusters=4):
    d = synthetic_counts(n, 600, density=0.15, n_clusters=n_clusters,
                         seed=seed)
    d = sct.apply("normalize.library_size", d, backend="cpu",
                  target_sum=1e4)
    return sct.apply("normalize.log1p", d, backend="cpu")


def _port_ref(ref) -> "sctt.CellData":
    return sctt.CellData(ref.X, obs=dict(ref.obs), var=dict(ref.var),
                         obsm=dict(ref.obsm), varm=dict(ref.varm),
                         uns=dict(ref.uns))


def _port_query(q_dev, var) -> "sctt.CellData":
    return cells_from_numpy(np.asarray(q_dev.X.indices),
                            np.asarray(q_dev.X.data), q_dev.n_cells,
                            q_dev.n_genes, var=dict(var))


@pytest.fixture(scope="module")
def ref_query():
    full = _prepped(1500, seed=0)
    Xf = full.X.tocsr()
    truth = np.asarray(full.obs["cluster_true"])
    ref = full.with_X(Xf[:1200])
    query = full.with_X(Xf[1200:])
    ref = sct.apply("pca.exact", ref, backend="cpu", n_components=20)
    ref = ref.with_obs(cell_type=np.array(
        [f"type_{c}" for c in truth[:1200]]))
    ref = ref.with_obs(depth=truth[:1200].astype(np.float64) * 2.0 + 1.0)
    ref = ref.with_obsm(X_umap=np.asarray(
        ref.obsm["X_pca"])[:, :2].astype(np.float64))
    q_dev = query.device_put()
    return (ref, q_dev, _port_ref(ref), _port_query(q_dev, query.var),
            np.array([f"type_{c}" for c in truth[1200:]]))


def _compare(got, want, n):
    np.testing.assert_allclose(got.obsm["X_pca"].numpy(),
                               np.asarray(want.obsm["X_pca"]), **X_PCA_TOL)
    assert got.obsm["X_pca"].shape[0] == n
    np.testing.assert_array_equal(got.obs["cell_type"],
                                  np.asarray(want.obs["cell_type"]))
    for key in ("cell_type_confidence", "depth"):
        np.testing.assert_allclose(got.obs[key], np.asarray(want.obs[key]),
                                   rtol=VALUE_TOL, atol=VALUE_TOL,
                                   err_msg=key)
    np.testing.assert_allclose(got.obsm["X_umap"],
                               np.asarray(want.obsm["X_umap"]),
                               rtol=VALUE_TOL, atol=VALUE_TOL)


@pytest.mark.parametrize("k,metric,refine", [(10, "cosine", 64),
                                             (15, "cosine", 64),
                                             (15, "euclidean", 32),
                                             (5, "correlation", 0)])
def test_ingest_matches_the_reference(ref_query, k, metric, refine):
    ref, q_dev, port_ref, port_q, truth = ref_query
    kw = dict(obs=("cell_type", "depth"), k=k, metric=metric, refine=refine)
    want = sct.apply("integrate.ingest", q_dev, backend="tpu", ref=ref, **kw)
    got = sctt.apply("integrate.ingest", port_q, device="cpu", ref=port_ref,
                     **kw)
    _compare(got, want, 300)
    assert (got.obs["cell_type"] == truth).mean() > 0.85


def test_dense_query_and_a_device_reference(ref_query):
    ref, q_dev, port_ref, port_q, _ = ref_query
    kw = dict(obs=("cell_type", "depth"), k=10)
    dense = q_dev.replace(X=q_dev.X.to_dense())
    want = sct.apply("integrate.ingest", dense, backend="tpu", ref=ref, **kw)
    got = sctt.apply("integrate.ingest", port_q.with_X(port_q.X.to_dense()),
                     device="cpu", ref=port_ref.to_device("cpu"), **kw)
    _compare(got, want, 300)


def test_ingest_against_the_float64_oracle(ref_query):
    ref, q_dev, port_ref, port_q, _ = ref_query
    kw = dict(obs=("cell_type", "depth"), k=10)
    got = sctt.apply("integrate.ingest", port_q, device="cpu", ref=port_ref,
                     **kw)
    oracle = sct.apply("integrate.ingest", q_dev.to_host(), backend="cpu",
                       ref=ref, **kw)
    # the reference test's bound between its two backends
    assert (got.obs["cell_type"] == np.asarray(
        oracle.obs["cell_type"])).mean() > 0.97


def test_projection_reuses_the_reference_s_loadings(ref_query):
    """Reprojecting the reference's own matrix gives its stored scores,
    and X_pca is never interpolated from the neighbours."""
    ref, _, port_ref, _, _ = ref_query
    again = sctt.apply("integrate.ingest", port_ref.with_X(ref.X), device="cpu",
                       ref=port_ref, embeddings=("X_pca", "X_umap"), k=5)
    np.testing.assert_allclose(again.obsm["X_pca"].numpy(),
                               np.asarray(ref.obsm["X_pca"]), rtol=1e-4,
                               atol=1e-5)
    emb = again.obsm["X_umap"]
    R = np.asarray(ref.obsm["X_umap"])
    assert emb.shape == (1200, 2)
    assert (emb.min(0) >= R.min(0) - 1e-9).all()
    assert (emb.max(0) <= R.max(0) + 1e-9).all()


def test_ingest_refusals(ref_query):
    _, _, port_ref, port_q, _ = ref_query
    bad = _prepped(50, seed=2)
    narrow = sctt.CellData(sp.csr_matrix(bad.X.toarray()[:, :100]))
    with pytest.raises(ValueError, match="genes"):
        sctt.apply("integrate.ingest", narrow, device="cpu", ref=port_ref)
    names = np.array(port_ref.var["gene_name"]).copy()
    names[[3, 4]] = names[[4, 3]]
    with pytest.raises(ValueError, match="gene names differ"):
        sctt.apply("integrate.ingest", port_q.with_var(gene_name=names),
                   device="cpu", ref=port_ref)
    with pytest.raises(ValueError, match="PCs"):
        sctt.apply("integrate.ingest", port_q, device="cpu", ref=port_q)
    with pytest.raises(KeyError, match="not in reference"):
        sctt.apply("integrate.ingest", port_q, device="cpu", ref=port_ref,
                   obs=("nope",))
