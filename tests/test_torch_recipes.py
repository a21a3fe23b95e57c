"""The port's preprocessing recipes against the JAX reference's: the
``zheng17``, ``seurat``, ``pearson_residuals``, ``atlas_knn`` and
``annotation_reference`` pipelines (``recipe_pipeline``), and the
one-call ops ``recipe.zheng17``, ``recipe.seurat``,
``recipe.pearson_residuals`` and ``recipe.weinreb17``.

Both packages start from the reference's ``synthetic_counts`` (600 ×
800, its padded-ELL planes carried by ``carry.cells_from_numpy``).  The
reference runs ``backend="tpu"`` on the CPU (its one-call ops fused, as
they always run); the port ``device="cpu"``, each step unfused.  Where a
recipe runs ``pca.randomized`` the reference's sketch is carried in: the
test registers, for its duration, a ``pca.randomized`` that passes it as
``omega=`` (torch cannot draw ``jax.random``'s bits).  Tolerances
(those of tests/test_torch_qc_normalize.py):

* kept cells and genes: exact; ``layers["counts"]`` equal to the raw
  counts subset to them;
* X after ``scale`` / ``pearson_residuals``: rtol 1e-5, atol 1e-5;
* HVG subsets: identical; weinreb17's mean/CV filter: identical gene
  sets, or every differing gene within 1e-6 relative of a threshold
  (printed);
* PCA: explained variance rtol 1e-4, scores within 1e-3 × max|score|
  and components within 1e-3 after aligning signs;
* atlas_knn's kNN: recall@15 ≥ 0.99 against the reference's lists (the
  embeddings agree to 1e-3, so near-ties may swap).
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sctools_tpu as sct
from sctools_tpu.data.synthetic import synthetic_counts as ref_counts
from sctools_tpu.ops.pca import _sketch_omega
from sctools_tpu.recipes import recipe_pipeline as ref_recipe
import sctools_tpu_torch as sctt
from sctools_tpu_torch.carry import cells_from_numpy, pca_omega_from_numpy
from sctools_tpu_torch.registry import apply

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_qc_normalize import (  # noqa: E402
    TOL, _np, _same_pca)

torch.set_num_threads(2)

N_CELLS, N_GENES, N_TOP, N_PCS = 600, 800, 200, 20

PIPELINE_KW = {
    "zheng17": dict(n_top_genes=N_TOP),
    "seurat": dict(n_top_genes=N_TOP, min_genes=30),
    "pearson_residuals": dict(n_top_genes=N_TOP, n_components=N_PCS),
    "atlas_knn": dict(n_top_genes=N_TOP, n_components=N_PCS),
    "annotation_reference": dict(n_components=N_PCS),
}
ONE_CALL_KW = {
    "recipe.zheng17": dict(n_top_genes=N_TOP),
    "recipe.seurat": dict(n_top_genes=N_TOP, min_genes=30),
    "recipe.pearson_residuals": dict(n_top_genes=N_TOP,
                                     n_components=N_PCS),
}


@pytest.fixture(scope="module")
def raw():
    host = ref_counts(N_CELLS, N_GENES, density=0.05, n_clusters=3, seed=2)
    host = host.replace(obs={**host.obs,
                             "cell_id": np.arange(N_CELLS, dtype=np.int32)})
    ref = host.device_put()
    port = cells_from_numpy(np.asarray(ref.X.indices),
                            np.asarray(ref.X.data), ref.n_cells,
                            ref.n_genes, obs=host.obs, var=host.var)
    return host, ref, port


def _carry_sketch(monkeypatch, ref_out):
    """Make the port's ``pca.randomized`` use the reference's sketch for
    the PCA of ``ref_out``'s genes while the test runs."""
    if "X_pca" not in ref_out.obsm:
        return
    G = ref_out.n_genes
    L = min(N_PCS + 10, G, ref_out.n_cells)
    omega = pca_omega_from_numpy(np.asarray(_sketch_omega(
        jax.random.PRNGKey(0), G, L, jnp.float32)))
    pca = sctt.registry.get("pca.randomized")
    monkeypatch.setitem(sctt.registry._REGISTRY["pca.randomized"], "cuda",
                        lambda data, **kw: pca(data, omega=omega, **kw))


def _check_counts_layer(host, p):
    """``layers["counts"]`` is the raw counts subset to the kept cells
    and genes."""
    cells = _np(p.obs["cell_id"])[: p.n_cells]
    names = list(np.asarray(host.var["gene_name"]))
    genes = [names.index(g) for g in p.var["gene_name"]]
    want = host.X.toarray()[np.ix_(cells, genes)]
    np.testing.assert_array_equal(_np(p.layers["counts"]), want)


def _check_same(host, r, p):
    """Same cells, genes (the HVG subsets included), values, raw counts
    layer and PCA."""
    assert p.shape == r.shape
    np.testing.assert_array_equal(_np(p.obs["cell_id"])[: p.n_cells],
                                  _np(r.obs["cell_id"])[: r.n_cells])
    np.testing.assert_array_equal(p.var["gene_name"],
                                  np.asarray(r.var["gene_name"]))
    np.testing.assert_allclose(_np(p.X), _np(r.X), **TOL)
    if "counts" in r.layers:
        _check_counts_layer(host, p)
    if "X_pca" in r.obsm:
        _same_pca(p, r, r.n_cells)


@pytest.mark.parametrize("name", sorted(PIPELINE_KW))
def test_pipeline_recipe_matches_reference(raw, name, monkeypatch):
    host, ref, port = raw
    kw = PIPELINE_KW[name]
    r = ref_recipe(name, **kw).run(ref, backend="tpu")
    _carry_sketch(monkeypatch, r)
    pipe = sctt.recipe_pipeline(name, **kw)
    assert [t.name for t in pipe] == [t.name for t in ref_recipe(name,
                                                                 **kw)]
    p = pipe.run(port, device="cpu")
    _check_same(host, r, p)
    if name == "atlas_knn":
        n = r.n_cells
        ri = np.asarray(r.obsp["knn_indices"])[:n]
        pi = _np(p.obsp["knn_indices"])[:n]
        hits = [len(np.intersect1d(a, b)) for a, b in zip(ri, pi)]
        assert np.sum(hits) / ri.size >= 0.99
        np.testing.assert_allclose(_np(p.obsp["knn_distances"])[:n],
                                   np.asarray(r.obsp["knn_distances"])[:n],
                                   atol=1e-3, rtol=0)
        # every gene scaled, none subset
        assert p.n_genes == N_GENES
        assert np.abs(_np(p.X)).max() <= 10.0


@pytest.mark.parametrize("op", sorted(ONE_CALL_KW))
def test_one_call_recipe_matches_reference(raw, op, monkeypatch):
    host, ref, port = raw
    kw = ONE_CALL_KW[op]
    r = sct.apply(op, ref, backend="tpu", **kw)
    _carry_sketch(monkeypatch, r)
    p = apply(op, port, device="cpu", **kw)
    _check_same(host, r, p)
    # the raw planes were never written in place
    np.testing.assert_array_equal(_np(port.X), host.X.toarray())


def _weinreb_moments(d):
    """Mean and CV of the median-normalised counts, float32, as the
    reference computes them."""
    from sctools_tpu.ops.hvg import _gene_moments_tpu

    mu, var, _ = _gene_moments_tpu(d.X)
    cv = jnp.sqrt(jnp.maximum(var, 0.0)) / jnp.maximum(mu, 1e-12)
    return np.asarray(mu), np.asarray(cv)


@pytest.mark.parametrize("kw", [dict(), dict(cv_threshold=1.5, log=False),
                                dict(mean_threshold=0.5, cv_threshold=3.0)])
def test_weinreb17_matches_reference(raw, kw, monkeypatch):
    host, ref, port = raw
    r = sct.apply("recipe.weinreb17", ref, backend="tpu", n_comps=N_PCS,
                  **kw)
    _carry_sketch(monkeypatch, r)
    p = apply("recipe.weinreb17", port, device="cpu", n_comps=N_PCS, **kw)
    r_genes = np.asarray(r.var["gene_name"])
    p_genes = np.asarray(p.var["gene_name"])
    diff = np.setxor1d(r_genes, p_genes)
    if len(diff):
        # a flip at a threshold: mean or CV within f32 rounding of it
        norm = sct.apply("normalize.library_size", ref, backend="tpu",
                         target_sum=None)
        mu, cv = _weinreb_moments(norm)
        names = list(np.asarray(host.var["gene_name"]))
        ids = [names.index(g) for g in diff]
        print(f"weinreb17 {kw}: genes differ at a threshold: {diff}, mean "
              f"{mu[ids]}, cv {cv[ids]}")
        for i in ids:
            near = [abs(v - t) <= 1e-6 * t for v, t in (
                (mu[i], kw.get("mean_threshold", 0.01)),
                (cv[i], kw.get("cv_threshold", 2.0)))]
            assert any(near), (i, mu[i], cv[i])
        return
    assert 0 < p.n_genes < N_GENES
    np.testing.assert_array_equal(p_genes, r_genes)
    np.testing.assert_allclose(_np(p.X), _np(r.X), **TOL)
    _check_counts_layer(host, p)
    _same_pca(p, r, N_CELLS)


def test_weinreb17_thresholds_raise(raw):
    _, _, port = raw
    with pytest.raises(ValueError, match="no gene passes"):
        apply("recipe.weinreb17", port, device="cpu", mean_threshold=1e9)


def test_recipe_surface(raw):
    _, _, port = raw
    with pytest.raises(KeyError, match="weinreb17 is one-call only"):
        sctt.recipe_pipeline("weinreb17")
    with pytest.raises(NotImplementedError, match="Queue 1 item 13"):
        sctt.recipes.run_recipe("seurat", port)
    with pytest.raises(NotImplementedError, match="Queue 1 item 13"):
        sctt.recipes.submit_recipe(None, "seurat", port)
    assert sorted(sctt.recipes.PIPELINES) == [
        "annotation_reference", "atlas_knn", "graph_tail",
        "pearson_residuals", "seurat", "zheng17"]
