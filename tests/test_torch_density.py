"""``embed.density``, ``de.marker_gene_overlap`` and
``palantir.gene_trends`` of the port against the JAX reference.

Fixtures rebuilt from the reference's tests: the core-and-halo layout
of ``tests/test_recipes_density.py:88`` (grouped and not), its
``synthetic_counts(800, 500, n_clusters=3)`` t-test ranking for the
marker overlap, and the branching progression of
``tests/test_palantir.py:11`` for the trends, with a pseudotime and fate
probabilities given to both packages.  The reference runs
``backend="tpu"`` on the CPU and its float64 oracle ``backend="cpu"``.
Tolerances: density within 1e-5 of the reference (the same whitening in
float64, the KDE's float32 sums in another order), 1e-4 of the oracle;
the overlap matrices equal; trends and std within rtol 1e-5 (atol 1e-6)
of the reference (float32 kernel products in another order), rtol 1e-4
of the oracle.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sctools_tpu as sct
from sctools_tpu.data.dataset import CellData as RefCellData
from sctools_tpu.data.synthetic import synthetic_counts as ref_counts
import sctools_tpu_torch as sctt
from sctools_tpu_torch.data.dataset import CellData

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def layout():
    """400 cells of a dense core and a sparse halo in 2-D, two groups."""
    rng = np.random.default_rng(0)
    E = np.vstack([rng.normal(0, 0.3, (300, 2)),
                   rng.normal(0, 3.0, (100, 2))]).astype(np.float32)
    grp = np.array(["a"] * 200 + ["b"] * 150 + ["c"] * 50)
    ref = RefCellData(np.zeros((400, 1), np.float32), obsm={"X_umap": E},
                      obs={"grp": grp})
    port = CellData(torch.zeros((400, 1)),
                    obsm={"X_umap": torch.from_numpy(E)}, obs={"grp": grp})
    return ref, port


@pytest.mark.parametrize("groupby", [None, "grp"])
def test_density_matches_reference(layout, groupby):
    ref, port = layout
    col = "umap_density" + (f"_{groupby}" if groupby else "")
    got = sctt.apply("embed.density", port, device="cpu",
                     groupby=groupby).obs[col]
    assert got.dtype == torch.float32
    got = got.numpy()
    want = np.asarray(sct.apply("embed.density", ref, backend="tpu",
                                groupby=groupby).obs[col])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    oracle = np.asarray(sct.apply("embed.density", ref, backend="cpu",
                                  groupby=groupby).obs[col])
    np.testing.assert_allclose(got, oracle, atol=1e-4)
    assert got.min() >= 0 and got.max() <= 1
    if groupby is None:
        assert got[:300].mean() > 2 * got[300:].mean()
    else:
        for g in ("a", "b", "c"):
            m = port.obs["grp"] == g
            assert got[m].max() == pytest.approx(1.0)
            assert got[m].min() == pytest.approx(0.0)


def test_density_validates(layout):
    _, port = layout
    with pytest.raises(KeyError, match="X_tsne"):
        sctt.apply("embed.density", port, device="cpu", basis="tsne")
    with pytest.raises(KeyError, match="nope"):
        sctt.apply("embed.density", port, device="cpu", groupby="nope")


@pytest.fixture(scope="module")
def ranked():
    raw = ref_counts(800, 500, density=0.12, n_clusters=3, seed=0)
    d = sct.apply("normalize.library_size", raw, backend="cpu")
    d = sct.apply("normalize.log1p", d, backend="cpu")
    d = d.with_obs(label=np.asarray(d.obs["cluster_true"]).astype(str))
    d = sct.apply("de.rank_genes_groups", d, backend="cpu",
                  groupby="label", method="t-test")
    res = d.uns["rank_genes_groups"]
    names = np.asarray(res["names"])
    port = CellData(torch.zeros((d.n_cells, 1)), uns={
        "rank_genes_groups": {"names": names, "groups": res["groups"]}})
    ref_markers = {"setA": list(map(str, names[0][:20])),
                   "setB": ["not_a_gene_1", "not_a_gene_2"],
                   "setC": list(map(str, names[1][5:60:3]))}
    return d, port, ref_markers


@pytest.mark.parametrize("method", ["overlap_count", "overlap_coef",
                                    "jaccard"])
@pytest.mark.parametrize("top", [20, 100])
def test_marker_gene_overlap_matches_reference(ranked, method, top):
    d, port, markers = ranked
    want = sct.apply("de.marker_gene_overlap", d, backend="tpu",
                     reference_markers=markers, method=method,
                     top_n_markers=top).uns["rank_genes_groups_overlap"]
    got = sctt.apply("de.marker_gene_overlap", port, device="cpu",
                     reference_markers=markers, method=method,
                     top_n_markers=top).uns["rank_genes_groups_overlap"]
    assert got["groups"] == want["groups"]
    assert got["reference"] == want["reference"]
    np.testing.assert_array_equal(got["matrix"], want["matrix"])
    assert got["method"] == method and got["top_n_markers"] == top
    if method == "overlap_count":
        assert got["matrix"][0, got["groups"].index("0")] == min(top, 20)


def test_marker_gene_overlap_validates(ranked):
    _, port, markers = ranked
    with pytest.raises(ValueError, match="unknown method"):
        sctt.apply("de.marker_gene_overlap", port, device="cpu",
                   reference_markers=markers, method="dice")
    with pytest.raises(KeyError, match="rank_genes_groups"):
        sctt.apply("de.marker_gene_overlap", CellData(torch.zeros((3, 1))),
                   device="cpu", reference_markers=markers)


@pytest.fixture(scope="module")
def trajectory():
    """The branching progression (600 cells, trunk then two branches):
    expression of 6 genes (progression, flat, its square, noise, two
    branch markers), a pseudotime in [0, 1] and fate probabilities."""
    rng = np.random.default_rng(0)
    n = 600
    t = rng.uniform(0, 2, size=n)
    branch = np.where(t < 1, 0, rng.integers(1, 3, size=n))
    expr = np.stack([t, np.ones_like(t), t * t, rng.random(n),
                     (branch == 1) * t, (branch == 2) * t],
                    axis=1).astype(np.float32)
    expr[rng.random(expr.shape) < 0.3] = 0.0  # sparse counts
    pt = ((t - t.min()) / np.ptp(t)).astype(np.float32)
    fate = np.where(branch[:, None] == np.array([1, 2])[None, :], 0.9, 0.1)
    fate = np.where(branch[:, None] == 0, 0.5, fate).astype(np.float32)
    names = np.array([f"g{i}" for i in range(expr.shape[1])])
    return expr, pt, fate, names


def _trend_pair(trajectory, sparse: bool):
    import scipy.sparse as sp

    expr, pt, fate, names = trajectory
    X = sp.csr_matrix(expr) if sparse else expr
    ref = RefCellData(X, var={"gene_name": names},
                      obs={"palantir_pseudotime": pt},
                      obsm={"palantir_fate_probs": fate, "expr": expr})
    port = CellData(X if sparse else torch.from_numpy(expr),
                    var={"gene_name": names},
                    obs={"palantir_pseudotime": torch.from_numpy(pt)},
                    obsm={"palantir_fate_probs": torch.from_numpy(fate),
                          "expr": torch.from_numpy(expr)})
    return ref, port


@pytest.mark.parametrize("sparse", [False, True])
@pytest.mark.parametrize("kw", [
    dict(), dict(lineage=0, n_grid=50), dict(genes=[4, 0, 2], lineage=1),
    dict(genes=["g5", "g1"], bandwidth=0.05, n_grid=30),
    dict(use_rep="expr", genes=[3, 3, 1])])
def test_gene_trends_match_reference(trajectory, sparse, kw):
    ref, port = _trend_pair(trajectory, sparse)
    r_in = ref.device_put() if sparse else ref.replace(
        X=jnp.asarray(trajectory[0]))
    want = sct.apply("palantir.gene_trends", r_in, backend="tpu",
                     **kw).uns["gene_trends"]
    got = sctt.apply("palantir.gene_trends", port, device="cpu",
                     **kw).uns["gene_trends"]
    np.testing.assert_array_equal(got["gene_idx"], want["gene_idx"])
    assert got["lineage"] == want["lineage"]
    np.testing.assert_allclose(got["grid"].numpy(), np.asarray(want["grid"]),
                               rtol=1e-6, atol=1e-7)
    for key in ("trends", "std"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=1e-5, atol=1e-6)
    oracle = sct.apply("palantir.gene_trends", ref, backend="cpu",
                       **kw).uns["gene_trends"]
    np.testing.assert_allclose(got["trends"].numpy(), oracle["trends"],
                               rtol=1e-4, atol=1e-5)


def test_gene_trends_follow_the_progression(trajectory):
    _, port = _trend_pair(trajectory, sparse=True)
    gt = sctt.apply("palantir.gene_trends", port, device="cpu",
                    n_grid=50).uns["gene_trends"]
    trends = gt["trends"].numpy()
    assert trends.shape == (50, 6) and gt["std"].shape == (50, 6)
    assert trends[-5:, 0].mean() > trends[:5, 0].mean() + 0.5
    # the branch-1 marker rises more on lineage 0 (branch 1's fate)
    l0 = sctt.apply("palantir.gene_trends", port, device="cpu", n_grid=50,
                    lineage=0).uns["gene_trends"]["trends"].numpy()
    assert l0[-5:, 4].mean() > trends[-5:, 4].mean()


def test_gene_trends_requires_palantir(trajectory):
    _, port = _trend_pair(trajectory, sparse=False)
    bare = port.replace(obs={})
    with pytest.raises(ValueError, match="palantir.run"):
        sctt.apply("palantir.gene_trends", bare, device="cpu")
