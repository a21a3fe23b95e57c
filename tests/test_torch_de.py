"""``de.rank_genes_groups`` and ``de.filter_rank_genes_groups`` of the
port against the JAX reference on the same inputs.

Both packages start from the reference's ``synthetic_counts(600, 800,
n_clusters=4)`` after its own library-size and log1p steps (the
padded-ELL planes carried by ``carry.cells_from_numpy``), grouped by the
generating cluster; the reference runs ``backend="tpu"`` on the CPU and
its scipy oracle ``backend="cpu"``.  Tolerances:

* t-test scores rtol 1e-4, p-values rtol 1e-4 where p > 1e-30, log fold
  changes rtol 1e-5 (the group sums add in the reference's order on the
  CPU: today they agree bit for bit); against the scipy oracle, which
  sums in float64, t and the log fold changes also within atol 1e-5
  (a t of 6e-5 is 1 % off there, as the reference's own is);
* wilcoxon: average ranks and centred rank sums equal the reference's;
  the tie term equals the exact Σ t³ − t of the value counts (the
  port adds it in float64; the reference's float32 one is within rtol
  2e-7 of it); z within rtol 1e-5 of the ``tpu`` path, whose float32
  tie term shifts z by up to ~2e-6 (relative) for rarely expressed
  genes, where 1 − ties/(n³ − n) is small, and within rtol 1e-9 of the
  scipy oracle (exact ties too; its float64 log fold changes within
  atol 1e-5);
* ranked gene order: equal but for genes whose scores lie within 1e-5
  (relative) of each other;
* logreg from the reference's start (``carry.logreg_w0_from_numpy``):
  W within 1e-5 after 5 steps; after 300 the reference's own gate on
  marker recovery and ≥ 0.8 overlap of each group's top 30 with the
  reference's run;
* expressing fractions (``pts``) and the filter's kept mask: exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sctools_tpu as sct
from sctools_tpu.data.synthetic import synthetic_counts as ref_counts
from sctools_tpu.ops import de as rde
import sctools_tpu_torch as sctt
from sctools_tpu_torch.carry import cells_from_numpy, logreg_w0_from_numpy
from sctools_tpu_torch.data import sparse
from sctools_tpu_torch.data.sparse import (dense_gene_block, gene_slots,
                                           gene_slots_sum, segment_reduce)
from sctools_tpu_torch.ops import de as pde

torch.set_num_threads(2)

N_CELLS, N_GENES, N_GROUPS = 600, 800, 4
TTEST = dict(rtol=1e-4, atol=0)
TTEST_ORACLE = dict(rtol=1e-4, atol=1e-5)
Z_REF = dict(rtol=1e-5, atol=1e-9)
Z_ORACLE = dict(rtol=1e-9, atol=1e-12)
LFC = dict(rtol=1e-5, atol=1e-6)
LFC_ORACLE = dict(rtol=1e-5, atol=1e-5)
NEAR_TIE = 1e-5


@pytest.fixture(scope="module")
def both():
    host = ref_counts(N_CELLS, N_GENES, density=0.05, n_clusters=N_GROUPS,
                      seed=3)
    ref = sct.Pipeline([("normalize.library_size", {}),
                        ("normalize.log1p", {})]).run(host.device_put(),
                                                      backend="tpu")
    label = np.asarray(host.obs["cluster_true"]).astype(str)
    ref = ref.with_obs(label=label)
    port = cells_from_numpy(np.asarray(ref.X.indices),
                            np.asarray(ref.X.data), ref.n_cells,
                            ref.n_genes, obs={"label": label},
                            var=host.var)
    return ref, port


@pytest.fixture(scope="module")
def dense(both):
    ref, port = both
    Xd = np.asarray(ref.X.to_dense())
    return (ref.replace(X=jnp.asarray(Xd)),
            port.replace(X=torch.from_numpy(Xd.copy())))


@pytest.fixture(scope="module")
def oracle(both):
    """The reference's host CellData, for its scipy oracle."""
    return both[0].to_host()


@pytest.fixture(params=["sparse", "dense"])
def pair(request, both, dense):
    return both if request.param == "sparse" else dense


def _ref(data, backend="tpu", **kw):
    return sct.apply("de.rank_genes_groups", data, backend=backend,
                     groupby="label", **kw).uns["rank_genes_groups"]


def _port(data, **kw):
    return sctt.apply("de.rank_genes_groups", data, device="cpu",
                      groupby="label", **kw).uns["rank_genes_groups"]


def by_gene(res, key):
    """``res[key]`` in gene-id order (every gene ranked)."""
    inv = np.argsort(np.asarray(res["indices"]), axis=1)
    return np.take_along_axis(np.asarray(res[key]), inv, axis=1)


def assert_same_order(a, b):
    """Ranked gene ids equal, but where a swapped gene's score lies
    within NEAR_TIE of its neighbour's."""
    ia, ib = np.asarray(a["indices"]), np.asarray(b["indices"])
    sa = np.asarray(a["scores"], np.float64)
    diff = ia != ib
    for g, j in zip(*np.nonzero(diff)):
        near = np.abs(sa[g] - sa[g, j]) <= NEAR_TIE * max(abs(sa[g, j]),
                                                           1e-12)
        assert near.sum() > 1, (g, j, ia[g, j], ib[g, j])


def assert_matches(p, r, tol, lfc=LFC, pvals=True):
    assert p["groups"] == r["groups"] and p["method"] == r["method"]
    assert p["reference"] == r["reference"]
    np.testing.assert_allclose(by_gene(p, "scores"), by_gene(r, "scores"),
                               **tol)
    if pvals:
        pp, rp = by_gene(p, "pvals"), by_gene(r, "pvals")
        ok = rp > 1e-30
        np.testing.assert_allclose(pp[ok], rp[ok], rtol=1e-4)
    np.testing.assert_allclose(by_gene(p, "logfoldchanges"),
                               by_gene(r, "logfoldchanges"), **lfc)
    assert_same_order(p, r)


# ------------------------------------------------------------- t-tests


@pytest.mark.parametrize("method", ["t-test", "t-test_overestim_var"])
def test_ttest_matches_the_reference(pair, oracle, method):
    ref, port = pair
    p = _port(port, method=method)
    assert_matches(p, _ref(ref, method=method), TTEST)
    assert_matches(p, _ref(oracle, "cpu", method=method), TTEST_ORACLE,
                   LFC_ORACLE)
    np.testing.assert_array_equal(p["names"], np.asarray(
        port.var["gene_name"])[p["indices"]])
    adj = np.asarray(p["pvals_adj"])
    assert np.all(adj >= np.asarray(p["pvals"]) - 1e-12) and adj.max() <= 1


def _codes(port):
    return np.unique(np.asarray(port.obs["label"]),
                     return_inverse=True)[1].astype(np.int32)


@pytest.mark.parametrize("seg_rows", [None, 32, 5])
def test_slot_sums_are_segment_reduces_bits(both, seg_rows):
    """The stored slots in gene-major order sum to the bits of
    segment_reduce's chunked, fixed-order sums of the same slot values
    (first-level blocks of all of a chunk's rows, as on the CPU, or of
    32 rows, as on the card)."""
    X = both[1].X
    onehot = torch.zeros((X.rows_padded, N_GROUPS))
    onehot[:N_CELLS] = torch.nn.functional.one_hot(
        torch.from_numpy(_codes(both[1]).astype(np.int64)), N_GROUPS).float()
    slots = gene_slots(X, block=256, seg_rows=seg_rows)
    got = gene_slots_sum(slots, lambda rows, dat: dat[:, None]
                         * onehot[rows], N_GROUPS)
    want = torch.zeros_like(got)
    for r0, ind, dat in sparse._row_chunks(X, 256):
        vals = dat[:, :, None] * onehot[r0:r0 + ind.shape[0], None, :]
        want = want + sparse._gene_segment_sum(
            ind, vals.reshape(-1, N_GROUPS), X.n_genes, seg_rows=seg_rows)
    assert torch.equal(got, want)
    if seg_rows is None:
        assert torch.equal(got, segment_reduce(
            X, lambda ind, dat, r0: dat[:, :, None]
            * onehot[r0:r0 + ind.shape[0], None, :], N_GROUPS, block=256))


def test_group_moments_match_the_reference(both):
    ref, port = both
    X, codes = port.X, _codes(port)
    grp = pde._Groups(X, codes, N_GROUPS, N_CELLS)
    s, ss, cnt = grp.moments()
    c = np.full(ref.X.rows_padded, -1, np.int32)
    c[:N_CELLS] = codes
    rs, rss, rcnt = rde._group_moments_sparse(ref.X, jnp.asarray(c),
                                              N_GROUPS)
    # the same slots in the same order on the CPU: the same bits
    np.testing.assert_array_equal(s, np.asarray(rs))
    np.testing.assert_array_equal(ss, np.asarray(rss))
    np.testing.assert_array_equal(cnt, np.asarray(rcnt))


# ------------------------------------------------------------- wilcoxon


def test_dense_gene_block_is_the_reference_block(both):
    ref, port = both
    for lo, width in ((0, 64), (100, 300), (700, 100), (0, N_GENES)):
        got = dense_gene_block(port.X, lo, width).numpy()
        want = np.asarray(rde._dense_gene_block(ref.X, lo, width))
        np.testing.assert_array_equal(got, want)


def test_ranks_and_tie_terms(both):
    ref, port = both
    X = dense_gene_block(port.X, 0, N_GENES)
    X[:, :5] = torch.round(X[:, :5])  # long runs of ties, not just zeros
    ranks, ties = pde._average_ranks(X)
    rr, rt = rde._average_ranks(jnp.asarray(X.numpy()))
    np.testing.assert_array_equal(ranks.T.numpy(), np.asarray(rr))
    exact = np.array([
        np.sum(t.astype(np.float64) ** 3 - t) for t in
        (np.unique(c, return_counts=True)[1] for c in X.numpy().T)])
    np.testing.assert_array_equal(ties.numpy(), exact)
    np.testing.assert_allclose(np.asarray(rt, np.float64), exact,
                               rtol=2e-7)
    codes = _codes(port)
    order = pde.segment_order(torch.from_numpy(codes.astype(np.int64)),
                              N_GROUPS)
    rs = pde._group_rank_sums(ranks, order, N_GROUPS)
    want, _ = rde._group_rank_sums(rr, jnp.asarray(codes), N_GROUPS)
    np.testing.assert_array_equal(rs.numpy(), np.asarray(want, np.float64))


def test_wilcoxon_matches_the_reference(pair, oracle):
    ref, port = pair
    p = _port(port, method="wilcoxon")
    assert_matches(p, _ref(ref, method="wilcoxon"), Z_REF)
    assert_matches(p, _ref(oracle, "cpu", method="wilcoxon"), Z_ORACLE,
                   LFC_ORACLE)
    q = _port(port, method="wilcoxon", tie_correct=False)
    assert_matches(q, _ref(oracle, "cpu", method="wilcoxon",
                           tie_correct=False), Z_ORACLE, LFC_ORACLE)


def test_wilcoxon_blocks_give_the_same_bits(both, monkeypatch):
    port = both[1]
    one = _port(port, method="wilcoxon")
    monkeypatch.setattr(pde, "_GENE_BLOCK", 96)  # 9 blocks, the last short
    many = _port(port, method="wilcoxon")
    for key in ("indices", "scores", "pvals", "logfoldchanges"):
        np.testing.assert_array_equal(one[key], many[key])


# --------------------------------------------------------------- logreg


def _ref_w0(n_genes, n_groups, seed=0):
    return 1e-3 * jax.random.normal(jax.random.PRNGKey(seed),
                                    (n_genes, n_groups), jnp.float32)


@pytest.mark.parametrize("kind", ["sparse", "dense"])
def test_logreg_steps_match_the_reference(both, dense, kind):
    ref, port = both if kind == "sparse" else dense
    codes = _codes(port)
    want = rde._logreg_scores(ref, codes, N_GROUPS, n_steps=5)
    w0 = logreg_w0_from_numpy(_ref_w0(N_GENES, N_GROUPS))
    grp = pde._Groups(port.X, codes, N_GROUPS, N_CELLS)
    got = pde._logreg_scores(port.X, grp, N_GENES, n_steps=5, w0=w0)
    assert got.shape == (N_GROUPS, N_GENES)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_logreg_recovers_markers(both, monkeypatch):
    ref, port = both
    monkeypatch.setattr(
        pde, "logreg_w0", lambda g, k, seed, device: logreg_w0_from_numpy(
            _ref_w0(g, k, seed)).to(device))
    res = _port(port, method="logreg", n_top=30)
    assert res["method"] == "logreg" and np.isnan(res["pvals"]).all()
    tt = _port(port, method="t-test", n_top=30)
    theirs = _ref(ref, method="logreg", n_top=30)
    for g in range(N_GROUPS):
        mine = set(res["indices"][g].tolist())
        # the reference's own gate (tests/test_de_score.py)
        assert len(mine & set(tt["indices"][g].tolist())) / 30 > 0.2, g
        assert (res["logfoldchanges"][g][:10] > 0).mean() > 0.8, g
        assert len(mine & set(theirs["indices"][g].tolist())) / 30 >= 0.8


def test_logreg_default_start_is_seeded(both):
    a = pde.logreg_w0(N_GENES, N_GROUPS, 0, "cpu")
    assert torch.equal(a, pde.logreg_w0(N_GENES, N_GROUPS, 0, "cpu"))
    assert not torch.equal(a, pde.logreg_w0(N_GENES, N_GROUPS, 1, "cpu"))
    assert a.dtype == torch.float32 and float(a.abs().max()) < 1e-2
    with pytest.raises(ValueError, match="n_genes, n_groups"):
        logreg_w0_from_numpy(np.zeros(N_GENES, np.float32))


# ------------------------------------------- pts, groups=, reference=


def test_pts_matches_the_reference(pair, oracle):
    ref, port = pair
    p = _port(port, pts=True)
    for r in (_ref(ref, pts=True), _ref(oracle, "cpu", pts=True)):
        assert p["pts"].shape == (N_GROUPS, N_GENES)
        np.testing.assert_array_equal(p["pts"], r["pts"])
        np.testing.assert_array_equal(p["pts_rest"], r["pts_rest"])
    assert "pts" not in _port(port)


@pytest.mark.parametrize("method", ["t-test", "wilcoxon"])
def test_groups_and_reference(pair, method):
    ref, port = pair
    kw = dict(method=method, groups=["1", "3"], reference="0", pts=True)
    p, r = _port(port, **kw), _ref(ref, **kw)
    assert p["groups"] == ["1", "3"] and p["reference"] == "0"
    assert_matches(p, r, TTEST if method == "t-test" else Z_REF)
    np.testing.assert_array_equal(p["pts"], r["pts"])
    np.testing.assert_array_equal(p["pts_rest"], r["pts_rest"])
    kw = dict(method=method, groups=["2"])
    assert_matches(_port(port, **kw), _ref(ref, **kw),
                   TTEST if method == "t-test" else Z_REF)


def test_n_top_cuts_every_array(both):
    p = _port(both[1], n_top=7)
    for key in ("indices", "names", "scores", "pvals", "pvals_adj",
                "logfoldchanges"):
        assert np.asarray(p[key]).shape == (N_GROUPS, 7), key


def test_errors(both):
    port = both[1]
    with pytest.raises(ValueError, match="not a level"):
        _port(port, reference="zzz")
    with pytest.raises(ValueError, match="logreg"):
        _port(port, method="logreg", reference="0")
    with pytest.raises(ValueError, match="not levels"):
        _port(port, groups=["1", "typo"])
    with pytest.raises(ValueError, match="not levels"):
        _port(port, method="wilcoxon", reference="0", groups=["typo"])
    with pytest.raises(ValueError, match="selects no"):
        _port(port, groups=["0"], reference="0")
    with pytest.raises(ValueError, match="unknown method"):
        _port(port, method="anova")
    with pytest.raises(KeyError, match="no key"):
        sctt.apply("de.rank_genes_groups", port, device="cpu",
                   groupby="nope")


# ------------------------------------------------- filter_rank_genes_groups


def test_filter_matches_the_reference(pair):
    """Both filters read one ranking (the reference's wilcoxon run)."""
    ref, port = pair
    r = sct.apply("de.rank_genes_groups", ref, backend="tpu",
                  groupby="label", method="wilcoxon")
    ranking = r.uns["rank_genes_groups"]
    kw = dict(groupby="label", min_in_group_fraction=0.1,
              max_out_group_fraction=0.6, min_fold_change=1.2)
    want = sct.apply("de.filter_rank_genes_groups", r, backend="tpu",
                     **kw).uns["rank_genes_groups_filtered"]
    got = sctt.apply("de.filter_rank_genes_groups",
                     port.with_uns(rank_genes_groups=ranking),
                     device="cpu", **kw).uns["rank_genes_groups_filtered"]
    assert 0 < got["kept"].sum() < got["kept"].size
    np.testing.assert_array_equal(got["kept"], want["kept"])
    np.testing.assert_array_equal(got["names_filtered"],
                                  want["names_filtered"])
    for key in ("frac_in_group", "frac_out_group"):
        np.testing.assert_array_equal(got[key], want[key])


def test_filter_errors(both):
    port = both[1]
    with pytest.raises(KeyError, match="run de.rank_genes_groups"):
        sctt.apply("de.filter_rank_genes_groups", port, device="cpu")
    ranked = sctt.apply("de.rank_genes_groups", port, device="cpu",
                        groupby="label", groups=["1"])
    with pytest.raises(ValueError, match="do not match"):
        sctt.apply("de.filter_rank_genes_groups", ranked, device="cpu",
                   groupby="label")
