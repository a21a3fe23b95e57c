"""The port's kNN search against the reference's fused Pallas kernel (run
in interpret mode here, as tests/test_pallas_knn.py runs it) and its
float32 refine.

On the CPU the port's search is the plain version of the CUDA kernel
(``knn_kernel.knn_select_plain``).  Pass condition: ids identical but
for near-ties (below), and distances within atol 1e-5 under the
float32 policy (two libraries' float32 dot products differ in the last
bits) and 1e-3 under bf16
(inputs rounded to bf16, products accumulated in float32 in a different
order).  Euclidean results are compared as squared distances — the
kernel's score — because the square root turns float32 noise around a
zero self-distance into ~1e-3; their inputs are scaled to norms near 1,
where an absolute tolerance on the score means what it means for
cosine.  Where two candidates' scores lie within
the tolerance of each other, the two libraries' last bits may order
them differently: an id may differ only at such a near-tie.  A fixture
of duplicated points pins the exact tie order: equal scores go to the
lower candidate id.

The binned merge (``knn_kernel.knn_binned_plain``, the CPU side of
``knn_impl="pallas_binned"``) is held against the reference's binned
Pallas kernel in interpret mode at the same tolerances, with one more
allowance: an id may also differ where the survivor of its bin (the
port's ``bin_survivors``) lies within the tolerance of its score, a
near-tie inside one bin.  Where every candidate owns its bin, the
binned merge is bitwise the exact one; on integer points with exact
ties inside and across bins, the ids are identical to the reference's
(ties to the lowest column inside a bin, to the lowest bin in the final
selection)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sctools_tpu.config import configure as ref_configure
from sctools_tpu.data.synthetic import gaussian_blobs as ref_blobs
from sctools_tpu.ops import knn as ref_knn
from sctools_tpu.ops.pallas_knn import pallas_knn_arrays
from sctools_tpu_torch.config import configure
from sctools_tpu_torch.data.synthetic import gaussian_blobs
from sctools_tpu_torch.ops import knn as port_knn
from sctools_tpu_torch.ops import knn_kernel

torch.set_num_threads(2)

ATOL = {"float32": 1e-5, "bfloat16": 1e-3}


def _ref(query, cand, mm, **kw):
    with ref_configure(matmul_dtype=mm):
        idx, dist = pallas_knn_arrays(query, cand, **kw)
    return np.asarray(idx), np.asarray(dist)


def _port(query, cand, mm, **kw):
    with configure(matmul_dtype=mm):
        idx, dist = port_knn.knn_arrays(torch.from_numpy(query),
                                        torch.from_numpy(cand), **kw)
    return idx.numpy(), dist.numpy()


def _blobs(metric, n, dim, **kw):
    pts, _ = gaussian_blobs(n, dim, **kw)
    return pts / np.float32(np.sqrt(dim)) if metric == "euclidean" else pts


def _score(dist, metric):
    return dist if metric == "cosine" else dist.astype(np.float64) ** 2


def assert_same_neighbours(p_idx, p_dist, r_idx, r_dist, metric, atol,
                           survivors=None):
    """Scores within ``atol``; ids identical except at near-ties.  For
    the binned merge, ``survivors`` is ``(scores (n, n_bins), n_bins)``
    of every bin: an id may also differ where its bin's survivor lies
    within ``atol`` of its score."""
    ps, rs = _score(p_dist, metric), _score(r_dist, metric)
    np.testing.assert_allclose(ps, rs, atol=atol, rtol=0)
    for i, j in zip(*np.nonzero(p_idx != r_idx)):
        at = np.nonzero(r_idx[i] == p_idx[i, j])[0]
        swapped = len(at) and abs(rs[i, at[0]] - ps[i, j]) <= atol
        boundary = abs(ps[i, j] - rs[i, -1]) <= atol
        in_bin = survivors is not None and abs(
            survivors[0][i, p_idx[i, j] % survivors[1]] - ps[i, j]) <= atol
        assert swapped or boundary or in_bin, (
            f"row {i} slot {j}: id {p_idx[i, j]} vs {r_idx[i, j]}, scores "
            f"{ps[i]} vs {rs[i]}")


def test_gaussian_blobs_identical_to_reference():
    a = ref_blobs(300, 16, n_clusters=5, seed=3)
    b = gaussian_blobs(300, 16, n_clusters=5, seed=3)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("mm", ["float32", "bfloat16"])
@pytest.mark.parametrize("exclude_self", [False, True])
@pytest.mark.parametrize("metric", ["cosine", "euclidean"])
def test_plain_matches_pallas_kernel(metric, exclude_self, mm):
    pts = _blobs(metric, 300, 16, n_clusters=5, spread=0.3, seed=3)
    kw = dict(k=10, metric=metric, exclude_self=exclude_self)
    r_idx, r_dist = _ref(pts, pts, mm, **kw)
    p_idx, p_dist = _port(pts, pts, mm, **kw)
    # the public shape is the reference's: rows padded to 256
    assert p_idx.shape == r_idx.shape == (512, 10)
    assert (p_idx[300:] == -1).all()
    # ids may differ only at near-ties (module docstring)
    assert_same_neighbours(p_idx[:300], p_dist[:300], r_idx[:300],
                           r_dist[:300], metric, ATOL[mm])
    if exclude_self:
        assert not (p_idx[:300] == np.arange(300)[:, None]).any()


@pytest.mark.parametrize("metric", ["cosine", "euclidean"])
def test_unaligned_counts_and_fewer_candidates_than_k(metric):
    pts = _blobs(metric, 333, 10, n_clusters=3, spread=0.3, seed=7)
    # n_query and n_cand below the arrays' rows; then n_cand < k
    for n_query, n_cand, k in ((301, 257, 7), (45, 6, 10)):
        kw = dict(k=k, metric=metric, n_query=n_query, n_cand=n_cand)
        # the reference's kernel wants no more query rows than n_query
        r_idx, r_dist = _ref(pts[:n_query], pts, "float32", **kw)
        p_idx, p_dist = _port(pts, pts, "float32", **kw)
        assert_same_neighbours(p_idx[:n_query], p_dist[:n_query],
                               r_idx[:n_query], r_dist[:n_query], metric,
                               1e-5)
        assert p_idx[:n_query].max() < n_cand
    # the empty slots past n_cand: id -1, infinite distance
    assert (p_idx[:45, 6:] == -1).all()
    assert np.isinf(p_dist[:45, 6:]).all()


@pytest.mark.parametrize("exclude_self", [False, True])
@pytest.mark.parametrize("metric", ["cosine", "euclidean"])
def test_ties_go_to_the_lower_id(metric, exclude_self):
    rng = np.random.default_rng(11)
    base = rng.integers(-3, 4, size=(40, 8)).astype(np.float32)
    pts = base[rng.integers(0, 40, size=200)]  # ~5 copies of each point
    kw = dict(k=12, metric=metric, exclude_self=exclude_self)
    r_idx, r_dist = _ref(pts, pts, "float32", **kw)
    p_idx, p_dist = _port(pts, pts, "float32", **kw)
    # integer points: every score is exact, so the ids must be identical
    np.testing.assert_array_equal(p_idx[:200], r_idx[:200])
    assert_same_neighbours(p_idx[:200], p_dist[:200], r_idx[:200],
                           r_dist[:200], metric, 1e-5)
    # within a run of equal distances the ids ascend
    d, i = p_dist[:200], p_idx[:200]
    same = d[:, 1:] == d[:, :-1]
    assert same.any()
    assert (i[:, 1:][same] > i[:, :-1][same]).all()


@pytest.mark.parametrize("mm", ["float32", "bfloat16"])
@pytest.mark.parametrize("metric", ["cosine", "euclidean"])
def test_refine_matches_reference(metric, mm):
    pts = _blobs(metric, 300, 12, n_clusters=3, spread=0.25, seed=9)
    kw = dict(k=10, metric=metric, refine=32, n_query=300, n_cand=300)
    with ref_configure(matmul_dtype=mm):
        r_idx, r_dist = ref_knn.knn_arrays(jnp.asarray(pts),
                                           jnp.asarray(pts), **kw)
    p_idx, p_dist = _port(pts, pts, mm, **kw)
    assert_same_neighbours(p_idx[:300], p_dist[:300],
                           np.asarray(r_idx)[:300],
                           np.asarray(r_dist)[:300], metric, 1e-5)


def test_recall_against_float64_oracle():
    pts, _ = gaussian_blobs(400, 16, n_clusters=4, spread=0.2, seed=5)
    p_idx, _ = _port(pts, pts, "float32", k=15, metric="cosine")
    o_idx, _ = port_knn.knn_numpy(pts, pts, k=15, metric="cosine")
    r_idx, _ = ref_knn.knn_numpy(pts, pts, k=15, metric="cosine")
    np.testing.assert_array_equal(o_idx, r_idx)
    assert port_knn.recall_at_k(p_idx[:400], o_idx, k=10) == 1.0
    assert port_knn.recall_at_k(p_idx[:400], o_idx) == \
        ref_knn.recall_at_k(p_idx[:400], o_idx)


def test_plain_version_blocking_does_not_change_the_result():
    pts, _ = gaussian_blobs(300, 16, n_clusters=5, spread=0.3, seed=3)
    q = port_knn._prep(torch.from_numpy(pts), "cosine", torch.float32)
    a = knn_kernel.knn_select_plain(q, q, k=10)
    b = knn_kernel.knn_select_plain(q, q, k=10, query_block=64,
                                    cand_block=50)
    assert torch.equal(a[1], b[1])
    torch.testing.assert_close(a[0], b[0], atol=1e-6, rtol=0)


@pytest.mark.parametrize("impl", ["auto", "pallas", "pallas_binned", "xla"])
def test_knn_impl_routes_to_its_merge(impl, monkeypatch):
    """"auto" and "pallas" reach the exact merge, "pallas_binned" the
    binned one (with ``config.knn_bins``), "xla" the blocked search
    (``knn_coarse="approx"`` accepted, the same merge as "topk"); an
    unknown name raises."""
    pts = torch.from_numpy(gaussian_blobs(40, 3, seed=1)[0])
    calls = []
    for name in ("knn_select", "knn_binned", "_knn_blocked"):
        real = getattr(port_knn, name)
        monkeypatch.setattr(port_knn, name, lambda *a, _n=name, _f=real,
                            **kw: calls.append((_n, kw)) or _f(*a, **kw))
    with configure(knn_impl=impl, knn_bins=200, knn_coarse="approx"):
        port_knn.knn_arrays(pts, pts, k=2)
    want = {"pallas_binned": "knn_binned",
            "xla": "_knn_blocked"}.get(impl, "knn_select")
    assert [c[0] for c in calls] == [want]
    if want == "knn_binned":
        assert calls[0][1]["n_bins"] == 200
    if want == "_knn_blocked":
        assert "coarse" not in calls[0][1]
    with configure(knn_impl="blocked"):
        with pytest.raises(ValueError, match="knn_impl"):
            port_knn.knn_arrays(pts, pts, k=2)


# --------------------------------------------------------- binned merge


def _ref_binned(pts, mm="float32", **kw):
    with ref_configure(matmul_dtype=mm):
        idx, dist = pallas_knn_arrays(pts, pts, merge="binned", **kw)
    return np.asarray(idx)[:len(pts)], np.asarray(dist)[:len(pts)]


def _port_binned(pts, k, n_bins, metric="cosine", mm=torch.float32, **kw):
    q = port_knn._prep(torch.from_numpy(pts), metric, mm)
    vals, idx = knn_kernel.knn_binned(q, q, k=k, n_bins=n_bins,
                                      metric=metric, **kw)
    surv, _ = knn_kernel.bin_survivors(
        q, q, n_bins=knn_kernel.binned_bins(k, n_bins), metric=metric,
        exclude_self=kw.get("exclude_self", False))
    dist = (1.0 - vals) if metric == "cosine" else torch.sqrt(
        torch.clamp(-vals, min=0.0))
    surv = (1.0 - surv) if metric == "cosine" else -surv
    return idx.numpy(), dist.numpy(), surv.numpy()


@pytest.mark.parametrize("metric", ["cosine", "euclidean"])
def test_binned_is_the_exact_merge_when_every_candidate_owns_a_bin(metric):
    pts = _blobs(metric, 300, 16, n_clusters=5, spread=0.3, seed=3)
    q = port_knn._prep(torch.from_numpy(pts), metric, torch.float32)
    for excl in (False, True):
        b = knn_kernel.knn_binned(q, q, k=10, n_bins=384, metric=metric,
                                  exclude_self=excl)
        e = knn_kernel.knn_select(q, q, k=10, metric=metric,
                                  exclude_self=excl)
        assert torch.equal(b[0], e[0]) and torch.equal(b[1], e[1])
    r_idx, _ = _ref_binned(pts, k=10, metric=metric, n_bins=384)
    r_exact, _ = _ref(pts, pts, "float32", k=10, metric=metric)
    np.testing.assert_array_equal(r_idx, r_exact[:300])


@pytest.mark.parametrize("metric,exclude_self,mm", [
    ("cosine", False, "float32"), ("euclidean", True, "float32"),
    ("cosine", True, "bfloat16")])
def test_binned_matches_pallas_kernel(metric, exclude_self, mm):
    """n = 3072 against 512 bins: six candidates share every bin."""
    pts = _blobs(metric, 3072, 16, n_clusters=5, spread=0.3, seed=3)
    kw = dict(k=10, metric=metric, exclude_self=exclude_self)
    r_idx, r_dist = _ref_binned(pts, mm, n_bins=512, **kw)
    with configure(matmul_dtype=mm):
        p_idx, p_dist, surv = _port_binned(
            pts, n_bins=512, mm=port_knn.config.matmul_torch_dtype(), **kw)
    atol = ATOL[mm]
    assert_same_neighbours(p_idx, p_dist, r_idx, r_dist, metric, atol,
                           survivors=(_score(surv, metric), 512))
    assert (p_idx == r_idx).mean() > 0.99
    if exclude_self:
        assert not (p_idx == np.arange(3072)[:, None]).any()


@pytest.mark.parametrize("metric", ["cosine", "euclidean"])
def test_binned_ties_go_to_the_lowest_column_then_the_lowest_bin(metric):
    """Integer points, ~20 copies of each: exact equal scores inside a
    bin and across bins.  The ids must be the reference's exactly."""
    rng = np.random.default_rng(12)
    base = rng.integers(-3, 4, size=(40, 8)).astype(np.float32)
    pts = base[rng.integers(0, 40, size=800)]
    r_idx, r_dist = _ref_binned(pts, k=12, metric=metric, n_bins=128)
    p_idx, p_dist, _ = _port_binned(pts, 12, 128, metric)
    np.testing.assert_array_equal(p_idx, r_idx)
    np.testing.assert_allclose(_score(p_dist, metric),
                               _score(r_dist, metric), atol=1e-5, rtol=0)
    # among equal scores the bins ascend, not the ids
    same = p_dist[:, 1:] == p_dist[:, :-1]
    bins = p_idx % 128
    assert same.any() and (bins[:, 1:][same] > bins[:, :-1][same]).all()
    assert (p_idx[:, 1:][same] < p_idx[:, :-1][same]).any()


def test_binned_bins_round_up_and_k_above_n_bins_raises():
    assert knn_kernel.binned_bins(15, 1024) == 1024
    assert knn_kernel.binned_bins(15, 300) == 384
    assert knn_kernel.binned_bins(1, 1) == 128
    q = torch.zeros((4, 3))
    with pytest.raises(ValueError, match="n_bins"):
        knn_kernel.knn_binned(q, q, k=20, n_bins=16)
    with configure(knn_impl="pallas_binned", knn_bins=16), \
            pytest.raises(ValueError, match="n_bins"):
        port_knn.knn_arrays(q, q, k=4, refine=20)
    # the rounded bins are what the merge uses: 300 asked, 384 used
    pts = _blobs("cosine", 1000, 8, n_clusters=3, spread=0.3, seed=4)
    r_idx, _ = _ref_binned(pts, k=5, n_bins=300)
    p_idx, _, _ = _port_binned(pts, 5, 300)
    assert (p_idx == r_idx).mean() > 0.99


@pytest.mark.parametrize("metric", ["cosine", "euclidean"])
def test_binned_through_knn_arrays_with_refine(metric):
    pts = _blobs(metric, 2000, 12, n_clusters=3, spread=0.25, seed=9)
    kw = dict(k=10, metric=metric, refine=32, n_query=2000, n_cand=2000)
    with ref_configure(knn_impl="pallas_binned", knn_bins=256):
        r_idx, r_dist = ref_knn.knn_arrays(jnp.asarray(pts),
                                           jnp.asarray(pts), **kw)
    with configure(knn_impl="pallas_binned", knn_bins=256):
        p_idx, p_dist = _port(pts, pts, "float32", **kw)
    assert p_idx.shape == (2048, 10) and (p_idx[2000:] == -1).all()
    assert_same_neighbours(p_idx[:2000], p_dist[:2000],
                           np.asarray(r_idx)[:2000],
                           np.asarray(r_dist)[:2000], metric, 1e-5)
    o_idx, _ = port_knn.knn_numpy(pts, pts, k=10, metric=metric)
    assert port_knn.recall_at_k(p_idx[:2000], o_idx) > 0.98


# ------------------------------------------------- candidate splits


def _split_select(q, c, k, metric, exclude_self, bounds):
    """``knn_select_plain`` on each candidate range [bounds[s],
    bounds[s + 1]) with the ids offset to global ones: the (S, nq, k)
    lists the kernel's split blocks write.  Under ``exclude_self`` (q is
    c) the queries inside a range drop their own pair there."""
    vals, ids = [], []
    nq = q.shape[0]
    for a, b in zip(bounds[:-1], bounds[1:]):
        v = torch.empty((nq, k))
        i = torch.empty((nq, k), dtype=torch.int32)
        rows = torch.zeros(nq, dtype=torch.bool)
        if exclude_self:
            rows[a:b] = True
            v[a:b], i[a:b] = knn_kernel.knn_select_plain(
                q[a:b], c[a:b], k=k, metric=metric, exclude_self=True)
        if (~rows).any():
            v[~rows], i[~rows] = knn_kernel.knn_select_plain(
                q[~rows], c[a:b], k=k, metric=metric)
        vals.append(v)
        ids.append(torch.where(i >= 0, i + a, -1))
    return torch.stack(vals), torch.stack(ids)


@pytest.mark.parametrize("bounds", [(0, 200), (0, 93, 200),
                                    (0, 5, 70, 71, 140, 200)],
                         ids=["S1", "S2", "S5"])
@pytest.mark.parametrize("exclude_self", [False, True])
@pytest.mark.parametrize("metric", ["cosine", "euclidean"])
def test_split_merge_matches_unsplit_and_pallas_kernel(metric, exclude_self,
                                                       bounds):
    """The kernel's candidate splits and merge launch, in their plain
    versions: points with exact ties, ranges of unequal length (one of 5
    and one of 1 candidate, fewer than k).  The merged lists equal the
    unsplit plain version and the reference's Pallas kernel (interpret
    mode): ids identical, scores within 1e-5.  Each point has ±1 in four
    of its eight places (norm 2), so every score is exact in float32 for
    both metrics, whatever the product's blocking (a one-column range
    takes another matmul path, whose last bits differ on inexact
    scores)."""
    rng = np.random.default_rng(11)
    base = np.zeros((40, 8), np.float32)
    for row in base:
        row[rng.choice(8, 4, replace=False)] = rng.choice([-1, 1], 4)
    pts = base[rng.integers(0, 40, size=200)]
    q = port_knn._prep(torch.from_numpy(pts), metric, torch.float32)
    k = 12
    sv, si = _split_select(q, q, k, metric, exclude_self, bounds)
    v, i = knn_kernel.knn_merge_plain(sv, si)
    uv, ui = knn_kernel.knn_select_plain(q, q, k=k, metric=metric,
                                         exclude_self=exclude_self)
    assert torch.equal(i, ui)
    torch.testing.assert_close(v, uv, atol=1e-5, rtol=0)
    r_idx, r_dist = _ref(pts, pts, "float32", k=k, metric=metric,
                         exclude_self=exclude_self)
    np.testing.assert_array_equal(i.numpy(), r_idx[:200])
    dist = (1.0 - v) if metric == "cosine" else torch.sqrt(
        torch.clamp(-v, min=0.0))
    assert_same_neighbours(i.numpy(), dist.numpy(), r_idx[:200],
                           r_dist[:200], metric, 1e-5)


def test_merge_of_empty_and_short_lists():
    """Lists padded with -inf / -1 (a range shorter than k, or empty)
    merge to the finite entries first and id -1 after them; equal
    values go to the lower list."""
    inf = float("-inf")
    vals = torch.tensor([[[0.5, 0.25, inf]], [[inf, inf, inf]],
                         [[0.5, inf, inf]]])
    ids = torch.tensor([[[3, 1, -1]], [[-1, -1, -1]], [[9, -1, -1]]],
                       dtype=torch.int32)
    v, i = knn_kernel.knn_merge_plain(vals, ids)
    assert v.tolist() == [[0.5, 0.5, 0.25]]
    assert i.tolist() == [[3, 9, 1]]
    v, i = knn_kernel.knn_merge_plain(vals[1:2], ids[1:2])
    assert i.tolist() == [[-1, -1, -1]] and torch.isinf(v).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pack_tiles_is_tile_major_feature_major_zero_padded(dtype):
    x = torch.from_numpy(np.random.default_rng(2).normal(
        size=(130, 7)).astype(np.float32)).to(dtype)
    p = knn_kernel.pack_tiles(x, 64)
    assert p.shape == (3, 7, 64) and p.dtype == torch.float32
    rows = torch.cat([p[t].T for t in range(3)])  # back to (192, 7)
    assert torch.equal(rows[:130], x.float())
    assert (rows[130:] == 0).all()
    assert torch.equal(knn_kernel.pack_tiles(x[:128], 64),
                       x[:128].float().reshape(2, 64, 7).permute(0, 2, 1))
    assert knn_kernel.pack_tiles(x[:0], 64).shape == (0, 7, 64)


# --------------------------------------------------- bin-chunk splits


def _exact_points(n, seed=11, d=8):
    """Points with ±1 in four of ``d`` places (norm 2): every cosine and
    euclidean score is exact in float32, whatever the product's
    blocking, and equal scores tie exactly inside and across bins."""
    rng = np.random.default_rng(seed)
    base = np.zeros((40, d), np.float32)
    for row in base:
        row[rng.choice(d, 4, replace=False)] = rng.choice([-1, 1], 4)
    return base[rng.integers(0, 40, size=n)]


def _split_binned(q, c, k, n_bins, metric, exclude_self, chunk_bounds):
    """The binned kernel's bin-chunk splits and merge launch, in their
    plain versions: split s holds the bins of the 128-bin chunks
    [chunk_bounds[s], chunk_bounds[s + 1]), each whole, and keeps the top
    ``k`` of their survivors by (value descending, bin ascending); the
    (S, nq, k) lists then go through ``knn_merge_plain``."""
    sv, si = knn_kernel.bin_survivors(q, c, n_bins=n_bins, metric=metric,
                                      exclude_self=exclude_self)
    tile = knn_kernel.BINS_MULTIPLE
    vals, ids = [], []
    for a, b in zip(chunk_bounds[:-1], chunk_bounds[1:]):
        v, sel = torch.sort(sv[:, a * tile:b * tile], dim=1,
                            descending=True, stable=True)
        i = torch.gather(si[:, a * tile:b * tile], 1, sel)
        pad = max(0, k - v.shape[1])
        v = torch.nn.functional.pad(v[:, :k], (0, pad), value=float("-inf"))
        i = torch.nn.functional.pad(i[:, :k], (0, pad), value=-1)
        vals.append(v)
        ids.append(torch.where(torch.isfinite(v), i, -1).to(torch.int32))
    return knn_kernel.knn_merge_plain(torch.stack(vals), torch.stack(ids))


@pytest.mark.parametrize("nc,n_bins,chunk_bounds", [
    (200, 128, (0, 1)),            # one chunk, one split; nc % n_bins != 0
    (700, 256, (0, 1, 2)),         # every chunk of 3 rounds
    (1000, 300, (0, 1, 3)),        # 300 -> 384 bins; unequal ranges, the
    (1000, 300, (0, 2, 3)),        # last chunk one round short
    (200, 384, (0, 1, 2)),         # fewer candidates than bins
    (777, 128, (0, 1)),            # seven rounds, the last a partial tile
], ids=["128-one-chunk", "256-two-splits", "300-short-last",
        "300-long-first", "nc-below-bins", "128-seven-rounds"])
@pytest.mark.parametrize("exclude_self", [False, True])
@pytest.mark.parametrize("metric", ["cosine", "euclidean"])
def test_binned_chunk_splits_match_unsplit_and_pallas_kernel(
        metric, exclude_self, nc, n_bins, chunk_bounds):
    """The binned kernel's splits over whole bin chunks, merged, equal
    ``knn_binned_plain`` (ids identical, scores bitwise) and the
    reference's binned Pallas kernel in interpret mode (ids identical on
    exact points with ties inside and across bins, scores within
    1e-5)."""
    pts = _exact_points(nc)
    q = port_knn._prep(torch.from_numpy(pts), metric, torch.float32)
    k = 12
    bins = knn_kernel.binned_bins(k, n_bins)
    assert chunk_bounds[-1] == -(-min(nc, bins) // knn_kernel.BINS_MULTIPLE)
    v, i = _split_binned(q, q, k, bins, metric, exclude_self, chunk_bounds)
    uv, ui = knn_kernel.knn_binned_plain(q, q, k=k, n_bins=n_bins,
                                         metric=metric,
                                         exclude_self=exclude_self)
    assert torch.equal(i, ui) and torch.equal(v, uv)
    r_idx, r_dist = _ref_binned(pts, k=k, metric=metric, n_bins=n_bins,
                                exclude_self=exclude_self)
    np.testing.assert_array_equal(i.numpy(), r_idx)
    dist = (1.0 - v) if metric == "cosine" else torch.sqrt(
        torch.clamp(-v, min=0.0))
    np.testing.assert_allclose(_score(dist.numpy(), metric),
                               _score(r_dist, metric), atol=1e-5, rtol=0)
    if nc <= bins:  # every candidate owns its bin: the exact merge
        ev, ei = knn_kernel.knn_select_plain(q, q, k=k, metric=metric,
                                             exclude_self=exclude_self)
        assert torch.equal(i, ei) and torch.equal(v, ev)
