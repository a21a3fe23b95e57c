"""The port's kNN search against the reference's fused Pallas kernel (run
in interpret mode here, as tests/test_pallas_knn.py runs it) and its
float32 refine.

On the CPU the port's search is the plain version of the CUDA kernel
(``knn_kernel.knn_select_plain``).  Pass condition: identical ids, and
distances within atol 1e-5 under the float32 policy (two libraries'
float32 dot products differ in the last bits) and 1e-3 under bf16
(inputs rounded to bf16, products accumulated in float32 in a different
order).  Euclidean results are compared as squared distances — the
kernel's score — because the square root turns float32 noise around a
zero self-distance into ~1e-3; their inputs are scaled to norms near 1,
where an absolute tolerance on the score means what it means for
cosine.  Where two candidates' scores lie within
the tolerance of each other, the two libraries' last bits may order
them differently: an id may differ only at such a near-tie.  A fixture
of duplicated points pins the exact tie order: equal scores go to the
lower candidate id."""

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


def assert_same_neighbours(p_idx, p_dist, r_idx, r_dist, metric, atol):
    """Scores within ``atol``; ids identical except at near-ties."""
    ps, rs = _score(p_dist, metric), _score(r_dist, metric)
    np.testing.assert_allclose(ps, rs, atol=atol, rtol=0)
    for i, j in zip(*np.nonzero(p_idx != r_idx)):
        at = np.nonzero(r_idx[i] == p_idx[i, j])[0]
        swapped = len(at) and abs(rs[i, at[0]] - ps[i, j]) <= atol
        boundary = abs(ps[i, j] - rs[i, -1]) <= atol
        assert swapped or boundary, (
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
    np.testing.assert_array_equal(p_idx[:300], r_idx[:300])
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


def test_only_auto_impl_is_ported():
    pts = torch.zeros((4, 3))
    with configure(knn_impl="pallas_binned"), pytest.raises(ValueError):
        port_knn.knn_arrays(pts, pts, k=2)
