"""The rest of the port's kNN surface against the reference on the CPU:
the blocked ``knn_impl="xla"`` search (``knn_coarse`` "topk" and
"approx"), ``n_valid_cand``, the sorted refine and its ``"auto"``
threshold, ``neighbors.bbknn``, ``distance.pairwise``,
``iter_knn_chunks``' wall time and ``stream_pipeline``'s unchunked
rows.

Tolerances and near-tie rules are those of ``tests/test_torch_knn.py``'s
docstring: ids identical but for near-ties, scores within 1e-5 under the
float32 policy and 1e-3 under bf16 (euclidean compared as squared
distances).  Off the TPU the reference's "approx" (``lax.approx_max_k``)
is exact, and the port's is an alias of "topk", so both coarse modes
are held to the exact rule.  The two refine gathers select the same neighbours with
scores equal up to float32 summation order (1e-5), as the reference's
own test holds them."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sctools_tpu as sct
from sctools_tpu.config import config as ref_config
from sctools_tpu.config import configure as ref_configure
from sctools_tpu.data.dataset import CellData as RefCellData
from sctools_tpu.ops import knn as ref_knn
import sctools_tpu_torch as sctt
from sctools_tpu_torch.config import config, configure, round_up
from sctools_tpu_torch.data.dataset import CellData
from sctools_tpu_torch.data.synthetic import gaussian_blobs
from sctools_tpu_torch.ops import knn as port_knn
from sctools_tpu_torch.ops.distance import pairwise_arrays
from sctools_tpu_torch.registry import apply
from test_torch_knn import ATOL, _blobs, assert_same_neighbours

torch.set_num_threads(2)

BLOCKS = dict(row_block=128, col_block=96)  # several blocks, ragged ends


def _both(query, cand, mm="float32", cfg=None, **kw):
    """The same call through the reference and the port, as numpy."""
    cfg = dict(cfg or {}, matmul_dtype=mm, **BLOCKS)
    with ref_configure(**cfg):
        r = ref_knn.knn_arrays(jnp.asarray(query), jnp.asarray(cand), **kw)
    with configure(**cfg):
        p = port_knn.knn_arrays(torch.from_numpy(query),
                                torch.from_numpy(cand), **kw)
    return [np.asarray(a) for a in r], [a.numpy() for a in p]


# ------------------------------------------------ the blocked search


@pytest.mark.parametrize("exclude_self", [False, True])
@pytest.mark.parametrize("metric", ["cosine", "euclidean", "correlation"])
@pytest.mark.parametrize("coarse", ["topk", "approx"])
def test_blocked_search_matches_reference(coarse, metric, exclude_self):
    n = 500
    pts = _blobs(metric, n, 16, n_clusters=5, spread=0.3, seed=11)
    (r_idx, r_dist), (p_idx, p_dist) = _both(
        pts, pts, cfg=dict(knn_impl="xla", knn_coarse=coarse), k=10,
        metric=metric, exclude_self=exclude_self)
    score_metric = "euclidean" if metric == "euclidean" else "cosine"
    assert_same_neighbours(p_idx[:n], p_dist[:n], r_idx[:n], r_dist[:n],
                           score_metric, ATOL["float32"])
    assert p_idx.shape == (round_up(n, 128), 10)
    assert (p_idx[n:] == -1).all() and (p_dist[n:] == 0).all()
    if exclude_self:
        assert not (p_idx[:n] == np.arange(n)[:, None]).any()


def test_blocked_search_bf16_matches_reference():
    pts = _blobs("cosine", 400, 24, n_clusters=4, spread=0.3, seed=12)
    (r_idx, r_dist), (p_idx, p_dist) = _both(
        pts, pts, mm="bfloat16", cfg=dict(knn_impl="xla"), k=8)
    assert_same_neighbours(p_idx[:400], p_dist[:400], r_idx[:400],
                           r_dist[:400], "cosine", ATOL["bfloat16"])


@pytest.mark.parametrize("coarse", ["topk", "approx"])
def test_blocked_search_equals_kernel_route(coarse):
    """Both routes keep the top k by (score, lower id) of true-float32
    scores; on the CPU they agree but for near-ties."""
    pts = _blobs("cosine", 450, 12, n_clusters=6, spread=0.3, seed=13)
    q = torch.from_numpy(pts)
    with configure(**BLOCKS):
        a = port_knn.knn_arrays(q, q, k=12)
        with configure(knn_impl="xla", knn_coarse=coarse):
            b = port_knn.knn_arrays(q, q, k=12)
    assert_same_neighbours(b[0].numpy()[:450], b[1].numpy()[:450],
                           a[0].numpy()[:450], a[1].numpy()[:450], "cosine",
                           1e-5)


def test_approx_coarse_with_refine_keeps_recall():
    """The reference's ``test_knn_approx_coarse_recall`` on the port."""
    pts, _ = gaussian_blobs(4096, 24, 6, seed=9)
    ref, _ = port_knn.knn_numpy(pts, pts, k=10, metric="cosine")
    q = torch.from_numpy(pts)
    with configure(knn_coarse="approx", knn_impl="xla"):
        idx, _ = port_knn.knn_arrays(q, q, k=10, metric="cosine",
                                     refine=32)
    assert port_knn.recall_at_k(idx.numpy()[:4096], ref) > 0.99


def test_knn_config_fields_exist():
    with configure(knn_impl="xla", knn_coarse="approx",
                   knn_refine_mode="sorted", bench_knn_refine=16) as c:
        assert c.resolved_knn_impl() == "xla"
        assert c.resolved_refine_mode(10) == "sorted"
    assert config.bench_knn_refine == ref_config.bench_knn_refine == 32
    assert config.knn_coarse == "topk"
    with configure(knn_coarse="binned"):
        with pytest.raises(ValueError, match="knn_coarse"):
            port_knn.knn_arrays(torch.zeros((4, 3)), torch.zeros((4, 3)),
                                k=2)


# ------------------------------------------------------- n_valid_cand


@pytest.mark.parametrize("impl", ["auto", "pallas_binned", "xla"])
def test_n_valid_cand_matches_reference_mask(impl):
    """Candidates padded to a bucket of rows with only the first
    ``n_valid_cand`` real: the reference masks the rest (its XLA path),
    the port's kernels search the real rows alone; same neighbours."""
    pts = _blobs("cosine", 300, 10, n_clusters=4, spread=0.3, seed=14)
    nv, bucket = 233, 384
    cand = np.zeros((bucket, 10), np.float32)
    cand[:nv] = pts[:nv]
    (r_idx, r_dist), (p_idx, p_dist) = _both(
        pts, cand, cfg=dict(knn_impl=impl, knn_bins=1024), k=9,
        n_query=300, n_cand=bucket, n_valid_cand=nv)
    assert p_idx[:300].max() < nv
    assert_same_neighbours(p_idx[:300], p_dist[:300], r_idx[:300],
                           r_dist[:300], "cosine", 1e-5)


# ------------------------------------------------------- the refines


def _lists(seed=3):
    rng = np.random.default_rng(seed)
    nq, nc, d, kp = 256, 1024, 20, 32
    q = rng.normal(size=(nq, d)).astype(np.float32)
    c = rng.normal(size=(nc, d)).astype(np.float32)
    idx = rng.integers(0, nc, (nq, kp)).astype(np.int32)
    idx[5, 20:] = -1  # coarse padding must mask identically
    idx[17, :] = -1
    return q, c, idx


def _same_sets(ib, db, is_, ds):
    for r in range(ib.shape[0]):
        assert set(ib[r].tolist()) == set(is_[r].tolist()), r
    np.testing.assert_allclose(np.sort(db, axis=1), np.sort(ds, axis=1),
                               atol=1e-5)


@pytest.mark.parametrize("metric", ["cosine", "euclidean"])
def test_sorted_refine_matches_blocked_and_reference(metric):
    q, c, idx = _lists()
    tq, tc, ti = map(torch.from_numpy, (q, c, idx))
    ib, db = port_knn._refine(tq, tc, ti, k=10, metric=metric)
    is_, ds = port_knn._refine_sorted(tq, tc, ti, k=10, metric=metric)
    _same_sets(ib.numpy(), db.numpy(), is_.numpy(), ds.numpy())
    assert (is_[17] == -1).all()
    rs_i, rs_d = ref_knn._refine_sorted_jit(
        jnp.asarray(q), jnp.asarray(c), jnp.asarray(idx), k=10,
        metric=metric)
    _same_sets(np.asarray(rs_i), np.asarray(rs_d), is_.numpy(), ds.numpy())


def test_sorted_refine_slices_do_not_change_the_result(monkeypatch):
    q, c, idx = map(torch.from_numpy, _lists(seed=4))
    a = port_knn._refine_sorted(q, c, idx, k=10, metric="cosine")
    monkeypatch.setattr(port_knn, "SORTED_SLICE", 100)
    b = port_knn._refine_sorted(q, c, idx, k=10, metric="cosine")
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_refine_mode_reaches_knn_arrays(monkeypatch):
    pts = _blobs("cosine", 300, 12, n_clusters=4, spread=0.3, seed=15)
    q = torch.from_numpy(pts)
    calls = []
    for name in ("_refine", "_refine_sorted"):
        real = getattr(port_knn, name)
        monkeypatch.setattr(port_knn, name, lambda *a, _n=name, _f=real,
                            **kw: calls.append(_n) or _f(*a, **kw))
    out = {}
    for mode in ("blocked", "sorted"):
        with configure(knn_refine_mode=mode):
            out[mode] = port_knn.knn_arrays(q, q, k=10, refine=24)
    with configure(refine_sorted_min_cand=300):
        port_knn.knn_arrays(q, q, k=10, refine=24)
        port_knn.knn_arrays(q[:299], q[:299], k=10, refine=24)
    assert calls == ["_refine", "_refine_sorted", "_refine_sorted",
                     "_refine"]
    _same_sets(out["blocked"][0].numpy(), out["blocked"][1].numpy(),
               out["sorted"][0].numpy(), out["sorted"][1].numpy())


@pytest.mark.parametrize("mode", ["auto", "blocked", "sorted"])
def test_resolved_refine_mode_threshold(mode):
    """The reference's rule at its own cutoff; the port's default cutoff
    is its own, measured on the card (``refine_sweep.py``)."""
    cut = ref_config.refine_sorted_min_cand
    for n_cand in (0, 1, 4095, 4096, 786431, 786432, 10_000_000):
        with ref_configure(knn_refine_mode=mode), \
                configure(knn_refine_mode=mode, refine_sorted_min_cand=cut):
            assert config.resolved_refine_mode(n_cand) == \
                ref_config.resolved_refine_mode(n_cand)
        with configure(knn_refine_mode=mode):
            want = mode if mode != "auto" else (
                "sorted" if n_cand >= 4096 else "blocked")
            assert config.resolved_refine_mode(n_cand) == want
    assert cut == 786432 and config.refine_sorted_min_cand == 4096
    with configure(knn_refine_mode="gathered"):
        with pytest.raises(ValueError, match="knn_refine_mode"):
            config.resolved_refine_mode(10)


# ------------------------------------------------------- neighbors.bbknn


def _bbknn_data(n, pts, batch):
    ref = RefCellData(np.zeros((n, 4), np.float32),
                      obs={"batch": batch}).with_obsm(X_pca=pts)
    port = CellData(torch.zeros((n, 4)), obs={"batch": batch}).with_obsm(
        X_pca=torch.from_numpy(pts))
    return ref, port


def test_bbknn_balances_batches_as_the_reference():
    n = 480
    pts, _ = gaussian_blobs(n, 12, 4, spread=0.3, seed=17)
    batch = np.where(np.arange(n) < 400, "big", "small")
    pts = pts + 0.5 * (batch == "small")[:, None].astype(np.float32)
    ref, port = _bbknn_data(n, pts, batch)
    t = sct.apply("neighbors.bbknn", ref, backend="tpu", k_within=3)
    c = sct.apply("neighbors.bbknn", ref, backend="cpu", k_within=3)
    o = apply("neighbors.bbknn", port, device="cpu", k_within=3)
    io = o.obsp["knn_indices"].numpy()
    assert io.shape == (n, 6) and io.dtype == np.int32
    assert o.uns["knn_k"] == 6 and o.uns["bbknn_k_within"] == 3
    np.testing.assert_array_equal(o.uns["bbknn_batches"], ["big", "small"])
    for other in (t, c):
        ir = np.asarray(other.obsp["knn_indices"])
        match = np.mean([set(io[i]) == set(ir[i]) for i in range(n)])
        assert match > 0.99, match
    np.testing.assert_allclose(
        np.sort(o.obsp["knn_distances"].numpy(), axis=1),
        np.sort(np.asarray(t.obsp["knn_distances"]), axis=1), atol=1e-5)
    from_small = (batch[np.clip(io, 0, n - 1)] == "small") & (io >= 0)
    assert (from_small.sum(axis=1) == 3).all()
    assert not (io == np.arange(n)[:, None]).any()


def test_bbknn_small_batch_pads_as_the_reference():
    rng = np.random.default_rng(3)
    n = 12
    pts = rng.normal(size=(n, 5)).astype(np.float32)
    batch = np.array(["a"] * 10 + ["b"] * 2)
    ref, port = _bbknn_data(n, pts, batch)
    c = sct.apply("neighbors.bbknn", ref, backend="cpu", k_within=3)
    o = apply("neighbors.bbknn", port, device="cpu", k_within=3)
    io, ic = o.obsp["knn_indices"].numpy(), np.asarray(c.obsp["knn_indices"])
    assert io.shape == ic.shape == (n, 6)
    assert o.uns["knn_k"] == int(c.uns["knn_k"]) == 6
    assert (io == -1).any()
    assert np.mean([set(io[i]) == set(ic[i]) for i in range(n)]) == 1.0


def test_bbknn_validation():
    n = 10
    ref, port = _bbknn_data(n, np.zeros((n, 3), np.float32),
                            np.array(["a"] * n))
    with pytest.raises(ValueError, match="2 batches"):
        sct.apply("neighbors.bbknn", ref, backend="cpu")
    with pytest.raises(ValueError, match="2 batches"):
        apply("neighbors.bbknn", port, device="cpu")
    with pytest.raises(KeyError, match="sample"):
        apply("neighbors.bbknn", port, device="cpu", batch_key="sample")


def test_bbknn_searches_once_a_batch(monkeypatch):
    n = 90
    pts, _ = gaussian_blobs(n, 6, 3, seed=2)
    batch = np.repeat([0, 1, 2], 30)
    _, port = _bbknn_data(n, pts, batch)
    calls = []
    real = port_knn.knn_select
    monkeypatch.setattr(port_knn, "knn_select", lambda *a, **kw:
                        calls.append(a[1].shape[0]) or real(*a, **kw))
    apply("neighbors.bbknn", port, device="cpu", k_within=2)
    assert calls == [30, 30, 30]


# ------------------------------------------------------ distance.pairwise


@pytest.mark.parametrize("metric", ["cosine", "euclidean"])
def test_pairwise_matches_reference(metric):
    rng = np.random.default_rng(21)
    emb = (rng.normal(size=(300, 10)) / np.sqrt(10)).astype(np.float32)
    ref = RefCellData(np.zeros((300, 2), np.float32), obsm={"X_pca": emb})
    port = CellData(torch.zeros((300, 2)), obsm={
        "X_pca": torch.from_numpy(emb)})
    t = sct.apply("distance.pairwise", ref.device_put(), backend="tpu",
                  metric=metric)
    c = sct.apply("distance.pairwise", ref, backend="cpu", metric=metric)
    with configure(row_block=64):
        o = apply("distance.pairwise", port, device="cpu", metric=metric)
    got = o.obsp["pairwise_distances"].numpy()
    assert got.shape == (300, 300) and got.dtype == np.float32
    assert o.uns["pairwise_metric"] == metric
    want = np.asarray(t.obsp["pairwise_distances"])
    if metric == "euclidean":  # squared: the sqrt of noise around 0
        got, want = got.astype(np.float64) ** 2, want.astype(np.float64) ** 2
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(o.obsp["pairwise_distances"].numpy(),
                               c.obsp["pairwise_distances"], rtol=1e-3,
                               atol=2e-2)


def test_pairwise_rectangular_and_unknown_metric():
    rng = np.random.default_rng(22)
    a = torch.from_numpy(rng.normal(size=(7, 5)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(11, 5)).astype(np.float32))
    d = pairwise_arrays(a, b, metric="euclidean")
    np.testing.assert_allclose(d.numpy(), torch.cdist(a, b).numpy(),
                               atol=1e-5)
    with pytest.raises(ValueError, match="unknown metric"):
        pairwise_arrays(a, b, metric="manhattan")


# ------------------------------------------ the departures, repaired


def test_iter_knn_chunks_yields_wall_like_the_reference():
    pts = _blobs("cosine", 700, 8, n_clusters=4, spread=0.3, seed=23)
    with ref_configure(row_block=256), configure(row_block=256):
        ref = list(ref_knn.iter_knn_chunks(jnp.asarray(pts), k=6,
                                           chunk=300))
        port = list(port_knn.iter_knn_chunks(torch.from_numpy(pts), k=6,
                                             chunk=300))
    assert len(ref) == len(port) == 2  # chunks of round_up(300, 256)
    for r, p in zip(ref, port):
        assert len(r) == len(p) == 5
        assert r[:2] == p[:2]
        assert isinstance(p[4], float) and p[4] >= 0.0
        assert_same_neighbours(p[2].numpy(), p[3].numpy(), np.asarray(r[2]),
                               np.asarray(r[3]), "cosine", 1e-5)


def test_stream_pipeline_unchunked_returns_padded_rows():
    from sctools_tpu.data.synthetic import synthetic_counts
    from sctools_tpu_torch.data import stream as S

    ds = synthetic_counts(300, 80, density=0.2, n_clusters=3, seed=4)
    src = S.ShardSource.from_scipy(ds.X, shard_rows=128, device="cpu")
    out = S.stream_pipeline(src, n_top=40, n_components=6, k=5, refine=0,
                            device="cpu")
    rows = round_up(300, min(config.row_block, 256))
    assert out["knn_indices"].shape == (rows, 5)
    assert (out["knn_indices"][300:] == -1).all()
    want = port_knn.knn_arrays(out["X_pca"], out["X_pca"], k=5)
    assert torch.equal(out["knn_indices"], want[0])


@pytest.mark.parametrize("op", ["neighbors.bbknn", "distance.pairwise",
                                "neighbors.knn_multichip"])
def test_new_ops_default_to_the_card_and_raise_without_one(op):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: None resolves to it")
    ds = CellData(torch.zeros((16, 2)), obs={"batch": np.arange(16) % 2},
                  obsm={"X_pca": torch.randn(16, 3)})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sctt.apply(op, ds)
