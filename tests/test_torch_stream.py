"""The streamed path of the port against the JAX reference.

One CSR fixture (the reference's ``synthetic_counts(1200, 400,
density=0.1, n_clusters=4, seed=8)``, 256-row shards: five, the last
ragged) feeds both packages' ``ShardSource.from_scipy``.  Tolerances:
per-cell totals and gene counts equal, ``pct_counts_mt`` rtol 1e-6,
gene moments and nnz rtol 1e-5 (float32 shard sums, float64 combine in
both); each HVG flavor the same gene set, where a difference must be a
near-tie (score within 1e-5 relative of the ``n_top``-th score, said in
the assertion message); PCA with the reference's sketch carried over
(``_sketch_omega`` → ``carry.pca_omega_from_numpy``): explained
variance rtol 1e-3, the first 10 score columns equal up to sign within
1e-3 of each column's norm, 15-NN recall between the embeddings ≥ 0.99.
The port's own checks: chunked kNN bit for bit one search, resume bit
for bit an uninterrupted pass, prefetch order, error tags, retries and
abandonment, and ``DeviceSyntheticSource``'s invariants."""

import dataclasses
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sctools_tpu.data import stream as ref_stream
from sctools_tpu.data.synthetic import _cluster_cdfs as ref_cluster_cdfs
from sctools_tpu.data.synthetic import synthetic_counts
from sctools_tpu.ops.pca import _sketch_omega
from sctools_tpu_torch.carry import pca_omega_from_numpy
from sctools_tpu_torch.config import configure, round_up
from sctools_tpu_torch.data import stream as S
from sctools_tpu_torch.data.synthetic import (DeviceSyntheticSource,
                                              _cluster_cdfs)
from sctools_tpu_torch.ops.knn import (iter_knn_chunks, knn_arrays,
                                       knn_numpy, recall_at_k)
from sctools_tpu_torch.utils.checkpoint import _read_arrays
from sctools_tpu_torch.utils.failsafe import TransientDeviceError
from sctools_tpu_torch.utils.vclock import VirtualClock

torch.set_num_threads(2)

N_TOP = 200
N_PCS = 20


@pytest.fixture(scope="module")
def counts():
    return synthetic_counts(1200, 400, density=0.1, n_clusters=4, seed=8)


@pytest.fixture(scope="module")
def ref_src(counts):
    return ref_stream.ShardSource.from_scipy(counts.X, shard_rows=256)


@pytest.fixture(scope="module")
def src(counts):
    return S.ShardSource.from_scipy(counts.X, shard_rows=256, device="cpu")


@pytest.fixture(scope="module")
def mito(counts):
    return np.asarray(counts.var["mito"])


@pytest.fixture(scope="module")
def stats(src, mito):
    return S.stream_stats(src, mito_mask=mito)


@pytest.fixture(scope="module")
def ref_stats(ref_src, mito):
    return ref_stream.stream_stats(ref_src, mito_mask=mito)


@pytest.fixture(scope="module")
def hvg(ref_stats, ref_src):
    return ref_stream.stream_hvg(ref_stats, n_top=N_TOP, flavor="seurat_v3",
                                 src=ref_src)


@pytest.fixture(scope="module")
def omega(hvg):
    om = _sketch_omega(jax.random.PRNGKey(0), len(hvg), N_PCS + 10,
                       jnp.float32)
    return pca_omega_from_numpy(np.asarray(om))


@pytest.fixture(scope="module")
def pcas(src, ref_src, stats, ref_stats, hvg, omega):
    ref = ref_stream.stream_pca(ref_src, hvg, ref_stats["gene_mean"],
                                jax.random.PRNGKey(0), n_components=N_PCS)
    port = S.stream_pca(src, hvg, stats["gene_mean"], n_components=N_PCS,
                        omega=omega)
    return ([np.asarray(a) for a in ref], [a.numpy() for a in port])


def _crashing(src, at: int):
    """``src`` whose shard ``at`` raises (a worker killed mid-pass)."""
    base_from = src.factory_from

    def exploding_from(k):
        for i, s in enumerate(base_from(k), start=k):
            if i == at:
                raise RuntimeError(f"simulated crash at shard {at}")
            yield s

    return dataclasses.replace(src, factory=lambda: exploding_from(0),
                               factory_from=exploding_from)


def _counting(src, reads: list):
    base_from = src.factory_from

    def counting_from(k):
        for i, s in enumerate(base_from(k), start=k):
            reads.append(i)
            yield s

    return dataclasses.replace(src, factory=lambda: counting_from(0),
                               factory_from=counting_from)


# ----------------------------------------------------------------------
# sources
# ----------------------------------------------------------------------


def test_shard_source_matches_reference(src, ref_src):
    assert (src.n_cells, src.n_genes, src.n_shards) == (1200, 400, 5)
    got = list(src)
    want = list(ref_src)
    assert [o for o, _ in got] == [o for o, _ in want] == [0, 256, 512,
                                                           768, 1024]
    assert got[-1][1].n_cells == 176
    for (_, a), (_, b) in zip(got, want):
        assert a.n_cells == b.n_cells and a.capacity == b.capacity
        np.testing.assert_array_equal(a.indices.numpy(),
                                      np.asarray(b.indices))
        np.testing.assert_array_equal(a.data.numpy(), np.asarray(b.data))


def test_source_defaults_to_the_card(counts):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: None resolves to it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        S.ShardSource.from_scipy(counts.X, shard_rows=256)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DeviceSyntheticSource(64, 32, capacity=128, shard_rows=32)


def test_pipeline_device_must_be_the_sources(src):
    with pytest.raises(ValueError, match="lie on cpu"):
        S.stream_pipeline(src, device="meta")


def test_from_h5ad_equals_from_scipy(counts, tmp_path, src):
    pytest.importorskip("h5py")
    from sctools_tpu.data.io import write_h5ad
    from sctools_tpu_torch.data.io import shard_iter

    path = str(tmp_path / "counts.h5ad")
    write_h5ad(counts, path)
    h5 = S.ShardSource.from_h5ad(path, shard_rows=256, device="cpu")
    assert h5.prefetch and (h5.n_cells, h5.n_genes) == (1200, 400)
    for (oa, a), (ob, b) in zip(h5, src):
        assert oa == ob and a.n_cells == b.n_cells
        assert torch.equal(a.indices, b.indices)
        assert torch.equal(a.data, b.data)
    # the h5 reader seeks
    tail = list(shard_iter(path, 256, start_row=512, capacity=src_cap(src)))
    assert len(tail) == 3
    assert torch.equal(tail[0].data, list(src)[2][1].data)
    with pytest.raises(ValueError, match="multiple"):
        next(shard_iter(path, 256, start_row=100))


def src_cap(src) -> int:
    return next(iter(src))[1].capacity


# ----------------------------------------------------------------------
# stats and HVG
# ----------------------------------------------------------------------


def test_stream_stats_parity(stats, ref_stats):
    np.testing.assert_array_equal(stats["total_counts"],
                                  np.asarray(ref_stats["total_counts"]))
    np.testing.assert_array_equal(stats["n_genes"],
                                  np.asarray(ref_stats["n_genes"]))
    np.testing.assert_allclose(stats["pct_counts_mt"],
                               ref_stats["pct_counts_mt"], rtol=1e-6)
    for key in ("gene_mean", "gene_var", "raw_gene_mean", "raw_gene_var",
                "gene_nnz"):
        np.testing.assert_allclose(stats[key], ref_stats[key], rtol=1e-5,
                                   err_msg=key)
    assert stats["n_cells"] == ref_stats["n_cells"] == 1200


@pytest.mark.parametrize("flavor", ["seurat_v3", "dispersion", "seurat",
                                    "cell_ranger", "pearson_residuals"])
def test_stream_hvg_flavor_parity(flavor, stats, ref_stats, src, ref_src):
    got = S.stream_hvg(stats, n_top=N_TOP, flavor=flavor, src=src)
    want = ref_stream.stream_hvg(ref_stats, n_top=N_TOP, flavor=flavor,
                                 src=ref_src)
    assert len(got) == N_TOP and np.all(np.diff(got) > 0)
    diff = sorted(set(got.tolist()) ^ set(want.tolist()))
    scores = S.stream_hvg_scores(stats, flavor=flavor, src=src)
    cut = np.sort(scores)[::-1][N_TOP - 1]
    far = [g for g in diff
           if abs(scores[g] - cut) > 1e-5 * abs(cut)]
    assert not far, (
        f"{flavor}: genes {far} differ from the reference's set and are "
        f"no near-tie of the cutoff score {cut}")
    if diff:  # near-ties at the cutoff only (the message says which)
        assert len(diff) <= 4, f"{flavor}: near-ties at the cutoff {diff}"


def test_stream_hvg_needs_src(stats):
    for flavor in ("seurat_v3", "pearson_residuals"):
        with pytest.raises(ValueError, match="needs src"):
            S.stream_hvg(stats, flavor=flavor)
    with pytest.raises(ValueError, match="unknown hvg flavor"):
        S.stream_hvg(stats, flavor="nope")


# ----------------------------------------------------------------------
# PCA
# ----------------------------------------------------------------------


def test_stream_pca_parity_with_the_reference_sketch(pcas):
    (rs, rc, re), (ps, pc, pe) = pcas
    assert ps.shape == (1200, N_PCS) and pc.shape == (N_TOP, N_PCS)
    np.testing.assert_allclose(pe, re, rtol=1e-3)
    for j in range(10):
        a, b = rs[:, j], ps[:, j]
        sign = 1.0 if np.dot(a, b) >= 0 else -1.0
        assert np.abs(a - sign * b).max() <= 1e-3 * np.linalg.norm(a), j
    ia, _ = knn_numpy(rs, rs, k=15, metric="cosine")
    ib, _ = knn_numpy(ps, ps, k=15, metric="cosine")
    assert recall_at_k(ib, ia) >= 0.99


def test_stream_pca_padding_rows_stay_zero(src, stats, hvg, omega):
    """The last shard's padding rows of Q take no part in any sweep: a
    source whose last shard carries garbage counts in its padding rows
    gives the same bits."""
    base = src.factory

    def dirty():
        for shard in base():
            if shard.n_cells < shard.rows_padded:
                ind = shard.indices.clone()
                dat = shard.data.clone()
                ind[shard.n_cells:, 0] = 3
                dat[shard.n_cells:, 0] = 7.0
                shard = S.SparseCells(ind, dat, shard.n_cells, shard.n_genes)
            yield shard

    odd = dataclasses.replace(src, factory=dirty, factory_from=None)
    assert next(iter(odd))[1].rows_padded == 256
    want = S.stream_pca(src, hvg, stats["gene_mean"], n_components=N_PCS,
                        omega=omega)
    got = S.stream_pca(odd, hvg, stats["gene_mean"], n_components=N_PCS,
                       omega=omega)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_shard_rmatvec_matches_dense_product(src, stats, hvg):
    """``_shard_rmatvec`` of the ragged last shard against the centred
    float64 dense product of its normalised HVG subset: the slots of
    genes outside the subset stay out.  Tolerance 1e-4 of the
    product's scale (float32 scatter)."""
    g_sub = len(hvg)
    mapping = np.full(src.n_genes + 1, g_sub, np.int32)
    mapping[hvg] = np.arange(g_sub, dtype=np.int32)
    mu = stats["gene_mean"][hvg].astype(np.float32)
    sh = list(src)[-1][1]
    Q = np.random.default_rng(0).normal(
        size=(sh.rows_padded, 7)).astype(np.float32)
    got = S._shard_rmatvec(sh, torch.from_numpy(mapping),
                           torch.from_numpy(mu), torch.from_numpy(Q), 1e4,
                           g_sub).numpy()
    dense = sh.to_dense().numpy().astype(np.float64)
    tot = dense.sum(axis=1, keepdims=True)
    xn = np.log1p(dense * np.where(tot > 0, 1e4 / np.maximum(tot, 1e-12),
                                   0.0))
    want = (xn[:, hvg] - mu).T @ Q[: sh.n_cells]
    assert got.shape == (g_sub, 7)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * np.abs(want).max())


# ----------------------------------------------------------------------
# kNN in query chunks, and the whole path
# ----------------------------------------------------------------------


def test_iter_knn_chunks_bitwise_one_search(pcas):
    scores = torch.from_numpy(pcas[1][0])
    n = scores.shape[0]
    idx, dist = knn_arrays(scores, scores, k=15, n_query=n, n_cand=n,
                           refine=32)
    for row_block, chunks in ((1024, 2), (256, 3)):
        with configure(row_block=row_block):
            parts = list(iter_knn_chunks(scores, k=15, chunk=300,
                                         refine=32))
        assert len(parts) == chunks
        offs, nqs, idxs, dists, walls = zip(*parts)
        assert list(offs) == [i * nqs[0] for i in range(chunks)]
        assert sum(nqs) == n
        assert torch.equal(torch.cat(idxs), idx[:n])
        assert torch.equal(torch.cat(dists), dist[:n])
        assert all(isinstance(w, float) and w >= 0.0 for w in walls)


def test_stream_pipeline_knn_chunk_same_result(src, mito, hvg, omega):
    kw = dict(n_top=N_TOP, n_components=N_PCS, k=10, mito_mask=mito,
              refine=32, omega=omega, device="cpu")
    full = S.stream_pipeline(src, **kw)
    chunked = S.stream_pipeline(src, knn_chunk=300, **kw)
    n = full["n_cells"]
    np.testing.assert_array_equal(full["hvg_genes"], hvg)
    assert torch.equal(chunked["X_pca"], full["X_pca"])
    # without knn_chunk, knn_arrays' padded rows, as the reference's
    # stream_pipeline returns them; with it, one row per cell
    assert full["knn_indices"].shape == (round_up(n, 256), 10)
    assert (full["knn_indices"][n:] == -1).all()
    assert chunked["knn_indices"].shape == (n, 10)
    assert torch.equal(chunked["knn_indices"], full["knn_indices"][:n])
    assert torch.equal(chunked["knn_distances"],
                       full["knn_distances"][:n])
    emb = full["X_pca"].numpy()
    ref, _ = knn_numpy(emb, emb, k=10, metric="cosine")
    assert recall_at_k(full["knn_indices"][:n].numpy(), ref) >= 0.99
    assert len(full["obs"]["total_counts"]) == n


# ----------------------------------------------------------------------
# resume
# ----------------------------------------------------------------------


def test_stream_stats_resume_bitwise(src, tmp_path):
    ck = str(tmp_path / "stats.npz")
    want = S.stream_stats(src)
    with pytest.raises(RuntimeError, match="shard 2"):
        S.stream_stats(_crashing(src, 2), checkpoint=ck)
    assert os.path.exists(ck)
    fp = _read_arrays(ck)["_integrity/fingerprint"]
    assert str(fp) == "stream_stats-v1"
    reads = []
    got = S.stream_stats(_counting(src, reads), checkpoint=ck)
    assert reads == [2, 3, 4]  # seeks to shard 2, nothing re-read
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert not os.path.exists(ck) and not os.path.exists(ck + ".prev")
    # a checkpoint of other arguments is wrong, not corrupt
    with pytest.raises(RuntimeError):
        S.stream_stats(_crashing(src, 1), checkpoint=ck)
    with pytest.raises(ValueError, match="different source"):
        S.stream_stats(src, target_sum=2e4, checkpoint=ck)


def test_stream_stats_corrupt_resume_quarantined(src, tmp_path):
    ck = str(tmp_path / "stats.npz")
    want = S.stream_stats(src)
    with pytest.raises(RuntimeError, match="shard 3"):
        S.stream_stats(_crashing(src, 3), checkpoint=ck)
    assert os.path.exists(ck + ".prev")
    blob = bytearray(open(ck, "rb").read())
    for i in range(0, len(blob), max(len(blob) // 16, 1)):
        blob[i] ^= 0xFF
    open(ck, "wb").write(bytes(blob))
    reads = []
    with pytest.warns(RuntimeWarning, match="quarantined"):
        got = S.stream_stats(_counting(src, reads), checkpoint=ck)
    assert reads == [2, 3, 4]  # .prev: one shard earlier
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    qdir = tmp_path / "quarantine"
    assert (qdir / "stats.npz").exists()
    assert (qdir / "stats.npz.reason.json").exists()


def test_stream_pca_resume_bitwise(src, stats, hvg, omega, tmp_path):
    args = dict(gene_idx=hvg, gene_mean=stats["gene_mean"],
                n_components=N_PCS, omega=omega)
    want = S.stream_pca(src, **args)
    ck = str(tmp_path / "pca.npz")
    visits = [0]
    base_from = src.factory_from

    def exploding_from(k):
        for s in base_from(k):
            visits[0] += 1
            # matvec sweep: visits 1-5; the rmatvec's third shard is 8
            if visits[0] == 8:
                raise RuntimeError("simulated crash after shard 2")
            yield s

    crashing = dataclasses.replace(src, factory=lambda: exploding_from(0),
                                   factory_from=exploding_from)
    with pytest.raises(RuntimeError, match="after shard 2"):
        S.stream_pca(crashing, checkpoint=ck, **args)
    state = np.load(ck)
    assert int(state["round"]) == 0 and int(state["next_shard"]) == 2
    got = S.stream_pca(src, checkpoint=ck, **args)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert not os.path.exists(ck)
    np.savez(ck, n_cells=1, g_sub=1, L=1, n_iter=1, target_sum=1.0,
             round=0, next_shard=0, carrier=np.zeros((1, 1)),
             acc=np.zeros((1, 1)))
    with pytest.raises(ValueError, match="different arguments"):
        S.stream_pca(src, checkpoint=ck, **args)


def test_stream_pipeline_checkpoint_dir(src, omega, tmp_path):
    kw = dict(n_top=N_TOP, n_components=N_PCS, k=8, omega=omega,
              device="cpu")
    want = S.stream_pipeline(src, **kw)
    ckd = str(tmp_path / "cks")
    got = S.stream_pipeline(src, checkpoint_dir=ckd, **kw)
    assert torch.equal(got["X_pca"], want["X_pca"])
    assert os.listdir(ckd) == []


# ----------------------------------------------------------------------
# prefetch
# ----------------------------------------------------------------------


def test_prefetch_orders_and_tags_generator_errors():
    assert list(S._prefetch_iter(lambda: iter(range(5)))) == list(range(5))

    def bad():
        yield "a"
        raise RuntimeError("reader died")

    with pytest.raises(RuntimeError, match="reader died") as ei:
        list(S._prefetch_iter(bad))
    assert ei.value.shard_index == 1


def test_prefetch_prepare_runs_in_the_worker():
    main = threading.get_ident()
    seen = []

    def prepare(x):
        seen.append(threading.get_ident())
        return ("prep", x)

    out = list(S._prefetch_iter(lambda: iter(range(4)), prepare=prepare))
    assert out == [("prep", i) for i in range(4)]
    assert seen and all(t != main for t in seen)


def test_prefetch_transient_retries_on_a_virtual_clock():
    clk = VirtualClock()
    retries, blips = [], []

    def prepare(x):
        if x == 1 and len(blips) < 2:
            blips.append(x)
            raise TransientDeviceError("UNAVAILABLE: disk blip")
        return x

    out = list(S._prefetch_iter(lambda: iter(range(3)), prepare=prepare,
                                clock=clk,
                                on_retry=lambda: retries.append(1)))
    assert out == [0, 1, 2] and len(retries) == 2
    assert clk.sleeps == [0.05, 0.1]  # backoff scheduled, never slept

    def always(x):
        raise OSError(5, "Input/output error")

    with pytest.raises(OSError) as ei:
        list(S._prefetch_iter(lambda: iter(range(2)), prepare=always,
                              clock=VirtualClock(), prepare_retries=2,
                              on_retry=lambda: None))
    assert ei.value.shard_index == 0


def test_prefetch_deterministic_error_fails_fast_with_index():
    retries = []

    def prepare(x):
        if x == 1:
            raise ValueError("bad shard bytes")
        return x

    it = S._prefetch_iter(lambda: iter(range(3)), prepare=prepare,
                          on_retry=lambda: retries.append(1))
    assert next(it) == 0
    with pytest.raises(ValueError, match="bad shard") as ei:
        list(it)
    assert ei.value.shard_index == 1 and not retries


def test_prefetch_overlap_and_stall_counters():
    clk = VirtualClock()
    got = {}

    def packer():
        for i in range(6):
            clk.advance(1.0)  # pack + copy
            yield i

    items = []
    for item in S._prefetch_iter(packer, clock=clk,
                                 on_stall=lambda s: got.update(stall=s),
                                 on_overlap=lambda s: got.update(ovl=s)):
        clk.advance(3.0)  # consumer compute
        items.append(item)
    assert items == list(range(6))
    assert got["ovl"] > 0.0 and got["stall"] >= 0.0
    assert got["ovl"] <= 4.0 * 6


def test_prefetch_abandoned_consumer_unblocks_producer():
    finished = threading.Event()

    def gen():
        try:
            yield from range(100)
        finally:
            finished.set()

    it = S._prefetch_iter(gen)
    assert next(it) == 0
    it.close()
    assert finished.wait(timeout=10.0), "producer thread leaked"


def test_prefetching_source_gives_the_plain_shards(src):
    pre = dataclasses.replace(src, prefetch=True,
                              counters=S.StreamCounters())
    a = list(pre)
    b = list(src)
    assert [o for o, _ in a] == [o for o, _ in b]
    for (_, x), (_, y) in zip(a, b):
        assert torch.equal(x.indices, y.indices)
        assert torch.equal(x.data, y.data)
    c = pre.counters
    assert c.stall_s > 0.0 and c.overlap_s >= 0.0 and c.retries == 0


# ----------------------------------------------------------------------
# device-generated shards
# ----------------------------------------------------------------------


def test_cluster_cdfs_equal_the_references():
    for args in ((400, 4, 8), (1200, 8, 0)):
        np.testing.assert_array_equal(_cluster_cdfs(*args),
                                      ref_cluster_cdfs(*args))


def test_device_synthetic_source_invariants():
    n, g = 1000, 300
    src = DeviceSyntheticSource(n, g, capacity=128, shard_rows=256, seed=3,
                                device="cpu")
    assert src.n_shards == 4 and src.shard_rows == 256
    shards = list(src)
    assert [o for o, _ in shards] == [0, 256, 512, 768]
    for off, sh in shards:
        ind = sh.indices.numpy()
        dat = sh.data.numpy()
        valid = ind != g
        assert ind.min() >= 0 and ind.max() <= g
        assert np.all(dat[~valid] == 0)
        assert np.all(dat[valid] >= 1) and np.all(dat == np.round(dat))
        assert not valid[sh.n_cells:].any()  # invalid rows are empty
        for r in range(sh.n_cells):
            ids = ind[r][valid[r]]
            assert len(ids) and np.all(np.diff(ids) > 0)  # sorted, unique
    # counts sum per row: the merge keeps every drawn count
    regen = DeviceSyntheticSource(n, g, capacity=128, shard_rows=256,
                                  seed=3, materialize=False, device="cpu")
    for (_, a), (_, b) in zip(regen.iter_from(1), shards[1:]):
        assert torch.equal(a.indices, b.indices)
        assert torch.equal(a.data, b.data)
    stats = S.stream_stats(src)
    assert stats["total_counts"].shape == (n,)
    assert np.all(stats["n_genes"] >= 1)
