"""The port's shard store against the reference's: one format on disk.

A store that either package writes reads back bit for bit in the other
(same manifest, same chunk digests, same padded-ELL shards), and a
damaged, renamed or cross-wired chunk raises ``ShardCorruptError`` in
the port with the reference's ``.reason``.

The read scheduler's cases (``tests/test_shardstore.py``) run in both
packages on copies of one store, with the same faults on the same
virtual clock: the same shards, ``ingest.*`` counters, fired faults,
journal events and, where no read is deferred, the same backoff sleeps.
"""

import json
import os
import shutil

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from sctools_tpu.data import shardstore as ref_store
from sctools_tpu.data.synthetic import synthetic_counts
from sctools_tpu.utils import chaos as ref_chaos
from sctools_tpu.utils.failsafe import \
    TransientDeviceError as RefTransientError
from sctools_tpu.utils.telemetry import MetricsRegistry as RefRegistry
from sctools_tpu.utils.vclock import VirtualClock as RefClock
from sctools_tpu_torch.data import shardstore as S
from sctools_tpu_torch.data import stream as stream
from sctools_tpu_torch.data.sparse import pack_ell, pack_ell_chunks
from sctools_tpu_torch.utils.chaos import ChaosMonkey, Fault
from sctools_tpu_torch.utils.failsafe import TransientDeviceError
from sctools_tpu_torch.utils.telemetry import MetricsRegistry
from sctools_tpu_torch.utils.vclock import VirtualClock

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def counts():
    return synthetic_counts(1200, 400, density=0.1, n_clusters=4, seed=8)


@pytest.fixture()
def store(counts, tmp_path):
    return S.write_store(counts.X, str(tmp_path / "store"), shard_rows=256,
                         chunk_rows=64)


def _sorted_csr(X):
    X = X.tocsr().copy()
    X.sort_indices()
    return X


def _same_shards(port_store, reference):
    for i in range(port_store.n_shards):
        a = port_store.read_shard(i)
        b = reference.read_shard(i)
        assert a.n_cells == b.n_cells
        np.testing.assert_array_equal(a.indices.numpy(),
                                      np.asarray(b.indices))
        np.testing.assert_array_equal(a.data.numpy(), np.asarray(b.data))


def test_port_store_reads_in_the_reference(counts, store):
    assert (store.n_cells, store.n_genes) == (1200, 400)
    assert store.n_shards == 5 and store.n_chunks == 19
    ref = ref_store.ShardStore.open(store.directory)
    assert ref.manifest == store.manifest
    _same_shards(store, ref)
    got = sp.vstack([s.to_scipy_csr() for s in store.iter_shards()],
                    format="csr")
    assert (got != _sorted_csr(counts.X)).nnz == 0


def test_reference_store_reads_in_the_port(counts, tmp_path, store):
    ref = ref_store.write_store(counts.X, str(tmp_path / "ref"),
                                shard_rows=256, chunk_rows=64)
    port = S.open_store(ref.directory)
    assert port.manifest == ref.manifest
    # the same digests as the store the port wrote
    assert port.manifest["store_digest"] == store.manifest["store_digest"]
    _same_shards(port, ref)


def test_append_to_and_ragged_blocks_give_one_store(counts, tmp_path):
    X = counts.X.tocsr()
    w = S.StoreWriter(str(tmp_path / "ragged"), X.shape[1], shard_rows=256,
                      chunk_rows=64)
    rng = np.random.default_rng(0)
    s = 0
    while s < 640:
        step = int(rng.integers(1, 200))
        w.append(X[s: min(s + step, 640)])
        s = min(s + step, 640)
    w.close()
    w = S.StoreWriter.append_to(str(tmp_path / "ragged"), label="tail")
    w.append(X[640:])
    grown = w.close()
    assert grown.append_labels() == ["tail"]
    ref = ref_store.write_store(X, str(tmp_path / "ref"), shard_rows=256,
                                chunk_rows=64)
    assert [c["digest"] for c in grown.manifest["chunks"]] == \
        [c["digest"] for c in ref.manifest["chunks"]]
    with pytest.raises(ValueError, match="geometry is frozen"):
        S.StoreWriter.append_to(grown, n_genes=3)


def _reason(fn):
    with pytest.raises(Exception) as ei:
        fn()
    return ei.value


@pytest.mark.parametrize("damage", ["flip", "truncate", "rename",
                                    "crosswire"])
def test_corruption_rulings_match_the_reference(counts, tmp_path, damage):
    """Damaged bytes, a truncated file, an intact chunk renamed into
    another slot, and an intact chunk of the right slot but another
    store's content: each raises ``ShardCorruptError`` in the port with
    the reason the reference gives."""
    store = S.write_store(counts.X, str(tmp_path / "s"), shard_rows=256,
                          chunk_rows=64)
    target = 6  # shard 1's third chunk
    path = store.chunk_path(target)
    if damage == "flip":
        blob = bytearray(open(path, "rb").read())
        blob[len(blob) // 2] ^= 0xFF
        open(path, "wb").write(bytes(blob))
    elif damage == "truncate":
        with open(path, "r+b") as fh:
            fh.truncate(os.path.getsize(path) // 2)
    elif damage == "rename":
        shutil.copyfile(store.chunk_path(4), path)
    else:
        other = S.write_store(counts.X[::-1].tocsr(), str(tmp_path / "o"),
                              shard_rows=256, chunk_rows=64)
        shutil.copyfile(other.chunk_path(target), path)
    got = _reason(lambda: store.read_shard(1))
    want = _reason(lambda: ref_store.ShardStore.open(
        store.directory).read_shard(1))
    assert isinstance(got, S.ShardCorruptError)
    assert isinstance(want, ref_store.ShardCorruptError)
    assert got.chunk == want.chunk == target and got.shard == 1
    assert got.reason == want.reason
    expect = {"flip": "digest mismatch|unreadable",
              "truncate": "unreadable",
              "rename": "fingerprint mismatch",
              "crosswire": "manifest digest mismatch"}[damage]
    assert any(e in got.reason for e in expect.split("|")), got.reason
    dest = store.quarantine_chunk(target, got.reason)
    assert os.path.exists(dest) and os.path.exists(dest + ".reason.json")
    assert store.quarantine_chunk(target, got.reason) is None


def test_open_refuses_bad_manifest(store, tmp_path):
    with pytest.raises(S.ShardCorruptError, match="unreadable"):
        S.ShardStore.open(str(tmp_path))
    mpath = os.path.join(store.directory, "manifest.json")
    doc = json.load(open(mpath))
    doc["schema"] = 999
    json.dump(doc, open(mpath, "w"))
    with pytest.raises(S.ShardCorruptError, match="newer than supported"):
        S.ShardStore.open(store.directory)


def test_pack_ell_chunks_matches_one_pack(counts):
    X = _sorted_csr(counts.X)[:256].astype(np.float32)
    cap = 128
    chunks = [(X[r: r + 64].indptr, X[r: r + 64].indices,
               X[r: r + 64].data, r) for r in range(0, 256, 64)]
    got = pack_ell_chunks(chunks, 256, cap, sentinel=400)
    want = pack_ell(X.indptr.astype(np.int64), X.indices, X.data, 256, cap,
                    400)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    with pytest.raises(ValueError, match="refusing to drop"):
        pack_ell_chunks(chunks, 256, 8, sentinel=400)


def test_store_source_streams_the_same_stats(counts, store):
    src = store.source(device="cpu")
    assert src.prefetch and src.n_shards == 5
    plain = stream.ShardSource.from_scipy(counts.X, shard_rows=256,
                                          capacity=store.capacity,
                                          device="cpu")
    a = stream.stream_stats(src)
    b = stream.stream_stats(plain)
    for key in a:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    # seeks: a resumed pass reads only the shards it has not done
    tail = list(src.iter_from(3))
    assert [o for o, _ in tail] == [768, 1024]
    # a scheduler must serve this store, and fail on corruption
    with pytest.raises(ValueError, match="different store"):
        store.source(scheduler=S.ShardReadScheduler(
            S.ShardStore.open(store.directory)), device="cpu")
    with pytest.raises(ValueError, match="skip"):
        store.source(scheduler=S.ShardReadScheduler(store, on_corrupt="skip"),
                     device="cpu")
    with pytest.raises(ValueError, match="on_corrupt"):
        S.ShardReadScheduler(store, on_corrupt="ignore")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            store.source()


# ----------------------------------------------------------------------
# the read scheduler, in both packages
# ----------------------------------------------------------------------

_PORT = dict(store=S.ShardStore, sched=S.ShardReadScheduler,
             monkey=ChaosMonkey, fault=Fault, registry=MetricsRegistry,
             clock=VirtualClock, corrupt=S.ShardCorruptError,
             transient=TransientDeviceError)
_REF = dict(store=ref_store.ShardStore, sched=ref_store.ShardReadScheduler,
            monkey=ref_chaos.ChaosMonkey, fault=ref_chaos.Fault,
            registry=RefRegistry, clock=RefClock,
            corrupt=ref_store.ShardCorruptError,
            transient=RefTransientError)


def _run_ladder(kit, directory, faults, slow_s=30.0, journal=None,
                consumers=1, start=0, **kw):
    """Open the store at ``directory`` in one package, read it through a
    scheduler with ``faults`` on a virtual clock; returns what the
    reading gave (the shards as CSR, or the exception), the counters,
    the clock's sleeps, the fired faults, the consults and ``.skipped``."""
    store = kit["store"].open(directory)
    clk = kit["clock"]()
    m = kit["registry"]()
    monkey = kit["monkey"]([kit["fault"](*f[:2], **f[2]) for f in faults],
                           slow_s=slow_s)
    sched = kit["sched"](store, clock=clk, metrics=m, chaos=monkey,
                         journal=journal, **kw)
    with sched:
        try:
            if consumers == 1:
                got = [s.to_scipy_csr() for s in sched.iter_shards(start)]
            else:
                its = [sched.iter_shards(start) for _ in range(consumers)]
                got = [[s.to_scipy_csr() for s in t] for t in zip(*its)]
        except Exception as e:  # noqa: BLE001 - compared between packages
            got = e
    snap = m.snapshot()
    return {"got": got, "counters": snap["counters"],
            "wait": snap["histograms"].get("ingest.read_wait_s"),
            "sleeps": list(clk.sleeps),
            "fired": sorted((f["op"], f["mode"]) for f in monkey.injected),
            "consulted": sorted(monkey.calls), "skipped": list(sched.skipped)}


LADDER = {
    # name: (faults, slow_s, scheduler kwargs, same sleeps)
    "budget": ([], 30.0, dict(n_readers=2, ram_budget_bytes="one"), True),
    "retry": ([("chunk-00000", "io_error", dict(times=2))], 30.0, {}, True),
    "exhausted": ([("chunk-00000", "io_error", dict(times=-1))], 30.0, {},
                  True),
    "truncate": ([("chunk-00006", "truncate_shard", {})], 30.0,
                 dict(on_corrupt="fail"), True),
    "hedge": ([("chunk-00004", "slow_read", {})], 9.0,
              dict(hedge_after_s=2.0), False),
    "below_slo": ([("chunk-00004", "slow_read", {})], 1.0,
                  dict(hedge_after_s=5.0), False),
    "deadline": ([("chunk-00000", "slow_read", dict(times=1))], 60.0,
                 dict(read_deadline_s=3.0), False),
    "acceptance": ([("chunk-00005", "io_error", dict(times=2)),
                    ("chunk-00009", "truncate_shard", {}),
                    ("chunk-00013", "slow_read", {})], 9.0,
                   dict(n_readers=2, hedge_after_s=2.0, on_corrupt="skip"),
                   False),
}


@pytest.mark.parametrize("case", sorted(LADDER))
def test_read_ladder_matches_the_reference(counts, store, tmp_path, case):
    """Each rung of the reference's tests (its budget, retry, exhausted
    retry, quarantine, hedge, SLO, deadline and acceptance cases) in
    both packages on copies of one store."""
    faults, slow_s, kw, same_sleeps = LADDER[case]
    if kw.get("ram_budget_bytes") == "one":
        kw = dict(kw, ram_budget_bytes=store.shard_nbytes_est())
    ref_dir = str(tmp_path / "ref_copy")
    shutil.copytree(store.directory, ref_dir)
    runs = {}
    for name, kit, d in (("port", _PORT, store.directory),
                         ("ref", _REF, ref_dir)):
        jp = str(tmp_path / f"{name}.jsonl")
        runs[name] = _run_ladder(kit, d, faults, slow_s, journal=jp, **kw)
        runs[name]["events"] = ([json.loads(x) for x in open(jp)]
                                if os.path.exists(jp) else [])
    port, ref = runs["port"], runs["ref"]
    assert port["counters"] == ref["counters"]
    assert port["fired"] == ref["fired"]
    assert port["skipped"] == ref["skipped"]
    if same_sleeps:
        assert port["sleeps"] == ref["sleeps"]
    if isinstance(ref["got"], Exception):
        assert type(port["got"]).__name__ == type(ref["got"]).__name__
        assert str(port["got"]).replace(store.directory, "") == str(
            ref["got"]).replace(ref_dir, "")
    else:
        assert len(port["got"]) == len(ref["got"])
        for a, b in zip(port["got"], ref["got"]):
            assert (a != b).nnz == 0
    for e in port["events"] + ref["events"]:
        e.pop("ts")
        e["path"] = os.path.basename(e["path"])
    assert port["events"] == ref["events"]
    X = _sorted_csr(counts.X)
    c = port["counters"]
    if case == "budget":
        assert c["ingest.reads{outcome=served}"] == store.n_shards
        assert (sp.vstack(port["got"], format="csr") != X).nnz == 0
    elif case == "retry":
        assert c["ingest.retries"] == 2 and port["sleeps"]
        assert c["ingest.reads{outcome=retried}"] == 1
    elif case == "exhausted":
        assert isinstance(port["got"], TransientDeviceError)
        assert "io_error" in str(port["got"])
    elif case == "truncate":
        assert isinstance(port["got"], S.ShardCorruptError)
        assert port["got"].chunk == 6
        qdir = os.path.join(store.directory, "chunks", "quarantine")
        assert os.path.exists(os.path.join(qdir, "chunk-00006.npz"))
        assert os.path.exists(os.path.join(qdir,
                                           "chunk-00006.npz.reason.json"))
        assert not os.path.exists(store.chunk_path(6))  # moved, kept
        assert [e["event"] for e in port["events"]] == ["shard_quarantined"]
        assert port["events"][0]["shard"] == 1
    elif case == "hedge":
        assert c["ingest.hedges"] == 1
        assert c["ingest.reads{outcome=hedged}"] == 1
        assert port["wait"]["max"] < 9.0
    elif case == "below_slo":
        assert "ingest.hedges" not in c
        assert c["ingest.reads{outcome=served}"] == store.n_shards
    elif case == "deadline":
        assert c["ingest.reads{outcome=retried}"] == 1
    else:
        assert port["skipped"] == [2]
        kept = sp.vstack([X[:512], X[768:]], format="csr")
        assert (sp.vstack(port["got"], format="csr") != kept).nnz == 0
        assert c["ingest.quarantines"] == 1


def test_scheduler_feeds_two_consumers_and_seeks(counts, store, tmp_path):
    X = _sorted_csr(counts.X)
    two = _run_ladder(_PORT, store.directory, [], consumers=2, n_readers=2)
    for k in range(2):
        assert (sp.vstack([pair[k] for pair in two["got"]], format="csr")
                != X).nnz == 0
    # a seek touches none of the skipped shards' chunks
    port = _run_ladder(_PORT, store.directory, [], start=3)
    ref = _run_ladder(_REF, store.directory, [], start=3)
    assert len(port["got"]) == store.n_shards - 3
    assert port["consulted"] == ref["consulted"] == [
        f"chunk-{c:05d}@io" for c in range(store.chunk_range(3)[0],
                                           store.n_chunks)]
    with S.ShardReadScheduler(store) as sched:
        with pytest.raises(IndexError):
            list(sched.iter_order([0, 99]))
        got = [s.to_scipy_csr() for s in sched.iter_order([3, 2, 0, 1])]
    for s, i in zip(got, [3, 2, 0, 1]):
        assert (s != store.read_shard(i).to_scipy_csr()).nnz == 0


def test_source_through_the_scheduler_equals_plain(counts, store):
    """``stream_stats`` over ``source(scheduler=)`` gives the plain
    source's bits, and a seek through the scheduler reads only the
    shards left."""
    m = MetricsRegistry()
    with S.ShardReadScheduler(store, n_readers=2, metrics=m) as sched:
        got = stream.stream_stats(store.source(scheduler=sched,
                                               device="cpu"))
        tail = list(store.source(scheduler=sched, device="cpu",
                                 prefetch=False).iter_from(3))
    want = stream.stream_stats(store.source(device="cpu"))
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert [o for o, _ in tail] == [768, 1024]
    assert m.snapshot_compact()["ingest.reads{outcome=served}"] == \
        store.n_shards + 2
