"""The port's shard store against the reference's: one format on disk.

A store that either package writes reads back bit for bit in the other
(same manifest, same chunk digests, same padded-ELL shards), and a
damaged, renamed or cross-wired chunk raises ``ShardCorruptError`` in
the port with the reference's ``.reason``."""

import json
import os
import shutil

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from sctools_tpu.data import shardstore as ref_store
from sctools_tpu.data.synthetic import synthetic_counts
from sctools_tpu_torch.data import shardstore as S
from sctools_tpu_torch.data import stream as stream
from sctools_tpu_torch.data.sparse import pack_ell, pack_ell_chunks

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
    with pytest.raises(NotImplementedError, match="Queue 1 item 13"):
        store.source(scheduler=object(), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            store.source()
