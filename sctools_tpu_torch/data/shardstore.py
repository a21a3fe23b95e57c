"""Durable shard store: the on-disk format of out-of-core ingest.

A store is a directory: one checksummed ``.npz`` per CSR chunk of
``chunk_rows`` cells (``data/io.py:write_csr_chunk``, the verified npz
layer's ``_integrity/*`` keys: content digest, schema, identity
fingerprint) and a ``manifest.json`` that records every chunk's digest.
Three failures are caught before a bad byte reaches the device: damaged
bytes (the file's digest), a renamed or foreign file (the slot
fingerprint) and an intact file in the wrong slot (the manifest's
digest).  A shard (the streaming unit, ``shard_rows`` cells) is several
chunks, packed on read into one padded-ELL shard of the manifest's
global capacity.

The format is that of ``sctools_tpu/data/shardstore.py``: one store on
disk feeds both packages.  Its ``ShardReadScheduler`` (reader pool,
hedged reads, chaos IO, the read journal) is not ported yet: ROADMAP.md
Queue 1 item 13.
"""

from __future__ import annotations

import hashlib
import json
import os

import numpy as np
import torch

from ..config import config, round_up
from ..utils.checkpoint import (CheckpointCorruptError,
                                quarantine_checkpoint)
from .sparse import SparseCells, pack_ell_chunks
from .stream import ShardSource

#: bump when the store layout changes incompatibly; manifests stamped
#: newer than the reader understands are refused (never half-parsed)
SHARDSTORE_SCHEMA = 1

_MANIFEST = "manifest.json"
_CHUNK_DIR = "chunks"


class ShardCorruptError(RuntimeError):
    """A store chunk failed integrity verification (damaged bytes,
    truncation, fingerprint or manifest-digest mismatch).
    Deterministic by classification — re-reading the same bytes fails
    the same way, so the ruling is quarantine + fail/skip, never a
    retry.  ``.chunk``/``.shard`` locate the failure, ``.path`` the
    file, ``.reason`` the machine-readable why."""

    def __init__(self, path: str, reason: str, chunk: int,
                 shard: int | None = None):
        super().__init__(f"chunk {chunk} ({path}): {reason}")
        self.path = path
        self.reason = reason
        self.chunk = chunk
        self.shard = shard


def _chunk_fingerprint(index: int, n_genes: int,
                       chunk_rows: int) -> str:
    """Identity fingerprint a chunk file carries in its
    ``_integrity/fingerprint`` slot: a pure function of the chunk's
    SLOT (index + store geometry), so a renamed file fails
    verification even before the manifest digest cross-check."""
    key = f"shardstore/chunk{index:05d}/g{n_genes}/cr{chunk_rows}"
    return hashlib.sha256(key.encode()).hexdigest()[:10]


class StoreWriter:
    """Append-only writer for a :class:`ShardStore` directory.

    ``append(csr_block)`` takes arbitrary-sized CSR row blocks (a
    generator can stream a store bigger than RAM into being) and
    flushes full ``chunk_rows``-row chunk files as rows accumulate;
    ``close()`` flushes the remainder and writes the manifest.  The
    global ELL ``capacity`` (max nnz/row over the whole store, rounded
    to the lane multiple) is discovered during the write and recorded
    in the manifest, so every later read shares one compiled program.
    """

    def __init__(self, directory: str, n_genes: int, *,
                 shard_rows: int = 65536, chunk_rows: int | None = None):
        self.directory = directory
        self.n_genes = int(n_genes)
        self.shard_rows = round_up(int(shard_rows), config.sublane)
        if chunk_rows is None:
            chunk_rows = max(self.shard_rows // 4, 1)
        self.chunk_rows = int(chunk_rows)
        if self.shard_rows % self.chunk_rows:
            raise ValueError(
                f"shard_rows={self.shard_rows} must be a multiple of "
                f"chunk_rows={self.chunk_rows} (a shard is a whole "
                f"number of chunk files)")
        os.makedirs(os.path.join(directory, _CHUNK_DIR), exist_ok=True)
        self._pending = []          # buffered csr blocks
        self._pending_rows = 0
        self._chunks: list[dict] = []
        self._n_cells = 0
        self._max_nnz = 0
        self._closed = False
        # append_to() seeds these from the manifest being extended
        self._base_capacity = 0
        self._appends: list[dict] = []
        self._append_label: str | None = None
        self._append_row_start = 0
        self._append_chunk_start = 0

    @classmethod
    def append_to(cls, store, *, label: str | None = None,
                  n_genes: int | None = None,
                  shard_rows: int | None = None,
                  chunk_rows: int | None = None,
                  verify_tail: bool = True) -> "StoreWriter":
        """Reopen an existing store for appending NEW chunks.

        The writer seeds its chunk ledger / row counters / nnz maximum
        from the store's manifest and continues chunk numbering where
        the store left off, so slot fingerprints stay a pure function
        of (index, geometry).  The commit point is the atomic manifest
        replace in :meth:`close` — a crash mid-append leaves orphan
        chunk files beyond the committed manifest that a deterministic
        redo overwrites byte-identically, which makes an append an
        at-most-once commit.

        Refusals (all BEFORE any byte is written):

        * the recorded ``store_digest`` must recompute from the
          recorded chunk digests (a tampered/hand-edited manifest is
          not a base to extend);
        * any explicitly passed geometry (``n_genes`` / ``shard_rows``
          / ``chunk_rows``) must match the manifest — the caller's
          idea of the store and the store itself must agree;
        * the committed store must end on a chunk boundary
          (``n_cells % chunk_rows == 0``): a partial tail chunk would
          shift every appended row's shard arithmetic;
        * with ``verify_tail`` (default), the final committed chunk
          file must pass full integrity verification — the chunk most
          at risk of a torn previous append.

        ``label=`` records an entry in the manifest's append ledger on
        close (``{"label", "row_start", "rows", "chunk_start",
        "n_chunks"}``); :meth:`ShardStore.append_labels` answers
        "was this batch already committed?" for at-most-once ingest.
        """
        if isinstance(store, str):
            store = ShardStore.open(store)
        m = store.manifest
        mpath = os.path.join(store.directory, _MANIFEST)
        recomputed = hashlib.sha256("".join(
            c["digest"] for c in m["chunks"]).encode()).hexdigest()[:16]
        if recomputed != m.get("store_digest"):
            raise ShardCorruptError(
                mpath, "store_digest does not recompute from the "
                       "recorded chunk digests — refusing to extend a "
                       "tampered manifest", chunk=-1)
        for name, got in (("n_genes", n_genes),
                          ("shard_rows", shard_rows),
                          ("chunk_rows", chunk_rows)):
            if got is not None and int(got) != int(m[name]):
                raise ValueError(
                    f"append_to: {name}={got} does not match the "
                    f"store's {name}={m[name]} — geometry is frozen "
                    f"at creation")
        if store.n_cells % store.chunk_rows:
            raise ValueError(
                f"append_to: store ends mid-chunk ({store.n_cells} "
                f"cells, chunk_rows={store.chunk_rows}) — appending "
                f"would shift shard arithmetic for every new row")
        if verify_tail and m["chunks"]:
            tail = len(m["chunks"]) - 1
            from .io import read_csr_chunk
            read_csr_chunk(
                store.chunk_path(tail),
                expect_fingerprint=_chunk_fingerprint(
                    tail, store.n_genes, store.chunk_rows),
                expect_digest=m["chunks"][tail]["digest"])
        w = cls(store.directory, store.n_genes,
                shard_rows=store.shard_rows,
                chunk_rows=store.chunk_rows)
        w._chunks = [dict(c) for c in m["chunks"]]
        w._n_cells = store.n_cells
        w._max_nnz = int(m.get("max_nnz_row", 0))
        w._base_capacity = store.capacity
        w._appends = [dict(a) for a in m.get("appends", [])]
        w._append_label = label
        w._append_row_start = store.n_cells
        w._append_chunk_start = len(m["chunks"])
        return w

    def append(self, csr_block) -> None:
        import scipy.sparse as sp

        if self._closed:
            raise ValueError("StoreWriter is closed")
        block = sp.csr_matrix(csr_block)
        if block.shape[1] != self.n_genes:
            raise ValueError(
                f"append: block has {block.shape[1]} genes, store has "
                f"{self.n_genes}")
        self._pending.append(block)
        self._pending_rows += block.shape[0]
        if self._pending_rows >= self.chunk_rows:
            self._drain(final=False)

    def _drain(self, final: bool) -> None:
        """Emit every full chunk buffered so far (plus the remainder
        when ``final``) from ONE vstacked buffer — each chunk is a
        single row-slice copy, so a large ``append`` costs O(rows),
        not the O(rows²) a per-chunk re-slice of the shrinking
        remainder would."""
        import scipy.sparse as sp

        buf = (self._pending[0] if len(self._pending) == 1
               else sp.vstack(self._pending, format="csr"))
        a = 0
        while buf.shape[0] - a >= self.chunk_rows:
            self._write_chunk(buf[a: a + self.chunk_rows])
            a += self.chunk_rows
        if final and buf.shape[0] - a:
            self._write_chunk(buf[a:])
            a = buf.shape[0]
        rest = buf[a:]
        self._pending = [rest] if rest.shape[0] else []
        self._pending_rows = int(rest.shape[0])

    def _write_chunk(self, chunk) -> None:
        chunk.sort_indices()
        rows = chunk.shape[0]
        index = len(self._chunks)
        name = f"chunk-{index:05d}"
        path = os.path.join(self.directory, _CHUNK_DIR, f"{name}.npz")
        from .io import write_csr_chunk

        digest = write_csr_chunk(
            path, chunk.data.astype(np.float32, copy=False),
            chunk.indices, chunk.indptr, chunk.shape,
            fingerprint=_chunk_fingerprint(index, self.n_genes,
                                           self.chunk_rows))
        nnz_row = int(np.diff(chunk.indptr).max()) if rows else 0
        self._max_nnz = max(self._max_nnz, nnz_row)
        self._chunks.append({
            "file": f"{_CHUNK_DIR}/{name}.npz", "rows": int(rows),
            "row_start": int(self._n_cells), "nnz": int(chunk.nnz),
            "digest": digest,
        })
        self._n_cells += rows

    def close(self) -> "ShardStore":
        if self._closed:
            raise ValueError("StoreWriter already closed")
        if self._pending_rows:
            self._drain(final=True)
        self._closed = True
        # monotonically non-decreasing across appends: readers compiled
        # against the old capacity must stay valid for old shards
        capacity = max(round_up(max(self._max_nnz, 1),
                                config.capacity_multiple),
                       config.capacity_multiple,
                       self._base_capacity)
        if self._append_label is not None:
            self._appends.append({
                "label": self._append_label,
                "row_start": self._append_row_start,
                "rows": self._n_cells - self._append_row_start,
                "chunk_start": self._append_chunk_start,
                "n_chunks": len(self._chunks) - self._append_chunk_start,
            })
        manifest = {
            "schema": SHARDSTORE_SCHEMA,
            "n_cells": self._n_cells, "n_genes": self.n_genes,
            "shard_rows": self.shard_rows,
            "chunk_rows": self.chunk_rows,
            "capacity": capacity, "max_nnz_row": self._max_nnz,
            "dtype": "float32",
            "chunks": self._chunks,
            "appends": self._appends,
            "store_digest": hashlib.sha256("".join(
                c["digest"] for c in self._chunks).encode())
            .hexdigest()[:16],
        }
        tmp = os.path.join(self.directory, _MANIFEST + ".tmp")
        with open(tmp, "w") as f:
            json.dump(manifest, f, indent=1, sort_keys=True)
        os.replace(tmp, os.path.join(self.directory, _MANIFEST))
        return ShardStore(self.directory, manifest)


def write_store(X, directory: str, *, shard_rows: int = 65536,
                chunk_rows: int | None = None) -> "ShardStore":
    """Write an in-memory CSR matrix as a durable shard store
    (convenience over :class:`StoreWriter`; for matrices bigger than
    RAM, stream blocks into ``StoreWriter.append`` instead)."""
    X = X.tocsr()
    w = StoreWriter(directory, X.shape[1], shard_rows=shard_rows,
                    chunk_rows=chunk_rows)
    step = w.chunk_rows
    for s in range(0, X.shape[0], step):
        w.append(X[s: s + step])
    return w.close()


class ShardStore:
    """An opened durable shard store (see module docstring for the
    on-disk format).  Cheap to open — the manifest is the only read;
    chunk files are read (and verified) lazily per shard."""

    def __init__(self, directory: str, manifest: dict):
        self.directory = directory
        self.manifest = manifest

    @classmethod
    def open(cls, directory: str) -> "ShardStore":
        path = os.path.join(directory, _MANIFEST)
        try:
            with open(path) as f:
                manifest = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            raise ShardCorruptError(
                path, f"manifest unreadable ({type(e).__name__}: {e})",
                chunk=-1) from e
        schema = int(manifest.get("schema", 0))
        if schema > SHARDSTORE_SCHEMA:
            raise ShardCorruptError(
                path, f"manifest schema {schema} newer than supported "
                      f"{SHARDSTORE_SCHEMA}", chunk=-1)
        for field in ("n_cells", "n_genes", "shard_rows", "chunk_rows",
                      "capacity", "chunks"):
            if field not in manifest:
                raise ShardCorruptError(
                    path, f"manifest missing field {field!r}", chunk=-1)
        return cls(directory, manifest)

    # -- geometry ------------------------------------------------------
    @property
    def n_cells(self) -> int:
        return int(self.manifest["n_cells"])

    @property
    def n_genes(self) -> int:
        return int(self.manifest["n_genes"])

    @property
    def shard_rows(self) -> int:
        return int(self.manifest["shard_rows"])

    @property
    def chunk_rows(self) -> int:
        return int(self.manifest["chunk_rows"])

    @property
    def capacity(self) -> int:
        return int(self.manifest["capacity"])

    @property
    def n_chunks(self) -> int:
        return len(self.manifest["chunks"])

    @property
    def n_shards(self) -> int:
        return -(-self.n_cells // self.shard_rows)

    def append_labels(self) -> list[str]:
        """Labels of every committed append batch (the manifest's
        append ledger, written by :meth:`StoreWriter.append_to` with
        ``label=``) — the at-most-once guard of an ingest: a
        batch whose label is here is already durably committed."""
        return [a["label"] for a in self.manifest.get("appends", [])
                if a.get("label") is not None]

    def chunk_path(self, c: int) -> str:
        return os.path.join(self.directory,
                            self.manifest["chunks"][c]["file"])

    def chunk_range(self, shard: int) -> tuple[int, int]:
        """Chunk indices ``[c0, c1)`` making up ``shard``."""
        per = self.shard_rows // self.chunk_rows
        return shard * per, min(self.n_chunks, (shard + 1) * per)

    def shard_rows_of(self, shard: int) -> int:
        return (min(self.n_cells, (shard + 1) * self.shard_rows)
                - shard * self.shard_rows)

    # -- reads ---------------------------------------------------------
    def read_chunk_arrays(self, c: int, shard: int | None = None,
                          verify: bool = True) -> tuple:
        """Read + triple-verify one chunk file (self digest,
        slot fingerprint, manifest digest).  Integrity failures raise
        :class:`ShardCorruptError`."""
        from .io import read_csr_chunk

        rec = self.manifest["chunks"][c]
        path = self.chunk_path(c)
        try:
            return read_csr_chunk(
                path, verify=verify,
                expect_fingerprint=_chunk_fingerprint(
                    c, self.n_genes, self.chunk_rows),
                expect_digest=rec["digest"])
        except CheckpointCorruptError as e:
            raise ShardCorruptError(path, e.reason, chunk=c,
                                    shard=shard) from e

    def read_shard(self, shard: int, verify: bool = True) -> SparseCells:
        """Read and verify every chunk of ``shard`` (file order) and
        pack them into one host padded-ELL :class:`SparseCells`."""
        c0, c1 = self.chunk_range(shard)
        chunks = []
        for c in range(c0, c1):
            data, indices, indptr, _shape = self.read_chunk_arrays(
                c, shard=shard, verify=verify)
            row0 = (self.manifest["chunks"][c]["row_start"]
                    - shard * self.shard_rows)
            chunks.append((indptr, indices, data, row0))
        return self.assemble_shard(shard, chunks)

    def assemble_shard(self, shard: int, chunks: list) -> SparseCells:
        """Pack a shard's decoded chunks into one host padded-ELL
        :class:`SparseCells` of the manifest's capacity."""
        rows = self.shard_rows_of(shard)
        rows_padded = round_up(max(rows, 1), config.sublane)
        indices, data = pack_ell_chunks(chunks, rows_padded,
                                        self.capacity,
                                        sentinel=self.n_genes)
        return SparseCells(torch.from_numpy(indices),
                           torch.from_numpy(data), rows, self.n_genes)

    def quarantine_chunk(self, c: int, reason: str) -> str | None:
        """Move chunk ``c`` aside (never delete) with a
        ``.reason.json`` sidecar.  Returns the quarantined path, or
        ``None`` when the file is already gone (a prior ruling moved
        it — the quarantine is idempotent evidence-keeping, not a
        second verdict)."""
        path = self.chunk_path(c)
        if not os.path.exists(path):
            return None
        return quarantine_checkpoint(path, reason)

    # -- stream integration -------------------------------------------
    def iter_shards(self, start_shard: int = 0, verify: bool = True):
        """Host shards from ``start_shard`` on, read serially and
        verified."""
        for i in range(start_shard, self.n_shards):
            yield self.read_shard(i, verify=verify)

    def source(self, scheduler=None, prefetch: bool = True,
               device=None) -> ShardSource:
        """A seeking :class:`~.stream.ShardSource` over this store on
        ``device`` (``None``: the card, raising without one): the
        streamed passes consume it unchanged, and their resume files
        restart it at the first shard not yet done.  With ``prefetch``
        a worker thread reads, verifies and packs the next shard and
        copies it to the card while the card computes."""
        if scheduler is not None:
            raise NotImplementedError(
                "the shard read scheduler (hedged reads, chaos IO, the "
                "read journal) is not ported yet: ROADMAP.md Queue 1 "
                "item 13")
        return ShardSource(
            lambda: self.iter_shards(0), self.n_cells, self.n_genes,
            self.shard_rows, device=device, prefetch=prefetch,
            factory_from=self.iter_shards)


def open_store(directory: str) -> ShardStore:
    return ShardStore.open(directory)
