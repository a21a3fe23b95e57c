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
disk feeds both packages.

**Read scheduler** (:class:`ShardReadScheduler`): a pool of reader
threads above the store, feeding one or more consumer streams.  Reads
are served in ascending shard order across consumers (an elevator
order), the decoded bytes in flight are bounded by ``ram_budget_bytes``
(one read a consumer is always allowed), and every wait runs on the
injectable clock (``utils/vclock.py``).  Each read passes a failure
ladder: a per-read deadline (a straggler is abandoned and counted
transient), classified retries under a ``runner.RetryPolicy``, a hedge
(a second read) for a straggler past ``hedge_after_s`` where the first
ready result wins, and for a corrupt chunk the quarantine ruling (the
file moved aside with its reason, never deleted, a
``shard_quarantined`` journal event), then a raise or a skip per
``on_corrupt``.  Every read ends in exactly one of the ``ingest.reads``
outcomes {served, retried, hedged} or ``ingest.quarantines``, as in
the reference.  The chaos IO modes (``utils/chaos.py``) fire through
it.
"""

from __future__ import annotations

import hashlib
import heapq
import itertools
import json
import os
import random
import threading

import numpy as np
import torch

from ..config import config, round_up
from ..runner import RetryPolicy, as_journal
from ..utils import telemetry
from ..utils.checkpoint import (CheckpointCorruptError,
                                quarantine_checkpoint)
from ..utils.failsafe import (TRANSIENT, TransientDeviceError,
                              classify_error)
from ..utils.vclock import SYSTEM_CLOCK
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

    def chunk_name(self, c: int) -> str:
        """The chunk file's basename without its extension, which chaos
        fault patterns match."""
        return f"chunk-{c:05d}"

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

    def shard_nbytes_est(self) -> int:
        """Decoded padded-ELL bytes of one full shard (int32 ids and
        float32 values): the read scheduler's RAM-budget unit."""
        return self.shard_rows * self.capacity * 8

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

    def read_shard(self, shard: int, verify: bool = True,
                   on_chunk=None) -> SparseCells:
        """Read and verify every chunk of ``shard`` (file order) and
        pack them into one host padded-ELL :class:`SparseCells`.
        ``on_chunk(index, name, path)`` runs before each chunk's read
        (the scheduler's chaos consult), so plain and scheduled reads
        share one chunk loop."""
        c0, c1 = self.chunk_range(shard)
        chunks = []
        for c in range(c0, c1):
            if on_chunk is not None:
                on_chunk(c, self.chunk_name(c), self.chunk_path(c))
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
        copies it to the card while the card computes.  With
        ``scheduler=`` (a :class:`ShardReadScheduler` of this store)
        every read goes through its failure ladder; its ``on_corrupt``
        must be ``"fail"``: a skipped shard would shift every later
        row offset."""
        if scheduler is not None:
            if scheduler.store is not self:
                raise ValueError("scheduler serves a different store")
            if scheduler.on_corrupt == "skip":
                raise ValueError(
                    "source(): on_corrupt='skip' would silently shift "
                    "row offsets mid-stream; streaming passes need "
                    "on_corrupt='fail' (use scheduler.iter_shards "
                    "directly for skip-tolerant consumers)")
            factory_from = scheduler.iter_shards
        else:
            factory_from = self.iter_shards
        return ShardSource(
            lambda: factory_from(0), self.n_cells, self.n_genes,
            self.shard_rows, device=device, prefetch=prefetch,
            factory_from=factory_from)


def open_store(directory: str) -> ShardStore:
    return ShardStore.open(directory)


# ----------------------------------------------------------------------
# Read scheduler (the IO-failure domain)
# ----------------------------------------------------------------------

_SKIPPED = object()


class _PendingRead:
    """One in-flight shard read.  The worker fills exactly one of
    ``result`` and ``error`` and sets ``done_evt``; ``ready_at`` is the
    clock instant from which the result may be served (a chaos-slow
    read is done in real time but stays in flight on the clock until
    then, so the hedge and deadline rulings run with no real sleep)."""

    __slots__ = ("shard", "lock", "done_evt", "result", "error",
                 "ready_at", "nbytes", "abandoned", "released",
                 "holds_budget")

    def __init__(self, shard: int, holds_budget: bool = False):
        self.shard = shard
        self.lock = threading.Lock()
        self.done_evt = threading.Event()
        self.result = None
        self.error: BaseException | None = None
        self.ready_at = 0.0
        self.nbytes = 0
        self.abandoned = False
        self.released = False
        self.holds_budget = holds_budget

    def peek(self, clock):
        """``("pending" | "error" | "ready" | "deferred", value)``."""
        if not self.done_evt.is_set():
            return "pending", None
        with self.lock:
            if self.error is not None:
                return "error", self.error
            if clock.monotonic() >= self.ready_at:
                return "ready", self.result
            return "deferred", self.ready_at


class ShardReadScheduler:
    """A pool of reader threads above a :class:`ShardStore`, with the
    read failure ladder (module docstring).

    ``n_readers`` threads serve every consumer stream.
    ``ram_budget_bytes`` bounds the decoded bytes of lookahead reads in
    flight across consumers (``None``: two reads of lookahead a
    consumer); a consumer's current read is always allowed.  ``policy``
    (a :class:`runner.RetryPolicy`; default 3 attempts, 0.05 s base,
    2 s cap) rules transient retries.  ``read_deadline_s`` abandons a
    straggler (counted transient); ``hedge_after_s`` issues a second
    read for one, and the first ready result wins; both on ``clock``.
    After a corrupt chunk's quarantine ``on_corrupt="fail"`` raises
    :class:`ShardCorruptError` and ``"skip"`` drops the shard (listed in
    ``.skipped``).  ``chaos`` (a ``utils.chaos.ChaosMonkey``) is
    consulted before each chunk read; ``journal`` (a ``runner._Journal``
    or a path) receives ``shard_quarantined`` events; ``metrics`` the
    ``ingest.*`` series."""

    def __init__(self, store: ShardStore, *, n_readers: int = 2,
                 ram_budget_bytes: int | None = None,
                 policy=None, read_deadline_s: float | None = None,
                 hedge_after_s: float | None = None,
                 on_corrupt: str = "fail",
                 clock=None, metrics=None, chaos=None, journal=None,
                 poll_s: float = 0.002):
        if on_corrupt not in ("fail", "skip"):
            raise ValueError("on_corrupt must be 'fail' or 'skip'")
        self.store = store
        self.n_readers = max(1, int(n_readers))
        self.ram_budget_bytes = ram_budget_bytes
        self.policy = (policy if policy is not None else
                       RetryPolicy(max_attempts=3, base_delay_s=0.05,
                                   max_delay_s=2.0))
        self.read_deadline_s = read_deadline_s
        self.hedge_after_s = hedge_after_s
        self.on_corrupt = on_corrupt
        self.clock = clock if clock is not None else SYSTEM_CLOCK
        self.metrics = (metrics if metrics is not None
                        else telemetry.default_registry())
        self.chaos = chaos
        self.journal = as_journal(journal)
        self.poll_s = float(poll_s)
        # bounds of a real-time wait on a read still executing: the
        # clock must not move while real work runs, and the wait wakes
        # on the read's completion, so these only clamp it
        self._min_wait_s = 0.001
        self._max_wait_s = 60.0
        self.skipped: list[int] = []
        self._cv = threading.Condition()
        self._heap: list = []
        self._seq = itertools.count()
        self._threads: list[threading.Thread] = []
        self._stop = False
        self._reserved = 0
        self._lock = threading.Lock()

    # -- lifecycle -----------------------------------------------------
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def close(self) -> None:
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        for t in self._threads:
            t.join(timeout=5)
        self._threads.clear()

    def _ensure_workers(self) -> None:
        with self._cv:
            if self._stop:
                raise ValueError("scheduler is closed")
            while len(self._threads) < self.n_readers:
                t = threading.Thread(target=self._worker, daemon=True)
                t.start()
                self._threads.append(t)

    # -- RAM budget ----------------------------------------------------
    def _try_reserve(self, nbytes: int) -> bool:
        if self.ram_budget_bytes is None:
            return True
        with self._lock:
            if self._reserved + nbytes > self.ram_budget_bytes:
                return False
            self._reserved += nbytes
            return True

    def _discard(self, req: _PendingRead) -> None:
        """Release a request's budget hold once (only lookahead reads
        hold one) and mark it abandoned, so a worker that has not
        started it skips the read."""
        with req.lock:
            req.abandoned = True
            if req.released or not req.holds_budget:
                req.released = True
                return
            req.released = True
        if self.ram_budget_bytes is not None:
            with self._lock:
                self._reserved = max(
                    0, self._reserved - self.store.shard_nbytes_est())

    # -- worker side ---------------------------------------------------
    def _submit(self, shard: int, priority: int = 1,
                holds_budget: bool = False) -> _PendingRead:
        req = _PendingRead(shard, holds_budget=holds_budget)
        with self._cv:
            # (priority, shard, seq): hedges (priority 0) go first, the
            # rest in ascending shard order across consumers
            heapq.heappush(self._heap,
                           (priority, shard, next(self._seq), req))
            self._cv.notify()
        return req

    def _worker(self) -> None:
        while True:
            with self._cv:
                while not self._heap and not self._stop:
                    self._cv.wait()
                if not self._heap:
                    return  # stopped and drained
                _, _, _, req = heapq.heappop(self._heap)
            if req.abandoned:
                req.done_evt.set()
                continue
            self._execute(req)

    def _execute(self, req: _PendingRead) -> None:
        t0 = self.clock.monotonic()
        slow = [0.0]

        def consult(c, name, path):
            if self.chaos is None:
                return
            f = self.chaos.on_io(name, path)
            if f is None:
                return
            if f["mode"] == "io_error":
                raise TransientDeviceError(
                    f"chaos: injected io_error reading {name} "
                    f"(shard {req.shard})")
            if f["mode"] == "slow_read":
                slow[0] += float(f["slow_s"])
            # truncate_shard: the monkey damaged the file, and the
            # verified read rules it corrupt

        try:
            shard = self.store.read_shard(req.shard, on_chunk=consult)
            with req.lock:
                req.result = shard
                req.nbytes = shard.indices.nbytes + shard.data.nbytes
                req.ready_at = t0 + slow[0]
        except BaseException as e:  # noqa: BLE001 - handed to the
            # consumer's ladder, which classifies it and rules
            with req.lock:
                req.error = e
                req.ready_at = t0
        req.done_evt.set()

    # -- consumer side -------------------------------------------------
    def iter_shards(self, start_shard: int = 0):
        """One consumer stream: host shards in order from
        ``start_shard``, each read through the ladder.  Concurrent
        streams share the pool, the order and the budget."""
        yield from self.iter_order(range(start_shard, self.store.n_shards))

    def iter_order(self, order):
        """Host shards in the explicit index ``order`` (each read
        through the ladder, sharing the pool and budget as
        :meth:`iter_shards` does): the streamed trainer's
        block-permuted epoch order, whose lookahead reads the pool
        still serves in ascending shard order."""
        order = [int(i) for i in order]
        n = self.store.n_shards
        for i in order:
            if not 0 <= i < n:
                raise IndexError(
                    f"iter_order: shard {i} out of range [0, {n})")
        self._ensure_workers()
        est = self.store.shard_nbytes_est()
        window = max(1, min(8, (self.ram_budget_bytes // est)
                            if self.ram_budget_bytes else 2))
        pending: dict[int, _PendingRead] = {}
        next_submit = 0
        try:
            for pos in range(len(order)):
                while (next_submit < len(order)
                       and next_submit - pos < window):
                    if next_submit == pos:
                        reserved = False  # the current read: always
                    elif self._try_reserve(est):
                        reserved = True
                    else:
                        break
                    pending[next_submit] = self._submit(
                        order[next_submit], holds_budget=reserved)
                    next_submit += 1
                shard = self._await_shard(order[pos], pending.pop(pos))
                if shard is _SKIPPED:
                    continue
                yield shard
        finally:
            for r in pending.values():
                self._discard(r)

    def _await_shard(self, i: int, primary: _PendingRead):
        t0 = self.clock.monotonic()
        attempt_t0 = t0
        rng = random.Random((self.policy.seed, "ingest", i).__repr__())
        attempt = 1
        retried = False
        hedged = False
        hedge: _PendingRead | None = None
        errors: list[BaseException] = []

        def resubmit():
            nonlocal attempt, retried, attempt_t0, primary, hedge
            attempt += 1
            retried = True
            self.metrics.counter("ingest.retries").inc()
            self.clock.sleep(self.policy.delay_s(attempt - 1, rng))
            attempt_t0 = self.clock.monotonic()
            primary = self._submit(i)
            hedge = None

        while True:
            served = err_req = None
            for r in (primary, hedge):
                if r is None:
                    continue
                st, val = r.peek(self.clock)
                if st == "ready":
                    served = (r, val)
                    break
                if st == "error" and err_req is None:
                    err_req = (r, val)
            if served is not None:
                r, shard = served
                outcome = ("hedged" if hedged
                           else "retried" if retried else "served")
                self.metrics.counter("ingest.reads", outcome=outcome).inc()
                self.metrics.counter("ingest.bytes").inc(r.nbytes)
                self.metrics.histogram("ingest.read_wait_s").observe(
                    self.clock.monotonic() - t0)
                for other in (primary, hedge):
                    if other is not None:
                        self._discard(other)
                return shard
            if err_req is not None:
                r, e = err_req
                errors.append(e)
                self._discard(r)
                if r is hedge:
                    hedge = None
                else:
                    primary = None
                if primary is not None or hedge is not None:
                    continue  # the twin read may still serve
                corrupt = next((x for x in errors
                                if isinstance(x, ShardCorruptError)), None)
                if corrupt is not None:
                    self._quarantine_ruling(i, corrupt)
                    if self.on_corrupt == "fail":
                        raise corrupt
                    self.skipped.append(i)
                    return _SKIPPED
                if (classify_error(e) == TRANSIENT
                        and attempt < self.policy.max_attempts):
                    resubmit()
                    continue
                raise e
            # nothing servable yet: the hedge and deadline rulings, then
            # a wait
            el = self.clock.monotonic() - attempt_t0
            if (self.hedge_after_s is not None and not hedged
                    and primary is not None and el >= self.hedge_after_s):
                hedged = True
                self.metrics.counter("ingest.hedges").inc()
                hedge = self._submit(i, priority=0)
                continue
            if (self.read_deadline_s is not None
                    and el >= self.read_deadline_s):
                for r in (primary, hedge):
                    if r is not None:
                        self._discard(r)
                primary = hedge = None
                if attempt < self.policy.max_attempts:
                    resubmit()
                    continue
                raise TransientDeviceError(
                    f"ingest: shard {i} read exceeded its "
                    f"{self.read_deadline_s:g}s deadline {attempt} "
                    f"time(s) — abandoning the straggler")
            self._wait_step(primary, hedge, attempt_t0)

    def _wait_step(self, primary, hedge, attempt_t0) -> None:
        """Block until something can change: a real wait, woken by the
        completion, on a read still executing (timed out only for a
        hedge or deadline ruling due before); or, when every result in
        flight is merely deferred, one clock sleep to the next release
        time or ruling (instant on a ``VirtualClock``)."""
        in_flight = [r for r in (primary, hedge)
                     if r is not None and not r.done_evt.is_set()]
        if in_flight:
            el = self.clock.monotonic() - attempt_t0
            waits = [self._max_wait_s]
            if self.hedge_after_s is not None and hedge is None:
                waits.append(self.hedge_after_s - el)
            if self.read_deadline_s is not None:
                waits.append(self.read_deadline_s - el)
            in_flight[0].done_evt.wait(max(min(waits), self._min_wait_s))
            return
        now = self.clock.monotonic()
        candidates = [r.ready_at - now for r in (primary, hedge)
                      if r is not None]
        if self.hedge_after_s is not None and hedge is None \
                and primary is not None:
            candidates.append(attempt_t0 + self.hedge_after_s - now)
        if self.read_deadline_s is not None:
            candidates.append(attempt_t0 + self.read_deadline_s - now)
        ahead = [c for c in candidates if c > 0.0]
        self.clock.sleep(min(ahead) if ahead else self.poll_s)

    def _quarantine_ruling(self, shard: int, e: ShardCorruptError):
        dest = self.store.quarantine_chunk(e.chunk, e.reason)
        self.metrics.counter("ingest.quarantines").inc()
        if self.journal is not None:
            self.journal.write("shard_quarantined", shard=shard,
                               chunk=e.chunk, path=dest or e.path,
                               reason=e.reason, policy=self.on_corrupt)
