"""Out-of-core streaming path: count matrices that do not fit on the
card, in row shards.

Counterpart of ``sctools_tpu/data/stream.py`` (BASELINE configs[2..3]:
seurat_v3 HVG, then 50-PC randomized PCA and the cosine kNN, on 1.3M
cells).  Only the sparse counts are too big; the skinny iterates of
randomized PCA ((n, ~60) float32) and the (n, 50) scores stay on the
card.  So:

* **one stats pass** over padded-ELL shards: each shard is normalised
  and log1p'd, and reduced to per-cell QC metrics and per-gene moments
  of both the raw and the normalised values (float32 per shard,
  combined across shards on the host in float64 by Chan's update);
* **HVG selection** on the host from those moments; seurat_v3 and
  pearson_residuals stream one more pass;
* **randomized PCA**: the iterates stay on the card, and every product
  with the HVG-subset normalised matrix streams the shards through a
  fused subset → normalise → centred product;
* **kNN** on the card's scores, in one search or in query chunks
  (``ops/knn.py`` ``iter_knn_chunks``), one ``knn_select`` launch a
  chunk.

Shards come from a :class:`ShardSource` (scipy CSR, h5ad, a shard store)
or a ``DeviceSyntheticSource``.  With ``prefetch`` a worker thread packs
the next shard on the host, copies it into pinned memory and sends the
host-to-device copy on a side CUDA stream while the card computes on
the current one; the consumer waits on the copy's event.

Multi-card streaming (``mesh=``) is not ported: ROADMAP.md Queue 1
item 9.
"""

from __future__ import annotations

import dataclasses
import os
import queue
import threading
from typing import Callable, Iterator

import numpy as np
import torch

from ..config import config, resolve_device, round_up, true_f32
from ..utils.checkpoint import (clear_npz_generations,
                                load_npz_generations,
                                save_npz_generations)
from ..utils.failsafe import TRANSIENT, classify_error
from ..utils.vclock import SYSTEM_CLOCK
from .sparse import SparseCells, segment_reduce, spmm, spmm_t

_MESH_TODO = ("multi-card streaming (mesh=) is not ported yet: ROADMAP.md "
              "Queue 1 item 9")

#: identity fingerprints of the two passes' resume files, which go
#: through the verified, generation-rotating npz layer (a stream_pca file
#: renamed onto the stats path fails verification); an argument mismatch
#: stays a ValueError: such a file is wrong, not corrupt
_STATS_FP = "stream_stats-v1"
_PCA_FP = "stream_pca-v1"


# ----------------------------------------------------------------------
# Prefetch
# ----------------------------------------------------------------------


@dataclasses.dataclass
class StreamCounters:
    """Totals of a source's prefetch worker: consumer seconds blocked on
    the queue (``stall_s``: the stream is producer-bound), producer
    seconds hidden behind consumer compute (``overlap_s``), and
    transient retries of a shard's preparation (``retries``)."""

    stall_s: float = 0.0
    overlap_s: float = 0.0
    retries: int = 0

    def add_stall(self, s: float) -> None:
        self.stall_s += s

    def add_overlap(self, s: float) -> None:
        self.overlap_s += s

    def add_retry(self) -> None:
        self.retries += 1



def _tag_shard_index(e: BaseException, idx: int) -> BaseException:
    """Attach the failing shard's index to an exception leaving the
    prefetch worker (``.shard_index`` and a note)."""
    e.shard_index = idx
    e.add_note(f"[stream] raised while producing shard {idx}")
    return e


def _prefetch_iter(make_gen, depth: int = 2, prepare=None, clock=None,
                   prepare_retries: int = 2, on_stall=None,
                   on_overlap=None, on_retry=None):
    """Run the generator ``make_gen()`` in a daemon worker thread and
    hand its items over a queue of ``depth`` (2: the worker keeps shard
    N+1 prepared while the consumer computes on shard N).  ``prepare``
    runs in the worker on every item (a source's host pack and
    host-to-device copy).

    A failed ``prepare`` is classified (``failsafe.classify_error``): a
    TRANSIENT one gets up to ``prepare_retries`` retries in the worker,
    with backoff on the injectable ``clock`` (each reported to
    ``on_retry()``); any other, an exhausted one and any raise of the
    generator itself reach the consumer at the failed item, tagged with
    the shard index (``exc.shard_index``).

    ``on_stall(seconds)`` gets the consumer's total time blocked on the
    queue and ``on_overlap(seconds)`` the producer's time hidden behind
    the consumer, when the iteration ends (a ``ShardSource`` passes its
    :class:`StreamCounters`' methods); each left ``None`` counts
    nothing.  A consumer that stops early unblocks and ends the
    worker."""
    clock = clock if clock is not None else SYSTEM_CLOCK
    q: queue.Queue = queue.Queue(maxsize=max(1, depth))
    stop = threading.Event()
    end = object()
    err = object()

    def run_prepare(item, idx):
        attempt = 0
        while True:
            try:
                return prepare(item)
            except Exception as e:
                if (classify_error(e) != TRANSIENT
                        or attempt >= prepare_retries):
                    raise _tag_shard_index(e, idx)
                attempt += 1
                if on_retry is not None:
                    on_retry()
                clock.sleep(min(0.05 * 2.0 ** (attempt - 1), 1.0))

    def put(item) -> bool:
        # a consumer that abandons the iteration must not leave this
        # thread blocked for ever on a full queue
        while not stop.is_set():
            try:
                q.put(item, timeout=0.5)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        gen = make_gen()
        produced = 0
        try:
            while True:
                t0 = clock.monotonic()
                try:
                    item = next(gen)
                except StopIteration:
                    break
                except BaseException as e:
                    # the generator is dead: no retry, tag and surface
                    raise _tag_shard_index(e, produced)
                if prepare is not None:
                    item = run_prepare(item, produced)
                # production wall, not the time blocked on a full queue
                work = clock.monotonic() - t0
                if not put((None, item, work)):
                    gen.close()
                    return
                produced += 1
        except BaseException as e:  # noqa: BLE001 - handed to the consumer
            put((err, e, 0.0))
        put(end)

    th = threading.Thread(target=worker, daemon=True)
    th.start()
    stall_total = 0.0
    overlap_total = 0.0
    try:
        while True:
            t0 = clock.monotonic()
            item = q.get()
            stall = clock.monotonic() - t0
            if item is end:
                return
            tag, payload, work = item
            if tag is err:
                raise payload
            stall_total += stall
            overlap_total += max(0.0, work - stall)
            yield payload
    finally:
        stop.set()
        try:  # wake a producer blocked on a full queue
            q.get_nowait()
        except queue.Empty:
            pass
        th.join(timeout=10.0)
        if on_stall is not None:
            on_stall(stall_total)
        if on_overlap is not None:
            on_overlap(overlap_total)


def _copy_to_card(shard: SparseCells, device: torch.device,
                  stream: torch.cuda.Stream):
    """Pinned host copy of ``shard``, then its host-to-device copy on
    the side ``stream``; returns the device shard and the copy's event.
    The caching host allocator keeps each pinned block until the copy
    that reads it has finished, so a block is reused only then."""
    host = shard.pin_memory()
    with torch.cuda.stream(stream):
        out = host.to(device, non_blocking=True)
        done = torch.cuda.Event()
        done.record(stream)
    return out, done


def _consume_on_current_stream(shard: SparseCells, done) -> SparseCells:
    """Make the current stream wait for a shard copied on the side
    stream, and tell the allocator that the current stream uses its
    memory (allocated on the side stream)."""
    cur = torch.cuda.current_stream(shard.device)
    cur.wait_event(done)
    shard.indices.record_stream(cur)
    shard.data.record_stream(cur)
    return shard


# ----------------------------------------------------------------------
# Shard sources
# ----------------------------------------------------------------------


@dataclasses.dataclass
class ShardSource:
    """A re-iterable source of ``(row_offset, SparseCells)`` shards on
    ``device``, all of one capacity and, except the last, of
    ``shard_rows`` rows.  ``factory()`` yields host shards (CPU
    tensors); ``factory_from(k)``, when given, seeks to shard ``k``.
    ``device`` ``None`` means the card, and raises without one."""

    factory: Callable[[], Iterator[SparseCells]]
    n_cells: int
    n_genes: int
    shard_rows: int
    device: torch.device | str | None = None
    # pack and copy the next shard in a worker thread while the card
    # computes on the current one (on for IO-backed sources)
    prefetch: bool = False
    factory_from: Callable[[int], Iterator[SparseCells]] | None = None
    prefetch_depth: int = 2
    # the prefetch worker's stall, overlap and retry totals
    counters: StreamCounters = dataclasses.field(
        default_factory=StreamCounters)

    def __post_init__(self):
        self.device = resolve_device(self.device)

    def __iter__(self):
        yield from self.iter_from(0)

    def iter_from(self, start_shard: int):
        """``(row_offset, device shard)`` from shard ``start_shard`` on.
        Seeking sources start there; others read and drop the skipped
        shards."""
        if start_shard and self.factory_from is not None:
            base = lambda: self.factory_from(start_shard)  # noqa: E731
            skip = 0
        else:
            base = self.factory
            skip = start_shard

        def host_iter():
            for i, shard in enumerate(base()):
                if i >= skip:
                    yield shard

        offset = start_shard * self.shard_rows
        dev = self.device
        if not self.prefetch:
            for shard in host_iter():
                yield offset, shard.to(dev)
                offset += shard.n_cells
            return
        if dev.type == "cuda":
            side = torch.cuda.Stream(device=dev)
            prepare = lambda s: _copy_to_card(s, dev, side)  # noqa: E731
        else:
            prepare = lambda s: (s.to(dev), None)  # noqa: E731
        c = self.counters
        for shard, done in _prefetch_iter(
                host_iter, depth=self.prefetch_depth, prepare=prepare,
                on_stall=c.add_stall, on_overlap=c.add_overlap,
                on_retry=c.add_retry):
            if done is not None:
                shard = _consume_on_current_stream(shard, done)
            yield offset, shard
            offset += shard.n_cells

    def with_mesh(self, mesh) -> "ShardSource":
        raise NotImplementedError(_MESH_TODO)

    @property
    def n_shards(self) -> int:
        return -(-self.n_cells // self.shard_rows)

    @classmethod
    def from_h5ad(cls, path: str, shard_rows: int = 65536,
                  capacity: int | None = None,
                  device=None) -> "ShardSource":
        """Prefetching source over the CSR (or dense) X of an h5ad file.
        Without ``capacity`` the global max nnz per row comes from the
        indptr alone (the whole row width for a dense X).  Needs
        ``h5py``."""
        import h5py

        from .io import shard_iter

        shard_rows = round_up(shard_rows, config.sublane)
        with h5py.File(path, "r") as h5:
            node = h5["X"]
            if hasattr(node, "attrs") and "shape" in node.attrs:
                n, g = tuple(node.attrs["shape"])
                if capacity is None and "indptr" in node:
                    nnz_max = int(np.diff(node["indptr"][...]).max())
                    capacity = round_up(max(nnz_max, 1),
                                        config.capacity_multiple)
            else:
                n, g = node.shape
                if capacity is None:
                    capacity = round_up(int(g), config.capacity_multiple)
        return cls(lambda: shard_iter(path, shard_rows, capacity=capacity),
                   int(n), int(g), shard_rows, device=device, prefetch=True,
                   factory_from=lambda k: shard_iter(
                       path, shard_rows, capacity=capacity,
                       start_row=k * shard_rows))

    @classmethod
    def from_scipy(cls, X, shard_rows: int = 65536,
                   capacity: int | None = None,
                   device=None) -> "ShardSource":
        """Source over an in-memory scipy CSR matrix."""
        X = X.tocsr()
        n, g = X.shape
        shard_rows = round_up(shard_rows, config.sublane)
        if capacity is None:
            nnz_max = int(np.diff(X.indptr).max()) if X.nnz else 1
            capacity = round_up(max(nnz_max, 1), config.capacity_multiple)

        def factory_from(start_shard):
            for s in range(start_shard * shard_rows, n, shard_rows):
                yield SparseCells.from_scipy_csr(
                    X[s: s + shard_rows], capacity=capacity)

        return cls(lambda: factory_from(0), n, g, shard_rows, device=device,
                   factory_from=factory_from)


# ----------------------------------------------------------------------
# Pass 1: QC and per-gene moments
# ----------------------------------------------------------------------


def _valid_slots(x: SparseCells, ind: torch.Tensor, row_offset: int):
    rows = row_offset + torch.arange(ind.shape[0], device=ind.device)
    return (ind != x.sentinel) & (rows < x.n_cells)[:, None]


def _shard_stats(x: SparseCells, mito_mask: torch.Tensor,
                 target_sum: float):
    """One shard: per-cell totals, genes and mito percentage, and per
    gene the columns ``[s_raw, m2_raw, s_norm, m2_norm, nnz]`` of the
    raw counts and the log1p-normalised values.

    The second moments are centred on the shard's own gene means,
    ``m2 = Σ_valid (x − μ)² + (n − nnz)·μ²``: sums of non-negative f32
    terms, with no cancellation (Σx² − n·μ² in f32 loses every digit
    of a low-dispersion gene).  Shards combine in float64 by Chan's
    update (:func:`stream_stats`)."""
    from ..ops.normalize import _library_size_sparse

    totals = x.data.sum(dim=1)
    n_genes_cell = x.nnz_per_row()
    zero = torch.zeros((1,), dtype=x.data.dtype, device=x.device)
    mito_pad = torch.cat([mito_mask.to(x.data.dtype), zero])
    mito_counts = (x.data * mito_pad[x.indices.long()]).sum(dim=1)
    pct_mito = torch.where(totals > 0, 100.0 * mito_counts
                           / torch.clamp(totals, min=1e-12), 0.0)
    xs, _ = _library_size_sparse(x, target_sum)
    xn_data = torch.log1p(xs.data)

    def slot_sums(ind, dat, row_offset):
        valid = _valid_slots(x, ind, row_offset)
        blk = xn_data[row_offset:row_offset + ind.shape[0]]
        return torch.stack([dat, blk, valid.to(dat.dtype)], dim=2)

    sums = segment_reduce(x, slot_sums, 3)
    s_raw, s_norm, nnz = sums[:, 0], sums[:, 1], sums[:, 2]
    inv_n = 1.0 / max(x.n_cells, 1)
    mu_raw_pad = torch.cat([s_raw * inv_n, zero])
    mu_norm_pad = torch.cat([s_norm * inv_n, zero])

    def slot_sq(ind, dat, row_offset):
        valid = _valid_slots(x, ind, row_offset)
        blk = xn_data[row_offset:row_offset + ind.shape[0]]
        il = ind.long()
        dr = torch.where(valid, dat - mu_raw_pad[il], 0.0)
        dn = torch.where(valid, blk - mu_norm_pad[il], 0.0)
        return torch.stack([dr * dr, dn * dn], dim=2)

    sq = segment_reduce(x, slot_sq, 2)
    zeros = torch.clamp(x.n_cells - nnz, min=0.0)
    mu_raw, mu_norm = mu_raw_pad[:-1], mu_norm_pad[:-1]
    m2_raw = sq[:, 0] + zeros * mu_raw * mu_raw
    m2_norm = sq[:, 1] + zeros * mu_norm * mu_norm
    stats = torch.stack([s_raw, m2_raw, s_norm, m2_norm, nnz], dim=1)
    return totals, n_genes_cell, pct_mito, stats


def stream_stats(src, target_sum: float = 1e4,
                 mito_mask: np.ndarray | None = None,
                 checkpoint: str | None = None) -> dict:
    """One pass: per-cell QC metrics and per-gene moments of the raw and
    the normalised log matrix (host arrays; the moments float64).

    ``checkpoint=`` (an ``.npz`` path) makes the pass resumable: after
    every shard the fetched per-shard results go through the verified
    npz layer (digest, fingerprint, atomic rename, the previous
    generation kept as ``.prev``).  A rerun with the same arguments
    loads it, seeks the source to the first shard not yet done and
    finishes the pass with the same bits as an uninterrupted one.  A
    file that fails verification is quarantined and resume falls back
    to ``.prev``, then to a fresh pass; the files are deleted at the
    end.  A checkpoint forces a host fetch per shard."""
    dev = src.device
    if mito_mask is None:
        mito_mask = np.zeros(src.n_genes, bool)
    mito = torch.as_tensor(np.asarray(mito_mask, bool), device=dev)
    totals, ngenes, pct, shard_stats, shard_sizes = [], [], [], [], []
    start_shard = 0
    z = (load_npz_generations(checkpoint, fingerprint=_STATS_FP)
         if checkpoint is not None else None)
    if z is not None:
        if not (int(z["n_cells"]) == src.n_cells
                and int(z["n_genes"]) == src.n_genes
                and int(z["shard_rows"]) == src.shard_rows
                and float(z["target_sum"]) == float(target_sum)):
            raise ValueError(
                f"stream_stats: checkpoint {checkpoint!r} was written "
                "for a different source/arguments; delete it or pass a "
                "fresh path")
        start_shard = int(z["next_shard"])
        bounds = np.concatenate([[0], np.cumsum(z["shard_sizes"])])
        for i, n_i in enumerate(z["shard_sizes"]):
            a, b = int(bounds[i]), int(bounds[i + 1])
            totals.append(z["totals"][a:b])
            ngenes.append(z["ngenes"][a:b].astype(np.int32))
            pct.append(z["pct"][a:b])
            shard_stats.append(z["stats"][i])
            shard_sizes.append(int(n_i))

    def fetch(t):
        return t.cpu().numpy() if isinstance(t, torch.Tensor) else t

    for k, (_, shard) in enumerate(src.iter_from(start_shard),
                                   start=start_shard):
        t, g, m, stats = _shard_stats(shard, mito, target_sum)
        n = shard.n_cells
        # device tensors until after the loop: a fetch here would make
        # the host wait for the card at every shard
        totals.append(t[:n])
        ngenes.append(g[:n])
        pct.append(m[:n])
        shard_stats.append(stats)
        shard_sizes.append(n)
        if checkpoint is not None:
            for lst in (totals, ngenes, pct, shard_stats):
                lst[-1] = fetch(lst[-1])
            save_npz_generations(
                checkpoint, fingerprint=_STATS_FP, n_cells=src.n_cells,
                n_genes=src.n_genes, shard_rows=src.shard_rows,
                target_sum=target_sum, next_shard=k + 1,
                shard_sizes=np.asarray(shard_sizes, np.int64),
                totals=np.concatenate(totals).astype(np.float32),
                ngenes=np.concatenate(ngenes).astype(np.float32),
                pct=np.concatenate(pct).astype(np.float32),
                stats=np.stack(shard_stats).astype(np.float32))
    totals = [fetch(t) for t in totals]
    ngenes = [fetch(g) for g in ngenes]
    pct = [fetch(m) for m in pct]
    # cross-shard combine in float64 by Chan's pairwise update; the
    # per-shard m2 arrive centred on their shard's mean
    n_acc = 0
    G = src.n_genes
    mean_r, m2_r = np.zeros(G), np.zeros(G)
    mean_n, m2_n = np.zeros(G), np.zeros(G)
    nnz = np.zeros(G)
    for stats, n_i in zip(shard_stats, shard_sizes):
        s_r, m2r_i, s_n, m2n_i, nnz_i = \
            np.asarray(fetch(stats)).T.astype(np.float64)
        for mean, m2, s_i, m2_i in ((mean_r, m2_r, s_r, m2r_i),
                                    (mean_n, m2_n, s_n, m2n_i)):
            delta = s_i / n_i - mean
            tot = n_acc + n_i
            m2 += np.maximum(m2_i, 0.0) + delta ** 2 * (n_acc * n_i / tot)
            mean += delta * (n_i / tot)
        nnz += nnz_i
        n_acc += n_i
    n = src.n_cells
    if checkpoint is not None:
        clear_npz_generations(checkpoint)  # state is stale
    return {
        "total_counts": np.concatenate(totals),
        "n_genes": np.concatenate(ngenes),
        "pct_counts_mt": np.concatenate(pct),
        "gene_mean": mean_n,
        "gene_var": np.maximum(m2_n / max(n - 1, 1), 0.0),
        "raw_gene_mean": mean_r,
        "raw_gene_var": np.maximum(m2_r / max(n - 1, 1), 0.0),
        "gene_nnz": nnz,
        "n_cells": n,
    }


# ----------------------------------------------------------------------
# HVG ranking
# ----------------------------------------------------------------------


def _shard_clipped_ssq(x: SparseCells, mu_over_std, inv_std,
                       clip: float) -> torch.Tensor:
    """Per gene Σ min(clip, (x − μ)/σ)² over a shard's stored entries;
    the zeros' term comes from the pass-1 nnz counts."""
    zero = torch.zeros((1,), dtype=torch.float32, device=x.device)
    mu_pad = torch.cat([mu_over_std, zero])
    inv_pad = torch.cat([inv_std, zero])

    def slot_vals(ind, dat, row_offset):
        il = ind.long()
        z = torch.clamp(inv_pad[il] * dat - mu_pad[il], -clip, clip)
        return torch.where(_valid_slots(x, ind, row_offset), z * z,
                           0.0)[:, :, None]

    return segment_reduce(x, slot_vals, 1)[:, 0]


def _shard_pearson_corr(x: SparseCells, p_pad, theta: float,
                        clip: float) -> torch.Tensor:
    """Stored-entry corrections (r − r0, r² − r0²) per gene of a shard;
    the row totals come from the shard itself."""
    totals = x.data.sum(dim=1)

    def slot_vals(ind, dat, row_offset):
        t = totals[row_offset:row_offset + ind.shape[0]]
        mu = t[:, None] * p_pad[ind.long()]
        denom = torch.clamp(torch.sqrt(mu + mu * mu / theta), min=1e-12)
        r = torch.clamp((dat - mu) / denom, -clip, clip)
        r0 = torch.clamp(-mu / denom, -clip, clip)
        ok = _valid_slots(x, ind, row_offset)
        return torch.stack([torch.where(ok, r - r0, 0.0),
                            torch.where(ok, r * r - r0 * r0, 0.0)], dim=2)

    return segment_reduce(x, slot_vals, 2)


def stream_hvg_scores(stats: dict, flavor: str = "seurat_v3", src=None,
                      theta: float = 100.0) -> np.ndarray:
    """Per-gene float64 scores of the streamed HVG ranking (higher is
    more variable).  "dispersion" / "seurat" and "cell_ranger" need
    only the pass-1 moments; "seurat_v3" (clipped standardised variance
    of the raw counts against a quadratic mean-variance trend) and
    "pearson_residuals" (clipped Pearson residual variance) stream one
    more pass over ``src``."""
    from ..ops import hvg

    if flavor in ("dispersion", "seurat"):
        return hvg._dispersion_scores_np(
            np.asarray(stats["gene_mean"], np.float64),
            np.asarray(stats["gene_var"], np.float64))
    if flavor == "cell_ranger":
        return hvg._cell_ranger_scores_np(stats["gene_mean"],
                                          stats["gene_var"])
    if flavor == "seurat_v3":
        if src is None:
            raise ValueError(
                "stream_hvg(flavor='seurat_v3') needs src= for the "
                "clipped second pass")
        mean = stats["raw_gene_mean"]
        var = stats["raw_gene_var"]
        n = stats["n_cells"]
        std = np.maximum(np.sqrt(hvg._fit_mean_var_trend_np(mean, var)),
                         1e-12)
        clip = float(np.sqrt(n))
        dev = src.device
        mu_over_std = torch.from_numpy((mean / std).astype(np.float32)).to(dev)
        inv_std = torch.from_numpy((1.0 / std).astype(np.float32)).to(dev)
        ssq = np.zeros(src.n_genes)
        for _, shard in src:
            part = _shard_clipped_ssq(shard, mu_over_std, inv_std, clip)
            ssq += part.cpu().numpy().astype(np.float64)
        ssq += (n - stats["gene_nnz"]) * np.clip(-mean / std, -clip,
                                                 clip) ** 2
        return hvg._seurat_v3_scores_np(mean, var, ssq, n)
    if flavor == "pearson_residuals":
        if src is None:
            raise ValueError(
                "stream_hvg(flavor='pearson_residuals') needs src= for "
                "the stored-entry correction pass")
        dev = src.device
        n = stats["n_cells"]
        totals_all = np.asarray(stats["total_counts"], np.float64)
        p = (np.asarray(stats["raw_gene_mean"], np.float64) * n
             / max(totals_all.sum(), 1e-12))
        clip = float(np.float32(np.sqrt(n)))
        G = src.n_genes
        S = np.zeros(G)
        Q = np.zeros(G)
        gchunk, cblock = 512, 65536
        p_dev = torch.from_numpy(
            np.pad(p, (0, (-G) % gchunk)).astype(np.float32)).to(dev)
        for c0 in range(0, n, cblock):
            tb = torch.from_numpy(
                totals_all[c0:c0 + cblock].astype(np.float32)).to(dev)
            for lo in range(0, G, gchunk):
                s0, q0 = hvg._pearson_zero_chunk(
                    tb, p_dev[lo:lo + gchunk], theta, clip)
                hi = min(G, lo + gchunk)
                S[lo:hi] += s0.cpu().numpy()[: hi - lo]
                Q[lo:hi] += q0.cpu().numpy()[: hi - lo]
        p_pad = torch.from_numpy(
            np.concatenate([p, [0.0]]).astype(np.float32)).to(dev)
        for _, shard in src:
            corr = _shard_pearson_corr(shard, p_pad, theta, clip)
            corr = corr.cpu().numpy().astype(np.float64)
            S += corr[:, 0]
            Q += corr[:, 1]
        return (Q - S * S / n) / max(n - 1, 1)
    raise ValueError(f"unknown hvg flavor {flavor!r}")


def stream_hvg(stats: dict, n_top: int = 2000, flavor: str = "seurat_v3",
               src=None, theta: float = 100.0) -> np.ndarray:
    """The ``n_top`` genes of :func:`stream_hvg_scores`, as sorted gene
    indices (ties to the lower gene id)."""
    scores = stream_hvg_scores(stats, flavor=flavor, src=src, theta=theta)
    return np.sort(np.argsort(-scores, kind="stable")[:n_top])


# ----------------------------------------------------------------------
# Streamed randomized PCA
# ----------------------------------------------------------------------


def _normalised_subset(x: SparseCells, mapping: torch.Tensor,
                       target_sum: float, g_sub: int) -> SparseCells:
    """Normalise (totals over all genes) and log1p a shard, then map its
    gene ids onto the HVG subset: dropped genes become the sentinel
    ``g_sub`` with value 0."""
    from ..ops.normalize import _library_size_sparse

    xs, _ = _library_size_sparse(x, target_sum)
    ind = mapping[x.indices.long()]
    dat = torch.where(ind == g_sub, 0.0, torch.log1p(xs.data))
    return SparseCells(ind, dat, x.n_cells, g_sub)


def _shard_matvec(x: SparseCells, mapping, mu, V, target_sum: float,
                  g_sub: int) -> torch.Tensor:
    """Fused subset → normalise → log1p → centred ``X_c @ V`` of one
    shard: (rows_padded, L) with the padding rows zero."""
    sub = _normalised_subset(x, mapping, target_sum, g_sub)
    with true_f32():
        out = spmm(sub, V) - (mu @ V)[None, :]
    return torch.where(sub.row_mask()[:, None], out, 0.0)


def _shard_rmatvec(x: SparseCells, mapping, mu, Q, target_sum: float,
                   g_sub: int) -> torch.Tensor:
    """Fused centred ``X_cᵀ @ Q`` of one shard (Q's rows past the
    shard's cells are masked).  Most slots of a shard belong to genes
    outside the HVG subset; ``spmm_t`` leaves them out before its
    scatter."""
    sub = _normalised_subset(x, mapping, target_sum, g_sub)
    Qm = torch.where(sub.row_mask()[:, None], Q, 0.0)
    colsum = Qm.sum(dim=0)
    return spmm_t(sub, Qm) - torch.outer(mu, colsum)


def _assemble_rows(blocks, n_rows: int) -> torch.Tensor:
    """Stack per-shard (rows_padded, L) blocks into one (n_rows, L)."""
    trimmed = []
    got = 0
    for b in blocks:
        take = min(b.shape[0], n_rows - got)
        trimmed.append(b[:take])
        got += take
    return torch.cat(trimmed, dim=0)


def stream_pca(src, gene_idx: np.ndarray, gene_mean: np.ndarray,
               n_components: int = 50, oversample: int = 10,
               n_iter: int = 2, target_sum: float = 1e4,
               checkpoint: str | None = None,
               omega: torch.Tensor | None = None, seed: int = 0):
    """Streamed randomized PCA of the HVG-subset normalised log matrix.

    ``gene_mean``: the full matrix's normalised gene means (from
    :func:`stream_stats`); the subset is centred on
    ``gene_mean[gene_idx]``.  ``omega`` (g_sub, L = n_components +
    oversample) is the sketch (``carry.pca_omega_from_numpy`` turns the
    reference's into one); without it a standard normal sketch is drawn
    from a ``torch.Generator`` seeded with ``seed`` on the source's
    device.  Returns (scores (n, k), components (g_sub, k), explained
    variance (k,)) on that device.

    The power iteration runs in rounds: carrier → Q = qr(X_c carrier) →
    z = X_cᵀ Q; z's qr is the next carrier, and the last z gives the
    SVD.  ``checkpoint=`` persists only the small carrier and the
    rmatvec accumulator after every shard (not the (n, L) Q): on resume
    Q is recomputed from the carrier by one matvec sweep and the
    rmatvec continues at the first shard not yet done, with the same
    bits.  The files go through the verified npz layer as
    :func:`stream_stats`' do."""
    from ..ops.pca import cholesky_qr

    dev = src.device
    gene_idx = np.asarray(gene_idx)
    g_sub = len(gene_idx)
    mapping = np.full(src.n_genes + 1, g_sub, np.int32)
    mapping[gene_idx] = np.arange(g_sub, dtype=np.int32)
    mapping = torch.from_numpy(mapping).to(dev)
    mu = torch.from_numpy(
        np.asarray(gene_mean)[gene_idx].astype(np.float32)).to(dev)
    L = n_components + oversample

    def matvec_all(V):
        blocks = [_shard_matvec(sh, mapping, mu, V, target_sum, g_sub)
                  for _, sh in src]
        return _assemble_rows(blocks, src.n_cells)

    start_round, start_shard, acc0 = 0, 0, None
    z = (load_npz_generations(checkpoint, fingerprint=_PCA_FP)
         if checkpoint is not None else None)
    if z is not None:
        if not (int(z["n_cells"]) == src.n_cells
                and int(z["g_sub"]) == g_sub and int(z["L"]) == L
                and int(z["n_iter"]) == n_iter
                and float(z["target_sum"]) == float(target_sum)):
            raise ValueError(
                f"stream_pca: checkpoint {checkpoint!r} was written for "
                "different arguments; delete it or pass a fresh path")
        start_round = int(z["round"])
        start_shard = int(z["next_shard"])
        carrier = torch.from_numpy(np.asarray(z["carrier"],
                                              np.float32)).to(dev)
        acc0 = torch.from_numpy(np.asarray(z["acc"], np.float32)).to(dev)
    elif omega is not None:
        if tuple(omega.shape) != (g_sub, L):
            raise ValueError(
                f"omega has shape {tuple(omega.shape)}, expected "
                f"{(g_sub, L)}")
        carrier = omega.to(device=dev, dtype=torch.float32)
    else:
        gen = torch.Generator(device=dev).manual_seed(seed)
        carrier = torch.randn((g_sub, L), generator=gen, device=dev)

    def rmatvec_all(Q, rnd, acc=None, first_shard=0):
        if acc is None:
            acc = torch.zeros((g_sub, L), dtype=torch.float32, device=dev)
        for offset, sh in src.iter_from(first_shard):
            q_blk = Q[offset: offset + sh.rows_padded]
            if q_blk.shape[0] < sh.rows_padded:  # the last shard's padding
                q_blk = torch.cat([q_blk, torch.zeros(
                    (sh.rows_padded - q_blk.shape[0], L), device=dev)])
            acc = acc + _shard_rmatvec(sh, mapping, mu, q_blk,
                                       target_sum, g_sub)
            if checkpoint is not None:
                save_npz_generations(
                    checkpoint, fingerprint=_PCA_FP, n_cells=src.n_cells,
                    g_sub=g_sub, L=L, n_iter=n_iter, target_sum=target_sum,
                    round=rnd,
                    next_shard=offset // src.shard_rows + 1,
                    carrier=carrier.cpu().numpy(), acc=acc.cpu().numpy())
        return acc

    for rnd in range(start_round, n_iter + 1):
        Q = cholesky_qr(matvec_all(carrier))
        zacc = rmatvec_all(Q, rnd,
                           acc=acc0 if rnd == start_round else None,
                           first_shard=(start_shard if rnd == start_round
                                        else 0))
        acc0 = None
        if rnd < n_iter:
            carrier = cholesky_qr(zacc)
    k = n_components
    with true_f32():
        U_b, S, Vt = torch.linalg.svd(zacc.T, full_matrices=False)
        scores = (Q @ U_b[:, :k]) * S[:k]
    if checkpoint is not None:
        clear_npz_generations(checkpoint)  # state is stale
    return scores, Vt[:k].T, (S[:k] ** 2) / max(src.n_cells - 1, 1)


# ----------------------------------------------------------------------
# The streamed path end to end
# ----------------------------------------------------------------------


def stream_pipeline(src, *, n_top: int = 2000, n_components: int = 50,
                    k: int = 15, metric: str = "cosine",
                    target_sum: float = 1e4,
                    mito_mask: np.ndarray | None = None, seed: int = 0,
                    refine: int = 64, hvg_flavor: str = "seurat_v3",
                    mesh=None, checkpoint_dir: str | None = None,
                    knn_chunk: int | None = None,
                    prefetch_depth: int | None = None, omega=None,
                    device=None) -> dict:
    """Shards → QC → HVG → randomized PCA → kNN, out of core.  Returns
    the obs metrics (host), ``hvg_genes``, ``X_pca``, the PCA
    components and explained variance, and ``knn_indices`` /
    ``knn_distances``.

    Runs on ``device`` (``None``: the card, raising without one), which
    must be the source's.  The kNN is one ``knn_arrays`` search of all
    cells (its padded rows), or with ``knn_chunk`` query chunks of that
    many cells (``iter_knn_chunks``, one row per cell), each one kernel
    launch against all cells.
    ``checkpoint_dir`` makes the stats and PCA passes resumable (see
    :func:`stream_stats`); ``prefetch_depth`` overrides a
    ``ShardSource``'s queue depth; ``omega`` and ``seed`` go to
    :func:`stream_pca`."""
    from ..ops.knn import iter_knn_chunks, knn_arrays

    if mesh is not None:
        raise NotImplementedError(_MESH_TODO)
    dev = resolve_device(device)
    if src.device != dev:
        raise ValueError(
            f"stream_pipeline: the source's shards lie on {src.device}, "
            f"not on device={dev}")
    if prefetch_depth is not None:
        src = dataclasses.replace(src, prefetch_depth=prefetch_depth)
    ck_stats = ck_pca = None
    if checkpoint_dir is not None:
        os.makedirs(checkpoint_dir, exist_ok=True)
        ck_stats = os.path.join(checkpoint_dir, "stream_stats.npz")
        ck_pca = os.path.join(checkpoint_dir, "stream_pca.npz")
    stats = stream_stats(src, target_sum=target_sum, mito_mask=mito_mask,
                         checkpoint=ck_stats)
    hvg_genes = stream_hvg(stats, n_top=n_top, flavor=hvg_flavor, src=src)
    scores, comps, expl = stream_pca(
        src, hvg_genes, stats["gene_mean"], n_components=n_components,
        target_sum=target_sum, checkpoint=ck_pca, omega=omega, seed=seed)
    if knn_chunk is None:
        idx, dist = knn_arrays(scores, scores, k=k, metric=metric,
                               n_query=src.n_cells, n_cand=src.n_cells,
                               refine=refine)
    else:
        parts = list(iter_knn_chunks(scores, k=k, chunk=knn_chunk,
                                     metric=metric, refine=refine,
                                     n=src.n_cells))
        idx = torch.cat([p[2] for p in parts])
        dist = torch.cat([p[3] for p in parts])
    return {
        "obs": {"total_counts": stats["total_counts"],
                "n_genes": stats["n_genes"],
                "pct_counts_mt": stats["pct_counts_mt"]},
        "hvg_genes": hvg_genes,
        "X_pca": scores,
        "pca_components": comps,
        "pca_explained_variance": expl,
        "knn_indices": idx,
        "knn_distances": dist,
        "n_cells": src.n_cells,
    }
