"""Synthetic single-cell data for tests and the chip smoke run.

numpy-only copies of ``sctools_tpu/data/synthetic.py``'s
``synthetic_counts``, ``gaussian_blobs``, ``synthetic_ell`` and
``_cluster_cdfs``: the same seed gives the same counts, points, ELL
planes and gene-program CDFs in both packages.
``DeviceSyntheticSource`` generates padded-ELL shards on the device from
a ``torch.Generator``; its random bits differ from the reference's
``jax.random`` ones, its structure does not.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from ..config import config, resolve_device, round_up
from .dataset import CellData
from .sparse import SparseCells


def synthetic_counts(n_cells: int, n_genes: int, *, density: float = 0.05,
                     n_clusters: int = 1, mito_frac: float = 0.01,
                     seed: int = 0, dtype=np.float32) -> CellData:
    """Host-side CellData with scipy CSR counts and gene names:
    lognormal per-gene rates, ``n_clusters`` gene programs, per-cell
    library-size variation, ``mito_frac`` of genes named ``MT-*``.
    ``density`` is the expected nnz fraction per cell."""
    rng = np.random.default_rng(seed)
    n_mito = max(1, int(n_genes * mito_frac)) if mito_frac > 0 else 0

    base = rng.lognormal(mean=0.0, sigma=1.5, size=n_genes)
    programs = np.tile(base, (n_clusters, 1))
    for c in range(1, n_clusters):
        boost = rng.choice(n_genes, size=max(1, n_genes // 20), replace=False)
        programs[c, boost] *= rng.uniform(3.0, 10.0, size=len(boost))
    programs /= programs.sum(axis=1, keepdims=True)

    labels = rng.integers(0, n_clusters, size=n_cells)
    lib = rng.lognormal(mean=0.0, sigma=0.4, size=n_cells)
    cdfs = np.cumsum(programs, axis=1)

    target_nnz = int(density * n_genes)
    rows, cols, vals = [], [], []
    chunk = max(1, min(n_cells, 200_000_000 // max(target_nnz, 1) // 8))
    for start in range(0, n_cells, chunk):
        stop = min(n_cells, start + chunk)
        nnz = np.maximum(
            1, rng.poisson(target_nnz * lib[start:stop])).astype(np.int64)
        nnz = np.minimum(nnz, n_genes)
        total = int(nnz.sum())
        row_idx = np.repeat(np.arange(start, stop), nnz)
        # gene ids per draw from the cell's cluster program: one
        # searchsorted per cluster, no per-cell loop
        draw_cluster = labels[row_idx]
        u = rng.random(total)
        gene_idx = np.empty(total, dtype=np.int32)
        for c in range(n_clusters):
            sel = draw_cluster == c
            gene_idx[sel] = np.searchsorted(cdfs[c], u[sel])
        gene_idx = np.clip(gene_idx, 0, n_genes - 1)
        count = rng.geometric(0.4, size=total).astype(dtype)
        rows.append(row_idx)
        cols.append(gene_idx)
        vals.append(count)

    coo = sp.coo_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
        shape=(n_cells, n_genes))
    coo.sum_duplicates()
    gene_names = np.array(
        [f"MT-{i}" if i < n_mito else f"GENE{i}" for i in range(n_genes)])
    return CellData(
        coo.tocsr(),
        obs={"cluster_true": labels.astype(np.int32)},
        var={"gene_name": gene_names, "mito": np.arange(n_genes) < n_mito},
    )


def gaussian_blobs(n_points: int, dim: int, n_clusters: int = 5, *,
                   spread: float = 0.2, seed: int = 0, dtype=np.float32):
    """Dense clustered points for kNN tests: (points (n, dim), labels
    (n,))."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_clusters, dim)).astype(dtype)
    labels = rng.integers(0, n_clusters, size=n_points)
    pts = centers[labels] + spread * rng.normal(
        size=(n_points, dim)).astype(dtype)
    return pts.astype(dtype), labels.astype(np.int32)


def synthetic_ell(n_cells: int, n_genes: int, *, nnz_per_cell: int = 600,
                  n_clusters: int = 8, seed: int = 0,
                  rows_padded: int | None = None,
                  capacity: int | None = None, dtype=np.float32) -> dict:
    """Benchmark-scale generator that writes the padded-ELL planes
    directly (no COO/CSR assembly, no global sort).  A cell may hold one
    gene id twice (harmless for linear ops: the counts add).  Returns a
    dict of numpy ``indices``, ``data``, ``labels`` and the ints
    ``n_cells``, ``n_genes``."""
    rng = np.random.default_rng(seed)
    capacity = capacity or round_up(int(nnz_per_cell * 2),
                                    config.capacity_multiple)
    rows_padded = rows_padded or round_up(n_cells, config.sublane)

    base = rng.lognormal(mean=0.0, sigma=1.5, size=n_genes)
    programs = np.tile(base, (n_clusters, 1))
    for c in range(1, n_clusters):
        boost = rng.choice(n_genes, size=max(1, n_genes // 20), replace=False)
        programs[c, boost] *= rng.uniform(3.0, 10.0, size=len(boost))
    programs /= programs.sum(axis=1, keepdims=True)
    cdfs = np.cumsum(programs, axis=1)
    labels = rng.integers(0, n_clusters, size=n_cells).astype(np.int32)

    lib = rng.lognormal(mean=0.0, sigma=0.4, size=n_cells)
    nnz = np.clip(rng.poisson(nnz_per_cell * lib), 1,
                  capacity).astype(np.int64)

    indices = np.full((rows_padded, capacity), n_genes, dtype=np.int32)
    data = np.zeros((rows_padded, capacity), dtype=dtype)
    total = int(nnz.sum())
    row_of = np.repeat(np.arange(n_cells), nnz)
    slot_of = np.arange(total) - np.repeat(np.cumsum(nnz) - nnz, nnz)
    u = rng.random(total)
    gene_idx = np.empty(total, dtype=np.int32)
    draw_cluster = labels[row_of]
    for c in range(n_clusters):
        sel = draw_cluster == c
        gene_idx[sel] = np.searchsorted(cdfs[c], u[sel])
    np.clip(gene_idx, 0, n_genes - 1, out=gene_idx)
    indices[row_of, slot_of] = gene_idx
    data[row_of, slot_of] = rng.geometric(0.4, size=total).astype(dtype)
    return dict(indices=indices, data=data, n_cells=n_cells,
                n_genes=n_genes, labels=labels)


def _cluster_cdfs(n_genes: int, n_clusters: int, seed: int) -> np.ndarray:
    """Per-cluster gene-program CDFs (n_clusters, n_genes) float32:
    lognormal base rates with cluster-specific boosts."""
    rng = np.random.default_rng(seed)
    base = rng.lognormal(mean=0.0, sigma=1.5, size=n_genes)
    programs = np.tile(base, (n_clusters, 1))
    for c in range(1, n_clusters):
        boost = rng.choice(n_genes, size=max(1, n_genes // 20),
                           replace=False)
        programs[c, boost] *= rng.uniform(3.0, 10.0, size=len(boost))
    programs /= programs.sum(axis=1, keepdims=True)
    return np.cumsum(programs, axis=1).astype(np.float32)


def _shard_seed(seed: int, shard: int) -> int:
    """The generator seed of shard ``shard`` of a source seeded
    ``seed``: a pure function of both, so a shard generated again is
    the same shard."""
    return int(np.random.SeedSequence([seed, shard]).generate_state(
        1, np.uint64)[0])


def ell_shard_device(gen: torch.Generator, cdfs: torch.Tensor,
                     n_valid: int, *, rows: int, capacity: int,
                     n_genes: int):
    """One padded-ELL shard generated on the device of ``cdfs`` from
    ``gen``: returns (indices (rows, capacity) int32, data (rows,
    capacity) float32, labels (rows,) int32).

    Each valid row draws ``capacity`` gene ids with replacement from its
    cluster's program (inverse CDF: one searchsorted over the cluster
    CDFs offset by the cluster, ``cdfs[c] + c``) and geometric(p=0.4)
    counts.  Duplicate ids within a row are then merged: the streamed
    passes apply log1p per slot, and log1p(a) + log1p(b) ≠ log1p(a + b).
    The merge is scatter-free, as the reference's: sort the row's slots
    by gene, give each run's first slot the run total (the row cumsum
    at the run's last slot, minus the cumsum before the run), and the
    other slots the sentinel.  Valid ids stay sorted, with sentinel
    slots between them.  Rows ≥ ``n_valid`` are empty."""
    dev = cdfs.device
    n_clusters = cdfs.shape[0]
    labels = torch.randint(0, n_clusters, (rows,), generator=gen,
                           device=dev, dtype=torch.int32)
    u = torch.rand((rows, capacity), generator=gen, device=dev)
    flat = (cdfs + torch.arange(n_clusters, dtype=cdfs.dtype,
                                device=dev)[:, None]).reshape(-1)
    idx = torch.searchsorted(flat, u + labels[:, None].float(),
                             out_int32=True) - labels[:, None] * n_genes
    del u
    idx = torch.clamp(idx, 0, n_genes - 1)
    uv = torch.rand((rows, capacity), generator=gen, device=dev)
    uv = uv * (1.0 - 1e-7) + 1e-7  # uniform on [1e-7, 1)
    vals = torch.ceil(torch.log1p(-uv * (1 - 1e-7))
                      / float(np.log(1.0 - 0.4)))
    del uv
    vals = torch.clamp(vals, min=1.0)
    row_ok = (torch.arange(rows, device=dev) < n_valid)[:, None]
    idx = torch.where(row_ok, idx, n_genes)
    vals = torch.where(row_ok, vals, 0.0)
    si, order = torch.sort(idx, dim=1)
    sv = torch.gather(vals, 1, order)
    del idx, vals, order
    first = torch.ones_like(si, dtype=torch.bool)
    first[:, 1:] = si[:, 1:] != si[:, :-1]
    csum = torch.cumsum(sv, dim=1)
    pos = torch.arange(capacity, dtype=torch.int32, device=dev)
    # index of the next run's first slot (capacity when none); the last
    # slot of this run is one before the next run's first
    nf = torch.where(first, pos, capacity).flip(1).cummin(dim=1).values.flip(1)
    last = torch.cat([nf[:, 1:], torch.full((rows, 1), capacity,
                                            dtype=nf.dtype, device=dev)],
                     dim=1) - 1
    totals = torch.gather(csum, 1, last.long()) - csum + sv
    idx = torch.where(first, si, n_genes)
    vals = torch.where(first & (idx < n_genes), totals, 0.0)
    return idx.to(torch.int32), vals, labels


class DeviceSyntheticSource:
    """A source of synthetic padded-ELL shards generated on the device,
    with the consumer protocol of ``data/stream.py:ShardSource``:
    iterating yields ``(row_offset, SparseCells)``, ``iter_from(k)``
    starts at shard ``k``.  ``device`` ``None`` means the card, and
    raises without one.

    ``materialize=True`` generates every shard once and keeps it on the
    device (the multi-pass PCA then reads memory, not the generator);
    ``False`` generates each shard again, from its own seed, on every
    pass, holding no more than the shard in use."""

    def __init__(self, n_cells: int, n_genes: int, *, capacity: int = 512,
                 shard_rows: int = 131072, n_clusters: int = 8,
                 seed: int = 0, materialize: bool = True, device=None):
        self.device = resolve_device(device)
        self.n_cells = int(n_cells)
        self.n_genes = int(n_genes)
        self.capacity = round_up(capacity, config.capacity_multiple)
        self.shard_rows = min(round_up(shard_rows, config.sublane),
                              round_up(self.n_cells, config.sublane))
        self.seed = seed
        self.n_clusters = n_clusters
        self._cdfs = None
        self._shards = None
        if materialize:
            self.materialize()

    def materialize(self, progress=None) -> None:
        """Generate every shard once and keep it, draining the device
        after each; ``progress(i, seconds)`` is called per shard."""
        import time

        from ..utils.sync import hard_sync

        shards = []
        t0 = time.perf_counter()
        for i, shard in enumerate(self._generate()):
            hard_sync(shard.data)
            if progress is not None:
                progress(i, time.perf_counter() - t0)
            t0 = time.perf_counter()
            shards.append(shard)
        self._shards = shards

    def _device_cdfs(self) -> torch.Tensor:
        if self._cdfs is None:
            self._cdfs = torch.from_numpy(_cluster_cdfs(
                self.n_genes, self.n_clusters, self.seed)).to(self.device)
        return self._cdfs

    def _generate(self, start_shard: int = 0):
        cdfs = self._device_cdfs()
        starts = range(start_shard * self.shard_rows, self.n_cells,
                       self.shard_rows)
        for si, start in enumerate(starts, start=start_shard):
            n_valid = min(self.shard_rows, self.n_cells - start)
            gen = torch.Generator(device=self.device).manual_seed(
                _shard_seed(self.seed, si))
            idx, dat, _ = ell_shard_device(
                gen, cdfs, n_valid, rows=self.shard_rows,
                capacity=self.capacity, n_genes=self.n_genes)
            yield SparseCells(idx, dat, n_valid, self.n_genes)

    def __iter__(self):
        yield from self.iter_from(0)

    def iter_from(self, start_shard: int):
        offset = start_shard * self.shard_rows
        shards = (self._shards[start_shard:] if self._shards is not None
                  else self._generate(start_shard=start_shard))
        for shard in shards:
            yield offset, shard
            offset += shard.n_cells

    @property
    def n_shards(self) -> int:
        return -(-self.n_cells // self.shard_rows)
