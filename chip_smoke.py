#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``sctools_tpu_torch``) on one
NVIDIA card.

    python3 chip_smoke.py        # from the repository root, one card

Phases, each printing one JSON line, each fatal on a failed check:

1. card    — ``nvidia-smi`` name and power limit, torch and CUDA
             versions, and the build of the CUDA kernels from
             ``sctools_tpu_torch/csrc`` (nvcc, at first use);
2. main    — the BASELINE configs[1] shape (68,579 cells × 32,738
             genes): QC → library size → log1p → HVG (2000, subset) →
             50-PC randomized PCA → cosine kNN (k=15) through
             ``Pipeline.run`` on the card, with the kernel's launch count
             read around that run, each stage's wall time and peak
             device memory, and recall@10 ≥ 0.99 against the float64
             oracle on 4,096 sampled cells; then ``hvg.select`` twice on
             the card and once on the CPU over the path's log1p output:
             each symmetric difference of the 2000-gene sets may hold
             near-ties only (scores within 1e-5 relative of the 2000th);
2a. sharded — the in-memory ops on cell-sharded data: the main phase's
             raw counts through ``shard_celldata`` over 4 shards of
             cuda:0, then QC → library size → log1p → HVG (2000, subset)
             → 50-PC PCA (CholeskyQR over the blocks) through
             ``Pipeline.run``, against the same steps on the card
             without the mesh: per-cell obs bit for bit, the HVG sets
             near-ties only (``hvg.select`` without subset on both
             log1p outputs), explained variance within rtol 1e-3, the
             result still sharded with finite scores on cuda:0; each
             run's wall and peak device memory;
2b. recipes — the preprocessing recipes on the main phase's raw counts
             (68,579 × 32,738), packed to the card once: the pipelines
             ``recipe_pipeline(name).run`` of seurat, zheng17,
             pearson_residuals, atlas_knn and annotation_reference, and
             ``apply("recipe.*")`` of seurat, zheng17, pearson_residuals
             and weinreb17, each at its defaults, each run's wall and
             peak device memory.  Checks: kept cells and genes against a
             count on the host CSR (weinreb17's mean/CV filter against
             float64, differing genes only within 1e-4 of a threshold);
             the dispersion, cell_ranger and pearson_residuals HVG sets
             on the card against the CPU on the recipe's input (near-ties
             only; for the two dispersion flavors, within the runs'
             largest score disagreement, itself under 1e-3 of the largest
             score), atlas_knn's seurat_v3 set against phase main's CPU
             run; layers["counts"] equal to the raw counts on 2,048
             sampled cells; every scaled gene that no clip touched with
             mean 0 and std 1 within 1e-3; finite PCAs with
             non-increasing variance; atlas_knn's recall@10 ≥ 0.99 on
             2,048 sampled cells with knn_select launched; each one-call
             op's cells and genes those of its pipeline, X within 1e-4;
             the raw planes unchanged at the end.  The CPU runs of
             hvg.select (and phase main's) run on a worker process while
             the card goes on; their checks are read after phase
             velocity;
3. binned  — ``neighbors.knn`` (k=15) on the main path's output under
             ``knn_impl="pallas_binned"`` (1024 bins): knn_binned
             launched once and knn_select never, recall@10 ≥ 0.98;
4. graph   — the main path's output (68,579 cells × 2000 genes, k=15)
             through ``Pipeline.run`` on the card: the steps of
             ``recipe_pipeline("graph_tail", t=3, jaccard=True)`` (RCM
             reorder → connectivities → Jaccard → diffusion operator →
             MAGIC → restore order), then ``embed.tsne`` (500
             iterations).  Checks: the graph kernels' launch counts
             around that run (matvec 3, jaccard 1, tsne_repulsion 500);
             knn_indices and X after the restore bitwise as before the
             reorder; jaccard bitwise its plain version; X_magic within
             rtol 1e-5 of three plain matvec steps; matvec on permuted
             inputs bitwise the permuted output; X_tsne finite, its
             15-NN label purity ≥ 0.95 × the kNN graph's.  40 more
             t-SNE iterations under torch.profiler split its device
             time into the repulsion kernels and the rest.  A second,
             stage-by-stage run gives each stage's wall time and peak
             device memory, and must repeat jaccard and X_magic bit for
             bit;
5. metacells — ``metacells.seacells`` at its defaults (914 metacells,
             50 rounds) on the main path's graph, then
             ``metacells.aggregate`` of the raw counts: matvec 151 and
             rmatvec 150 launches, A and B column-stochastic, purity
             ≥ 0.9 × the kNN graph's, counts conserved, rmatvec bitwise
             repeatable;
6. palantir — ``embed.spectral`` (matvec 61) then
             ``palantir.run(root=0)`` (rmatvec 100, one matvec per fate
             iteration): pseudotime in [0, 1], fate rows summing to 1,
             finite entropy, at least one terminal state;
6b. cluster — ``cluster.leiden``, ``louvain``, ``leiden_like``,
             ``phenograph``, ``kmeans`` (10 clusters), ``dendrogram``
             and ``graph.paga`` (over leiden's labels) on the main
             path's output with the port's connectivities, each twice
             on the card: labels and uns bit for bit between the runs,
             on the card; wall, peak memory, communities, modularity and
             ARI against the synthetic clusters; graph_jaccard launched
             once a phenograph run.  The port on the CPU on the same
             inputs (leiden_like, phenograph, kmeans, dendrogram and PAGA
             at full width; leiden and louvain on the kNN graph of the
             first 16,384 cells, rebuilt on the card): labels equal or
             ARI ≥ 0.99 with |ΔQ| ≤ 1e-4 (flipped nodes printed);
             dendrogram and PAGA bit for bit;
6c. stats  — the analysis statistics at configs[1]'s width: phase
             main's raw counts through library size and log1p on the
             card (all 32,738 genes), grouped by the synthetic clusters,
             on the main path's kNN graph with the port's
             connectivities.  Each op twice at full width, bit for bit:
             ``de.rank_genes_groups`` (t-test, t-test_overestim_var,
             wilcoxon, logreg), ``de.filter_rank_genes_groups``,
             ``score.genes`` and ``score.cell_cycle`` on marker sets,
             ``metrics.morans_i`` and ``gearys_c`` with graph_matvec
             launched twice a 256-gene block (256 a run); each run's wall
             and peak memory.  Checks: finite; groups 1–9's top 20 t-test
             genes up, logreg's top 30 overlapping the t-test's by more
             than 0.2; marker sets score their group higher and are more
             autocorrelated than the median gene.  The port on the CPU on
             cuts: the tests and both metrics on the first 2,048 genes
             (all cells), the filter on that block's wilcoxon ranking,
             the control genes (equal) and scores on the first 8,192
             cells (``STATS_TOL``);
6c'. integrate — multi-sample batch integration at configs[1]'s
             width: phase main's raw counts cut into four contiguous
             batches b0–b3 (17,145 / 17,145 / 17,145 / 17,144 cells),
             each batch's counts times its own per-gene factor
             exp(σ·N(0, 1)) (``integrate_batches``, σ =
             INTEGRATE_SIGMA, seed 19), merged by ``concat(label=
             "batch")``, through the main path to 2,000 HVGs and 50
             PCs; then ``integrate.combat`` (and a PCA of its X),
             ``integrate.harmony`` and ``integrate.mnn`` on the PCA,
             ``neighbors.bbknn`` on X_harmony, and ``integrate.ingest``
             of b3 (to log1p, b0–b2's HVG genes) onto b0–b2 (their own
             path and PCA), transferring the synthetic clusters.  Each
             op twice, bit for bit, knn_select launches counted (combat
             and harmony 0, mnn 9, bbknn 4, ingest 1); gates: the
             20-NN batch mixing up by 0.1 after harmony, mnn and
             combat's PCA, purity ≥ 0.9 × the uncorrected, ingest's
             vote right for ≥ 0.9 × the share the same vote gets inside
             b0–b2.  The card against the CPU (the worker) on the first
             2,048 cells of each batch (``INTEGRATE_TOL``; MNN's and
             ingest's neighbour lists equal or near-ties only);
6d. layouts — ``embed.umap`` (200 epochs), ``embed.force_directed``
             (300) and ``embed.draw_graph`` on the graph phase's output
             (68,579 cells, k=15), each layout twice on the card: both
             runs bit for bit, draw_graph bit for bit force_directed,
             finite (n, 2) layouts, 15-NN label purity ≥ 0.85 × (UMAP)
             and ≥ 0.65 × (ForceAtlas2) the kNN graph's, graph_matvec 61
             times a spectral start; each optimiser on the card against
             the CPU from one start and one draw of negatives after 1
             and 10 epochs (``LAYOUT_CPU_TOL``); walls, peak memory;
6e. velocity — scVelo's workflow on a seeded stand-in
             (``velocity_standin``: 68,579 cells × 2,000 genes, a trunk
             splitting into two arms, splicing-ODE Poisson counts):
             library size → log1p → 30-PC PCA → kNN (k=30, knn_select
             once) → ``velocity.moments(second=True)`` (graph_matvec 4
             times) → ``velocity.estimate`` in both modes →
             ``velocity.graph`` → ``embed.umap`` →
             ``velocity.embedding`` → ``terminal_states`` →
             ``fate_probabilities`` → ``lineage_drivers`` →
             ``recover_dynamics`` → ``latent_time``, each op's wall and
             peak memory; then ``velocity.moments(mesh=)`` over 4 shards
             of cuda:0 (ring, all_gather) against the unsharded moments,
             graph_matvec P² or P times.  Checks: every output finite,
             fate rows summing to 1 within 1e-5 where mass arrived, at
             least 2 terminal groups, the fate chain bit for bit in a
             second run; latent time's Spearman against the true time
             printed;
7. neighbors — the rest of the kNN surface on the main path's embedding
             (68,579 × 50, k=15): ``knn_impl="xla"`` under both
             ``knn_coarse`` with refine 0 and 32 (``knn_refine_mode``
             "blocked" and "sorted"): no kernel launch, id sets ≥ 0.999
             those of the knn_select route, recall@10 ≥ 0.99 on 2,048
             sampled cells; ``neighbors.bbknn`` on a seeded 4-batch
             label (knn_select once a batch, within-batch recall ≥ 0.99
             against the float64 oracle); ``distance.pairwise`` on 4,096
             rows × all cells within rtol 1e-3, atol 2e-2 of float64;
8. stream  — BASELINE configs[2..3] at 1.3M cells × 28,672 genes on the
             card (bench.py's atlas stand-in: ``DeviceSyntheticSource``,
             capacity 512, 131,072-row shards, materialized):
             ``stream_stats`` → ``stream_hvg`` (seurat_v3, 2000) →
             ``stream_pca`` (50 PCs, n_iter 2) → ``iter_knn_chunks``
             (k=15, 131,072 queries a chunk, refine 32).  Each stage's
             wall and peak memory; knn_select launched once a chunk;
             recall@10 ≥ 0.99 against the float64 oracle on 1,024
             sampled cells; scores finite, explained variance
             non-increasing, ids in range, distances sorted.  Then stats
             and HVG twice more (near-ties only), and the shard store:
             the first
             131,072 cells through ``StoreWriter`` into a temporary
             directory and back by ``ShardStore.source()`` with
             prefetch (per-cell totals bitwise, gene moments within
             rtol 1e-5; prefetch overlap and stall, read rate);
8b. stream_mesh — configs[4]'s composition: the stream phase's shards
             (on the card) through ``stream_pipeline(mesh=, k=15)``
             over 4 shards of cuda:0 and over every card: each shard cut
             into one row block a device, per-gene partials added in
             mesh order, the ring kNN over the mesh.  Each stage's wall
             and peak memory.  Checks against the stream phase: obs bit
             for bit, HVG sets near-ties only, explained variance within
             rtol 1e-3, recall@10 ≥ 0.99 of its ids; recall@10 ≥ 0.99
             against the float64 oracle on 1,024 sampled cells;
             knn_select launched P² times, padded rows -1; the stats
             pass twice more: obs and per-gene moments bit for bit
             (fixed-order sums); a prefetching host source of 131,072 cells on
             the mesh (each block copied on its device's side stream)
             against the same source flat: obs bit for bit, moments
             within rtol 1e-5;
9. mesh    — BASELINE configs[4]'s path on single-process meshes, on
             the stream phase's 1.3M × 50 embedding (the stand-in for
             the 10M-cell census slice): ``neighbors.knn_multichip``
             (k=15, ring and all_gather) over 4 shards of cuda:0 and
             over every card, against single-device ``neighbors.knn``
             (recall ≥ 0.999, distances within rtol 1e-3, atol 5e-3;
             bitwise equality printed) and the float64 oracle on 2,048
             sampled cells (recall@10 ≥ 0.99), knn_select launched P²
             (ring) or P (all_gather) times; ``impute.magic(t=3,
             mesh=)`` over 4 shards on the graph phase's output within
             atol 1e-4 of unsharded MAGIC, graph_matvec launched 3 × P²
             or 3 × P times;
10. edges  — the kNN kernels against their plain versions at small
             shapes that reach their corners (k = 1 to 256, d = 1 and
             256, euclidean, self exclusion, bf16, fewer candidates than
             k or than bins, n_bins 128 to 1024, exact ties; for
             knn_select also row counts one off its query tile,
             candidate tile and split boundaries, with empty splits, at
             k = 15 to 256 and d = 1, 3, 50, 256; for knn_binned
             candidate counts one off its 128-column tile, its chunk
             ranges and its split boundaries, and one chunk in one
             split); then the
             graph kernels at theirs (-1 ids, empty rows and
             destinations, repeated ids, a hub of 5,000 incoming edges,
             rectangular rmatvec, k = 1 and 64, odd d; Jaccard at
             k = 1 to 256, across k = 16 / 17, with odd n; t-SNE dim 1–4
             at 2 rows and at row counts one off the repulsion kernel's
             query tile, candidate tile and split boundaries),
             and matvec and rmatvec at every width path (d = 1 to 914):
             a column slice of x gives that slice of the result bit for
             bit, and an x 4 bytes off alignment the same bits;
11. kernels — each kernel against its plain version on the card at the
             path's shapes (kNN also at the configs[3] candidate width:
             1.3M points, 65,536 queries; f32 k=15, binned k=15 and
             bf16 k=32 then the f32 refine to 15, with recall against
             the float64 oracle; at each of the three knn_select bit for
             bit as knn_binned with n_bins >= nc, where every candidate
             owns its bin, and in two calls), and times: kernel, plain
             version, knn_binned with every candidate its own bin
             (binned_all_bins_ms), one library
             yardstick where a single PyTorch call computes the same
             function (timed here and used nowhere in the port) and the
             card's bound (the published peaks and the bound rules are
             printed on a line of their own).  graph_matvec is timed at
             each path's width on that path's edges (MAGIC 2000,
             SEACells 914, spectral 21, Palantir's fates, the metrics'
             256-gene block on the main graph), graph_rmatvec
             at SEACells' 914 and Palantir's 1; each holds the column-
             slice identity there too.  graph_jaccard adds its
             torch.profiler device µs a recorded launch (taken in phase
             graph, early in the process, and again here, where the
             trace loses records) and a bound at the INT32 rate;
             tsne_repulsion gives the same bits in two calls at the
             path's final layout.  knn_select also at the stream path's
             first chunk (131,072 × 1.3M × 50, k=32, f32, its own
             embedding), with the stream path's launches, and at the
             mesh phase's 4-shard shapes (a ring step, 325,632 ×
             325,632, and an all_gather search, 325,632 × 1.3M), and on
             the recipes phase's atlas_knn embedding with that run's
             launches;
             graph_matvec also at ``diffuse_sharded``'s shapes (a ring
             step on one shard's chunk, an all_gather product), at the
             layouts' spectral start (d = 8) and at the velocity
             moments (d = 2000, and ``moments(mesh=)``'s ring step and
             all_gather product at d = 8000); knn_select also at the
             velocity stand-in's 68,579² × 30, k=30, at
             stream_mesh's ring step (325,632² × 50 of its own
             embedding), and at phase integrate's searches: MNN's last
             merge (17,144 × 51,435 × 50, euclidean, K = 32, and the
             smoothing's k = 50 against b3's anchors; yardstick
             ``torch.cdist`` + ``torch.topk``) and ingest's (17,144 ×
             51,435 × 50, cosine, k = 64).

The float64 kNN oracles of phases stream and mesh run on the worker
process while the card goes on; their recalls are checked at the end of
their phase.

The line before the last is the ``kernels`` JSON; the last is
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without
the package beside it, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

MAIN_CELLS, MAIN_GENES = 68_579, 32_738
WIDE_CANDS, WIDE_QUERIES, DIM = 1_300_000, 65_536, 50
N_COMPARE = 1024  # queries held against the plain version and the oracle
N_RECALL = 4096  # cells of the main path held against the oracle
PLAIN_BLOCK = 8192  # query and candidate block of the plain version here
TSNE_ITERS = 500  # embed.tsne's default n_iter
DEVICE = "cuda"  # where the graph phases run
# t-SNE forces at the full shape, kernel against plain version: atol
# TSNE_FULL_ATOL × max_i |y_i|·Σ_j w_ij² (the two sums the force is the
# difference of).  The plain version's sums over n = 68,579 float32
# terms carry ~sqrt(n)·eps ≈ 1.6e-5 of that scale; 2e-4 leaves room for
# the largest of 137k such errors.
TSNE_FULL_ATOL = 2e-4

# Published peaks (NVIDIA data sheets, dense): f32 on the CUDA cores,
# bf16 on the tensor cores, HBM bandwidth.
PEAKS = {
    "H100 SXM": {"float32": 67e12, "bfloat16": 989e12, "bytes": 3.35e12,
                 "int32": 132 * 64 * 1.98e9},
    "H100 PCIe": {"float32": 51e12, "bfloat16": 756e12, "bytes": 2.0e12,
                  "int32": 114 * 64 * 1.755e9},
}
# int32: 64 INT32 lanes an SM a clock (the Hopper architecture white
# paper; half the FP32 lanes) at the boost clock the f32 peak assumes:
# the rate of integer compares (ISETP), which only those lanes run.


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise SmokeFailure(msg)


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


_POOL = []  # the worker process of the CPU comparisons, made at first use


def cpu_pool():
    """One worker process for the CPU oracles and comparison runs: it
    runs them while the card works on the next phase.  It is started on
    the upper half of this process's cores, and this process keeps the
    lower half from then on, so that the card phases' host work shares
    neither cores nor the interpreter lock with it.  A failed check in
    a job raises where its ``result()`` is read."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    if not _POOL:
        cores = sorted(os.sched_getaffinity(0))
        mine = cores[:max(1, len(cores) // 2)]
        theirs = cores[len(mine):] or cores
        os.sched_setaffinity(0, theirs)  # the worker inherits this mask
        try:
            pool = ProcessPoolExecutor(
                max_workers=1, mp_context=multiprocessing.get_context("spawn"))
            pool.submit(int).result()  # started now, on those cores
        finally:
            os.sched_setaffinity(0, mine)
        _POOL.append(pool)
    return _POOL[0]


def sync():
    import torch

    torch.cuda.synchronize()


def cuda_times(fn, reps: int = 5, warmup: bool = True) -> list:
    """``reps`` calls of ``fn`` timed one by one by CUDA events (ms,
    sorted), after one untimed call unless the caller has just made
    one."""
    import torch

    if warmup:
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)


def cuda_ms(fn, reps: int = 5, warmup: bool = True) -> float:
    """Median of ``cuda_times``."""
    return statistics.median(cuda_times(fn, reps, warmup))


def smi_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def host_us(fn, calls: int = 200) -> list:
    """Microseconds per call of ``fn``: host time to enqueue ``calls``
    calls, then until the card has run them."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return [(t1 - t0) / calls * 1e6, (t2 - t0) / calls * 1e6]


def device_us(fns: dict, calls: int = 20, counts: dict | None = None
              ) -> dict:
    """Device time per launch (µs) of each kernel that ``fns`` launch
    over ``calls`` calls, by torch.profiler: {label: {kernel name:
    µs}}.  Per launch the profiler recorded, not per call, so that a
    trace that lost records still gives each launch's time.
    ``counts``, when given, receives {label: {kernel name: launches
    recorded}}."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for label, fn in fns.items():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        times, seen = {}, {}
        for ev in prof.key_averages():
            t = getattr(ev, "device_time_total",
                        getattr(ev, "cuda_time_total", 0.0))
            if t > 0:
                times[ev.key[:60]] = t / max(ev.count, 1)
                seen[ev.key[:60]] = ev.count
        out[label] = times
        if counts is not None:
            counts[label] = seen
    return out


def load_package(root, name: str):
    """The package ``sctools_tpu_torch`` of the checkout at ``root`` (a
    ``git archive`` of another commit), imported as the package ``name``
    beside this one."""
    import importlib.util
    from pathlib import Path

    init = Path(root).resolve() / "sctools_tpu_torch" / "__init__.py"
    spec = importlib.util.spec_from_file_location(
        name, init, submodule_search_locations=[str(init.parent)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def peaks_for(name: str) -> tuple[str, dict]:
    key = "H100 PCIe" if "PCIe" in name else "H100 SXM"
    return key, PEAKS[key]


# ----------------------------------------------------------------------
# 1. card
# ----------------------------------------------------------------------


def card_phase() -> str:
    import torch

    from sctools_tpu_torch import cuda_build

    line = smi_line()
    print(line, flush=True)
    t0 = time.perf_counter()
    lib = cuda_build.build(verbose=True)
    build_s = time.perf_counter() - t0
    emit({"phase": "card", "nvidia_smi": line,
          "device": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0], "library": lib.name,
          "build_s": build_s})
    return line


# ----------------------------------------------------------------------
# 2. main path
# ----------------------------------------------------------------------

MAIN_STEPS = [
    ("qc.per_cell_metrics", {}),
    ("normalize.library_size", {"target_sum": 1e4}),
    ("normalize.log1p", {}),
    ("hvg.select", {"n_top": 2000, "subset": True}),
    ("pca.randomized", {"n_components": 50}),
    ("neighbors.knn", {"k": 15, "metric": "cosine"}),
]


def main_phase(card: str):
    import torch

    from sctools_tpu_torch import Pipeline
    from sctools_tpu_torch.data.synthetic import synthetic_counts
    from sctools_tpu_torch.ops.knn import knn_numpy, recall_at_k
    from sctools_tpu_torch.ops.knn_kernel import knn_select

    t0 = time.perf_counter()
    ds = synthetic_counts(MAIN_CELLS, MAIN_GENES, density=0.02,
                          n_clusters=10, seed=0)
    gen_s = time.perf_counter() - t0
    pipe = Pipeline(MAIN_STEPS)
    dev = torch.device("cuda")

    knn_select.launches = 0
    sync()
    t0 = time.perf_counter()
    out = pipe.run(ds, device=dev)
    sync()
    run_s = time.perf_counter() - t0
    launches = knn_select.launches
    check(launches > 0, "the main path's kNN launched no knn_select kernel")

    # stage by stage, for each stage's wall time and peak memory
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    data = ds.to_device(dev)
    sync()
    stages = [{"stage": "to_device", "s": time.perf_counter() - t0,
               "peak_gb": torch.cuda.max_memory_allocated() / 1e9}]
    data, more = staged(pipe, data, dev)
    stages += more
    del data

    n = out.n_cells
    x_pca = out.obsm["X_pca"][:n]
    idx = out.obsp["knn_indices"][:n].cpu().numpy()
    dist = out.obsp["knn_distances"][:n].cpu().numpy()
    check(tuple(x_pca.shape) == (n, 50), f"X_pca shape {tuple(x_pca.shape)}")
    check(out.n_genes == 2000, f"{out.n_genes} genes after hvg.select")
    check(bool(torch.isfinite(x_pca).all()), "X_pca is not finite")
    check(idx.shape == (n, 15) and (idx >= 0).all() and (idx < n).all(),
          "kNN ids out of range")
    check(np.isfinite(dist).all() and (np.diff(dist, axis=1) >= 0).all(),
          "kNN distances not finite or not sorted")
    host_pca = x_pca.cpu().numpy()
    rng = np.random.default_rng(0)
    sample = np.sort(rng.choice(n, N_RECALL, replace=False))
    oracle, _ = knn_numpy(host_pca[sample], host_pca, k=15,
                          metric="cosine", chunk=1024)
    recall = recall_at_k(idx[sample], oracle, k=10)
    check(recall >= 0.99, f"main path recall@10 {recall} < 0.99")
    hvg_sets, hvg_cpu = hvg_repeat(ds)
    emit({"phase": "main", "card": card, "cells": MAIN_CELLS,
          "genes": MAIN_GENES, "generate_s": gen_s, "run_s": run_s,
          "stages": stages, "knn_select_launches": launches,
          "recall_at_10": recall, "recall_queries": N_RECALL,
          "hvg_sets": hvg_sets})
    return {"raw": ds, "out": out, "x_pca": x_pca, "launches": launches,
            "sample": sample, "oracle": oracle, "hvg_cpu": hvg_cpu,
            "hvg_sets": hvg_sets}


SHARDED_OBS = ("total_counts", "n_genes", "pct_counts_mt", "library_size")


def sharded_phase(raw, card: str, mesh=None, label: str | None = None
                  ) -> dict:
    """``shard_celldata(raw, mesh)`` (4 shards of cuda:0 by default)
    through ``Pipeline(MAIN_STEPS[:5])`` against the same pipeline on
    the card without the mesh.  Checks: the per-cell obs bit for bit
    (row-local), the HVG sets near-ties only (``hvg.select`` without
    subset over both log1p outputs, for every gene's score), explained
    variance within rtol 1e-3, and the output still sharded: X and
    X_pca in blocks on the mesh's devices, the scores finite.  Each
    pipeline's wall and peak device memory."""
    import torch

    from sctools_tpu_torch import Pipeline, apply
    from sctools_tpu_torch.data.sharded import ShardedRows, is_sharded
    from sctools_tpu_torch.parallel import make_mesh, shard_celldata

    dev = torch.device(DEVICE)
    if mesh is None:
        mesh = make_mesh(devices=["cuda:0"] * MESH_SHARDS)
        label = f"cuda:0 x {MESH_SHARDS}"
    n = raw.n_cells
    pipe = Pipeline(MAIN_STEPS[:5])
    t0 = time.perf_counter()
    sharded = shard_celldata(raw, mesh)
    for d in set(mesh.devices):
        torch.cuda.synchronize(d)
    shard_s = time.perf_counter() - t0
    runs, outs = [], {}
    for what, data in (("one device", raw), (label, sharded)):
        out, wall, peak = timed_run(lambda: pipe.run(data, device=dev),
                                    devices=set(mesh.devices))
        pre = Pipeline(MAIN_STEPS[:3]).run(data, device=dev)
        hv = apply("hvg.select", pre, n_top=STREAM_TOP, device=dev).var
        outs[what] = (out, np.flatnonzero(hv["highly_variable"].cpu()
                                          .numpy()),
                      hv["hvg_score"].cpu().numpy())
        runs.append({"data": what, "s": wall, "peak_gb": peak})
        del pre, hv
    (one, g1, s1), (got, g2, s2) = outs.values()
    what = f"Pipeline(MAIN_STEPS[:5]) on shard_celldata(mesh={label})"
    X, emb = got.X, got.obsm["X_pca"]
    check(is_sharded(got) and isinstance(emb, ShardedRows)
          and [b.device for b in X.blocks] == list(mesh.devices)
          and [b.device for b in emb.blocks] == list(mesh.devices),
          f"{what}: the output is not sharded over the mesh")
    for k in SHARDED_OBS:
        a = got.obs[k].gather("cpu")[:n].numpy()
        b = one.obs[k][:n].cpu().numpy()
        check(np.array_equal(a, b), f"{what}: obs {k} differs from the "
                                    "single device's")
    diff = hvg_diff(g2, s2, g1, s1, STREAM_TOP,
                    f"{what}: HVG vs the single device")
    check(got.n_genes == STREAM_TOP, f"{what}: {got.n_genes} genes kept")
    ev1 = one.uns["pca_explained_variance"].cpu().numpy()
    ev2 = got.uns["pca_explained_variance"].cpu().numpy()
    ev_err = float(np.max(np.abs(ev2 - ev1) / ev1))
    check(ev_err <= 1e-3, f"{what}: explained variance beyond rtol 1e-3 "
                          f"({ev_err})")
    scores = emb.gather()
    check(tuple(scores[:n].shape) == (n, DIM)
          and bool(torch.isfinite(scores).all()),
          f"{what}: X_pca {tuple(scores.shape)} or not finite")
    emit({"phase": "sharded", "card": card, "cells": n,
          "genes": raw.n_genes, "mesh": label, "shards": mesh.size,
          "shard_celldata_s": shard_s, "runs": runs, "hvg_sym_diff": diff,
          "ev_max_rel_err": ev_err})
    del one, got, sharded, X, emb, scores, outs
    torch.cuda.empty_cache()
    return {"runs": runs, "hvg_sym_diff": diff, "ev_max_rel_err": ev_err}


def staged(steps, data, dev) -> tuple:
    """Run ``steps`` (Transforms) one by one on ``dev``: the output and
    each stage's wall time and peak device memory (each also printed to
    stderr as it ends, so a run cut by its time limit shows where)."""
    import torch

    stages = []
    for t in steps:
        torch.cuda.reset_peak_memory_stats()
        sync()
        t0 = time.perf_counter()
        data = t(data, device=dev)
        sync()
        stages.append({"stage": t.name, "s": time.perf_counter() - t0,
                       "peak_gb": torch.cuda.max_memory_allocated() / 1e9})
        print(f"[stage] {t.name} {stages[-1]['s']:.3f} s", file=sys.stderr,
              flush=True)
    return data, stages


# ----------------------------------------------------------------------
# 2b. recipes
# ----------------------------------------------------------------------

RECIPE_PIPELINES = ("seurat", "zheng17", "pearson_residuals", "atlas_knn",
                    "annotation_reference")
# one-call op → the pipeline it runs (weinreb17 is one-call only)
RECIPE_OPS = {"recipe.seurat": "seurat", "recipe.zheng17": "zheng17",
              "recipe.pearson_residuals": "pearson_residuals",
              "recipe.weinreb17": None}
# steps of each pipeline before its hvg.select, and the flavor there
HVG_PREFIX = {"seurat": (6, "dispersion", 2000),
              "zheng17": (3, "cell_ranger", 1000),
              "pearson_residuals": (2, "pearson_residuals", 2000)}
SCALED = {"seurat": 10.0, "zheng17": None, "atlas_knn": 10.0,
          "recipe.seurat": 10.0, "recipe.zheng17": None,
          "recipe.weinreb17": None}
N_LAYER_ROWS = 2048  # sampled cells of the layers["counts"] check
SCALE_COLS = 2048  # genes a float64 tile of the scaled-moments check
SCALE_TOL = 1e-3  # |mean| and |std − 1| of a scaled, unclipped gene


def expected_filters(csr) -> dict:
    """The recipes' kept cells and genes, counted on the host CSR:
    seurat keeps cells with ≥ 200 genes, then genes in ≥ 3 of them;
    zheng17 genes in ≥ 1 cell, pearson_residuals in ≥ 5."""
    n_cells, n_genes = csr.shape
    per_gene = np.bincount(csr.indices, minlength=n_genes)
    cells = np.flatnonzero(np.diff(csr.indptr) >= 200)
    kept = csr[cells]
    return {"seurat": (cells, np.flatnonzero(np.bincount(
                kept.indices, minlength=n_genes) >= 3)),
            "zheng17": (np.arange(n_cells), np.flatnonzero(per_gene >= 1)),
            "pearson_residuals": (np.arange(n_cells),
                                  np.flatnonzero(per_gene >= 5))}


def weinreb_expected(csr, mean_threshold: float = 0.01,
                     cv_threshold: float = 2.0):
    """weinreb17's gene filter in float64 on the host: median-normalised
    counts, mean and coefficient of variation (ddof=1) per gene."""
    import scipy.sparse as sp

    x = csr.astype(np.float64)
    totals = np.asarray(x.sum(axis=1)).ravel()
    scale = np.where(totals > 0, np.median(totals) / np.maximum(totals,
                                                                1e-300), 0)
    x = sp.diags(scale) @ x
    n = x.shape[0]
    mu = np.asarray(x.sum(axis=0)).ravel() / n
    ss = np.asarray(x.multiply(x).sum(axis=0)).ravel()
    var = np.maximum(ss - n * mu * mu, 0.0) / (n - 1)
    cv = np.sqrt(var) / np.maximum(mu, 1e-12)
    return (mu >= mean_threshold) & (cv >= cv_threshold), mu, cv


def scaled_moments(X, clip, what: str) -> dict:
    """``normalize.scale``'s output: within ±clip, and every gene that
    no clip touched (so its values are those before the clip) with mean
    0 and std 1 (float64 on the card, SCALE_COLS genes at a time)."""
    import torch

    top, errs, checked, clipped = 0.0, [0.0, 0.0], 0, 0
    for c0 in range(0, X.shape[1], SCALE_COLS):
        x = X[:, c0:c0 + SCALE_COLS].double()
        amax = x.abs().amax(dim=0)
        top = max(top, float(amax.max()))
        std = x.std(dim=0, correction=0)
        free = std > 0
        if clip is not None:
            free &= amax < clip
            clipped += int((amax >= clip).sum())
        checked += int(free.sum())
        if free.any():
            errs[0] = max(errs[0], float(x.mean(dim=0)[free].abs().max()))
            errs[1] = max(errs[1], float((std[free] - 1).abs().max()))
        del x
    check(clip is None or top <= clip,
          f"{what}: |X| reaches {top} > clip {clip}")
    check(checked > 0, f"{what}: no scaled gene escaped the clip")
    check(max(errs) <= SCALE_TOL,
          f"{what}: scaled genes have |mean| up to {errs[0]}, |std - 1| up "
          f"to {errs[1]}")
    return {"genes_checked": checked, "genes_clipped": clipped,
            "max_abs_mean": errs[0], "max_abs_std_minus_1": errs[1]}


def counts_layer_ok(out, csr, gene_pos: dict, what: str) -> None:
    """``layers["counts"]`` equals the raw counts subset to the kept
    cells and genes, on N_LAYER_ROWS sampled cells."""
    from sctools_tpu_torch.data.sparse import gather_rows_sparse

    cells = out.obs["cell_id"][: out.n_cells].cpu().numpy()
    genes = [gene_pos[g] for g in out.var["gene_name"]]
    rows = np.sort(np.random.default_rng(1).choice(
        len(cells), min(N_LAYER_ROWS, len(cells)), replace=False))
    got = gather_rows_sparse(out.layers["counts"], rows).to_scipy_csr()
    want = csr[cells[rows]][:, genes]
    check(got.shape == want.shape and (got != want).nnz == 0,
          f"{what}: layers['counts'] is not the raw counts of the kept "
          "cells and genes")


def pca_ok(out, what: str) -> None:
    import torch

    x = out.obsm["X_pca"][: out.n_cells]
    ev = out.uns["pca_explained_variance"]
    check(x.shape == (out.n_cells, 50), f"{what}: X_pca shape {x.shape}")
    check(bool(torch.isfinite(x).all()) and bool(torch.isfinite(ev).all()),
          f"{what}: the PCA is not finite")
    check(bool((ev[1:] <= ev[:-1] * (1 + 1e-5)).all()),
          f"{what}: explained variance not non-increasing")


def timed_run(fn, devices=(None,)) -> tuple:
    """``fn()`` on the card: its output, wall seconds to the drain of
    ``devices`` (the current card) and peak memory (GB) of the current
    card."""
    import torch

    torch.cuda.reset_peak_memory_stats()
    for d in devices:
        torch.cuda.synchronize(d)
    t0 = time.perf_counter()
    out = fn()
    for d in devices:
        torch.cuda.synchronize(d)
    return (out, time.perf_counter() - t0,
            torch.cuda.max_memory_allocated() / 1e9)


def hvg_card_vs_cpu(pre, flavor: str, n_top: int, what: str) -> dict:
    """``hvg.select`` of ``flavor`` on the card now and on the CPU on the
    worker process, over one input (the recipe's steps before it).
    ``finish()`` waits for the CPU run and checks: the gene means and
    variances within rtol 1e-4; the sets differing in near-ties only,
    and for the dispersion-based flavors in genes whose own score moved
    across the cutoff (by as much as it moved from card to CPU, plus
    the cutoff's move): their float32 bin statistics, the reference's
    formula, amplify the moments' ulps (a bin's variance s/n − mean²
    cancels; the card's sums run in no fixed order).  It returns the
    summary and ``band``, the largest such move, which bounds the flips
    between two card runs.  Also returned now: the card run's set and
    scores."""
    import torch

    from sctools_tpu_torch import apply

    t0 = time.perf_counter()
    out = apply("hvg.select", pre, n_top=n_top, flavor=flavor,
                device=torch.device(DEVICE))
    g1 = np.flatnonzero(out.var["highly_variable"].cpu().numpy())
    s1 = out.var["hvg_score"].cpu().numpy().astype(np.float64)
    t1 = time.perf_counter() - t0
    m1 = [out.var[k].cpu().numpy().astype(np.float64)
          for k in ("means", "variances")]
    del out
    job = cpu_pool().submit(cpu_hvg, pre.to_device("cpu"), flavor, n_top)
    done = []

    def finish() -> tuple:
        if done:
            return done[0]
        g2, s2, t2, m2 = job.result()
        for k, a, b in zip(("means", "variances"), m1, m2):
            bad = np.abs(a - b) > 1e-4 * np.abs(b) + 1e-12
            check(not bad.any(), f"{what}: card and CPU gene {k} differ "
                                 f"at {np.flatnonzero(bad)[:10]}")
        ds = np.abs(s1 - s2)
        cut_moved = abs(np.sort(s1)[::-1][n_top - 1]
                        - np.sort(s2)[::-1][n_top - 1])
        noisy = flavor in ("dispersion", "cell_ranger")
        band = float(ds.max() + cut_moved) if noisy else 0.0
        summary = {"flavor": flavor, "card_vs_cpu": hvg_diff(
            g1, s1, g2, s2, n_top, f"{what}: hvg.select card vs CPU",
            noise=ds + cut_moved if noisy else None),
            "max_score_diff": float(ds.max()),
            "genes_score_diff_over_1e-4": int(
                (ds > 1e-4 * (1 + np.abs(s2))).sum()),
            "card_s": t1, "cpu_s": t2}
        done.append((summary, band))
        return done[0]

    return {"card_genes": g1, "card_scores": s1, "finish": finish}


def recipes_phase(main: dict, card: str) -> dict:
    """The five pipeline recipes and the four one-call recipe ops on the
    card at 68,579 × 32,738, from the main path's raw counts (packed to
    the card once; no op may write them: they are compared at the end).
    Checks: the kept cells and genes against a count on the host CSR;
    each HVG flavor's set against the port's CPU run on the same input
    (the recipe's steps before hvg.select), and each recipe's genes
    against that set; ``layers["counts"]`` against the raw counts on
    sampled cells; scaled genes with mean 0 and std 1 where no clip
    touched them; finite PCAs; atlas_knn's recall@10 ≥ 0.99 against the
    float64 oracle on 2,048 sampled cells with knn_select launched; each
    one-call op against its pipeline.  Each run's wall and peak device
    memory."""
    import torch

    from sctools_tpu_torch import Pipeline, apply, recipe_pipeline
    from sctools_tpu_torch.ops.knn import knn_numpy, recall_at_k
    from sctools_tpu_torch.ops.knn_kernel import knn_select

    dev = torch.device(DEVICE)
    raw = main["raw"]
    csr = raw.X.tocsr()
    names = np.asarray(raw.var["gene_name"]).astype(str)
    gene_pos = {g: i for i, g in enumerate(names)}
    data = raw.to_device(dev).with_obs(cell_id=torch.arange(
        raw.n_cells, dtype=torch.int32, device=dev))
    planes = (data.X.indices.clone(), data.X.data.clone())
    expect = expected_filters(csr)
    runs, hvg, kept = [], {}, {}
    atlas = None
    later = []  # checks that wait for the worker's CPU runs

    def genes_of(out):
        return np.array([gene_pos[g] for g in out.var["gene_name"]])

    for name in RECIPE_PIPELINES:
        pipe = recipe_pipeline(name)
        knn_select.launches = 0
        out, wall, peak = timed_run(lambda: pipe.run(data, device=dev))
        launches = knn_select.launches
        info = {"recipe": f"recipe_pipeline({name!r})", "s": wall,
                "peak_gb": peak, "cells": out.n_cells, "genes": out.n_genes}
        cells = out.obs["cell_id"][: out.n_cells].cpu().numpy()
        genes = genes_of(out)
        if name in HVG_PREFIX:
            n_pre, flavor, n_top = HVG_PREFIX[name]
            pre = Pipeline(list(pipe)[:n_pre]).run(data, device=dev)
            want_cells, want_genes = expect[name]
            check(np.array_equal(cells, want_cells),
                  f"{name}: {len(cells)} cells kept, the host count keeps "
                  f"{len(want_cells)} (or others)")
            check(np.array_equal(genes_of(pre), want_genes),
                  f"{name}: the gene filter differs from the host count")
            h = hvg_card_vs_cpu(pre, flavor, n_top, name)
            del pre

            def recipe_genes(info=info, h=h, got=np.searchsorted(
                    want_genes, genes), n_top=n_top, name=name):
                # the recipe's genes: the card run's set, up to near-ties
                summary, band = h["finish"]()
                info["hvg"] = dict(summary, recipe_vs_card=hvg_diff(
                    got, h["card_scores"], h["card_genes"],
                    h["card_scores"], n_top,
                    f"{name}: recipe genes vs hvg.select", noise=band))

            later.append(recipe_genes)
            hvg[name] = h
            check(out.n_genes == n_top, f"{name}: {out.n_genes} genes")
        else:
            check(np.array_equal(cells, np.arange(raw.n_cells))
                  and out.n_genes == raw.n_genes,
                  f"{name}: cells or genes were dropped")
        if name in SCALED:
            info["scaled"] = scaled_moments(out.X, SCALED[name], name)
        if "counts" in out.layers:
            counts_layer_ok(out, csr, gene_pos, name)
        if "X_pca" in out.obsm:
            pca_ok(out, name)
        if name == "atlas_knn":
            hv = out.var["highly_variable"].cpu().numpy()

            def atlas_genes(info=info, got=np.flatnonzero(hv),
                            scores=out.var["hvg_score"].cpu().numpy()):
                cpu_genes, cpu_scores = main["hvg_cpu"]()
                info["hvg"] = {"flavor": "seurat_v3",
                               "card_vs_cpu": hvg_diff(
                                   got, scores, cpu_genes, cpu_scores, 2000,
                                   "atlas_knn: seurat_v3 card vs the main "
                                   "phase's CPU run")}

            later.append(atlas_genes)
            n = out.n_cells
            emb = out.obsm["X_pca"][:n]
            idx = out.obsp["knn_indices"][:n].cpu().numpy()
            host = emb.cpu().numpy()
            sample = np.sort(np.random.default_rng(2).choice(
                n, N_SAMPLED, replace=False))
            oracle, _ = knn_numpy(host[sample], host, k=15,
                                  metric="cosine", chunk=1024)
            recall = recall_at_k(idx[sample], oracle, k=10)
            check(launches > 0, "atlas_knn launched no knn_select kernel")
            check(recall >= 0.99, f"atlas_knn recall@10 {recall} < 0.99")
            info.update({"knn_select_launches": launches,
                         "recall_at_10": recall})
            atlas = {"x_pca": emb, "launches": launches}
        kept[name] = (cells, genes, out)
        runs.append(info)
        emit({"phase": "recipes", "run": info["recipe"], "s": wall,
              "peak_gb": peak})
        del out
        if name not in RECIPE_OPS.values():
            kept.pop(name)

    for op, name in RECIPE_OPS.items():
        out, wall, peak = timed_run(lambda: apply(op, data, device=dev))
        info = {"recipe": f"apply({op!r})", "s": wall, "peak_gb": peak,
                "cells": out.n_cells, "genes": out.n_genes}
        if op in SCALED:
            info["scaled"] = scaled_moments(out.X, SCALED[op], op)
        if "X_pca" in out.obsm:
            pca_ok(out, op)
        counts_layer_ok(out, csr, gene_pos, op)
        cells = out.obs["cell_id"][: out.n_cells].cpu().numpy()
        genes = genes_of(out)
        if name is None:  # weinreb17 against the host's float64 filter
            keep, mu, cv = weinreb_expected(csr)
            diff = np.setxor1d(genes, np.flatnonzero(keep))
            far = [int(g) for g in diff
                   if abs(mu[g] - 0.01) > 1e-4 * 0.01
                   and abs(cv[g] - 2.0) > 1e-4 * 2.0]
            check(not far and len(cells) == raw.n_cells,
                  f"{op}: genes {far[:10]} differ from the host filter "
                  "away from its thresholds")
            info["genes_vs_host"] = int(len(diff))
        else:
            p_cells, p_genes, p_out = kept.pop(name)
            h = hvg[name]
            n_top = HVG_PREFIX[name][2]
            want_genes = expect[name][1]
            check(np.array_equal(cells, p_cells),
                  f"{op}: cells differ from recipe_pipeline({name!r})")
            info["vs_pipeline"] = {}

            def op_genes(info=info, h=h, got=np.searchsorted(
                    want_genes, genes), want=np.searchsorted(
                    want_genes, p_genes), n_top=n_top, op=op):
                info["vs_pipeline"]["genes"] = hvg_diff(
                    got, h["card_scores"], want, h["card_scores"], n_top,
                    f"{op} vs its pipeline", noise=h["finish"]()[1])

            later.append(op_genes)
            if np.array_equal(genes, p_genes):
                err = float((out.X - p_out.X).abs().max())
                check(err <= 1e-4, f"{op}: X differs from its pipeline's "
                                   f"by {err}")
                info["vs_pipeline"]["max_abs_diff"] = err
            del p_out
        runs.append(info)
        emit({"phase": "recipes", "run": info["recipe"], "s": wall,
              "peak_gb": peak})
        del out
    check(torch.equal(data.X.indices, planes[0])
          and torch.equal(data.X.data, planes[1]),
          "a recipe wrote the raw counts in place")
    del data, planes

    def finish() -> None:
        """The checks on the worker's CPU runs, and the phase's line."""
        t0 = time.perf_counter()
        main["hvg_cpu"]()
        for fn in later:
            fn()
        emit({"phase": "main", "hvg_sets": main["hvg_sets"]})
        emit({"phase": "recipes", "card": card, "cells": raw.n_cells,
              "genes": raw.n_genes, "runs": runs,
              "hvg": {k: v["finish"]()[0] for k, v in hvg.items()},
              "cpu_wait_s": time.perf_counter() - t0})

    return atlas, finish


# ----------------------------------------------------------------------
# 3. neighbors.knn through the binned merge
# ----------------------------------------------------------------------


def binned_phase(main: dict, card: str) -> int:
    """``neighbors.knn`` (k=15) on the main path's output under
    ``knn_impl="pallas_binned"`` (1024 bins): the binned kernel launched
    once and the exact one never, recall@10 ≥ 0.98 against the float64
    oracle on the main phase's sampled cells."""
    import torch

    from sctools_tpu_torch import Transform, configure
    from sctools_tpu_torch.ops.knn import recall_at_k
    from sctools_tpu_torch.ops.knn_kernel import knn_binned, knn_select

    dev = torch.device(DEVICE)
    data = main["out"]
    n = data.n_cells
    knn_binned.launches = knn_select.launches = 0
    with configure(knn_impl="pallas_binned"):
        out, stages = staged([Transform("neighbors.knn", k=15)], data, dev)
    launches = {"knn_binned": knn_binned.launches,
                "knn_select": knn_select.launches}
    check(launches == {"knn_binned": 1, "knn_select": 0},
          f"binned neighbors.knn launches {launches}")
    idx = out.obsp["knn_indices"][:n].cpu().numpy()
    dist = out.obsp["knn_distances"][:n].cpu().numpy()
    check(idx.shape == (n, 15) and (idx >= 0).all() and (idx < n).all(),
          "binned kNN ids out of range")
    check(np.isfinite(dist).all() and (np.diff(dist, axis=1) >= 0).all(),
          "binned kNN distances not finite or not sorted")
    recall = recall_at_k(idx[main["sample"]], main["oracle"], k=10)
    check(recall >= 0.98, f"binned recall@10 {recall} < 0.98")
    exact = data.obsp["knn_indices"][:n].cpu().numpy()
    emit({"phase": "binned", "card": card, "cells": n, "k": 15,
          "n_bins": 1024, "stages": stages, "launches": launches,
          "recall_at_10": recall, "recall_queries": len(main["sample"]),
          "ids_equal_to_exact": float((idx == exact).mean())})
    return launches["knn_binned"]


# ----------------------------------------------------------------------
# 5-6. metacells and Palantir on the main path's graph
# ----------------------------------------------------------------------


def label_purity(labels, true) -> float:
    """Mean over the groups of ``labels`` of the share of their largest
    ``true`` class."""
    import torch

    labels, true = labels.long(), true.long()
    m, c = int(labels.max()) + 1, int(true.max()) + 1
    tab = torch.zeros((m, c), device=labels.device).index_put_(
        (labels, true), torch.ones_like(labels, dtype=torch.float32),
        accumulate=True)
    size = tab.sum(dim=1)
    return float((tab.max(dim=1).values[size > 0] / size[size > 0]).mean())


def metacells_phase(main: dict, card: str) -> dict:
    """``metacells.seacells`` at its defaults (n/75 = 914 metacells, 50
    rounds) on the main path's graph, then ``metacells.aggregate`` of the
    raw 68,579 × 32,738 counts by those labels.  Checks: matvec 151 and
    rmatvec 150 launches, A and B column-stochastic within 1e-4,
    purity against the synthetic clusters ≥ 0.9 × the kNN graph's
    (a metacell pools neighbours of neighbours, so it cannot be much
    purer than the graph it is built on, and the synthetic clusters
    overlap), counts conserved in
    float64, sizes summing to n, rmatvec bitwise repeatable at this
    shape."""
    import torch

    from sctools_tpu_torch import Transform
    from sctools_tpu_torch.ops import graph_kernels as GK
    from sctools_tpu_torch.ops.metacells import _sym_kernel

    dev = torch.device(DEVICE)
    data = main["out"]
    n = data.n_cells
    GK.matvec.launches = GK.rmatvec.launches = 0
    out, stages = staged([Transform("metacells.seacells")], data, dev)
    launches = {"matvec": GK.matvec.launches,
                "rmatvec": GK.rmatvec.launches}
    check(launches == {"matvec": 151, "rmatvec": 150},
          f"seacells launches {launches}, expected matvec 151 and "
          "rmatvec 150")
    A, B = out.uns["seacells_A"], out.uns["seacells_B"]
    m = A.shape[0]
    check(tuple(A.shape) == (m, n) and tuple(B.shape) == (n, m)
          and m == round(n / 75), f"A {tuple(A.shape)}, B {tuple(B.shape)}")
    col_err = max(float((A.sum(dim=0) - 1).abs().max()),
                  float((B.sum(dim=0) - 1).abs().max()))
    check(col_err <= 1e-4, f"A or B columns sum to 1 ± {col_err}")
    labels = out.obs["metacell"][:n]
    _, idx, w = _sym_kernel(out, device=dev)
    pur = label_purity(labels, out.obs["cluster_true"][:n])
    pur_graph = purity(out.obs["cluster_true"][:n], idx)
    check(pur >= 0.9 * pur_graph,
          f"metacell purity {pur} < 0.9 × the kNN graph's {pur_graph}")

    raw = main["raw"].with_obs(metacell=labels.cpu().numpy())
    raw = raw.to_device(dev)
    agg, agg_stages = staged([Transform("metacells.aggregate")], raw, dev)
    total = float(raw.X.data.double().sum())
    got = float(agg.uns["metacell_counts"].double().sum())
    check(got == total, f"aggregated counts {got} != the raw total {total}")
    sizes = agg.uns["metacell_sizes"]
    check(float(sizes.sum()) == n, f"metacell sizes sum to {sizes.sum()}")
    del raw, agg

    x = GK.matvec(idx, w, B)  # C = K·B, the rmatvec input of the path
    order = GK.rmatvec_order(idx, n)
    y1 = GK.rmatvec(idx, w, x, n, order=order)
    check(torch.equal(y1, GK.rmatvec(idx, w, x, n, order=order)),
          "rmatvec is not bitwise repeatable at the path's shape")
    order_ms = cuda_ms(lambda: GK.rmatvec_order(idx, n))
    emit({"phase": "metacells", "card": card, "cells": n, "metacells": m,
          "stages": stages + agg_stages, "launches": launches,
          "column_sum_max_err": col_err, "purity": pur,
          "knn_graph_purity": pur_graph,
          "counts_total": total, "rmatvec_order_ms": order_ms})
    return {"idx": idx, "w": w, "x": x, "B": B.contiguous(),
            "order_ms": order_ms, "launches": launches["rmatvec"],
            "matvec_launches": launches["matvec"]}


def palantir_phase(main: dict, card: str) -> dict:
    """``embed.spectral`` then ``palantir.run(root=0)`` on the main
    path's graph.  The ten synthetic clusters are disconnected, so the
    shortest path reruns with 4× the rounds and warns about the cells
    of the other clusters.  Checks: spectral matvec 61 launches;
    Palantir rmatvec 100 and one matvec per fate iteration; pseudotime
    finite in [0, 1], fate rows summing to 1 within 1e-5, entropy finite
    and ≥ -1e-6 (a fate share may round an ulp above 1), at least one
    terminal state."""
    import warnings

    import torch

    from sctools_tpu_torch import Transform
    from sctools_tpu_torch.ops import graph as G
    from sctools_tpu_torch.ops import graph_kernels as GK
    from sctools_tpu_torch.ops import palantir as PL

    dev = torch.device(DEVICE)
    data = main["out"]
    n = data.n_cells
    GK.matvec.launches = GK.rmatvec.launches = 0
    spec, stages = staged([Transform("embed.spectral")], data, dev)
    spectral_matvec = GK.matvec.launches
    check(spectral_matvec == 61 and GK.rmatvec.launches == 0,
          f"embed.spectral launched matvec {spectral_matvec}, rmatvec "
          f"{GK.rmatvec.launches}; expected 61 and 0")
    GK.matvec.launches = GK.rmatvec.launches = 0
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out, pal_stages = staged([Transform("palantir.run", root=0)], spec,
                                 dev)
    launches = {"spectral_matvec": spectral_matvec,
                "rmatvec": GK.rmatvec.launches,
                "fate_matvec": GK.matvec.launches}
    check(launches["rmatvec"] == 100 and launches["fate_matvec"] >= 1,
          f"palantir.run launches {launches}")
    pt = out.obs["palantir_pseudotime"][:n]
    check(bool(torch.isfinite(pt).all()) and float(pt.min()) >= 0.0
          and float(pt.max()) <= 1.0, "pseudotime not finite in [0, 1]")
    fate = out.obsm["palantir_fate_probs"][:n]
    row_err = float((fate.sum(dim=1) - 1).abs().max())
    check(row_err <= 1e-5, f"fate rows sum to 1 ± {row_err}")
    ent = out.obs["palantir_entropy"][:n]
    check(bool(torch.isfinite(ent).all()) and float(ent.min()) >= -1e-6,
          "entropy not finite and non-negative")
    terms = out.uns["palantir_terminal_states"]
    check(len(terms) >= 1, "no terminal state")
    emit({"phase": "palantir", "card": card, "cells": n,
          "stages": stages + pal_stages, "launches": launches,
          "terminal_states": len(terms),
          "unreachable_warning": [str(w.message) for w in caught
                                  if "unreachable" in str(w.message)],
          "fate_row_sum_max_err": row_err,
          "reached": int((pt < 1).sum()), "evals": [
              float(v) for v in spec.uns["diffmap_evals"][:5]]})
    # the matvec inputs of both paths, for the kernels phase: spectral's
    # symmetric edges with a start block of its width (15 + 1 + 5), and
    # Palantir's directed chain with the fate block
    idx = spec.obsp["knn_indices"][:n]
    s_edges, _, _ = G._sym_normalized_edges(
        idx, spec.obsp["connectivities"][:n])
    gen = torch.Generator(device=dev).manual_seed(0)
    v0 = torch.randn((n, 21), generator=gen, device=dev)
    ms = PL.multiscale_space(spec.uns["diffmap_evals"].cpu().numpy(),
                             spec.obsm["X_diffmap"][:n].cpu().numpy())
    p = PL.directed_chain_arrays(idx, torch.from_numpy(ms).to(dev), pt)
    return {"launches": launches["rmatvec"], "idx": idx,
            "spectral": (s_edges, v0, spectral_matvec),
            "fate": (p, fate.contiguous(), launches["fate_matvec"])}


# ----------------------------------------------------------------------
# 6b. cluster
# ----------------------------------------------------------------------

KMEANS_K = 10  # the synthetic clusters of the main path's counts
SUB_CELLS = 16_384  # cells of the leiden/louvain card-against-CPU graph
# (op, parameters, obs key of its labels); dendrogram and paga read the
# labels of cluster.leiden, their default groups
CLUSTER_OPS = [("cluster.leiden", {}, "leiden"),
               ("cluster.louvain", {}, "louvain"),
               ("cluster.leiden_like", {}, "leiden_like"),
               ("cluster.phenograph", {}, "phenograph"),
               ("cluster.kmeans", {"n_clusters": KMEANS_K}, "kmeans"),
               ("cluster.dendrogram", {}, None),
               ("graph.paga", {}, None)]
CPU_FULL = ("cluster.leiden_like", "cluster.phenograph", "cluster.kmeans",
            "cluster.dendrogram", "graph.paga")
ARI_MIN, DQ_MAX = 0.99, 1e-4  # where two runs' labels differ
# functions of ops/cluster.py whose cumulative time a profiled run reads
# (moves on the device end in host reads, so their time includes the
# device's; the coarse merge's moves count in _modularity_merge too)
CLUSTER_PARTS = ("_symmetrize_knn", "label_propagation_arrays",
                 "louvain_moves_arrays", "_modularity_merge", "_coarse_ell",
                 "modularity")


def cluster_breakdown(fn) -> dict:
    """{function: [calls, cumulative s]} of ``CLUSTER_PARTS`` in one
    call of ``fn`` under cProfile, and the call's wall."""
    import cProfile
    import pstats

    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    fn()
    sync()
    prof.disable()
    out = {"wall_s": time.perf_counter() - t0}
    for (path, _, name), (_, calls, _, cum, _) in \
            pstats.Stats(prof).stats.items():
        if path.endswith("cluster.py") and name in CLUSTER_PARTS:
            out[name] = [calls, cum]
    return out


def with_coarse_count(fn):
    """``fn()`` and how many graphs it aggregated for
    ``_modularity_merge``'s coarse branch (calls of ``_coarse_ell``,
    which that branch alone makes): 0 means only the dense matching
    merge ran."""
    from sctools_tpu_torch.ops import cluster as C

    orig, calls = C._coarse_ell, [0]

    def counted(*args, **kwargs):
        calls[0] += 1
        return orig(*args, **kwargs)

    C._coarse_ell = counted
    try:
        return fn(), calls[0]
    finally:
        C._coarse_ell = orig


def same_bits(a, b) -> bool:
    """Two results equal bit for bit: tensors, arrays, dicts, lists and
    scalars (a NaN of an array equal to a NaN in the same place)."""
    import torch

    if isinstance(a, torch.Tensor):
        return (isinstance(b, torch.Tensor) and a.dtype == b.dtype
                and torch.equal(a.cpu(), b.cpu()))
    if isinstance(a, dict):
        return (isinstance(b, dict) and sorted(a) == sorted(b)
                and all(same_bits(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)):
        return (len(a) == len(b)
                and all(same_bits(x, y) for x, y in zip(a, b)))
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and np.array_equal(
        a, b, equal_nan=a.dtype.kind in "fc")


def op_result(out, op: str, key: str | None) -> dict:
    """What ``op`` wrote: its labels and its uns entries."""
    if key is not None:
        res = {"labels": out.obs[key][: out.n_cells]}
        res.update({k: v for k, v in out.uns.items()
                    if k.startswith(key + "_")})
        return res
    prefix = "dendrogram_" if op == "cluster.dendrogram" else "paga_"
    return {k: v for k, v in out.uns.items() if k.startswith(prefix)}


def labels_agree(a, b, idx2, w2, what: str) -> dict:
    """Two label vectors: equal, or ARI ≥ 0.99 and |ΔQ| ≤ 1e-4 with the
    flipped nodes counted (each node whose community, matched to the
    other run's by most shared nodes, differs)."""
    from sctools_tpu_torch.ops.cluster import adjusted_rand_index, modularity

    a, b = np.asarray(a), np.asarray(b)
    if np.array_equal(a, b):
        return {"equal": True, "flipped": 0}
    ari = adjusted_rand_index(a, b)
    dq = abs(modularity(idx2, w2, a) - modularity(idx2, w2, b))
    tab = {}
    for x, y in zip(a.tolist(), b.tolist()):
        tab[(x, y)] = tab.get((x, y), 0) + 1
    best = {}
    for (x, y), c in tab.items():
        if c > best.get(x, (0, None))[0]:
            best[x] = (c, y)
    flipped = int(sum(best[x][1] != y for x, y in zip(a.tolist(),
                                                       b.tolist())))
    check(ari >= ARI_MIN and dq <= DQ_MAX,
          f"{what}: labels differ with ARI {ari} (< {ARI_MIN}?) or |ΔQ| "
          f"{dq} (> {DQ_MAX}?), {flipped} nodes flipped")
    return {"equal": False, "ari": ari, "abs_dq": dq, "flipped": flipped}


def cluster_phase(main: dict, card: str) -> dict:
    """The seven clustering ops on the main path's output (68,579 × 50
    X_pca, k = 15) with ``graph.connectivities`` from the port, each at
    the reference's defaults (``cluster.kmeans`` at 10 clusters;
    dendrogram and PAGA over ``cluster.leiden``'s labels), each twice
    on the card: the two runs must give the same labels and uns bit for
    bit, on the card.  Each run's wall and peak memory; for each labelling
    its communities, modularity Q on the symmetrised graph and ARI
    against the synthetic clusters.  ``cluster.phenograph`` must launch
    ``graph_jaccard`` (no ``jaccard`` in obsp).  Then the port on the
    CPU on the same inputs: leiden_like, phenograph, kmeans, dendrogram
    and PAGA at full width, leiden and louvain on the kNN graph of the
    first 16,384 cells rebuilt on the card; labels equal, or ARI ≥ 0.99
    and |ΔQ| ≤ 1e-4 with the flipped nodes printed; dendrogram and PAGA
    bit for bit.  Every compared run prints ``coarse_merges`` (card,
    CPU): the graphs ``_modularity_merge``'s coarse branch aggregated.
    That branch is also compared on its own at full width: leiden's
    first level of moves on the card, then the merge on each device."""
    import torch

    from sctools_tpu_torch import apply
    from sctools_tpu_torch.ops import graph_kernels as GK
    from sctools_tpu_torch.ops.cluster import (_modularity_merge,
                                               _symmetrize_knn,
                                               adjusted_rand_index,
                                               louvain_moves_arrays,
                                               modularity)

    dev = torch.device(DEVICE)
    t_phase = time.perf_counter()
    out = main["out"]
    n = out.n_cells
    base = out.replace(obsp={k: out.obsp[k]
                             for k in ("knn_indices", "knn_distances")})
    base = apply("graph.connectivities", base, device=dev)
    truth = out.obs["cluster_true"][:n].cpu().numpy()
    idx_h = base.obsp["knn_indices"][:n].cpu().numpy()
    w_h = base.obsp["connectivities"][:n].cpu().numpy()
    idx2, w2 = _symmetrize_knn(idx_h, w_h.astype(np.float64))

    data, card_res, card_coarse, runs = base, {}, {}, []
    jaccard_launches = 0
    for op, kw, key in CLUSTER_OPS:
        res = []
        for rep in range(2):
            GK.jaccard.launches = 0
            torch.cuda.reset_peak_memory_stats()
            sync()
            t0 = time.perf_counter()
            r, coarse = with_coarse_count(
                lambda: apply(op, data, device=dev, **kw))
            sync()
            wall = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated() / 1e9
            res.append((r, op_result(r, op, key), wall, peak,
                        GK.jaccard.launches, coarse))
        check(same_bits(res[0][1], res[1][1]),
              f"{op}: two runs on the card differ")
        row = {"op": op, "wall_s": [res[0][2], res[1][2]],
               "peak_gb": [res[0][3], res[1][3]], "bitwise_repeat": True,
               "coarse_merges": [res[0][5], res[1][5]]}
        if op == "cluster.phenograph":
            launches = [x[4] for x in res]
            check(launches == [1, 1],
                  f"cluster.phenograph launched graph_jaccard {launches} "
                  "times, expected once a run")
            jaccard_launches = launches[0]
            row["graph_jaccard_launches"] = launches
        if key is not None:
            lab_t = res[0][1]["labels"]
            check(lab_t.device.type == dev.type,
                  f"{op}: labels on {lab_t.device}, not {dev}")
            lab = lab_t.cpu().numpy()
            row.update(communities=int(len(np.unique(lab))),
                       modularity=modularity(idx2, w2, lab),
                       ari_truth=adjusted_rand_index(lab, truth))
            if key + "_modularity" in res[0][1]:
                row["uns_modularity"] = float(res[0][1][key + "_modularity"])
        runs.append(row)
        card_res[op] = res[0][1]
        card_coarse[op] = res[0][5]
        if op == "cluster.leiden":
            data = res[0][0]  # obs["leiden"] for dendrogram and paga
        del res
    check(card_res["cluster.dendrogram"]["dendrogram_leiden"][
        "correlation_matrix"].shape[0] == runs[0]["communities"],
        "dendrogram groups are not leiden's communities")
    breakdown = {op: cluster_breakdown(lambda: apply(op, base, device=dev))
                 for op in ("cluster.leiden", "cluster.leiden_like",
                            "cluster.phenograph")}

    # the port on the CPU, same inputs
    t0 = time.perf_counter()
    host = data.to_device("cpu")
    cpu_rows = []
    for op, kw, key in CLUSTER_OPS:
        if op not in CPU_FULL:
            continue
        t1 = time.perf_counter()
        r, coarse = with_coarse_count(
            lambda: apply(op, host, device="cpu", **kw))
        r = op_result(r, op, key)
        row = {"op": op, "cells": n, "cpu_s": time.perf_counter() - t1,
               "coarse_merges": [card_coarse[op], coarse]}
        if key is None:
            check(same_bits(r, card_res[op]),
                  f"{op}: the CPU result differs from the card's")
            row["bitwise"] = True
        else:
            row.update(labels_agree(card_res[op]["labels"].cpu(),
                                    r["labels"], idx2, w2,
                                    f"{op} card against CPU"))
            if op == "cluster.kmeans":
                row["centroid_max_abs_err"] = float(
                    (card_res[op]["kmeans_centroids"].cpu()
                     - r["kmeans_centroids"]).abs().max())
        cpu_rows.append(row)
    del host

    # the coarse branch at full width: leiden's first level of moves on
    # the card, then _modularity_merge on the card and on the CPU
    first = louvain_moves_arrays(
        torch.from_numpy(idx2).to(dev), torch.from_numpy(w2).to(dev),
        torch.arange(n, dtype=torch.int32, device=dev)).cpu().numpy()
    t1 = time.perf_counter()
    m_card, c_card = with_coarse_count(
        lambda: _modularity_merge(first, idx2, w2, device=dev))
    card_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    m_cpu, c_cpu = with_coarse_count(
        lambda: _modularity_merge(first, idx2, w2, device="cpu"))
    row = {"op": "_modularity_merge of leiden's first level", "cells": n,
           "first_level_communities": int(len(np.unique(first))),
           "card_s": card_s, "cpu_s": time.perf_counter() - t1,
           "coarse_merges": [c_card, c_cpu],
           "communities": int(len(np.unique(m_card)))}
    row.update(labels_agree(m_card, m_cpu, idx2, w2,
                            "coarse merge card against CPU"))
    cpu_rows.append(row)

    # leiden and louvain on the kNN graph of the first SUB_CELLS cells
    from sctools_tpu_torch import CellData

    emb = out.obsm["X_pca"][:SUB_CELLS]
    sub = CellData(emb, obsm={"X_pca": emb})
    sub = apply("neighbors.knn", sub, device=dev, k=15)
    sub = apply("graph.connectivities", sub, device=dev)
    s_idx = sub.obsp["knn_indices"][:SUB_CELLS].cpu().numpy()
    s_w = sub.obsp["connectivities"][:SUB_CELLS].cpu().numpy()
    s_idx2, s_w2 = _symmetrize_knn(s_idx, s_w.astype(np.float64))
    sub_host = sub.to_device("cpu")
    for op, _, key in CLUSTER_OPS[:2]:
        t1 = time.perf_counter()
        a, c_card = with_coarse_count(lambda: apply(op, sub, device=dev))
        card_s = time.perf_counter() - t1
        t1 = time.perf_counter()
        b, c_cpu = with_coarse_count(
            lambda: apply(op, sub_host, device="cpu"))
        row = {"op": op, "cells": SUB_CELLS, "card_s": card_s,
               "cpu_s": time.perf_counter() - t1,
               "coarse_merges": [c_card, c_cpu],
               "communities": int(len(np.unique(
                   a.obs[key].cpu().numpy())))}
        row.update(labels_agree(a.obs[key].cpu(), b.obs[key], s_idx2, s_w2,
                                f"{op} card against CPU ({SUB_CELLS} "
                                "cells)"))
        row["uns_modularity"] = [float(a.uns[key + "_modularity"]),
                                 float(b.uns[key + "_modularity"])]
        cpu_rows.append(row)
    compare_s = time.perf_counter() - t0
    emit({"phase": "cluster", "card": card, "cells": n,
          "k": int(idx_h.shape[1]), "symmetrized_cap": int(idx2.shape[1]),
          "runs": runs, "breakdown": breakdown, "cpu_compare": cpu_rows,
          "compare_s": compare_s,
          "phase_s": time.perf_counter() - t_phase})
    return {"jaccard_launches": jaccard_launches}


# ----------------------------------------------------------------------
# 6c. stats
# ----------------------------------------------------------------------

STATS_METHODS = ("t-test", "t-test_overestim_var", "wilcoxon", "logreg")
STATS_BLOCK = 2048  # genes of the card-against-CPU compares (one rank block)
STATS_TOP = 20  # top t-test genes a group whose log fold change must be > 0
LOGREG_TOP = 30  # top genes a group of the logreg against t-test overlap
LOGREG_OVERLAP = 0.2  # tests/test_de_score.py's gate (random: 0.1)
SCORE_CELLS = 8192  # cells of the score ops' card-against-CPU compare
# card against CPU, (rtol, atol): the CPU tests' tolerances against the
# float64 oracle (tests/test_torch_de.py, test_torch_score.py,
# test_torch_metrics.py); p-values where p > STATS_P_FLOOR, below which
# an ulp of t moves p by more than 1e-4 of itself
STATS_TOL = {"scores": (1e-4, 1e-5), "pvals": (1e-4, 0.0),
             "logfoldchanges": (1e-5, 1e-5), "score": (1e-6, 5e-7),
             "metrics": (1e-4, 1e-5)}
STATS_P_FLOOR = 1e-6
RANK_KEYS = ("indices", "scores", "pvals", "pvals_adj", "logfoldchanges")


def f64(v):
    """A numpy array as a float64 tensor, for ``within``."""
    import torch

    return torch.from_numpy(np.asarray(v, np.float64))


def by_gene(res: dict, key: str) -> np.ndarray:
    """A ranking's ``key`` in gene-id order (every gene ranked)."""
    inv = np.argsort(np.asarray(res["indices"]), axis=1)
    return np.take_along_axis(np.asarray(res[key]), inv, axis=1)


STATS_FILTER = dict(groupby="cluster_true", min_in_group_fraction=0.1,
                    max_out_group_fraction=0.5, min_fold_change=1.5)


def stats_cpu(blk) -> dict:
    """The port on the CPU on the stats phase's 2,048-gene block with
    all cells (a job of the worker process): the three tests, the
    filter of wilcoxon's ranking and both metrics, each timed."""
    import torch

    from sctools_tpu_torch import apply
    from sctools_tpu_torch.ops import metrics as M

    cpu = torch.device("cpu")
    out = {"rank": {}, "s": {}}
    for method in STATS_METHODS[:3]:
        t0 = time.perf_counter()
        out["rank"][method] = apply(
            "de.rank_genes_groups", blk, device=cpu, groupby="cluster_true",
            method=method).uns["rank_genes_groups"]
        out["s"][method] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["filter"] = apply(
        "de.filter_rank_genes_groups", blk.with_uns(
            rank_genes_groups=out["rank"]["wilcoxon"]), device=cpu,
        **STATS_FILTER).uns["rank_genes_groups_filtered"]
    out["s"]["filter"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["morans_i"], out["gearys_c"] = M._metrics(blk, "X", cpu)
    out["s"]["metrics"] = time.perf_counter() - t0
    return out


def stats_phase(main: dict, card: str) -> dict:
    """The analysis statistics at configs[1]'s width: the main phase's
    raw counts (68,579 × 32,738) through library size and log1p on the
    card, grouped by ``obs["cluster_true"]`` (10 groups), with the main
    path's kNN graph and the port's connectivities.  Each op twice on
    the card at full width, bit for bit: ``de.rank_genes_groups`` with
    t-test, t-test_overestim_var, wilcoxon and logreg (300 Adam steps),
    ``de.filter_rank_genes_groups`` on the wilcoxon ranking,
    ``score.genes`` and ``score.cell_cycle`` on marker sets of the
    t-test ranking, ``metrics.morans_i`` and ``gearys_c`` (graph_matvec
    launched exactly twice a 256-gene block).  Checks: finite results;
    in groups 1–9 (each boosts a gene program) the top 20 t-test genes
    up in their group and the logreg's top 30 overlapping the t-test's
    by more than 0.2; marker sets score their own group higher and are
    more autocorrelated than the median gene.  Against the port on the
    CPU: the three tests and both metrics on the first 2,048 genes with
    all cells, the filter on that block's wilcoxon ranking
    (``stats_cpu``, on the worker process while the card runs the
    rest), the scores and control genes on the first 8,192 cells (in
    this process, meanwhile)."""
    import torch

    from sctools_tpu_torch import Pipeline, apply
    from sctools_tpu_torch.ops import graph_kernels as GK
    from sctools_tpu_torch.ops import metrics as M
    from sctools_tpu_torch.ops import score as S
    from sctools_tpu_torch.ops.hvg import (_compact_capacity,
                                           select_genes_device)

    dev = torch.device(DEVICE)
    t_phase = time.perf_counter()
    out = main["out"]
    n = out.n_cells
    data = Pipeline(MAIN_STEPS[1:3]).run(main["raw"], device=dev)
    check(data.n_cells == n, f"{data.n_cells} cells against the kNN "
                             f"graph's {n}")
    graph = apply("graph.connectivities", out.replace(
        obsp={k: out.obsp[k] for k in ("knn_indices", "knn_distances")}),
        device=dev)
    data = data.with_obsp(**graph.obsp)
    genes = data.n_genes
    runs = []

    def twice(what: str, fn, result, launches=None):
        """``fn()`` twice on the card, each run timed; the two
        ``result(out)`` must be equal bit for bit."""
        got = []
        for rep in range(2):
            GK.matvec.launches = 0
            o, s, peak = timed_run(fn)
            row = {"op": what, "rep": rep, "s": s, "peak_gb": peak}
            if launches is not None:
                row["graph_matvec_launches"] = GK.matvec.launches
                check(GK.matvec.launches == launches,
                      f"{what}: graph_matvec launched {GK.matvec.launches} "
                      f"times, not {launches}")
            runs.append(row)
            got.append(result(o))
        check(same_bits(got[0], got[1]), f"{what}: two card runs differ")
        return got[0]

    def rank_of(o, key="rank_genes_groups"):
        res = o.uns[key]
        return {k: np.asarray(res[k]) for k in res
                if k not in ("method", "reference", "groups")}

    def rank(method):
        res = twice(f"de.rank_genes_groups {method}", lambda: apply(
            "de.rank_genes_groups", data, device=dev, groupby="cluster_true",
            method=method), rank_of)
        check(res["scores"].shape == (KMEANS_K, genes),
              f"{method}: scores {res['scores'].shape}")
        for key in ("scores", "logfoldchanges") + (
                ("pvals", "pvals_adj") if method != "logreg" else ()):
            check(np.isfinite(res[key]).all(), f"{method}: {key} not finite")
        return res

    # the t-test first: its markers are the score phase's gene sets; then
    # the CPU's cuts go to the worker while the card runs the rest
    ranks = {"t-test": rank("t-test")}
    tt = ranks["t-test"]
    sets = {"genes": tt["indices"][1, :50], "s_genes": tt["indices"][2, :40],
            "g2m_genes": tt["indices"][3, :40]}
    blk = select_genes_device(data, np.arange(STATS_BLOCK))
    blk = blk.with_X(_compact_capacity(blk.X,
                                       int(blk.X.nnz_per_row().max())))
    job = cpu_pool().submit(stats_cpu, blk.to_device("cpu"))
    for method in STATS_METHODS[1:]:
        ranks[method] = rank(method)
    lr = ranks["logreg"]
    overlap = []
    for g in range(1, KMEANS_K):
        check((tt["logfoldchanges"][g, :STATS_TOP] > 0).all(),
              f"group {g}: a top-{STATS_TOP} t-test gene is not up")
        overlap.append(len(set(tt["indices"][g, :LOGREG_TOP])
                           & set(lr["indices"][g, :LOGREG_TOP]))
                       / LOGREG_TOP)
        check(overlap[-1] > LOGREG_OVERLAP,
              f"group {g}: logreg top {LOGREG_TOP} overlaps the t-test's by "
              f"{overlap[-1]}")
    flt = twice("de.filter_rank_genes_groups", lambda: apply(
        "de.filter_rank_genes_groups", data.with_uns(rank_genes_groups={
            **ranks["wilcoxon"], "method": "wilcoxon", "reference": "rest",
            "groups": [str(g) for g in range(KMEANS_K)]}), device=dev,
        **STATS_FILTER), lambda o: rank_of(o, "rank_genes_groups_filtered"))

    # scores on marker sets of the t-test ranking
    sc = twice("score.genes", lambda: apply(
        "score.genes", data, device=dev, genes=sets["genes"]),
        lambda o: o.obs["score"][:n])
    cc = twice("score.cell_cycle", lambda: apply(
        "score.cell_cycle", data, device=dev, s_genes=sets["s_genes"],
        g2m_genes=sets["g2m_genes"]),
        lambda o: [o.obs["S_score"][:n], o.obs["G2M_score"][:n],
                   o.obs["phase"][:n]])
    truth = data.obs["cluster_true"][:n].cpu().numpy()
    score = sc.cpu().numpy()
    check(np.isfinite(score).all() and all(
        bool(torch.isfinite(v).all()) for v in cc[:2]), "scores not finite")
    check(score[truth == 1].mean() > score[truth != 1].mean(),
          "group 1's markers do not score group 1 higher")
    check(set(np.unique(cc[2])) <= {"G1", "S", "G2M"}, "unknown phases")

    # metrics at full width: two products a 256-gene block
    blocks = -(-genes // M._GCHUNK)
    met = {}
    for op, key in (("metrics.morans_i", "morans_i"),
                    ("metrics.gearys_c", "gearys_c")):
        met[key] = twice(op, lambda: apply(op, data, device=dev),
                         lambda o: np.asarray(o.var[key]),
                         launches=2 * blocks)
        check(met[key].shape == (genes,) and np.isfinite(met[key]).all(),
              f"{op}: not finite")
    marks = tt["indices"][1:, :STATS_TOP].ravel()
    check(np.median(met["morans_i"][marks]) > np.median(met["morans_i"])
          and np.median(met["gearys_c"][marks])
          < np.median(met["gearys_c"]),
          "marker genes are not more autocorrelated than the median gene")

    # the scores on their cut, card against CPU in this process, while
    # the worker runs the block's
    t0 = time.perf_counter()
    sub = data[np.arange(SCORE_CELLS)]
    cut = {}
    for d in (sub, sub.to_device("cpu")):
        ctrl = S._control_indices(S._gene_means_host(d.X), sets["genes"],
                                  50, 25, 0)
        r = apply("score.cell_cycle", apply(
            "score.genes", d, device=d.X.device, genes=sets["genes"]),
            device=d.X.device, s_genes=sets["s_genes"],
            g2m_genes=sets["g2m_genes"])
        cut[d.X.device.type] = (ctrl, {
            k: np.asarray(r.obs[k].cpu() if k != "phase" else r.obs[k])
            [:SCORE_CELLS] for k in ("score", "S_score", "G2M_score",
                                     "phase")})
    (ctrl_card, a), (ctrl_cpu, b) = cut[dev.type], cut["cpu"]
    check(np.array_equal(ctrl_card, ctrl_cpu),
          "score.genes: card and CPU draw other control genes")
    cmp = {"control_genes": int(len(ctrl_cpu))}
    for key in ("score", "S_score", "G2M_score"):
        cmp[key] = within(f64(a[key]), f64(b[key]), *STATS_TOL["score"])
    eps = STATS_TOL["score"][1]
    s, g = b["S_score"], b["G2M_score"]
    clear = (np.abs(s) > eps) & (np.abs(g) > eps) & (np.abs(s - g) > eps)
    check(np.array_equal(a["phase"][clear], b["phase"][clear]),
          "score.cell_cycle: card and CPU call other phases")
    cmp["score_s"] = time.perf_counter() - t0

    # the block, card against the worker's CPU runs
    t0 = time.perf_counter()
    host = job.result()
    cmp.update(cpu_s=host["s"], wait_s=time.perf_counter() - t0)
    for method in STATS_METHODS[:3]:
        row = {}
        for key in ("scores", "pvals", "logfoldchanges"):
            a = by_gene(ranks[method], key)[:, :STATS_BLOCK]
            b = by_gene(host["rank"][method], key)
            keep = b > STATS_P_FLOOR if key == "pvals" else slice(None)
            row[key] = within(f64(a[keep]), f64(b[keep]), *STATS_TOL[key])
        cmp[method] = row
    fc = apply("de.filter_rank_genes_groups", blk.with_uns(
        rank_genes_groups=host["rank"]["wilcoxon"]), device=dev,
        **STATS_FILTER).uns["rank_genes_groups_filtered"]
    fh = host["filter"]
    check(same_bits({k: np.asarray(fc[k]) for k in fh},
                    {k: np.asarray(fh[k]) for k in fh}),
          "filter_rank_genes_groups: card and CPU differ")
    cmp["filter_kept"] = int(np.asarray(fh["kept"]).sum())
    for key in ("morans_i", "gearys_c"):
        cmp[key] = within(f64(met[key][:STATS_BLOCK]), f64(host[key]),
                          *STATS_TOL["metrics"])

    # graph_matvec's input on this path: the first block's centred values
    idx, w = M._edge_arrays(data)
    x = M._values_chunk(M._resolve_values(data, "X"), n, 0, M._GCHUNK)
    emit({"phase": "stats", "card": card, "cells": n, "genes": genes,
          "groups": KMEANS_K, "runs": runs, "logreg_overlap": overlap,
          "filter_kept": int(np.asarray(flt["kept"]).sum()),
          "cpu_compare": cmp, "phase_s": time.perf_counter() - t_phase})
    return {"idx": torch.from_numpy(idx).to(dev),
            "w": torch.from_numpy(w.astype(np.float32)).to(dev),
            "x": x - x.mean(dim=0, keepdim=True),
            "launches": 2 * blocks}


# ----------------------------------------------------------------------
# 6c'. integrate
# ----------------------------------------------------------------------

INTEGRATE_KEYS = ("b0", "b1", "b2", "b3")  # the batches, in row order
INTEGRATE_SEED = 19  # numpy default_rng seed of the per-gene batch factors
INTEGRATE_SIGMA = 1.0  # a batch's factor on gene g: exp(σ·N(0, 1))
INTEGRATE_CUT = 2048  # first cells of each batch in the card-against-CPU cut
MIX_K = 20  # tests/test_integrate.py:_local_batch_mix's k
# quality gates at full width (PERF.md §6): local batch mixing
# must rise by MIX_RISE, kNN purity against the synthetic clusters keep
# PURITY_KEEP of the uncorrected embedding's, and ingest's vote on the
# query b3 be right for INGEST_KEEP of the share that the same vote
# gets inside the reference
MIX_RISE = 0.1
PURITY_KEEP = 0.9
INGEST_KEEP = 0.9  # of the same vote's accuracy inside the reference
# card against CPU on the cut: the CPU tests' tolerances
# (tests/test_torch_integrate.py, test_torch_mnn.py, test_torch_ingest.py),
# but for ingest's confidences: the test's 1e-6 holds sums in one order
# on the CPU; on the card the refine's 64 distances come from sums in
# another order (a few ulps each), and a confidence, a sum of
# normalised 1/d, moves by up to ~20 ulps of 1
INTEGRATE_TOL = {"combat": 1e-5, "harmony": 1e-4, "mnn": 1e-5,
                 "ingest_pca": (1e-5, 1.5e-6), "confidence": 1e-5,
                 "near_tie": 1e-5}
MNN_MOVED = 0.1  # the cut's share of cells a near-tie flip may move


def integrate_batches(raw, sigma: float = INTEGRATE_SIGMA):
    """The main phase's raw counts cut into len(INTEGRATE_KEYS)
    contiguous batches (sizes differing by at most one), each batch's
    stored counts multiplied by its own per-gene factor exp(σ·N(0, 1))
    (one draw a batch from ``default_rng(INTEGRATE_SEED)``): a batch
    effect in log space.  obs ``cluster_true`` and, as a category for
    ``integrate.ingest``'s vote, ``cluster``.  Returns (host CellData
    parts, row bounds)."""
    from sctools_tpu_torch import CellData

    X = raw.X.tocsr()
    n, g = X.shape
    b = len(INTEGRATE_KEYS)
    bounds = np.concatenate([[0], np.cumsum(
        [n // b + (i < n % b) for i in range(b)])])
    rng = np.random.default_rng(INTEGRATE_SEED)
    truth = np.asarray(raw.obs["cluster_true"])
    parts = []
    for i in range(b):
        rows = slice(bounds[i], bounds[i + 1])
        Xb = X[rows].astype(np.float32)  # a copy
        f = np.exp(sigma * rng.standard_normal(g)).astype(np.float32)
        Xb.data *= f[Xb.indices]
        parts.append(CellData(Xb, obs={"cluster_true": truth[rows],
                                       "cluster": truth[rows].astype(str)},
                              var=dict(raw.var)))
    return parts, bounds


def mix_purity(emb, batch, truth) -> dict:
    """``tests/test_integrate.py:_local_batch_mix`` (the share of each
    cell's MIX_K nearest neighbours, euclidean, self excluded, from
    other batches) and the share from its own synthetic cluster, with
    the port's exact kNN on the embedding's device."""
    import torch

    from sctools_tpu_torch.ops.knn import knn_arrays

    n = len(batch)
    x = emb[:n].float().contiguous()
    idx, _ = knn_arrays(x, x, k=MIX_K + 1, metric="euclidean",
                        exclude_self=True)
    idx = idx[:n, :MIX_K].long()
    b = torch.as_tensor(batch, device=x.device)
    t = torch.as_tensor(truth, device=x.device)
    return {"mixing": float((b[idx] != b[:, None]).float().mean()),
            "purity": float((t[idx] == t[:, None]).float().mean())}


def recording_search(dev, calls: list):
    """``ops.mnn.search_on(dev)`` that keeps each search's ids of the
    valid rows in ``calls``, with their float64 distances (the
    smoothing's, which the op takes; a self-distance is 0)."""
    from sctools_tpu_torch.ops import mnn as M

    knn = M.search_on(dev)

    def search(q, c, k):
        idx, d = knn(q, c, k)
        ids = idx[: len(q)]
        calls.append((ids, M._distances(q, c, ids)))
        return idx, d

    return search


def integrate_cut(inp: dict, device) -> dict:
    """The five ops on the cut's inputs on ``device`` (the card here,
    the CPU in the worker), each where its inputs are in ``inp``:
    ComBat, Harmony and MNN (its searches recorded) on ``pre`` (the HVG
    matrix and PCA), bbknn on ``bb``'s X_harmony, ingest of ``query``
    onto ``ref`` with its search's lists; each op's seconds."""
    import torch

    from sctools_tpu_torch import apply
    from sctools_tpu_torch.ops.knn import knn_arrays

    dev = torch.device(device)
    secs = {}
    out = {"s": secs}

    def timed(name, fn):
        t0 = time.perf_counter()
        r = fn()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
        return r

    if "pre" in inp:
        out.update(_integrate_cut_pre(inp["pre"].to_device(dev), dev, timed))
    if "bb" in inp:
        bb = timed("bbknn", lambda: apply(
            "neighbors.bbknn", inp["bb"].to_device(dev), device=dev,
            use_rep="X_harmony"))
        n = bb.n_cells
        out["bbknn"] = (bb.obsp["knn_indices"][:n].cpu().numpy(),
                        bb.obsp["knn_distances"][:n].cpu().numpy())
    if "query" in inp:
        ref = inp["ref"].to_device(dev)
        ing = timed("ingest", lambda: apply(
            "integrate.ingest", inp["query"], device=dev, ref=ref,
            obs=("cluster",), embeddings=()))
        nq = ing.n_cells
        idx, d = knn_arrays(ing.obsm["X_pca"], ref.obsm["X_pca"], k=15,
                            metric="cosine", n_query=nq, n_cand=ref.n_cells,
                            refine=64)
        out["ingest"] = {
            "X_pca": ing.obsm["X_pca"].cpu().numpy(),
            "cluster": np.asarray(ing.obs["cluster"]),
            "confidence": np.asarray(ing.obs["cluster_confidence"]),
            "lists": (idx[:nq].cpu().numpy(), d[:nq].cpu().numpy())}
    return out


def _integrate_cut_pre(pre, dev, timed) -> dict:
    from sctools_tpu_torch import apply
    from sctools_tpu_torch.ops import mnn as M

    out = {}
    out["combat"] = timed("combat", lambda: apply(
        "integrate.combat", pre, device=dev).X.cpu().numpy())
    out["harmony"] = timed("harmony", lambda: apply(
        "integrate.harmony", pre, device=dev).obsm["X_harmony"].cpu().numpy())
    calls = []
    out["mnn"], out["mnn_order"] = timed("mnn", lambda: M._mnn(
        pre, "batch", "X_pca", 20, 1.0, recording_search(dev, calls)))
    out["mnn_calls"] = calls
    return out


def near_tie_rows(a_idx, a_d, b_idx, b_d, what: str) -> np.ndarray:
    """Rows whose neighbour sets differ, each checked to be a near-tie:
    the ids only one list holds pair up, by sorted distance, with ids
    only the other holds at distances within INTEGRATE_TOL["near_tie"]
    (relative); the shared ids' distances agree within it too.  Returns
    the rows that differ."""
    tie = INTEGRATE_TOL["near_tie"]
    check(a_idx.shape == b_idx.shape, f"{what}: list shapes differ")
    diff = np.nonzero((np.sort(a_idx, axis=1)
                       != np.sort(b_idx, axis=1)).any(axis=1))[0]
    for i in diff:
        da = np.sort(a_d[i][~np.isin(a_idx[i], b_idx[i])])
        db = np.sort(b_d[i][~np.isin(b_idx[i], a_idx[i])])
        check(len(da) == len(db) and np.all(
            np.abs(da - db) <= tie * np.maximum(np.abs(db), 1.0)),
            f"{what}: row {i} differs beyond a near-tie ({da} vs {db})")
    same = np.setdiff1d(np.arange(len(a_idx)), diff)
    a_s = np.sort(a_d[same], axis=1)
    b_s = np.sort(b_d[same], axis=1)
    fin = np.isfinite(b_s)
    check(np.array_equal(np.isfinite(a_s), fin) and np.all(
        np.abs(a_s[fin] - b_s[fin]) <= tie * np.maximum(np.abs(b_s[fin]),
                                                        1.0)),
          f"{what}: distances of the same neighbours differ beyond {tie}")
    return diff


def integrate_compare(card: dict, cpu: dict) -> dict:
    """The cut's card results against the CPU's, at INTEGRATE_TOL."""
    tol = INTEGRATE_TOL
    cmp = {}
    a, b = card["combat"], cpu["combat"]
    cmp["combat"] = within(f64(a), f64(b), tol["combat"],
                           tol["combat"] * float(np.abs(b).max()))
    a, b = card["harmony"], cpu["harmony"]
    err = float(np.abs(a.astype(np.float64) - b).max())
    check(err <= tol["harmony"] * float(np.abs(b).max()),
          f"integrate.harmony: card and CPU {err} apart, beyond "
          f"{tol['harmony']} of the scale")
    cmp["harmony"] = err
    cmp["harmony_scale"] = float(np.abs(b).max())
    check(card["mnn_order"] == cpu["mnn_order"],
          "integrate.mnn: card and CPU merge in another order")
    flips = [len(near_tie_rows(x[0], x[1], y[0], y[1],
                               f"integrate.mnn search {i}"))
             for i, (x, y) in enumerate(zip(card["mnn_calls"],
                                            cpu["mnn_calls"]))]
    cmp["mnn_searches"] = len(flips)
    cmp["mnn_near_tie_rows"] = flips
    # a near-tie flip changes a pair, and the anchors' smoothing then
    # moves the cells around them: where a list differs, X_mnn is held
    # on all but MNN_MOVED of the cells
    a, b = card["mnn"].astype(np.float64), cpu["mnn"].astype(np.float64)
    ok = (np.abs(a - b) <= tol["mnn"] * (1.0 + np.abs(b))).all(axis=1)
    cmp["mnn_rows_moved"] = int((~ok).sum())
    cmp["mnn_max_abs_diff"] = float(np.abs(a - b).max())
    check(ok.all() if not any(flips) else ok.mean() >= 1.0 - MNN_MOVED,
          f"integrate.mnn: {int((~ok).sum())} of {len(ok)} cells beyond "
          f"rtol/atol {tol['mnn']} (near-tie rows {flips})")
    cmp["bbknn_near_tie_rows"] = len(near_tie_rows(
        *card["bbknn"], *cpu["bbknn"], "neighbors.bbknn"))
    ci, pi = card["ingest"], cpu["ingest"]
    rtol, atol = tol["ingest_pca"]
    cmp["ingest_X_pca"] = within(f64(ci["X_pca"]), f64(pi["X_pca"]), rtol,
                                 atol * float(np.abs(pi["X_pca"]).max()))
    rows = near_tie_rows(*ci["lists"], *pi["lists"], "integrate.ingest")
    keep = np.setdiff1d(np.arange(len(pi["cluster"])), rows)
    check(np.array_equal(ci["cluster"][keep], pi["cluster"][keep]),
          "integrate.ingest: card and CPU vote other labels")
    cmp["ingest_confidence"] = within(
        f64(ci["confidence"][keep]), f64(pi["confidence"][keep]),
        tol["confidence"], tol["confidence"])
    cmp["ingest_near_tie_rows"] = len(rows)
    return cmp


def integrate_phase(main: dict, card: str, sigma: float = INTEGRATE_SIGMA
                    ) -> dict:
    """Multi-sample batch integration at configs[1]'s width: the main
    phase's raw counts (68,579 × 32,738) cut into four batches with a
    per-gene batch factor each (``integrate_batches``), merged by
    ``concat(label="batch")`` and taken through the main path to 2,000
    HVGs and 50 PCs on the card; then ``integrate.combat`` (and a PCA
    of its output), ``integrate.harmony`` and ``integrate.mnn`` on the
    PCA, ``neighbors.bbknn`` on X_harmony, and ``integrate.ingest`` of
    batch b3 (the same steps, the reference's HVG genes) onto b0–b2
    (their own path and PCA), transferring the synthetic clusters.
    Each op twice on the card, bit for bit, with its knn_select
    launches counted around each run (combat and harmony 0, mnn three
    a merge, bbknn one a batch, ingest 1).  Gates: mixing, purity and
    the transfer (MIX_RISE, PURITY_KEEP; ingest's transfer
    ≥ INGEST_KEEP × the same vote inside the reference).  The
    card against the port on the CPU (the worker) on a cut, the first
    INTEGRATE_CUT cells of each batch with the card's inputs there, at
    the CPU tests' tolerances (``integrate_compare``)."""
    import torch

    from sctools_tpu_torch import CellData, Pipeline, apply, concat
    from sctools_tpu_torch.ops import ingest as IG
    from sctools_tpu_torch.ops import knn_kernel as KK
    from sctools_tpu_torch.ops import mnn as M
    from sctools_tpu_torch.ops.graph import _host
    from sctools_tpu_torch.ops.knn import knn_arrays

    dev = torch.device(DEVICE)
    t_phase = time.perf_counter()
    nb = len(INTEGRATE_KEYS)
    parts, bounds = integrate_batches(main["raw"], sigma)
    runs = []
    t0 = time.perf_counter()
    merged = concat(parts, label="batch", keys=list(INTEGRATE_KEYS))
    runs.append({"op": "concat", "s": time.perf_counter() - t0})
    check(merged.shape == main["raw"].shape,
          f"concat: shape {merged.shape}")
    for i, p in enumerate(parts):
        check((merged.X[bounds[i]:bounds[i + 1]] != p.X).nnz == 0,
              f"concat: batch {i}'s rows differ from its input")
    batch = np.asarray(merged.obs["batch"])
    check(list(batch[bounds[:-1]]) == list(INTEGRATE_KEYS),
          "concat: the batch labels")
    codes = np.unique(batch, return_inverse=True)[1]
    truth = np.asarray(merged.obs["cluster_true"])
    n = merged.n_cells

    pre, s, peak = timed_run(lambda: Pipeline(MAIN_STEPS[:5]).run(
        merged, device=dev))
    runs.append({"op": "main path to 50 PCs", "s": s, "peak_gb": peak})

    def twice(what: str, fn, result, launches: int):
        """``fn()`` twice on the card, each run timed with its
        knn_select launches counted; the two ``result(out)`` must be
        equal bit for bit."""
        got = []
        for rep in range(2):
            KK.knn_select.launches = 0
            o, s, peak = timed_run(fn)
            got.append((o, result(o)))
            runs.append({"op": what, "rep": rep, "s": s, "peak_gb": peak,
                         "knn_select_launches": KK.knn_select.launches})
            check(KK.knn_select.launches == launches,
                  f"{what}: knn_select launched {KK.knn_select.launches} "
                  f"times, not {launches}")
        check(same_bits(got[0][1], got[1][1]), f"{what}: two card runs "
                                               "differ")
        return got[0][0]

    # the cut's inputs go to the worker first; the card runs meanwhile
    cut = np.concatenate([bounds[i] + np.arange(INTEGRATE_CUT)
                          for i in range(nb)])
    n_ref = int(bounds[-2])
    ref_raw, q_raw = (CellData(merged.X[rows], obs={
        k: v[rows] for k, v in merged.obs.items()}, var=dict(merged.var))
        for rows in (slice(0, n_ref), slice(n_ref, n)))

    cb = twice("integrate.combat", lambda: apply(
        "integrate.combat", pre, device=dev), lambda o: o.X, 0)
    check(tuple(cb.X.shape) == (n, pre.n_genes)
          and bool(torch.isfinite(cb.X).all()), "integrate.combat: X")
    cb_pca, s, peak = timed_run(lambda: apply(
        "pca.randomized", cb, device=dev, n_components=50))
    runs.append({"op": "pca.randomized of combat's X", "s": s,
                 "peak_gb": peak})
    hm = twice("integrate.harmony", lambda: apply(
        "integrate.harmony", pre, device=dev),
        lambda o: o.obsm["X_harmony"], 0)
    mn = twice("integrate.mnn", lambda: apply(
        "integrate.mnn", pre, device=dev), lambda o: o.obsm["X_mnn"],
        3 * (nb - 1))
    check(mn.uns["mnn_merge_order"] == list(INTEGRATE_KEYS),
          f"integrate.mnn merge order {mn.uns['mnn_merge_order']}")
    for key, o in (("X_harmony", hm), ("X_mnn", mn)):
        check(tuple(o.obsm[key].shape) == (n, DIM)
              and bool(torch.isfinite(o.obsm[key]).all()), f"{key}")
    bb = twice("neighbors.bbknn", lambda: apply(
        "neighbors.bbknn", hm, device=dev, use_rep="X_harmony"),
        lambda o: [o.obsp["knn_indices"], o.obsp["knn_distances"]], nb)
    job = cpu_pool().submit(integrate_cut, {
        "pre": pre[cut].to_device("cpu"),
        "bb": CellData(torch.zeros((len(cut), 1)), obs={
            "batch": batch[cut]}, obsm={
            "X_harmony": hm.obsm["X_harmony"][cut].cpu()})}, "cpu")
    bidx = bb.obsp["knn_indices"][:n].cpu().numpy()
    check(bidx.shape == (n, 3 * nb) and (bidx >= 0).all()
          and (bidx < n).all(), "neighbors.bbknn: ids")
    per_batch = np.stack([(codes[bidx] == i).sum(axis=1) for i in range(nb)],
                         axis=1)
    check((per_batch == 3).all(),
          "neighbors.bbknn: not 3 neighbours from each batch in every row")

    # ingest: b3 onto b0–b2
    ref_out, s, peak = timed_run(lambda: Pipeline(MAIN_STEPS[:5]).run(
        ref_raw, device=dev))
    runs.append({"op": "reference b0-b2: main path to 50 PCs", "s": s,
                 "peak_gb": peak})
    genes = list(_host(ref_out.var["gene_name"]))
    query, s, peak = timed_run(lambda: Pipeline(MAIN_STEPS[:3]).run(
        q_raw, device=dev)[:, genes])
    runs.append({"op": "query b3: to log1p, the reference's genes", "s": s,
                 "peak_gb": peak})
    ing = twice("integrate.ingest", lambda: apply(
        "integrate.ingest", query, device=dev, ref=ref_out,
        obs=("cluster",), embeddings=()),
        lambda o: [o.obsm["X_pca"], o.obs["cluster"],
                   o.obs["cluster_confidence"]], 1)
    job_ingest = cpu_pool().submit(integrate_cut, {
        "query": query[np.arange(INTEGRATE_CUT)].to_device("cpu"),
        "ref": ref_out[cut[:3 * INTEGRATE_CUT]].to_device("cpu")}, "cpu")
    nq = n - n_ref
    right = float((np.asarray(ing.obs["cluster"])[:nq]
                   == truth[n_ref:].astype(str)).mean())
    # the same vote inside the reference (each b0–b2 cell from the other
    # reference cells): what the clusters allow without a batch gap
    ref_pca = ref_out.obsm["X_pca"][:n_ref]
    li, ld = knn_arrays(ref_pca, ref_pca, k=15, metric="cosine",
                        exclude_self=True, refine=64)
    vote, _ = IG._transfer({"cluster": truth[:n_ref].astype(str)}, {},
                           ("cluster",), (), li.cpu().numpy(),
                           ld.cpu().numpy(), n_ref)
    ref_right = float((vote["cluster"] == truth[:n_ref].astype(str)).mean())

    # quality at full width, with the port's exact kNN on the card
    quality = {"uncorrected": mix_purity(pre.obsm["X_pca"], codes, truth)}
    for name, emb in (("harmony", hm.obsm["X_harmony"]),
                      ("mnn", mn.obsm["X_mnn"]),
                      ("combat", cb_pca.obsm["X_pca"])):
        quality[name] = mix_purity(emb, codes, truth)
    quality["ingest_right"] = right
    quality["reference_vote_right"] = ref_right
    base = quality["uncorrected"]
    for name in ("harmony", "mnn", "combat"):
        got = quality[name]
        check(got["mixing"] >= base["mixing"] + MIX_RISE,
              f"{name}: batch mixing {got['mixing']} did not rise by "
              f"{MIX_RISE} from {base['mixing']}")
        check(got["purity"] >= PURITY_KEEP * base["purity"],
              f"{name}: purity {got['purity']} < {PURITY_KEEP} × "
              f"{base['purity']}")
    check(right >= INGEST_KEEP * ref_right,
          f"integrate.ingest: {right} of b3 right, < {INGEST_KEEP} × the "
          f"reference's own vote ({ref_right})")

    # the last merge's searches, for the kernels line: b3's rows against
    # the merged b0–b2, and b3 against its anchors
    ref_rows = np.arange(n_ref)
    bat = _host(pre.obsm["X_pca"])[n_ref:n].astype(np.float64)
    refz = _host(mn.obsm["X_mnn"])[ref_rows].astype(np.float64)
    search = M.search_on(dev)
    i1, _ = search(bat, refz, 20)
    i2, _ = search(refz, bat, 20)
    bm, _ = M._mutual_pairs(i1[:nq], i2[:n_ref])
    anchors = np.unique(bm)

    # the cut on the card, then against the worker's CPU run
    inp = {"pre": pre[cut],
           "bb": CellData(torch.zeros((len(cut), 1), device=dev), obs={
               "batch": batch[cut]}, obsm={
               "X_harmony": hm.obsm["X_harmony"][cut]}),
           "query": query[np.arange(INTEGRATE_CUT)],
           "ref": ref_out[cut[:3 * INTEGRATE_CUT]]}
    on_card = integrate_cut(inp, DEVICE)
    t0 = time.perf_counter()
    on_cpu, more = job.result(), job_ingest.result()
    wait_s = time.perf_counter() - t0
    on_cpu["s"].update(more.pop("s"))
    on_cpu.update(more)
    cmp = integrate_compare(on_card, on_cpu)
    cmp.update(card_s=on_card["s"], cpu_s=on_cpu["s"], wait_s=wait_s)
    emit({"phase": "integrate", "card": card, "cells": n,
          "genes": merged.n_genes, "batches": [int(x) for x in
                                               np.diff(bounds)],
          "sigma": sigma, "runs": runs, "quality": quality,
          "anchors_last_merge": int(len(anchors)), "cut": len(cut),
          "cpu_compare": cmp, "phase_s": time.perf_counter() - t_phase})
    return {"q": torch.from_numpy(bat.astype(np.float32)).to(dev),
            "c": torch.from_numpy(refz.astype(np.float32)).to(dev),
            "anchors": torch.from_numpy(bat[anchors].astype(np.float32))
            .to(dev),
            "ingest_q": ing.obsm["X_pca"][:nq],
            "ingest_c": ref_out.obsm["X_pca"][:n_ref],
            "mnn_launches": 3 * (nb - 1), "ingest_launches": 1}


def library_cdist_topk(q, c, k: int):
    """The euclidean yardstick: ``torch.cdist`` + ``torch.topk``
    (smallest), in query blocks whose distance rows stay under 1 GiB."""
    import torch

    block = 1 << max(0, (2 ** 28 // c.shape[0]).bit_length() - 1)
    vals, ids = [], []
    for q0 in range(0, q.shape[0], block):
        v, i = torch.topk(torch.cdist(q[q0:q0 + block], c), k, dim=1,
                          largest=False)
        vals.append(v)
        ids.append(i)
    return torch.cat(vals), torch.cat(ids)


def integrate_kernel_rows(integ: dict, card: str, peaks: dict) -> list:
    """knn_select at phase integrate's shapes: MNN's last merge (b3's
    17,144 rows against the merged 51,435, euclidean, the k = 20
    searches' K = 32 and the smoothing's k = 50 against b3's anchors)
    and ingest's search (b3 against b0–b2's PCA, cosine, refine 64),
    each with the launches of its op's run on the path."""
    import torch

    from sctools_tpu_torch.ops.knn import _prep, knn_numpy

    rows = []
    q, c, a = integ["q"], integ["c"], integ["anchors"]
    for what, cand, k in (("batch → merged reference", c, 32),
                          ("smoothing: batch → its anchors", a, 50)):
        host_q, host_c = q.cpu().numpy(), cand.cpu().numpy()
        orc, _ = knn_numpy(host_q[:N_COMPARE], host_c, k=15,
                           metric="euclidean", chunk=256)
        scale = float((q * q).sum(1).max() + (cand * cand).sum(1).max())
        row = kernel_case(
            f"{q.shape[0]}x{cand.shape[0]}x{DIM} k={k} float32 euclidean "
            f"(integrate.mnn last merge, {what})", q, cand, k, "euclidean",
            orc, integ["mnn_launches"], card, peaks, all_bins=False,
            library=library_cdist_topk, tol=1e-5 * max(1.0, scale))
        row["launches_note"] = ("the op's launches a run: 2 a merge at "
                                "K = 32, 1 a merge at K = 64")
        row["library_call"] = "torch.cdist + torch.topk"
        rows.append(row)
    qi = _prep(integ["ingest_q"], "cosine", torch.float32)
    ci = _prep(integ["ingest_c"], "cosine", torch.float32)
    orc, _ = knn_numpy(integ["ingest_q"][:N_COMPARE].cpu().numpy(),
                       integ["ingest_c"].cpu().numpy(), k=15,
                       metric="cosine", chunk=256)
    rows.append(kernel_case(
        f"{qi.shape[0]}x{ci.shape[0]}x{DIM} k=64 float32 (integrate.ingest:"
        " b3 onto b0-b2's PCA, refine 64)", qi, ci, 64, "cosine", orc,
        integ["ingest_launches"], card, peaks, all_bins=False))
    return rows


# ----------------------------------------------------------------------
# 6d. layouts
# ----------------------------------------------------------------------

# (op, obsm key, epochs, scale of its spectral start)
LAYOUT_RUNS = (("embed.umap", "X_umap", 200, 10.0),
               ("embed.force_directed", "X_draw_graph", 300, 1.0))
# a layout's 15-NN label purity must reach this share of the kNN
# graph's (PERF.md §2, stated before the first card run).  On a
# 20,000-cell synthetic_counts graph on the CPU the reference's layouts
# reach 0.956 and 0.767 of it, the port's 0.951 and 0.763
LAYOUT_PURITY = {"embed.umap": 0.85, "embed.force_directed": 0.65}
# card against CPU from one start and one draw of negatives: max |Δy|
# over max |y| after 1 and after 10 epochs.  pow and exp differ by an
# ulp between the two devices' libraries, and each epoch multiplies
# such a difference: on the CPU alone, one ulp added to half the start
# grows to 3e-7 of the scale after 1 epoch and to 1.6e-4 (UMAP) and
# 4.8e-4 (ForceAtlas2) after 10, on a 20,000-cell synthetic_counts
# graph.  ForceAtlas2 grows most: its start, scaled to ±1, keeps a
# cluster's cells within ~1e-3 of each other, where its 1/d² repulsion
# is steepest.
LAYOUT_CPU_TOL = {1: {"embed.umap": 1e-5, "embed.force_directed": 1e-5},
                  10: {"embed.umap": 1e-3, "embed.force_directed": 1e-2}}
SPECTRAL_MATVEC = 61  # embed.spectral's 60 subspace iterations + 1


def layouts_phase(graph: dict, card: str) -> dict:
    """``embed.umap`` (200 epochs), ``embed.force_directed`` (300) and
    ``embed.draw_graph`` on the graph phase's output (68,579 cells, its
    k=15 graph and connectivities), each layout twice on the card.
    Checks: the two runs equal bit for bit, ``draw_graph`` bit for bit
    ``force_directed``; finite (n, 2) layouts; 15-NN label purity ≥
    ``LAYOUT_PURITY`` × the kNN graph's; graph_matvec launched 61 times
    by each spectral start.  Then each layout's optimiser on the card and
    on the CPU from one start with one draw of negatives, 1 and 10
    epochs: max |Δ| within ``LAYOUT_CPU_TOL`` × max |y|.  Each run's
    wall and peak memory."""
    import torch

    from sctools_tpu_torch import Transform
    from sctools_tpu_torch.ops import graph_kernels as GK
    from sctools_tpu_torch.ops import umap as U
    from sctools_tpu_torch.ops.graph import (_sym_normalized_edges,
                                             _symmetrized_weights)
    from sctools_tpu_torch.ops.knn import knn_arrays

    dev = torch.device(DEVICE)
    t_phase = time.perf_counter()
    data = graph["out"]
    n = data.n_cells
    idx = data.obsp["knn_indices"][:n]
    conn = data.obsp["connectivities"][:n]
    labels = data.obs["cluster_true"][:n]
    pur_graph = purity(labels, idx)
    runs, results, launches = [], {}, 0
    for op, key, epochs, _ in LAYOUT_RUNS:
        GK.matvec.launches = 0
        first, st1 = staged([Transform(op, n_epochs=epochs)], data, dev)
        spectral = GK.matvec.launches
        check(spectral == SPECTRAL_MATVEC,
              f"{op}: its spectral start launched graph_matvec {spectral} "
              f"times, expected {SPECTRAL_MATVEC}")
        launches += spectral
        again, st2 = staged([Transform(op, n_epochs=epochs)], data, dev)
        y = first.obsm[key][:n]
        check(tuple(y.shape) == (n, 2) and bool(torch.isfinite(y).all()),
              f"{op}: {key} is not a finite (n, 2) layout")
        check(torch.equal(y, again.obsm[key][:n]),
              f"{op}: two runs on the card differ")
        nbr, _ = knn_arrays(y, y, k=15, metric="euclidean",
                            exclude_self=True)
        pur = purity(labels, nbr[:n])
        gate = LAYOUT_PURITY[op]
        check(pur >= gate * pur_graph,
              f"{op}: 15-NN label purity {pur} < {gate} × the kNN "
              f"graph's {pur_graph}")
        runs.append({"op": op, "epochs": epochs, "stages": st1 + st2,
                     "spectral_matvec": spectral, "purity": pur,
                     "purity_gate": gate, "scale": float(y.abs().max())})
        results[op] = y
        del first, again
    drawn, st = staged([Transform("embed.draw_graph",
                                  n_epochs=LAYOUT_RUNS[1][2])], data, dev)
    check(torch.equal(drawn.obsm["X_draw_graph"][:n],
                      results["embed.force_directed"]),
          "embed.draw_graph differs from embed.force_directed")
    runs.append({"op": "embed.draw_graph", "stages": st,
                 "bitwise_force_directed": True})
    del drawn

    # the optimisers alone, card against CPU, from one start and one draw
    seed = 0
    compare = {}
    for op, _, _, scale in LAYOUT_RUNS:
        y0 = U._spectral_init(data, 2, seed, dev, scale=scale)
        if op == "embed.umap":
            w = _symmetrized_weights(idx, conn, mode="union_norm")
            fn = U.umap_layout_arrays
        else:
            w = conn
            fn = U.fa2_layout_arrays
        compare[op] = []
        for epochs, tols in LAYOUT_CPU_TOL.items():
            t0 = time.perf_counter()
            y_card = fn(idx, w, y0, seed, n_epochs=epochs).cpu()
            card_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            y_cpu = fn(idx.cpu(), w.cpu(), y0.cpu(), seed, n_epochs=epochs)
            cpu_s = time.perf_counter() - t0
            err = float((y_card - y_cpu).abs().max() / y_cpu.abs().max())
            check(err <= tols[op],
                  f"{op}: card against CPU after {epochs} epochs: max |Δ| "
                  f"{err} of the scale > {tols[op]}")
            compare[op].append({"epochs": epochs, "rel_max_abs_err": err,
                                "tol": tols[op],
                                "bitwise": bool(torch.equal(y_card, y_cpu)),
                                "card_s": card_s, "cpu_s": cpu_s})
    emit({"phase": "layouts", "card": card, "cells": n,
          "k": int(idx.shape[1]), "graph_purity": pur_graph, "runs": runs,
          "card_vs_cpu": compare, "phase_s": time.perf_counter() - t_phase})
    s_edges, _, _ = _sym_normalized_edges(idx, conn)
    gen = torch.Generator(device=dev).manual_seed(0)
    v0 = torch.randn((n, 2 + 1 + 5), generator=gen, device=dev)
    return {"idx": idx, "spectral": (s_edges, v0, launches)}


# ----------------------------------------------------------------------
# 6e. velocity
# ----------------------------------------------------------------------

VEL_GENES = 2000  # scVelo's filter_and_normalize(n_top_genes=2000)
VEL_PCS, VEL_K = 30, 30  # scVelo's pp.moments(n_pcs=30, n_neighbors=30)
VEL_BRANCH = 0.3  # the true time at which the trunk splits into two arms
VEL_SEED = 0


def velocity_standin(n: int, g: int, seed: int, dev):
    """The seeded stand-in for scVelo's pancreas / dentate gyrus data
    (downloads the repository does not hold): n cells along a trunk that
    splits at true time 0.3 into two arms, g genes in three programs
    (trunk, arm A, arm B; a program runs only in its own cells), each
    gene on the splicing ODE (rates drawn as in
    ``tests/test_velocity.py:260``: α in 2–5, β in 3–8, γ/β in 0.3–3,
    switch at 0.45–0.8 of the program's span), Poisson counts of
    ``level_g · library_c · (u, s)``.  Returns (spliced counts, unspliced
    counts, true time, arm), on ``dev``."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)
    f64 = torch.float64

    def unif(lo, hi, size):
        return lo + (hi - lo) * torch.rand(size, generator=gen, device=dev,
                                           dtype=f64)

    t = unif(0.0, 1.0, (n,))
    arm = torch.where(t < VEL_BRANCH, 0,
                      1 + (unif(0.0, 1.0, (n,)) < 0.5).long())
    program = torch.arange(g, device=dev) % 3  # 0 trunk, 1 arm A, 2 arm B
    alpha = unif(2.0, 5.0, (g,))
    beta = unif(3.0, 8.0, (g,))
    gamma = beta * unif(0.3, 3.0, (g,))
    gamma = torch.where((gamma - beta).abs() < 1e-3 * beta, 1.001 * beta,
                        gamma)
    t_on = torch.where(program == 0, 0.0, VEL_BRANCH).to(f64)
    span = unif(0.45, 0.8, (g,)) * (1.0 - t_on)  # on until the switch
    tau = torch.clamp(t[:, None] - t_on[None, :], min=0.0)

    def on(tt):
        u = alpha / beta * (1.0 - torch.exp(-beta * tt))
        s = (alpha / gamma * (1.0 - torch.exp(-gamma * tt))
             + alpha / (gamma - beta) * (torch.exp(-gamma * tt)
                                         - torch.exp(-beta * tt)))
        return u, s

    u_sw, s_sw = on(span)
    off = torch.clamp(tau - span, min=0.0)
    u_on, s_on = on(torch.minimum(tau, span))
    u = torch.where(tau <= span, u_on, u_sw * torch.exp(-beta * off))
    s = torch.where(tau <= span, s_on,
                    s_sw * torch.exp(-gamma * off)
                    + beta * u_sw / (gamma - beta)
                    * (torch.exp(-beta * off) - torch.exp(-gamma * off)))
    del u_on, s_on, tau, off
    active = (program[None, :] == 0) | (program[None, :] == arm[:, None])
    level = torch.exp(1.0 + 0.5 * torch.randn(g, generator=gen, device=dev,
                                              dtype=f64))
    lib = torch.exp(0.3 * torch.randn(n, generator=gen, device=dev,
                                      dtype=f64))
    scale = lib[:, None] * level[None, :]
    U = torch.poisson(torch.where(active, u * scale, 0.0).float(),
                      generator=gen)
    S = torch.poisson(torch.where(active, s * scale, 0.0).float(),
                      generator=gen)
    return S, U, t, arm


def library_normalized(L):
    """Each cell's counts scaled to the median library size (scVelo's
    ``filter_and_normalize`` of a layer)."""
    import torch

    size = L.sum(dim=1, keepdim=True)
    return L / torch.clamp(size, min=1.0) * size.median()


def all_finite(data, fields) -> list:
    """The fields of ``data`` (``(where, key)``) that hold a non-finite
    value."""
    import torch

    return [f"{where}[{key!r}]" for where, key in fields
            if not bool(torch.isfinite(
                getattr(data, where)[key].float()).all())]


FATE_FIELDS = (("obs", "terminal_states"), ("uns", "terminal_stationary"),
               ("obsm", "fate_probs"))


def velocity_phase(card: str) -> dict:
    """scVelo's workflow on a seeded stand-in (``velocity_standin``,
    68,579 cells × 2,000 genes), on the card: library size → log1p →
    30-PC randomized PCA → kNN (k=30; knn_select once), then
    ``velocity.moments(second=True)`` (graph_matvec 4 times at d =
    2000), ``velocity.estimate`` in both modes, ``velocity.graph`` →
    ``embed.umap`` → ``velocity.embedding`` → ``terminal_states`` →
    ``fate_probabilities`` → ``lineage_drivers`` → ``recover_dynamics``
    → ``latent_time``, each op's wall and peak memory; then
    ``velocity.moments(mesh=)`` over 4 shards of cuda:0, ring and
    all_gather, within rtol 1e-5 and atol 1e-5 of the unsharded moments,
    graph_matvec launched P² or P times.  Checks: every output finite;
    fate rows summing to 1 within 1e-5 where mass arrived; at least 2
    terminal groups; a second run of the fate chain equal bit for bit.
    The Spearman correlation of latent_time with the true time is
    printed."""
    import torch
    from scipy.stats import spearmanr

    from sctools_tpu_torch import Transform
    from sctools_tpu_torch.data.dataset import CellData
    from sctools_tpu_torch.ops import graph_kernels as GK
    from sctools_tpu_torch.ops.graph import _symmetrized_weights
    from sctools_tpu_torch.ops.knn_kernel import knn_select
    from sctools_tpu_torch.parallel import make_mesh

    dev = torch.device(DEVICE)
    t_phase = time.perf_counter()
    n = MAIN_CELLS
    sync()
    t0 = time.perf_counter()
    S, U, t_true, arm = velocity_standin(n, VEL_GENES, VEL_SEED, dev)
    sync()
    gen_s = time.perf_counter() - t0
    data = CellData(S, obs={"t_true": t_true, "arm": arm},
                    layers={"spliced": library_normalized(S),
                            "unspliced": library_normalized(U)})
    del U
    knn_select.launches = 0
    pre, stages = staged([Transform("normalize.library_size"),
                          Transform("normalize.log1p"),
                          Transform("pca.randomized", n_components=VEL_PCS),
                          Transform("neighbors.knn", k=VEL_K)], data, dev)
    knn_launches = knn_select.launches
    check(knn_launches == 1, f"the stand-in's neighbors.knn launched "
                             f"knn_select {knn_launches} times")
    GK.matvec.launches = 0
    mom, st = staged([Transform("velocity.moments", second=True)], pre, dev)
    stages += st
    moment_launches = GK.matvec.launches
    check(moment_launches == 4, f"velocity.moments(second=True) launched "
                                f"graph_matvec {moment_launches} times")
    det, st = staged([Transform("velocity.estimate")], mom, dev)
    stages += st
    est, st = staged([Transform("velocity.estimate", mode="stochastic")],
                     mom, dev)
    stages += st
    GK.matvec.launches = 0
    chain = [Transform("velocity.graph"), Transform("embed.umap"),
             Transform("velocity.embedding", basis="umap")]
    emb, st = staged(chain, est, dev)
    stages += st
    umap_matvec = GK.matvec.launches
    check(umap_matvec == SPECTRAL_MATVEC,
          f"embed.umap's spectral start launched graph_matvec "
          f"{umap_matvec} times")
    fate_ops = [Transform("velocity.terminal_states"),
                Transform("velocity.fate_probabilities")]
    fates, st = staged(fate_ops, emb, dev)
    stages += st
    drivers, st = staged([Transform("velocity.lineage_drivers")], fates,
                         dev)
    stages += st
    dyn, st = staged([Transform("velocity.recover_dynamics"),
                      Transform("velocity.latent_time")], drivers, dev)
    stages += st
    again, _ = staged(fate_ops, emb, dev)
    check(all(same_bits(getattr(fates, where)[key],
                        getattr(again, where)[key])
              for where, key in FATE_FIELDS),
          "two runs of the fate chain on the card differ")
    del again

    bad = (all_finite(mom, [("layers", k) for k in ("Ms", "Mu", "Mss",
                                                     "Mus")])
           + all_finite(det, [("layers", "velocity"),
                              ("var", "velocity_gamma")])
           + all_finite(est, [("layers", "velocity"),
                              ("var", "velocity_gamma")])
           + all_finite(emb, [("obsp", "velocity_graph"),
                              ("obsm", "X_umap"),
                              ("obsm", "velocity_umap")])
           + all_finite(drivers, FATE_FIELDS[1:]
                        + (("varm", "lineage_drivers"),))
           + all_finite(dyn, [("var", k) for k in (
               "fit_alpha", "fit_beta", "fit_gamma", "fit_t_switch",
               "fit_scaling", "fit_r2")] + [("layers", "fit_t"),
                                           ("layers", "velocity"),
                                           ("obs", "latent_time")]))
    check(not bad, f"non-finite outputs: {bad}")
    term = fates.obs["terminal_states"][:n]
    groups = int(term.max()) + 1
    check(groups >= 2, f"{groups} terminal group(s), expected at least 2")
    F = fates.obsm["fate_probs"][:n]
    row = F.sum(dim=1)
    arrived = row > 0
    row_err = float((row[arrived] - 1).abs().max())
    check(row_err <= 1e-5, f"fate rows sum to 1 ± {row_err}")
    lt = dyn.obs["latent_time"][:n].cpu().numpy()
    rho = float(spearmanr(lt, t_true.cpu().numpy()).statistic)
    genes = det.var["velocity_genes"]

    # the moments over 4 shards of cuda:0 against the unsharded ones
    mesh = make_mesh(devices=["cuda:0"] * MESH_SHARDS)
    sharded = []
    for strategy in ("ring", "all_gather"):
        GK.matvec.launches = 0
        out, st = staged([Transform("velocity.moments", second=True,
                                    mesh=mesh, strategy=strategy)], pre,
                         dev)
        launches = GK.matvec.launches
        expect = mesh.size ** 2 if strategy == "ring" else mesh.size
        check(launches == expect,
              f"velocity.moments(mesh=) {strategy}: graph_matvec "
              f"{launches} launches, expected {expect}")
        err = max(within(out.layers[k], mom.layers[k][:n], 1e-5, 1e-5)
                  for k in ("Ms", "Mu", "Mss", "Mus"))
        sharded.append({"strategy": strategy, "shards": mesh.size,
                        "stages": st, "matvec_launches": launches,
                        "max_abs_err": err})
        del out
    emit({"phase": "velocity", "card": card, "cells": n,
          "genes": VEL_GENES, "pcs": VEL_PCS, "k": VEL_K,
          "standin": "velocity_standin (seeded; not scVelo's data)",
          "generate_s": gen_s, "stages": stages,
          "knn_select_launches": knn_launches,
          "moments_matvec_launches": moment_launches,
          "umap_matvec_launches": umap_matvec,
          "velocity_genes": {"deterministic": int(genes.sum()),
                             "stochastic":
                                 int(est.var["velocity_genes"].sum())},
          "terminal_groups": groups,
          "terminal_cells": int((term >= 0).sum()),
          "fate_row_sum_max_err": row_err,
          "fate_rows_arrived": int(arrived.sum()),
          "fit_r2_over_0.3": int((dyn.var["fit_r2"] > 0.3).sum()),
          "latent_time_spearman": rho, "fate_chain_bitwise": True,
          "moments_mesh": sharded,
          "phase_s": time.perf_counter() - t_phase})
    idx = mom.obsp["knn_indices"][:n]
    w = _symmetrized_weights(idx, mom.obsp["connectivities"][:n],
                             mode="union")
    w = torch.where(idx < 0, 0.0, w)
    return {"x_pca": pre.obsm["X_pca"][:n], "knn_launches": knn_launches,
            "idx": idx, "w": w, "S": mom.layers["spliced"][:n].contiguous(),
            "moments_launches": moment_launches, "mesh": mesh,
            "sharded": {r["strategy"]: r["matvec_launches"]
                        for r in sharded}}


def velocity_kernel_rows(lay: dict, vel: dict, card: str,
                         peaks: dict) -> list:
    """The kernel rows of phases layouts and velocity: graph_matvec at
    the layouts' spectral start (d = 8, both layouts' launches) and at
    the moments (d = 2000 on the stand-in's k=30 union graph; a ring
    step and an all_gather product of ``velocity.moments(mesh=)`` over
    4 shards, d = 8000); knn_select at the stand-in's 68,579² × 30,
    k=30."""
    import torch

    from sctools_tpu_torch.ops.knn import _prep, knn_numpy
    from sctools_tpu_torch.parallel.graph_multichip import (
        _Sharded, pad_rows_for_mesh)
    from sctools_tpu_torch.parallel.mesh import CELL_AXIS, split_rows

    s_edges, v0, launches = lay["spectral"]
    rows = [matvec_row(lay["idx"], s_edges, v0, launches,
                       "embed.umap + embed.force_directed spectral start",
                       card, peaks)]
    idx, w, S = vel["idx"], vel["w"], vel["S"]
    rows.append(matvec_row(idx, w, S, vel["moments_launches"],
                           "velocity.moments, one layer", card, peaks))
    m = vel["mesh"]
    x = torch.cat([S] * 4, dim=1)  # the four layers' width
    idx_p, w_p, x_p, _ = pad_rows_for_mesh(m, idx=idx, weights=w, x=x)
    ring = _Sharded("ring step", idx_p, w_p, x_p, m, CELL_AXIS, "ring")
    gather = _Sharded("all_gather", idx_p, w_p, x_p, m, CELL_AXIS,
                      "all_gather")
    x0 = split_rows(x_p, m)[0]
    rows.append(matvec_row(ring.local[0][0], ring.w[0], x0,
                           vel["sharded"]["ring"],
                           f"velocity.moments(mesh=) ring step, {m.size} "
                           "shards", card, peaks))
    rows.append(matvec_row(gather.idx[0], gather.w[0], x_p,
                           vel["sharded"]["all_gather"],
                           f"velocity.moments(mesh=) all_gather, {m.size} "
                           "shards", card, peaks))
    del x, x_p, x0, ring, gather
    emb = vel["x_pca"]
    n = emb.shape[0]
    host = emb.cpu().numpy()
    oracle, _ = knn_numpy(host[:N_COMPARE], host, k=VEL_K, metric="cosine",
                          chunk=256)
    q = _prep(emb, "cosine", torch.float32)
    rows.append(kernel_case(
        f"{n}x{n}x{VEL_PCS} k={VEL_K} float32 (velocity stand-in)", q, q,
        VEL_K, "cosine", oracle, vel["knn_launches"], card, peaks,
        plain_reps=1, library_reps=2, all_bins=False))
    return rows


# ----------------------------------------------------------------------
# 7. the rest of the kNN surface on the main path's embedding
# ----------------------------------------------------------------------

N_SAMPLED = 2048  # sampled queries of the recall checks of phases 7 and 9
XLA_RUNS = [(coarse, refine, mode) for coarse in ("topk", "approx")
            for refine, mode in ((0, None), (32, "blocked"), (32, "sorted"))]
BBKNN_BATCHES, BBKNN_K = 4, 3
PAIRWISE_ROWS = 4096


def neighbors_phase(main: dict, card: str) -> dict:
    """On the main path's embedding (68,579 × 50, k=15): the blocked
    ``knn_impl="xla"`` search under both ``knn_coarse``, with refine 0
    and 32 (``knn_refine_mode`` "blocked" and "sorted"): no kernel
    launched, ids against the ``knn_select`` route at the same refine
    (set agreement ≥ 0.999) and recall@10 ≥ 0.99 against the float64
    oracle on 2,048 of the main phase's sampled cells; then
    ``neighbors.bbknn`` on a seeded 4-batch label column (knn_select
    once a batch; each sampled row's lists from each batch against
    ``knn_numpy`` within that batch, recall ≥ 0.99); then
    ``distance.pairwise``'s arrays on 4,096 query rows × all cells
    against float64 numpy (rtol 1e-3, atol 2e-2) and the op on those
    4,096 cells."""
    import torch

    from sctools_tpu_torch import Transform, configure
    from sctools_tpu_torch.ops.distance import pairwise_arrays
    from sctools_tpu_torch.ops.knn import knn_arrays, knn_numpy, recall_at_k
    from sctools_tpu_torch.ops.knn_kernel import knn_select

    dev = torch.device(DEVICE)
    data = main["out"]
    x = main["x_pca"]
    n = x.shape[0]
    step = len(main["sample"]) // N_SAMPLED  # spread over all rows
    sample = main["sample"][::step][:N_SAMPLED]
    oracle = main["oracle"][::step][:N_SAMPLED]
    host = x.cpu().numpy()
    select = {0: data.obsp["knn_indices"][:n].cpu().numpy(),
              32: knn_arrays(x, x, k=15, refine=32)[0][:n].cpu().numpy()}
    runs = []
    for coarse, refine, mode in XLA_RUNS:
        cfg = dict(knn_impl="xla", knn_coarse=coarse)
        if mode:
            cfg["knn_refine_mode"] = mode
        knn_select.launches = 0
        sync()
        t0 = time.perf_counter()
        with configure(**cfg):
            idx, dist = knn_arrays(x, x, k=15, refine=refine)
        sync()
        wall = time.perf_counter() - t0
        what = f"xla {coarse} refine {refine} {mode or ''}".strip()
        check(knn_select.launches == 0, f"{what}: launched knn_select")
        idx = idx[:n].cpu().numpy()
        dist = dist[:n].cpu().numpy()
        check(np.isfinite(dist).all() and (np.diff(dist, axis=1) >= 0).all(),
              f"{what}: distances not finite or not sorted")
        agree = recall_at_k(idx, select[refine])
        check(agree >= 0.999, f"{what}: id sets agree {agree} < 0.999 with "
                              "the knn_select route")
        recall = recall_at_k(idx[sample], oracle, k=10)
        check(recall >= 0.99, f"{what}: recall@10 {recall} < 0.99")
        runs.append({"knn_coarse": coarse, "refine": refine,
                     "knn_refine_mode": mode, "s": wall,
                     "id_sets_agree": agree,
                     "ids_equal": float((idx == select[refine]).mean()),
                     "recall_at_10": recall})

    batch = np.random.default_rng(0).integers(0, BBKNN_BATCHES, n)
    knn_select.launches = 0
    out, stages = staged([Transform("neighbors.bbknn", k_within=BBKNN_K)],
                         data.with_obs(batch=batch), dev)
    bb_launches = knn_select.launches
    check(bb_launches == BBKNN_BATCHES,
          f"bbknn launched knn_select {bb_launches} times for "
          f"{BBKNN_BATCHES} batches")
    got = out.obsp["knn_indices"][:n].cpu().numpy()
    check(got.shape == (n, BBKNN_BATCHES * BBKNN_K) and (got >= 0).all(),
          f"bbknn ids {got.shape} with padding")
    hits = total = 0
    for b in range(BBKNN_BATCHES):
        sel = np.flatnonzero(batch == b)
        ids, _ = knn_numpy(host[sample], host[sel], k=BBKNN_K + 1,
                           metric="cosine", chunk=1024)
        ids = sel[ids]
        for r, row in enumerate(sample):
            want = [i for i in ids[r] if i != row][:BBKNN_K]
            hits += len(set(want) & set(got[row].tolist()))
            total += BBKNN_K
    bb_recall = hits / total
    check(bb_recall >= 0.99, f"bbknn within-batch recall {bb_recall}")

    rows = np.sort(main["sample"][:PAIRWISE_ROWS])
    sync()
    t0 = time.perf_counter()
    dmat = pairwise_arrays(x[torch.from_numpy(rows).to(dev)], x)
    sync()
    pair_s = time.perf_counter() - t0
    x64 = host.astype(np.float64)
    x64 /= np.maximum(np.linalg.norm(x64, axis=1, keepdims=True), 1e-12)
    worst = 0.0
    for r0 in range(0, len(rows), 512):
        want = 1.0 - x64[rows[r0:r0 + 512]] @ x64.T
        part = dmat[r0:r0 + 512].cpu().numpy().astype(np.float64)
        worst = max(worst, float((np.abs(part - want)
                                  - 1e-3 * np.abs(want)).max()))
    check(worst <= 2e-2, f"distance.pairwise beyond rtol 1e-3 + atol 2e-2 "
                         f"({worst} over)")
    sub = data[rows]
    op = Transform("distance.pairwise")(sub, device=dev)
    check(torch.equal(op.obsp["pairwise_distances"],
                      pairwise_arrays(sub.obsm["X_pca"][:len(rows)],
                                      sub.obsm["X_pca"][:len(rows)])),
          "distance.pairwise differs from pairwise_arrays")
    emit({"phase": "neighbors", "card": card, "cells": n, "k": 15,
          "xla_runs": runs, "recall_queries": len(sample),
          "bbknn": {"batches": BBKNN_BATCHES, "k_within": BBKNN_K,
                    "stages": stages, "knn_select_launches": bb_launches,
                    "within_batch_recall": bb_recall},
          "pairwise": {"rows": len(rows), "cols": n, "s": pair_s,
                       "max_excess_over_rtol": worst}})
    return {"runs": runs}


# ----------------------------------------------------------------------
# 8. the streamed path: BASELINE configs[2..3] at 1.3M cells
# ----------------------------------------------------------------------

# bench.py:phase_atlas's stand-in for the 1.3M-cell mouse-brain matrix
STREAM_CELLS, STREAM_GENES = 1_300_000, 28_672
STREAM_CAPACITY, STREAM_SHARD_ROWS = 512, 131_072
STREAM_CHUNK = 131_072  # queries a knn_select launch
STREAM_REFINE = 32  # bench.py's refine width on the atlas path
STREAM_TOP = 2000
STORE_ROWS, STORE_SHARD_ROWS = 131_072, 32_768  # the store sub-phase
NEAR_TIE = 1e-5  # relative distance of a near-tie to the cutoff score


def hvg_diff(a_genes, a_scores, b_genes, b_scores, n_top: int,
             what: str, noise=None) -> int:
    """Size of the symmetric difference of two HVG sets; fails unless
    every gene in it lies within NEAR_TIE (relative) of the
    ``n_top``-th score in both runs' scores, or within ``noise`` (per
    gene, or one value for all: for scores whose float32 ulps are
    amplified, as in the dispersion flavors' bin statistics, how far
    scores move between two runs)."""
    a_scores = np.asarray(a_scores, np.float64)
    b_scores = np.asarray(b_scores, np.float64)
    noise = np.broadcast_to(0.0 if noise is None else noise,
                            a_scores.shape)
    diff = np.setxor1d(np.asarray(a_genes), np.asarray(b_genes))
    cuts = [np.sort(s)[::-1][n_top - 1] for s in (a_scores, b_scores)]
    far = [int(g) for g in diff
           if any(abs(s[g] - c) > max(NEAR_TIE * abs(c), noise[g])
                  for s, c in zip((a_scores, b_scores), cuts))]
    check(not far, f"{what}: genes {far[:10]} differ beyond near-ties of "
                   f"the cutoff scores {cuts}")
    return int(len(diff))


def hvg_repeat(ds) -> tuple:
    """``hvg.select`` (seurat_v3, 2000) twice on the card and once on the
    CPU over one input: the main path's log1p output, copied to the
    host for the CPU run.  Each symmetric difference may hold near-ties
    only.  Returns the summary and the CPU run's (genes, scores)."""
    import torch

    from sctools_tpu_torch import Pipeline, apply

    dev = torch.device(DEVICE)
    pre = Pipeline(MAIN_STEPS[:3]).run(ds, device=dev)
    runs = []
    for where in (dev, dev):
        t0 = time.perf_counter()
        out = apply("hvg.select", pre, n_top=STREAM_TOP, device=where)
        hv = out.var["highly_variable"].cpu().numpy()
        runs.append((np.flatnonzero(hv), out.var["hvg_score"].cpu().numpy(),
                     time.perf_counter() - t0))
        del out
    host = pre.to_device("cpu")
    del pre
    (g1, s1, t1), (g2, s2, t2) = runs
    cpu = cpu_pool().submit(cpu_hvg, host, "seurat_v3", STREAM_TOP)
    summary = {"n_top": STREAM_TOP,
               "card_vs_card": hvg_diff(g1, s1, g2, s2, STREAM_TOP,
                                        "hvg.select, card run 1 vs 2"),
               "card_s": [t1, t2]}

    def finish() -> tuple:
        g3, s3, t3, _ = cpu.result()
        summary.update(card_vs_cpu=hvg_diff(g1, s1, g3, s3, STREAM_TOP,
                                            "hvg.select, card vs CPU"),
                       cpu_s=t3)
        return g3, s3

    return summary, finish


def cpu_hvg(host, flavor: str, n_top: int) -> tuple:
    """``hvg.select`` of ``flavor`` on the CPU over ``host`` (a CellData
    on the CPU): the set, the scores, the seconds, and the gene means
    and variances (float64).  Runs on the worker process."""
    import torch

    from sctools_tpu_torch import apply

    t0 = time.perf_counter()
    out = apply("hvg.select", host, n_top=n_top, flavor=flavor,
                device=torch.device("cpu"))
    return (np.flatnonzero(out.var["highly_variable"].numpy()),
            out.var["hvg_score"].numpy().astype(np.float64),
            time.perf_counter() - t0,
            [out.var[k].numpy().astype(np.float64)
             for k in ("means", "variances")])


def store_phase(src, card: str) -> dict:
    """The shard store at scale: the first STORE_ROWS cells of the
    streamed source written through ``StoreWriter`` (chunks of 8,192
    rows) into a temporary directory, then streamed back by
    ``ShardStore.source()`` with prefetch on.  Per-cell totals bitwise
    those of the in-memory shards, gene moments within rtol 1e-5."""
    import tempfile

    import torch

    from sctools_tpu_torch.data import stream as ST
    from sctools_tpu_torch.data.shardstore import StoreWriter

    dev = torch.device(DEVICE)
    _, first = next(iter(src))
    csr = first.to_scipy_csr()[:STORE_ROWS]
    pieces = [ST.SparseCells(first.indices[a:a + STORE_SHARD_ROWS],
                             first.data[a:a + STORE_SHARD_ROWS],
                             min(STORE_SHARD_ROWS, STORE_ROWS - a),
                             first.n_genes)
              for a in range(0, STORE_ROWS, STORE_SHARD_ROWS)]
    mem = ST.ShardSource(lambda: iter(pieces), STORE_ROWS, src.n_genes,
                         STORE_SHARD_ROWS, device=dev)
    want = ST.stream_stats(mem)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_store_") as d:
        t0 = time.perf_counter()
        w = StoreWriter(d, src.n_genes, shard_rows=STORE_SHARD_ROWS,
                        chunk_rows=STORE_SHARD_ROWS // 4)
        w.append(csr)
        store = w.close()
        write_s = time.perf_counter() - t0
        disk = sum(os.path.getsize(store.chunk_path(c))
                   for c in range(store.n_chunks))
        ssrc = store.source(device=dev)
        sync()
        t0 = time.perf_counter()
        got = ST.stream_stats(ssrc)
        read_s = time.perf_counter() - t0
    check(np.array_equal(got["total_counts"], want["total_counts"]),
          "store: per-cell totals differ from the in-memory shards")
    errs = {}
    for key in ("gene_mean", "gene_var", "raw_gene_mean", "raw_gene_var",
                "gene_nnz"):
        a, b = got[key], want[key]
        errs[key] = float(np.max(np.abs(a - b) / np.maximum(np.abs(b),
                                                            1e-30)))
        check(np.allclose(a, b, rtol=1e-5, atol=0.0),
              f"store: {key} beyond rtol 1e-5 (max rel {errs[key]})")
    c = ssrc.counters
    row = {"phase": "store", "card": card, "cells": STORE_ROWS,
           "shards": store.n_shards, "chunks": store.n_chunks,
           "nnz": int(csr.nnz), "disk_gb": disk / 1e9, "write_s": write_s,
           "stats_pass_s": read_s, "read_gb_per_s": disk / 1e9 / read_s,
           "prefetch_overlap_s": c.overlap_s, "prefetch_stall_s": c.stall_s,
           "retries": c.retries, "max_rel_err": errs}
    emit(row)
    return row


def stream_phase(card: str) -> dict:
    """BASELINE configs[2..3] on the card at 1.3M cells (bench.py's
    atlas stand-in, ``DeviceSyntheticSource``, materialized):
    ``stream_stats`` → ``stream_hvg(seurat_v3, 2000)`` →
    ``stream_pca(50, n_iter=2)`` → ``iter_knn_chunks(k=15, 131,072
    queries a chunk, refine=STREAM_REFINE)``.  Each stage's
    wall (ending in a sync) and peak memory; knn_select launched once a
    chunk; recall@10 ≥ 0.99 against the float64 oracle on 1,024 sampled
    cells; scores finite, explained variance non-increasing, ids in
    range, distances sorted.  Then stats + HVG twice more (near-ties
    only), and the store sub-phase."""
    import torch

    from sctools_tpu_torch.config import config
    from sctools_tpu_torch.data import stream as ST
    from sctools_tpu_torch.data.synthetic import DeviceSyntheticSource
    from sctools_tpu_torch.ops import knn_kernel as KK
    from sctools_tpu_torch.ops.knn import (iter_knn_chunks, knn_numpy,
                                           recall_at_k)

    dev = torch.device(DEVICE)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    sync()
    t0 = time.perf_counter()
    src = DeviceSyntheticSource(
        STREAM_CELLS, STREAM_GENES, capacity=STREAM_CAPACITY,
        shard_rows=STREAM_SHARD_ROWS, n_clusters=8, seed=0, device=dev)
    sync()
    gen_s = time.perf_counter() - t0
    gen_gb = sum(sh.indices.nbytes + sh.data.nbytes for _, sh in src) / 1e9
    gen_peak = torch.cuda.max_memory_allocated() / 1e9
    n = src.n_cells
    stages = []

    def stage(name, fn):
        torch.cuda.reset_peak_memory_stats()
        sync()
        t = time.perf_counter()
        out = fn()
        sync()
        stages.append({"stage": name, "s": time.perf_counter() - t,
                       "peak_gb": torch.cuda.max_memory_allocated() / 1e9})
        return out

    def knn_all(scores):
        parts = list(iter_knn_chunks(scores, k=15, chunk=STREAM_CHUNK,
                                     refine=STREAM_REFINE))
        return (torch.cat([p[2] for p in parts]),
                torch.cat([p[3] for p in parts]), len(parts))

    KK.knn_select.launches = 0
    sync()
    t_path = time.perf_counter()
    stats = stage("stream_stats", lambda: ST.stream_stats(src))
    genes = stage("stream_hvg", lambda: ST.stream_hvg(
        stats, n_top=STREAM_TOP, flavor="seurat_v3", src=src))
    scores, comps, expl = stage("stream_pca", lambda: ST.stream_pca(
        src, genes, stats["gene_mean"], n_components=50, n_iter=2))
    idx, dist, chunks = stage("iter_knn_chunks", lambda: knn_all(scores))
    sync()
    path_s = time.perf_counter() - t_path
    launches = KK.knn_select.launches
    check(launches == chunks,
          f"stream: {launches} knn_select launches for {chunks} chunks")

    check(tuple(scores.shape) == (n, 50), f"stream: X_pca {scores.shape}")
    check(bool(torch.isfinite(scores).all()), "stream: X_pca not finite")
    ev = expl.cpu().numpy()
    check(bool(np.all(np.diff(ev) <= 0)),
          "stream: explained variance increases")
    check(tuple(idx.shape) == (n, 15), f"stream: knn ids {idx.shape}")
    check(bool(((idx >= 0) & (idx < n)).all()), "stream: ids out of range")
    check(bool(torch.isfinite(dist).all())
          and bool((dist[:, 1:] >= dist[:, :-1]).all()),
          "stream: distances not finite or not sorted")
    host = scores.cpu().numpy()
    sample = np.sort(np.random.default_rng(0).choice(n, N_COMPARE,
                                                     replace=False))
    # the float64 oracle on the worker while the card repeats the passes
    oracle_job = cpu_pool().submit(knn_numpy, host[sample], host, k=15,
                                   metric="cosine", chunk=256)
    del dist, host

    # stats + HVG twice more: the set may move by near-ties only
    sets = [(genes, ST.stream_hvg_scores(stats, src=src))]
    for _ in range(2):
        st = ST.stream_stats(src)
        s = ST.stream_hvg_scores(st, src=src)
        sets.append((np.sort(np.argsort(-s, kind="stable")[:STREAM_TOP]),
                     s))
    hvg_diffs = [hvg_diff(*sets[0], *sets[1], STREAM_TOP,
                          "stream_hvg, path vs run 2"),
                 hvg_diff(*sets[1], *sets[2], STREAM_TOP,
                          "stream_hvg, run 2 vs run 3")]

    store = store_phase(src, card)
    t0 = time.perf_counter()
    oracle, _ = oracle_job.result()
    oracle_wait_s = time.perf_counter() - t0
    recall = recall_at_k(idx[sample].cpu().numpy(), oracle, k=10)
    check(recall >= 0.99, f"stream: recall@10 {recall} < 0.99")
    emit({"phase": "stream", "card": card, "cells": n,
          "genes": STREAM_GENES, "capacity": STREAM_CAPACITY,
          "shards": src.n_shards, "shard_rows": src.shard_rows,
          "generate_s": gen_s, "generate_gb": gen_gb,
          "generate_peak_gb": gen_peak, "path_s": path_s,
          "stages": stages, "knn_chunks": chunks,
          "knn_select_launches": launches, "refine": STREAM_REFINE,
          "refine_mode": config.resolved_refine_mode(n),
          "recall_at_10": recall, "recall_queries": N_COMPARE,
          "oracle_wait_s": oracle_wait_s,
          "explained_variance_top5": ev[:5].tolist(),
          "hvg_sym_diffs": hvg_diffs})
    # the source's shards, the stats, HVG and kNN ids stay for the
    # stream_mesh phase, which frees them
    return {"scores": scores, "launches": launches, "store": store,
            "src": src, "stats": stats, "hvg": sets[0], "ev": ev,
            "idx": idx, "path_s": path_s}


# ----------------------------------------------------------------------
# 8b. configs[4]'s streamed path on a mesh
# ----------------------------------------------------------------------

STREAM_MESH_STAGES = ("stream_stats", "stream_hvg", "stream_pca")
OBS_KEYS = ("total_counts", "n_genes", "pct_counts_mt")


def staged_stream_pipeline(src, mesh, dev) -> tuple:
    """``stream_pipeline(src, mesh=mesh, k=15)`` at its defaults (seed
    0: the stream phase's sketch), with each stage's wall and peak
    device memory: the stages are wrapped, for this call, in timers
    that drain the card before and after (the pipeline reads each
    pass's result on the host anyway).  Returns the output, the path's
    wall, the stages and the HVG scores."""
    import torch

    from sctools_tpu_torch.data import stream as ST
    from sctools_tpu_torch.parallel import knn_multichip as KM

    stages, scores = [], {}
    saved = {name: getattr(ST, name) for name in STREAM_MESH_STAGES
             + ("stream_hvg_scores",)}
    saved_knn = KM.knn_multichip_arrays

    def timed(name, fn):
        def run(*args, **kw):
            sync()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            sync()
            stages.append({"stage": name, "s": time.perf_counter() - t0,
                           "peak_gb": torch.cuda.max_memory_allocated()
                           / 1e9})
            return out
        return run

    def keep_scores(*args, **kw):
        scores["hvg"] = saved["stream_hvg_scores"](*args, **kw)
        return scores["hvg"]

    try:
        for name in STREAM_MESH_STAGES:
            setattr(ST, name, timed(name, saved[name]))
        ST.stream_hvg_scores = keep_scores
        KM.knn_multichip_arrays = timed("knn_multichip_arrays (ring)",
                                        saved_knn)
        sync()
        t0 = time.perf_counter()
        out = ST.stream_pipeline(src, mesh=mesh, k=15, seed=0,
                                 n_top=STREAM_TOP, n_components=DIM,
                                 device=dev)
        sync()
        wall = time.perf_counter() - t0
    finally:
        for name, fn in saved.items():
            setattr(ST, name, fn)
        KM.knn_multichip_arrays = saved_knn
    return out, wall, stages, scores["hvg"]


def prefetch_on_mesh(shard, mesh, dev) -> dict:
    """The prefetching source on a mesh: the first STORE_ROWS cells of
    ``shard`` as a host CSR source (STORE_SHARD_ROWS-row shards,
    prefetch on), whose blocks are pinned and copied on each device's
    side stream, each waited for by its own event; ``stream_stats`` on
    it against the same source without the mesh: obs bit for bit,
    per-gene moments within rtol 1e-5."""
    import dataclasses

    from sctools_tpu_torch.data import stream as ST

    csr = shard.to_scipy_csr()[:STORE_ROWS]
    host = dataclasses.replace(ST.ShardSource.from_scipy(
        csr, shard_rows=STORE_SHARD_ROWS, capacity=shard.capacity,
        device=dev), prefetch=True)
    want = ST.stream_stats(host)
    meshed = host.with_mesh(mesh)
    sync()
    t0 = time.perf_counter()
    got = ST.stream_stats(meshed)
    wall = time.perf_counter() - t0
    for k in OBS_KEYS:
        check(np.array_equal(got[k], want[k]),
              f"prefetch on the mesh: obs {k} differs from the flat pass")
    err = 0.0
    for k in ("gene_mean", "gene_var", "raw_gene_mean", "raw_gene_var"):
        a, b = got[k], want[k]
        err = max(err, float(np.max(np.abs(a - b)
                                    / np.maximum(np.abs(b), 1e-30))))
        check(np.allclose(a, b, rtol=1e-5, atol=0.0),
              f"prefetch on the mesh: {k} beyond rtol 1e-5")
    c = meshed.counters
    return {"cells": STORE_ROWS, "shard_rows": STORE_SHARD_ROWS,
            "stats_s": wall, "moments_max_rel_diff": err,
            "overlap_s": c.overlap_s, "stall_s": c.stall_s}


def stream_mesh_phase(stream: dict, card: str, meshes=None) -> dict:
    """configs[4]'s composition: the stream phase's materialized 1.3M ×
    28,672 shards (on the card, no host copy) in a ``ShardSource`` on
    cuda:0 through ``stream_pipeline(mesh=, k=15)`` (seed 0, the stream
    phase's) over 4 shards of cuda:0 and over ``make_mesh()`` (every
    card), or over ``meshes`` ({label: mesh}).  Each stage's wall and
    peak.  Checks against the stream
    phase: obs bit for bit, the HVG sets near-ties only, explained
    variance within rtol 1e-3, recall@10 ≥ 0.99 of its kNN ids; recall@10
    ≥ 0.99 against the float64 oracle on 1,024 sampled cells (on a
    worker process while the second mesh runs); knn_select launched P²
    times (``mesh_launches``), padded rows -1; then ``stream_stats``
    twice more on the first mesh: obs and per-gene moments bit for bit;
    and ``prefetch_on_mesh``."""
    import torch

    from sctools_tpu_torch.data import stream as ST
    from sctools_tpu_torch.ops.knn import knn_numpy, recall_at_k
    from sctools_tpu_torch.ops.knn_kernel import knn_select
    from sctools_tpu_torch.parallel import make_mesh

    dev = torch.device(DEVICE)
    base = stream["src"]
    shards = [sh for _, sh in base]
    n, genes = base.n_cells, base.n_genes
    src = ST.ShardSource(lambda: iter(shards), n, genes, base.shard_rows,
                         device=dev, factory_from=lambda k: iter(shards[k:]))
    want_obs = {k: stream["stats"][k] for k in OBS_KEYS}
    want_genes, want_scores = stream["hvg"]
    want_ids = stream["idx"].cpu().numpy()
    sample = np.sort(np.random.default_rng(3).choice(n, N_COMPARE,
                                                     replace=False))
    if meshes is None:
        meshes = {f"cuda:0 x {MESH_SHARDS}": make_mesh(
            devices=["cuda:0"] * MESH_SHARDS),
            f"{torch.cuda.device_count()} card(s)": make_mesh()}
    runs, oracle_job, kept = [], None, None
    for label, mesh in meshes.items():
        knn_select.launches = 0
        out, wall, stages, hvg_scores = staged_stream_pipeline(src, mesh,
                                                              dev)
        launches = knn_select.launches
        what = f"stream_pipeline(mesh={label})"
        expect = mesh_launches(n, mesh.size, "ring")
        check(launches == expect, f"{what}: {launches} knn_select launches, "
                                  f"expected {expect}")
        for k in OBS_KEYS:
            check(np.array_equal(out["obs"][k], want_obs[k]),
                  f"{what}: obs {k} differs from the stream phase's")
        diff = hvg_diff(out["hvg_genes"], hvg_scores, want_genes,
                        want_scores, STREAM_TOP,
                        f"{what}: HVG vs the stream phase")
        ev = out["pca_explained_variance"].cpu().numpy()
        ev_err = float(np.max(np.abs(ev - stream["ev"]) / stream["ev"]))
        check(ev_err <= 1e-3, f"{what}: explained variance beyond rtol "
                              f"1e-3 ({ev_err})")
        emb = out["X_pca"]
        check(tuple(emb.shape) == (n, 50)
              and bool(torch.isfinite(emb).all()),
              f"{what}: X_pca {tuple(emb.shape)} or not finite")
        idx = out["knn_indices"]
        check(bool((idx[n:] == -1).all()), f"{what}: padding rows hold ids")
        host_i = idx[:n].cpu().numpy()
        rec_stream = recall_at_k(host_i, want_ids, k=10)
        check(rec_stream >= 0.99, f"{what}: recall@10 {rec_stream} < 0.99 "
                                  "of the stream phase's ids")
        if oracle_job is None:
            host = emb.cpu().numpy()
            oracle_job = cpu_pool().submit(
                knn_numpy, host[sample], host, k=15, metric="cosine",
                chunk=256)
            kept = {"emb": emb, "launches": launches, "mesh": mesh,
                    "ids": host_i, "label": label}
            del host
        runs.append({"mesh": label, "shards": mesh.size, "s": wall,
                     "stages": stages, "knn_select_launches": launches,
                     "hvg_sym_diff": diff, "ev_max_rel_err": ev_err,
                     "recall_at_10_vs_stream": rec_stream})
        emit({"phase": "stream_mesh", "run": what, "s": wall,
              "stages": stages})
        del out, idx, host_i
    t0 = time.perf_counter()
    oracle, _ = oracle_job.result()
    oracle_wait_s = time.perf_counter() - t0
    recall = recall_at_k(kept["ids"][sample], oracle, k=10)
    check(recall >= 0.99, f"stream_pipeline(mesh={kept['label']}): "
                          f"recall@10 {recall} < 0.99 against the oracle")

    # the stats pass twice more on the first mesh
    msrc = src.with_mesh(next(iter(meshes.values())))
    reps = [ST.stream_stats(msrc) for _ in range(2)]
    for k in OBS_KEYS:
        check(all(np.array_equal(r[k], want_obs[k]) for r in reps),
              f"stream_stats on the mesh: obs {k} differs between runs")
    for k in ("gene_mean", "gene_var", "raw_gene_mean", "raw_gene_var",
              "gene_nnz"):
        check(np.array_equal(reps[0][k], reps[1][k]),
              f"stream_stats on the mesh: {k} differs between runs")
    prefetch = prefetch_on_mesh(shards[0], next(iter(meshes.values())),
                                dev)
    emit({"phase": "stream_mesh", "card": card, "cells": n, "genes": genes,
          "shards": base.n_shards, "shard_rows": base.shard_rows,
          "single_device_path_s": stream["path_s"], "runs": runs,
          "recall_at_10": recall, "recall_queries": N_COMPARE,
          "oracle_wait_s": oracle_wait_s,
          "stats_repeat": {"obs_bitwise": True, "moments_bitwise": True},
          "prefetch": prefetch})
    for key in ("src", "stats", "idx"):
        stream.pop(key)
    del src, msrc, shards, base, reps
    torch.cuda.empty_cache()
    return {"emb": kept["emb"], "launches": kept["launches"],
            "runs": runs}


# ----------------------------------------------------------------------
# 9. configs[4]'s kNN and the diffusion on a single-process mesh
# ----------------------------------------------------------------------

MESH_SHARDS = 4  # shards of the mesh that names cuda:0 that many times
MAGIC_T = 3


def mesh_shard_rows(n: int, p: int) -> int:
    """The rows of a shard of ``knn_multichip_arrays`` on n rows over p
    shards at its default block."""
    from sctools_tpu_torch.config import config, round_up

    block = min(config.row_block, max(8, round_up(-(-n // p), 8)))
    return round_up(n, p * block) // p


def mesh_launches(n: int, p: int, strategy: str) -> int:
    """The ``knn_select`` launches of ``knn_multichip_arrays`` on n rows
    over p shards: one for each pair of shards holding rows (ring), one
    for each shard holding rows (all_gather)."""
    m = mesh_shard_rows(n, p)
    busy = sum(1 for s in range(p) if n > s * m)
    return busy * busy if strategy == "ring" else busy


def mesh_phase(stream: dict, graph: dict, card: str) -> dict:
    """configs[4]'s path on the stream phase's 1.3M × 50 embedding
    (the stand-in for the 10M-cell census slice) and the main graph's
    diffusion, on single-process meshes: ``neighbors.knn_multichip``
    (k=15, ring and all_gather) over 4 shards that all name cuda:0 and
    over every visible card, each against single-device
    ``neighbors.knn`` (recall ≥ 0.999, sorted distances within rtol
    1e-3 and atol 5e-3; whether the ids are equal bit for bit is
    printed) and against the float64 oracle on 2,048 sampled cells
    (recall@10 ≥ 0.99), with knn_select launched once for each pair of
    busy shards (ring) or each busy shard (all_gather); then
    ``impute.magic(t=3, mesh=)`` over 4 shards on the graph phase's
    output, both strategies, within atol 1e-4 of unsharded MAGIC, with
    graph_matvec launched t × P² (ring) or t × P (all_gather) times."""
    import torch

    from sctools_tpu_torch import Transform
    from sctools_tpu_torch.data.dataset import CellData
    from sctools_tpu_torch.ops import graph_kernels as GK
    from sctools_tpu_torch.ops.knn import knn_numpy, recall_at_k
    from sctools_tpu_torch.ops.knn_kernel import knn_select
    from sctools_tpu_torch.parallel import make_mesh

    dev = torch.device(DEVICE)
    scores = stream["scores"]
    n = scores.shape[0]
    data = CellData(torch.zeros((n, 1), device=dev),
                    obsm={"X_pca": scores})

    def timed(transform, d):
        sync()
        t0 = time.perf_counter()
        out = transform(d, device=dev)
        sync()
        return out, time.perf_counter() - t0

    knn_select.launches = 0
    single, single_s = timed(Transform("neighbors.knn", k=15), data)
    check(knn_select.launches == 1, "single-device neighbors.knn launched "
                                    f"knn_select {knn_select.launches} times")
    one_i = single.obsp["knn_indices"][:n]
    one_d = single.obsp["knn_distances"][:n]
    one_d_sorted = np.sort(one_d.cpu().numpy(), axis=1)
    sample = np.sort(np.random.default_rng(1).choice(n, N_SAMPLED,
                                                     replace=False))
    # the float64 oracle on the worker while the card runs the meshes
    oracle_job = cpu_pool().submit(
        knn_numpy, scores[torch.from_numpy(sample).to(dev)].cpu().numpy(),
        scores.cpu().numpy(), k=15, metric="cosine", chunk=256)
    sampled = []  # (run, its ids of the sampled queries)
    meshes = {f"cuda:0 x {MESH_SHARDS}": make_mesh(
        devices=["cuda:0"] * MESH_SHARDS)}
    meshes[f"{torch.cuda.device_count()} card(s)"] = make_mesh()
    runs = []
    for label, mesh in meshes.items():
        for strategy in ("ring", "all_gather"):
            knn_select.launches = 0
            out, wall = timed(Transform("neighbors.knn_multichip", k=15,
                                        mesh=mesh, strategy=strategy), data)
            launches = knn_select.launches
            want = mesh_launches(n, mesh.size, strategy)
            what = f"knn_multichip {strategy} on {label}"
            check(launches == want,
                  f"{what}: {launches} knn_select launches, expected {want}")
            idx = out.obsp["knn_indices"][:n]
            dist = out.obsp["knn_distances"][:n]
            check(bool((out.obsp["knn_indices"][n:] == -1).all()),
                  f"{what}: padding rows hold ids")
            bitwise = bool(torch.equal(idx, one_i) and torch.equal(dist,
                                                                   one_d))
            host_i = idx.cpu().numpy()
            rec_one = recall_at_k(host_i, one_i.cpu().numpy())
            check(rec_one >= 0.999, f"{what}: recall {rec_one} < 0.999 "
                                    "against single-device neighbors.knn")
            d_ok = np.allclose(np.sort(dist.cpu().numpy(), axis=1),
                               one_d_sorted, rtol=1e-3, atol=5e-3)
            check(d_ok, f"{what}: distances beyond rtol 1e-3, atol 5e-3")
            sampled.append((what, host_i[sample]))
            runs.append({"mesh": label, "shards": mesh.size,
                         "strategy": strategy, "s": wall,
                         "knn_select_launches": launches,
                         "recall_vs_single": rec_one,
                         "bitwise_equal_to_single": bitwise})
            del out, idx, dist

    # MAGIC over 4 shards of cuda:0 on the graph phase's output
    gdata = graph["out"]
    g = gdata.n_cells
    mesh = meshes[f"cuda:0 x {MESH_SHARDS}"]
    GK.matvec.launches = 0
    ref, ref_s = timed(Transform("impute.magic", t=MAGIC_T), gdata)
    check(GK.matvec.launches == MAGIC_T,
          f"impute.magic launched matvec {GK.matvec.launches} times")
    want = ref.obsm["X_magic"][:g]
    magic = []
    for strategy in ("ring", "all_gather"):
        GK.matvec.launches = 0
        out, wall = timed(Transform("impute.magic", t=MAGIC_T, mesh=mesh,
                                    strategy=strategy), gdata)
        launches = GK.matvec.launches
        expect = MAGIC_T * (mesh.size ** 2 if strategy == "ring"
                            else mesh.size)
        check(launches == expect, f"impute.magic(mesh=) {strategy}: matvec "
                                  f"{launches} launches, expected {expect}")
        err = float((out.obsm["X_magic"][:g] - want).abs().max())
        check(err <= 1e-4, f"impute.magic(mesh=) {strategy}: max |error| "
                           f"{err} > 1e-4")
        magic.append({"strategy": strategy, "shards": mesh.size, "s": wall,
                      "matvec_launches": launches, "max_abs_err": err})
        del out
    t0 = time.perf_counter()
    oracle, _ = oracle_job.result()
    oracle_wait_s = time.perf_counter() - t0
    for run, (what, ids) in zip(runs, sampled):
        run["recall_at_10"] = recall_at_k(ids, oracle, k=10)
        check(run["recall_at_10"] >= 0.99,
              f"{what}: recall@10 {run['recall_at_10']} < 0.99")
    emit({"phase": "mesh", "card": card, "cells": n, "k": 15,
          "single_knn_s": single_s, "oracle_wait_s": oracle_wait_s,
          "recall_queries": N_SAMPLED, "knn_multichip": runs,
          "magic": {"cells": g, "t": MAGIC_T, "unsharded_s": ref_s,
                    "runs": magic}})
    return {"runs": runs, "magic": magic, "mesh": mesh, "gdata": gdata,
            "shard_rows": mesh_shard_rows(n, MESH_SHARDS)}


# ----------------------------------------------------------------------
# 4. graph tail and t-SNE on the main path's output
# ----------------------------------------------------------------------

GRAPH_LAUNCHES = {"matvec": 3, "jaccard": 1, "tsne_repulsion": TSNE_ITERS}


def remap_rows(idx, perm):
    """The edge list of the graph whose row i is old row ``perm[i]``:
    rows permuted, ids renamed (-1 kept)."""
    import torch

    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(len(perm), device=perm.device)
    safe = torch.where(idx < 0, 0, idx).long()
    return torch.where(idx < 0, idx, inv[safe].to(idx.dtype))[perm]


def purity(labels, nbr) -> float:
    """Share of the valid, non-self neighbours that carry the row's
    label."""
    import torch

    rows = torch.arange(len(nbr), device=nbr.device)[:, None]
    ok = (nbr >= 0) & (nbr != rows)
    same = labels[nbr.clamp(min=0).long()] == labels[:, None]
    return float((same & ok).sum() / ok.sum())


def within(a, b, rtol: float, atol: float, scale=None) -> float:
    """Largest |a - b| after checking |a - b| <= atol + rtol·scale
    everywhere; ``scale`` defaults to |b| (the numpy/torch allclose
    rule).  A sum whose terms cancel is held against the sum of their
    magnitudes instead."""
    diff = (a - b).abs()
    scale = b.abs() if scale is None else scale
    bad = int((diff > atol + rtol * scale).sum())
    err = float(diff.max()) if diff.numel() else 0.0
    check(bad == 0, f"{bad} values beyond atol {atol} + rtol {rtol}·|b| "
                    f"(max |a - b| {err})")
    return err


def graph_phase(data, card: str) -> dict:
    import torch

    from sctools_tpu_torch import Pipeline, Transform, recipe_pipeline
    from sctools_tpu_torch.ops import graph_kernels as GK
    from sctools_tpu_torch.ops.knn import knn_arrays

    dev = torch.device(DEVICE)
    pipe = Pipeline(list(recipe_pipeline("graph_tail", t=3, jaccard=True))
                    + [Transform("embed.tsne", n_iter=TSNE_ITERS)])
    n = data.n_cells
    idx0 = data.obsp["knn_indices"][:n].clone()
    planes0 = (data.X.indices.clone(), data.X.data.clone())
    wrappers = {name: getattr(GK, name) for name in GRAPH_LAUNCHES}

    for w in wrappers.values():
        w.launches = 0
    sync()
    t0 = time.perf_counter()
    out = pipe.run(data, device=dev)
    sync()
    run_s = time.perf_counter() - t0
    launches = {name: w.launches for name, w in wrappers.items()}
    check(launches == GRAPH_LAUNCHES,
          f"graph path launches {launches}, expected {GRAPH_LAUNCHES}")

    # the restored layout is the caller's, bit for bit
    check(torch.equal(out.obsp["knn_indices"][:n], idx0),
          "knn_indices after restore_order differ from before the reorder")
    check(torch.equal(out.X.indices, planes0[0])
          and torch.equal(out.X.data, planes0[1]),
          "X after restore_order differs from before the reorder")
    jac = out.obsp["jaccard"][:n]
    check(torch.equal(jac, GK.jaccard_plain(idx0)),
          "jaccard differs from jaccard_plain on the card")
    P = out.obsp["diffusion_weights"][:n]
    x = out.X.to_dense().contiguous()
    want = x
    for _ in range(3):
        want = GK.matvec_plain(idx0, P, want)
    magic_err = within(out.obsm["X_magic"][:n], want, 1e-5, 1e-6)
    del want
    # slot-order sums: permuting the rows permutes the result exactly
    y_nat = GK.matvec(idx0, P, x)
    perm = torch.from_numpy(np.random.default_rng(0).permutation(n)).to(dev)
    y_perm = GK.matvec(remap_rows(idx0, perm), P[perm], x[perm])
    check(torch.equal(y_perm, y_nat[perm]),
          "matvec on permuted inputs is not the permuted output")
    del y_nat, y_perm
    emb = out.obsm["X_tsne"][:n]
    check(tuple(emb.shape) == (n, 2) and bool(torch.isfinite(emb).all()),
          "X_tsne is not a finite (n, 2) layout")
    labels = out.obs["cluster_true"][:n]
    tsne_idx, _ = knn_arrays(emb, emb, k=15, metric="euclidean",
                             exclude_self=True)
    pur_graph = purity(labels, idx0)
    pur_tsne = purity(labels, tsne_idx[:n])
    check(pur_tsne >= 0.95 * pur_graph,
          f"t-SNE 15-NN label purity {pur_tsne} < 0.95 × the graph's "
          f"{pur_graph}")

    # stage by stage, for each stage's wall time and peak memory
    again, stages = staged(pipe, data, dev)
    # the graph tail has no atomics: the second run repeats the first
    # exactly (t-SNE's attraction adds with index_add_ atomics)
    for where, key in (("obsp", "jaccard"), ("obsm", "X_magic")):
        check(torch.equal(getattr(again, where)[key],
                          getattr(out, where)[key]),
              f"{key} differs between two runs of the graph path")
    del again
    # graph_jaccard's device time at the path's layout, early in the
    # process: late in a long run the profiler's trace loses records
    from sctools_tpu_torch.ops import graph as G

    r_idx = remap_rows(idx0, torch.from_numpy(
        G.reorder_permutation(idx0)).to(dev))
    recorded = {}
    jac_us = device_us({"fn": lambda: GK.jaccard(r_idx)},
                       counts=recorded)["fn"]
    emit({"phase": "graph", "card": card, "cells": n,
          "genes": data.n_genes, "k": int(idx0.shape[1]), "run_s": run_s,
          "stages": stages, "launches": launches,
          "x_magic_max_abs_err": magic_err,
          "tsne_purity": pur_tsne, "graph_purity": pur_graph,
          "jaccard_device_us": jac_us,
          "jaccard_launches_recorded": recorded["fn"],
          "tsne_profile": tsne_profile(data)})
    return {"out": out, "idx": idx0, "P": P, "x": x, "y": emb.contiguous(),
            "launches": launches,
            "jaccard_device": (jac_us, recorded["fn"])}


REPULSION_KERNELS = ("tsne_split_kernel", "tsne_combine_kernel")


def tsne_profile(data, iters: int = 40) -> dict:
    """``iters`` iterations of the t-SNE loop on the path's kNN graph,
    once as they run and once under ``torch.profiler``: device ms a
    iteration of the repulsion kernels and of every other kernel (the
    attraction, the update) from the profiled run, host ms a iteration
    of each run, and the device's idle share of the unprofiled wall; and
    the host seconds of the affinities ``embed.tsne`` computes before
    its loop (``_prep_p``, from the graph on the card)."""
    import warnings

    import torch
    from torch.profiler import ProfilerActivity, profile

    from sctools_tpu_torch.ops import tsne as T

    n = data.n_cells
    t0 = time.perf_counter()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        P, _ = T._prep_p(data.obsp["knn_indices"][:n].cpu().numpy(),
                         data.obsp["knn_distances"][:n].cpu().numpy(), 30.0)
    prep_s = time.perf_counter() - t0
    init = (np.random.default_rng(0).standard_normal((n, 2)) * 1e-4).astype(
        np.float32)
    args = [data.obsp["knn_indices"][:n].to(DEVICE),
            torch.from_numpy(P).to(DEVICE), torch.from_numpy(init).to(DEVICE)]
    T.tsne_layout_arrays(*args, n_iter=2, exaggeration_iter=1)
    sync()
    # the wall unprofiled: the profiler's own work per launch lengthens it
    t0 = time.perf_counter()
    T.tsne_layout_arrays(*args, n_iter=iters, exaggeration_iter=iters // 4)
    sync()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        T.tsne_layout_arrays(*args, n_iter=iters,
                             exaggeration_iter=iters // 4)
        sync()
        wall_profiled = time.perf_counter() - t0
    rep = other = 0.0
    kernels, recorded = {}, {}
    for ev in prof.key_averages():
        t = getattr(ev, "device_time_total",
                    getattr(ev, "cuda_time_total", 0.0)) / 1e3 / iters
        if t <= 0:
            continue
        kernels[ev.key[:60]] = t
        recorded[ev.key[:60]] = ev.count
        if any(k in ev.key for k in REPULSION_KERNELS):
            rep += t
        else:
            other += t
    wall_ms = wall * 1e3 / iters
    return {"iterations": iters, "prep_p_host_s": prep_s,
            "host_ms_per_iter": wall_ms,
            "host_ms_per_iter_profiled": wall_profiled * 1e3 / iters,
            "repulsion_device_ms_per_iter": rep,
            "other_device_ms_per_iter": other,
            "device_idle_share": 1.0 - (rep + other) / wall_ms,
            "device_ms_per_iter_by_kernel": kernels,
            # each repulsion kernel runs once an iteration: fewer
            # recorded launches than iterations mean a lossy trace
            "launches_recorded": recorded}


# Column slices (a, b) of the input, b = None for the last column: they
# start and end off the vector widths (odd, even, multiples of 4) and
# cross the kernels' column tiles and slabs (multiples of 64 columns).
COL_SLICES = ((0, 1), (1, 3), (3, 13), (2, 22), (7, 40), (60, 70),
              (31, 160), (120, 250), (250, 520), (1000, 1999), (1, None))
# the widths of graph_edges_phase: each lane-group size and vector width
EDGE_WIDTHS = (1, 2, 3, 5, 10, 21, 33, 127, 128, 914)


def check_slices(fn, x, full, what: str) -> int:
    """``fn(x[:, a:b].contiguous())`` bitwise ``full[:, a:b]`` (``full =
    fn(x)``) for every slice of COL_SLICES inside x's width: each output
    element is one fmaf chain in a fixed order whatever vector width,
    lane group or slab computes it.  Returns the number of slices."""
    import torch

    d = x.shape[1]
    seen = set()
    for a, b in COL_SLICES:
        b = d if b is None else min(b, d)
        if a >= b or (a, b) in seen:
            continue
        seen.add((a, b))
        check(torch.equal(fn(x[:, a:b].contiguous()), full[:, a:b]),
              f"{what}: columns {a}:{b} of a {d}-wide x differ from those "
              "columns of the full result")
    return len(seen)


def graph_edges_phase() -> None:
    """The graph kernels against their plain versions at small shapes
    that reach their corners: -1 ids and rows without edges, repeated
    ids, k = 1 and 64, d = 1 and odd widths (the scalar path), t-SNE
    dims 1–4 and partial tiles."""
    import torch

    from sctools_tpu_torch.ops import graph_kernels as GK

    rng = np.random.default_rng(2)
    cases = []
    for n, k, d in ((1000, 15, 2000), (777, 1, 3), (500, 64, 1),
                    (300, 7, 33), (5, 3, 8)):
        idx = rng.integers(0, n, (n, k)).astype(np.int32)
        idx[rng.random((n, k)) < 0.1] = -1
        idx[::13] = -1
        idx[::7, 0] = idx[::7, -1]
        w = rng.random((n, k)).astype(np.float32)
        x = rng.standard_normal((n, d)).astype(np.float32)
        ti, tw, tx = (torch.from_numpy(a).to(DEVICE) for a in (idx, w, x))
        # signed terms cancel: hold each output against Σ_t |w|·|x|
        mv_err = within(GK.matvec(ti, tw, tx), GK.matvec_plain(ti, tw, tx),
                        1e-5, 1e-6,
                        scale=GK.matvec_plain(ti, tw.abs(), tx.abs()))
        check(torch.equal(GK.jaccard(ti), GK.jaccard_plain(ti)),
              f"jaccard n={n} k={k} differs from its plain version")
        cases.append({"kernel": "graph_matvec+graph_jaccard", "n": n,
                      "k": k, "d": d, "matvec_max_abs_err": mv_err})
    # Jaccard at the kernel's layout changes: a half-warp a row at k <= 16
    # (odd n: the last warp holds one row), a warp a row above, up to
    # K_MAX
    for n, k in ((1001, 16), (999, 17), (301, 256), (7, 16), (513, 32)):
        idx = rng.integers(0, n, (n, k)).astype(np.int32)
        idx[rng.random((n, k)) < 0.1] = -1
        idx[::13] = -1
        idx[::7, 0] = idx[::7, -1]
        ti = torch.from_numpy(idx).to(DEVICE)
        check(torch.equal(GK.jaccard(ti), GK.jaccard_plain(ti)),
              f"jaccard n={n} k={k} differs from its plain version")
        cases.append({"kernel": "graph_jaccard", "n": n, "k": k,
                      "bitwise": True})
    # rmatvec: -1 ids, destinations without edges (ids confined to the
    # first rows), a hub with >= 5,000 incoming edges, d = 1, 3, 33 and
    # 914, and rectangular n (more and fewer outputs than rows; ids >= n
    # add nothing)
    for rows, k, d, n_out in ((3000, 15, 914, 3000), (6000, 15, 1, 6000),
                              (777, 4, 3, 1000), (2000, 9, 33, 1500),
                              (1000, 6, 5, 300), (5, 3, 8, 5)):
        idx = rng.integers(0, max(1, rows // 2), (rows, k)).astype(np.int32)
        idx[rng.random((rows, k)) < 0.1] = -1
        idx[::13] = -1
        idx[:5000:, 0] = n_out - 1  # the hub: the last destination
        w = rng.random((rows, k)).astype(np.float32)
        x = rng.standard_normal((rows, d)).astype(np.float32)
        ti, tw, tx = (torch.from_numpy(a).to(DEVICE) for a in (idx, w, x))
        order = GK.rmatvec_order(ti, n_out)
        got = GK.rmatvec(ti, tw, tx, n_out, order=order)
        err = within(got, GK.rmatvec_plain(ti, tw, tx, n_out), 1e-5, 1e-6,
                     scale=GK.rmatvec_plain(ti, tw.abs(), tx.abs(), n_out))
        check(torch.equal(got, GK.rmatvec(ti, tw, tx, n_out)),
              "rmatvec with a built order differs from a given one")
        hub = int((idx == n_out - 1).sum())
        cases.append({"kernel": "graph_rmatvec", "rows": rows, "k": k,
                      "d": d, "n": n_out, "hub_in_degree": hub,
                      "max_abs_err": err})
    # both kernels at every width path, with the column-slice identity,
    # and on an x whose storage starts 4 bytes off (no vector loads)
    n, k = 3000, 15
    idx = rng.integers(0, n, (n, k)).astype(np.int32)
    idx[rng.random((n, k)) < 0.1] = -1
    idx[::2, 0] = 7  # a hub of 1,500 incoming edges
    w = rng.random((n, k)).astype(np.float32)
    ti, tw = (torch.from_numpy(a).to(DEVICE) for a in (idx, w))
    order = GK.rmatvec_order(ti, n)
    for d in EDGE_WIDTHS:
        x = torch.from_numpy(
            rng.standard_normal((n, d)).astype(np.float32)).to(DEVICE)
        mv = GK.matvec(ti, tw, x)
        mv_err = within(mv, GK.matvec_plain(ti, tw, x), 1e-5, 1e-6,
                        scale=GK.matvec_plain(ti, tw.abs(), x.abs()))
        rv = GK.rmatvec(ti, tw, x, n, order=order)
        rv_err = within(rv, GK.rmatvec_plain(ti, tw, x, n), 1e-5, 1e-6,
                        scale=GK.rmatvec_plain(ti, tw.abs(), x.abs(), n))
        slices = check_slices(lambda xx: GK.matvec(ti, tw, xx), x, mv,
                              "matvec")
        slices += check_slices(
            lambda xx: GK.rmatvec(ti, tw, xx, n, order=order), x, rv,
            "rmatvec")
        off = torch.empty(n * d + 1, device=DEVICE)[1:].view(n, d)
        off.copy_(x)
        check(torch.equal(GK.matvec(ti, tw, off), mv)
              and torch.equal(GK.rmatvec(ti, tw, off, n, order=order), rv),
              f"d={d}: an x 4 bytes off alignment gives other bits")
        cases.append({"kernel": "graph_matvec+graph_rmatvec", "n": n,
                      "k": k, "d": d, "matvec_max_abs_err": mv_err,
                      "rmatvec_max_abs_err": rv_err,
                      "column_slices_bitwise": slices})
    tsne_cases = [(300, 2), (257, 1), (1000, 3), (513, 4), (1, 2)]
    tsne_cases += [(n, dim) for n in tsne_edge_sizes() for dim in (1, 2, 3, 4)]
    for n, dim in tsne_cases:
        y = torch.from_numpy(
            (rng.standard_normal((n, dim)) * 3).astype(np.float32)).to(DEVICE)
        f, z = GK.tsne_repulsion(y, n)
        pf, pz = GK.tsne_repulsion_plain(y, n)
        terms = tsne_term_scale(y)
        err = within(f, pf, 1e-5, 1e-6 * terms)
        within(z.reshape(1), pz.reshape(1), 1e-5, 0.0)
        cases.append({"kernel": "tsne_repulsion", "n": n, "dim": dim,
                      "max_abs_err": err, "term_scale": terms})
    sync()
    emit({"phase": "graph_edges", "cases": cases})


def tsne_edge_sizes() -> list:
    """Row counts at the edges of the repulsion kernel's grid (its sizes
    read from the library): 2 rows; one below and one past a query
    tile and a candidate tile; one past a split boundary, where the
    last split holds a single candidate (spans of one and of two
    tiles); and counts that are no multiple of the query rows a
    thread."""
    from sctools_tpu_torch.ops import graph_kernels as GK

    lay = GK.tsne_repulsion_layout()
    qt, tile, splits, qpt = (lay[k] for k in ("query_tile", "cand_tile",
                                              "splits", "qpt"))
    sizes = sorted({2, qt - 1, qt + 1, tile + 1, (splits - 1) * tile + 1,
                    (splits - 1) * 2 * tile + 1, 3 * qt + qpt - 1})
    check(any(n % qpt for n in sizes),
          f"t-SNE edge sizes {sizes} miss a count off the thread's rows")
    return sizes


def tsne_term_scale(y, block: int = 2048) -> float:
    """max_i |y_i|·Σ_j w_ij²: the size of the two sums whose difference
    is the repulsive force, against which its float32 error is held."""
    import torch

    from sctools_tpu_torch.config import true_f32

    yn2 = (y * y).sum(dim=1)
    best = 0.0
    for r0 in range(0, y.shape[0], block):
        yb = y[r0:r0 + block]
        with true_f32():
            s = yb @ y.T
        d2 = torch.clamp(yn2[r0:r0 + block, None] - 2.0 * s + yn2[None, :],
                         min=0.0)
        w = 1.0 / (1.0 + d2)
        s2 = (w * w).sum(dim=1) - 1.0  # the self pair has w = 1
        best = max(best, float((yb.abs() * s2[:, None]).max()))
    return best


# ----------------------------------------------------------------------
# kernel against plain version
# ----------------------------------------------------------------------


def compare(kernel_out, plain_out, tol: float, survivors=None) -> dict:
    """Kernel rows against the plain version's: values within ``tol``
    (equal where infinite); ids equal except where the two values lie
    within ``tol`` of each other (a swap of near-ties, or the k-th
    slot).  For the binned merge, ``survivors`` is the plain version's
    ``(values (nq, n_bins), n_bins)`` of every bin: a differing id is
    also allowed where the plain survivor of the kernel id's bin lies
    within ``tol`` of the kernel's value (a near-tie inside one bin)."""
    kv, ki = (t.cpu().numpy() for t in kernel_out)
    pv, pi = (t.cpu().numpy() for t in plain_out)
    check(kv.shape == pv.shape, f"shapes {kv.shape} vs {pv.shape}")
    fin = np.isfinite(pv)
    check((np.isfinite(kv) == fin).all() and (kv[~fin] == pv[~fin]).all(),
          "kernel and plain version disagree on empty slots")
    err = float(np.abs(kv[fin] - pv[fin]).max()) if fin.any() else 0.0
    check(err <= tol, f"max |value error| {err} > {tol}")
    bad = 0
    for i, j in zip(*np.nonzero(ki != pi)):
        at = np.nonzero(pi[i] == ki[i, j])[0]
        swapped = len(at) and abs(pv[i, at[0]] - kv[i, j]) <= tol
        boundary = abs(kv[i, j] - pv[i, -1]) <= tol
        in_bin = survivors is not None and ki[i, j] >= 0 and abs(
            survivors[0][i, ki[i, j] % survivors[1]] - kv[i, j]) <= tol
        bad += not (swapped or boundary or in_bin)
    check(bad == 0, f"{bad} ids differ beyond near-ties")
    return {"max_abs_err": err, "idx_agree": float((ki == pi).mean())}


def binned_plain(q, c, k: int, n_bins: int, metric: str = "cosine",
                 exclude_self: bool = False, block=None):
    """The binned merge's plain version and its per-bin survivors (for
    the bin-aware near-tie rule of ``compare``)."""
    from sctools_tpu_torch.ops.knn_kernel import (bin_survivors,
                                                  binned_bins,
                                                  knn_binned_plain)

    kw = dict(metric=metric, exclude_self=exclude_self, query_block=block,
              cand_block=block)
    want = knn_binned_plain(q, c, k=k, n_bins=n_bins, **kw)
    nb = binned_bins(k, n_bins)
    sv, _ = bin_survivors(q, c, n_bins=nb, **kw)
    return want, (sv.cpu().numpy(), nb)


def split_edge_cases(qb: int, cb: int, splits: int) -> list:
    """``edges_phase`` cases at row counts one off the exact kernel's
    query tile (``qb``), candidate tile (``cb``) and split boundaries
    (``splits`` ranges of whole tiles; with two tiles some ranges are
    empty), at k = 15, 16, 17, 32, 33 and 256, d = 1, 3, 50 and 256,
    both metrics and both dtypes.  Their tie cases take "exact" points
    (``tie_points``): the plain version's one-column candidate block
    (nc = 1025 against its 1024-column blocks) is a matrix-vector
    product whose last bits differ from the blocks' on inexact scores,
    which would part exact ties there."""
    import torch

    f32, bf16 = torch.float32, torch.bfloat16
    return [
        # (nq, nc, d, k, metric, dtype, exclude_self, integer points)
        (qb - 1, cb + 1, 50, 15, "cosine", f32, False, False),
        (qb + 1, splits * cb - 1, 3, 16, "euclidean", f32, True, False),
        (2 * qb + 1, splits * cb + 1, 1, 17, "cosine", bf16, False, False),
        (qb + 1, 3 * splits * cb - 1, 256, 32, "euclidean", bf16, True,
         False),
        (2 * qb - 1, 2 * splits * cb + 1, 50, 33, "cosine", f32, True,
         "exact"),
        (qb - 1, 2 * splits * cb - 1, 50, 256, "euclidean", f32, False,
         False),
        (qb + 1, (splits + 1) * cb + 1, 3, 15, "euclidean", bf16, False,
         False),
        (2 * qb + 1, splits * cb + 1, 256, 16, "cosine", f32, True,
         "exact"),
    ]


def tie_points(rng, n: int, d: int, exact: bool = False):
    """``n`` rows drawn from 40 base points, so that equal scores tie
    exactly: integers in [-3, 3], or with ``exact`` ±1 in four places
    (norm 2, so every cosine and euclidean score is exact in float32,
    whatever the order of the sums)."""
    if exact:
        base = np.zeros((40, d), np.float32)
        for row in base:
            row[rng.choice(d, 4, replace=False)] = rng.choice([-1, 1], 4)
    else:
        base = rng.integers(-3, 4, size=(40, d)).astype(np.float32)
    return base[rng.integers(0, 40, size=n)]


def edges_phase() -> None:
    import torch

    from sctools_tpu_torch.ops.knn import _prep
    from sctools_tpu_torch.ops.knn_kernel import (knn_select,
                                                  knn_select_layout,
                                                  knn_select_plain)

    rng = np.random.default_rng(1)
    layout = knn_select_layout()
    cases = [
        # (nq, nc, d, k, metric, dtype, exclude_self, integer points)
        (1000, 3000, 50, 1, "cosine", torch.float32, False, False),
        (777, 5000, 50, 200, "cosine", torch.float32, False, False),
        (1000, 1000, 33, 16, "euclidean", torch.float32, True, False),
        (1000, 2000, 50, 17, "euclidean", torch.bfloat16, False, False),
        (1000, 2000, 50, 32, "cosine", torch.bfloat16, True, False),
        (130, 7, 50, 15, "cosine", torch.float32, False, False),
        (300, 2000, 256, 64, "cosine", torch.float32, False, False),
        (300, 2000, 1, 8, "euclidean", torch.float32, False, False),
        (70, 65, 9, 5, "cosine", torch.float32, True, False),
        (2000, 2000, 8, 12, "euclidean", torch.float32, True, True),
        (2000, 2000, 8, 12, "cosine", torch.float32, False, True),
    ] + split_edge_cases(layout["query_tile"], layout["cand_tile"],
                         layout["splits"])
    results = []
    for nq, nc, d, k, metric, dtype, excl, integer in cases:
        if integer:
            pts = tie_points(rng, max(nq, nc), d, integer == "exact")
        else:
            pts = rng.normal(size=(max(nq, nc), d)).astype(np.float32)
        x = torch.from_numpy(pts).cuda()
        c = _prep(x[:nc], metric, dtype)
        q = _prep(x[:nq], metric, dtype) if nq != nc else c
        got = knn_select(q, c, k=k, metric=metric, exclude_self=excl)
        want = knn_select_plain(q, c, k=k, metric=metric,
                                exclude_self=excl)
        sync()
        tol = 1e-3 if dtype == torch.bfloat16 else 1e-5
        if metric == "euclidean":
            tol *= max(1.0, 2 * d)  # scores scale with |q|^2 + |c|^2
        stats = compare(got, want, tol)
        if integer:
            check(stats["idx_agree"] == 1.0,
                  "exact ties must give identical ids")
        results.append({"nq": nq, "nc": nc, "d": d, "k": k,
                        "metric": metric, "dtype": str(dtype)[6:],
                        "exclude_self": excl, **stats})
    emit({"phase": "edges", "layout": layout, "cases": results})


def binned_split_cases(qb: int, cb: int, splits: int) -> list:
    """``binned_edges_phase`` cases at the corners of the binned kernel's
    sweep (``qb`` queries a block, ``cb``-column tiles = bin chunks, at
    most ``splits`` splits over chunk ranges): one chunk in one split
    (n_bins = cb) with nc one below the tile and one column into a sixth
    round; one chunk fewer, as many and one more than splits, with nc
    one off a round's end (the chunks before it take one round more than
    those after); that boundary one chunk past a split boundary; fewer
    candidates than bins over several chunks; several chunks a split,
    with and without more candidates than bins; query counts one off the
    query tile.  The tie cases take "exact" points (``tie_points``)."""
    import torch

    f32, bf16 = torch.float32, torch.bfloat16
    few = max(1, splits - 1) * cb
    return [
        # (nq, nc, d, k, n_bins, metric, dtype, exclude_self, integer)
        (qb - 1, cb - 1, 50, 15, cb, "cosine", f32, False, False),
        (qb + 1, 5 * cb + 1, 50, 16, cb, "euclidean", f32, True, "exact"),
        (2 * qb + 1, 2 * few + 1, 3, 17, few, "cosine", bf16, False,
         False),
        (qb - 1, 2 * splits * cb - 1, 50, 15, splits * cb, "euclidean",
         f32, False, "exact"),
        (qb + 1, 2 * (splits + 1) * cb + cb - 1, 50, 33,
         (splits + 1) * cb, "cosine", f32, True, False),
        (2 * qb - 1, 2 * (splits + 1) * cb + cb + 1, 256, 15,
         (splits + 1) * cb, "cosine", f32, False, "exact"),
        (qb + 1, 2 * splits * cb + (splits + 1) * cb + 1, 8, 32,
         2 * splits * cb, "euclidean", bf16, True, False),
        (2 * qb + 1, splits * cb + 1, 50, 15, 4 * splits * cb, "cosine",
         f32, True, "exact"),
        # several chunks a split: the row buffers and thresholds carry
        # over chunk ends, the lists stored between them
        (qb + 1, 7 * splits * cb + 5, 16, 40, 6 * splits * cb, "cosine",
         f32, True, False),
        (2 * qb - 1, 5 * splits * cb - 3, 8, 15, 4 * splits * cb,
         "euclidean", f32, False, "exact"),
        (qb - 1, 3 * splits * cb + 1, 50, 16, 4 * splits * cb, "cosine",
         bf16, False, "exact"),
    ]


def binned_edges_phase() -> None:
    """The binned kNN kernel against its plain version at the corners of
    its merge: fewer candidates than bins (then bitwise the exact
    kernel), candidate counts that are no multiple of n_bins, k = 1 and
    256, n_bins 128 and 1024 (and one rounded up from 300), bf16,
    euclidean, self exclusion, and integer points with exact ties inside
    and across bins (then ids identical); then ``binned_split_cases``."""
    import torch

    from sctools_tpu_torch.ops.knn import _prep
    from sctools_tpu_torch.ops.knn_kernel import (knn_binned,
                                                  knn_binned_layout,
                                                  knn_select)

    rng = np.random.default_rng(3)
    layout = knn_binned_layout()
    cases = [
        # (nq, nc, d, k, n_bins, metric, dtype, exclude_self, integer)
        (1000, 1000, 50, 15, 1024, "cosine", torch.float32, False, False),
        (1000, 1000, 33, 16, 1024, "euclidean", torch.float32, True, False),
        (1000, 5000, 50, 15, 1024, "cosine", torch.float32, False, False),
        (777, 3001, 50, 1, 128, "cosine", torch.float32, False, False),
        (300, 6000, 50, 256, 1024, "cosine", torch.float32, False, False),
        (1000, 4000, 50, 32, 300, "euclidean", torch.bfloat16, False,
         False),
        (1000, 2000, 50, 15, 128, "cosine", torch.bfloat16, True, False),
        (2000, 2000, 8, 12, 128, "euclidean", torch.float32, True, True),
        (2000, 2000, 8, 12, 256, "cosine", torch.float32, False, True),
    ] + binned_split_cases(layout["query_tile"], layout["cand_tile"],
                           layout["splits"])
    results = []
    for nq, nc, d, k, n_bins, metric, dtype, excl, integer in cases:
        if integer:
            pts = tie_points(rng, max(nq, nc), d, integer == "exact")
        else:
            pts = rng.normal(size=(max(nq, nc), d)).astype(np.float32)
        x = torch.from_numpy(pts).cuda()
        c = _prep(x[:nc], metric, dtype)
        q = _prep(x[:nq], metric, dtype) if nq != nc else c
        got = knn_binned(q, c, k=k, n_bins=n_bins, metric=metric,
                         exclude_self=excl)
        want, surv = binned_plain(q, c, k, n_bins, metric, excl)
        sync()
        tol = 1e-3 if dtype == torch.bfloat16 else 1e-5
        if metric == "euclidean":
            tol *= max(1.0, 2 * d)  # scores scale with |q|^2 + |c|^2
        stats = compare(got, want, tol, survivors=surv)
        if integer:
            check(stats["idx_agree"] == 1.0,
                  "exact ties must give identical ids")
        if nc <= surv[1]:
            exact = knn_select(q, c, k=k, metric=metric, exclude_self=excl)
            check(all(torch.equal(a, b) for a, b in zip(got, exact)),
                  f"n_cand {nc} <= n_bins {surv[1]}: binned differs from "
                  "the exact kernel")
        results.append({"nq": nq, "nc": nc, "d": d, "k": k,
                        "n_bins": surv[1], "metric": metric,
                        "dtype": str(dtype)[6:], "exclude_self": excl,
                        **stats})
    emit({"phase": "binned_edges", "layout": layout, "cases": results})


def library_topk(q, c, k: int):
    """The yardstick: blocked ``torch.matmul`` + ``torch.topk``, in
    blocks of queries whose score rows stay under 1 GiB."""
    import torch

    block = 1 << max(0, (2 ** 28 // c.shape[0]).bit_length() - 1)
    vals, ids = [], []
    for q0 in range(0, q.shape[0], block):
        v, i = torch.topk(q[q0:q0 + block] @ c.T, k, dim=1)
        vals.append(v)
        ids.append(i)
    return torch.cat(vals), torch.cat(ids)


def kernel_case(name_shape: str, q, c, k: int, metric: str, oracle,
                launches: int, card: str, peaks: dict,
                ids_for_recall=None, n_bins: int | None = None,
                plain_reps: int = 3, library_reps: int = 5,
                all_bins: bool = True, library=None,
                tol: float | None = None) -> dict:
    """Kernel against plain version on the first N_COMPARE queries,
    recall@10 of those queries against the float64 ``oracle`` ids, and
    the times: the exact kernel, or the binned one with ``n_bins`` (its
    ids held with the bin-aware near-tie rule, recall gated at 0.98).
    The comparison calls are the timings' warm-up; the plain version is
    timed over 3 calls (seconds each at the wide shape).  ``all_bins``
    adds ``binned_all_bins`` to an exact row.  ``library`` is the
    yardstick (default ``library_topk``, the inner-product one), ``tol``
    the value tolerance (default 1e-5, 1e-3 for bf16)."""
    import torch

    from sctools_tpu_torch.config import true_f32
    from sctools_tpu_torch.ops.knn import recall_at_k
    from sctools_tpu_torch.ops import knn_kernel as KK

    if n_bins is None:
        name, line, gate = "knn_select", 84, 0.99
        kernel = lambda: KK.knn_select(q, c, k=k, metric=metric)  # noqa
        plain = lambda qq: KK.knn_select_plain(  # noqa: E731
            qq, c, k=k, metric=metric, query_block=PLAIN_BLOCK,
            cand_block=PLAIN_BLOCK)
    else:
        name, line, gate = "knn_binned", 113, 0.98
        kernel = lambda: KK.knn_binned(  # noqa: E731
            q, c, k=k, n_bins=n_bins, metric=metric)
        plain = lambda qq: KK.knn_binned_plain(  # noqa: E731
            qq, c, k=k, n_bins=n_bins, metric=metric,
            query_block=PLAIN_BLOCK, cand_block=PLAIN_BLOCK)
    dtype = "bfloat16" if q.dtype == torch.bfloat16 else "float32"
    if tol is None:
        tol = 1e-3 if dtype == "bfloat16" else 1e-5
    kv, ki = kernel()
    if n_bins is None:
        (pv, pi), surv = plain(q[:N_COMPARE]), None
    else:
        (pv, pi), surv = binned_plain(q[:N_COMPARE], c, k, n_bins, metric,
                                      block=PLAIN_BLOCK)
    sync()
    stats = compare((kv[:N_COMPARE], ki[:N_COMPARE]), (pv, pi), tol,
                    survivors=surv)
    pred = (ki[:N_COMPARE] if ids_for_recall is None
            else ids_for_recall[:N_COMPARE]).cpu().numpy()
    recall = recall_at_k(pred, oracle, k=10)
    check(recall >= gate, f"{name} {name_shape}: recall@10 {recall} < "
                          f"{gate}")
    del kv, ki, pv, pi, surv

    ms = cuda_ms(kernel, warmup=False)
    plain_ms = cuda_ms(lambda: plain(q), reps=plain_reps, warmup=False)
    with true_f32():
        library_ms = cuda_ms(lambda: (library or library_topk)(q, c, k),
                             reps=library_reps)
    nq, d = q.shape
    nc = c.shape[0]
    t_ops = 2.0 * nq * nc * d / peaks[dtype] * 1e3
    t_bytes = ((nq + nc) * d * q.element_size() + nq * k * 8) \
        / peaks["bytes"] * 1e3
    row = {"name": name, "route": "cuda",
           "source": f"sctools_tpu_torch/csrc/{name}.cu",
           "replaces": f"sctools_tpu/ops/pallas_knn.py:{line}",
           "shape": name_shape, "launches": launches,
           "max_abs_err": stats["max_abs_err"],
           "idx_agree": stats["idx_agree"], "recall_at_10": recall,
           "ms": ms, "kernel_ms": ms, "plain_ms": plain_ms,
           "library_ms": library_ms, "bound_ms": max(t_ops, t_bytes),
           "bound_by": "operations" if t_ops >= t_bytes else "bytes",
           "card": card}
    kb = 16 if k <= 16 else 32
    if n_bins is None:
        if all_bins:
            row.update(binned_all_bins(q, c, k, metric))
        layout = KK.knn_select_layout()
        splits = layout["splits"]
    else:
        layout = KK.knn_binned_layout()
        chunks = -(-min(nc, KK.binned_bins(k, n_bins)) // layout["cand_tile"])
        splits = max(1, min(layout["splits"], chunks))
    row.update({"split_count": splits,
                "registers": layout[f"registers_k{kb}"],
                "local_bytes": layout[f"local_bytes_k{kb}"]})
    return row


def binned_all_bins(q, c, k: int, metric: str) -> dict:
    """The exact kernel against ``knn_binned`` with ``n_bins`` ≥ nc,
    where every candidate owns its bin, so that the binned kernel (its
    own launch, on the shared core) computes the exact top k.  Both
    calls of the exact kernel and the binned one must give equal bits;
    the binned kernel's time there is ``binned_all_bins_ms``."""
    import torch

    from sctools_tpu_torch.config import round_up
    from sctools_tpu_torch.ops import knn_kernel as KK

    n_bins = round_up(c.shape[0], KK.BINS_MULTIPLE)
    first = KK.knn_select(q, c, k=k, metric=metric)
    again = KK.knn_select(q, c, k=k, metric=metric)
    launches = KK.knn_binned.launches
    binned = KK.knn_binned(q, c, k=k, n_bins=n_bins, metric=metric)
    sync()
    check(KK.knn_binned.launches == launches + 1,
          "knn_binned at n_bins >= nc did not launch its kernel")
    check(all(torch.equal(a, b) for a, b in zip(first, again)),
          "knn_select: two calls give different bits")
    check(all(torch.equal(a, b) for a, b in zip(first, binned)),
          f"knn_select differs from knn_binned at n_bins {n_bins} >= nc")
    del first, again, binned
    ms = cuda_ms(lambda: KK.knn_binned(q, c, k=k, n_bins=n_bins,
                                       metric=metric))
    return {"binned_all_bins_ms": ms,
            "binned_all_bins": f"knn_binned, n_bins {n_bins} >= nc "
                               "(every candidate its own bin, bitwise "
                               "equal)"}


BOUND_RULES = {
    "knn_select": "max(2*nq*nc*d / peak[dtype], "
                  "((nq + nc)*d*elt + nq*k*8) / peak['bytes'])",
    "knn_binned": "max(2*nq*nc*d / peak[dtype], "
                  "((nq + nc)*d*elt + nq*k*8) / peak['bytes']); the "
                  "merge's compares are not counted",
    "graph_matvec": "max(2*e*d / peak['float32'], "
                    "((nx + n)*d*4 + n*k*8) / peak['bytes']); e = valid "
                    "edges, each x row read once, y written once",
    "graph_rmatvec": "max(2*e*d / peak['float32'], "
                     "((rows + n)*d*4 + e*8) / peak['bytes']); e = valid "
                     "edges, each x row read once, y written once, each "
                     "edge's slot id and weight read once",
    "graph_jaccard": "max(2*e*k*k / peak['float32'], 2*n*k*4 / "
                     "peak['bytes']); one compare and one add per pair of "
                     "list entries of each valid edge e (the data sheet "
                     "lists no int32 rate; the f32 CUDA-core rate stands "
                     "in); bound_ms_int32 = max(e*k*k / peak['int32'], "
                     "2*n*k*4 / peak['bytes']): the compares alone, on the "
                     "64 INT32 lanes an SM a clock; the adds run on the "
                     "FP32 lanes (IMAD, IADD), whose 128 lanes an SM take "
                     "the compares and adds together in no more time",
    "tsne_repulsion": "max((5*dim + 3)*n*(n - 1) / peak['float32'], "
                      "(2*n*dim + n)*4 / peak['bytes']); per pair: dim "
                      "subs, dim fmas (1 + d2), the reciprocal (w), w*w, "
                      "the z add, dim fmas (w2*dx); fma = 2",
}


def bounds_phase() -> dict:
    import torch

    peak_key, peaks = peaks_for(torch.cuda.get_device_name(0))
    emit({"phase": "bounds", "peaks": peaks,
          "source": f"NVIDIA {peak_key} data sheet, dense rates",
          "rules": {name: "bound_ms = " + rule
                    for name, rule in BOUND_RULES.items()}})
    return peaks


def bound(ops: float, nbytes: float, peaks: dict, dtype="float32"):
    """``(bound_ms, bound_by)`` of work of ``ops`` operations at the
    ``dtype`` peak and ``nbytes`` bytes at the memory rate."""
    t_ops = ops / peaks[dtype] * 1e3
    t_bytes = nbytes / peaks["bytes"] * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def edge_list_csr(idx, w, transpose: bool = False, cols: int | None = None):
    """The (n, k) edge list as an (n, cols) CSR tensor P (cols = n by
    default), or Pᵀ, for the library yardstick (duplicate edges
    summed)."""
    import torch

    n, k = idx.shape
    cols_n = n if cols is None else cols
    rows = torch.arange(n, device=idx.device).repeat_interleave(k)
    cols = idx.reshape(-1).long()
    keep = cols >= 0
    pair = [rows[keep], cols[keep]]
    coo = torch.sparse_coo_tensor(torch.stack(pair[::-1] if transpose
                                              else pair),
                                  w.reshape(-1)[keep],
                                  (cols_n, n) if transpose else (n, cols_n))
    return coo.coalesce().to_sparse_csr()


def path_matvec_rows(meta: dict, pal: dict, card: str, peaks: dict
                     ) -> list:
    """``graph_matvec`` at the widths of its other paths, each on that
    path's own edge list: SEACells' kernel and B (914 columns),
    ``embed.spectral``'s symmetric edges and a start block of 21
    columns, Palantir's directed chain and the fate block."""
    rows = [matvec_row(meta["idx"], meta["w"], meta["B"],
                       meta["matvec_launches"], "metacells.seacells Kmat",
                       card, peaks)]
    for (w, x, launches), what in ((pal["spectral"], "embed.spectral"),
                                   (pal["fate"], "palantir fates")):
        rows.append(matvec_row(pal["idx"], w, x, launches, what, card,
                               peaks))
    return rows


def diffuse_matvec_rows(mesh: dict, card: str, peaks: dict) -> list:
    """``graph_matvec`` at ``diffuse_sharded``'s shapes in the mesh
    phase's MAGIC over 4 shards of cuda:0: shard 0's edges remapped to
    its own chunk of x (a ring step) and with global ids against all of
    x (an all_gather product)."""
    from sctools_tpu_torch.parallel.graph_multichip import (
        _Sharded, pad_rows_for_mesh)
    from sctools_tpu_torch.parallel.mesh import CELL_AXIS, split_rows

    data, m = mesh["gdata"], mesh["mesh"]
    n = data.n_cells
    idx, w, x, _ = pad_rows_for_mesh(
        m, idx=data.obsp["knn_indices"][:n],
        weights=data.obsp["diffusion_weights"][:n],
        x=data.X.to_dense().contiguous())
    launches = {r["strategy"]: r["matvec_launches"] for r in mesh["magic"]}
    ring = _Sharded("ring step", idx, w, x, m, CELL_AXIS, "ring")
    gather = _Sharded("all_gather", idx, w, x, m, CELL_AXIS, "all_gather")
    x0 = split_rows(x, m)[0]
    return [matvec_row(ring.local[0][0], ring.w[0], x0, launches["ring"],
                       f"diffuse_sharded ring step, {m.size} shards",
                       card, peaks),
            matvec_row(gather.idx[0], gather.w[0], x,
                       launches["all_gather"],
                       f"diffuse_sharded all_gather, {m.size} shards",
                       card, peaks)]


def rmatvec_rows(meta: dict, palantir_launches: int, card: str,
                 peaks: dict) -> list:
    """``graph_rmatvec`` against its plain version at the metacells
    path's shape (the kernel edge list, x = K·B of 914 columns) and at
    d = 1 (Palantir's stationary vector) on the same edge list, with
    times; the destination order is built once, outside the timings."""
    import torch

    from sctools_tpu_torch.config import true_f32
    from sctools_tpu_torch.ops import graph_kernels as GK

    idx, w, x = meta["idx"], meta["w"], meta["x"]
    n, k = idx.shape
    order = GK.rmatvec_order(idx, n)
    edges = int(order[1][-1])
    csr = edge_list_csr(idx, w, transpose=True)
    rows = []
    for xx, launches, what in (
            (x, meta["launches"], "metacells.seacells KTmat"),
            (x[:, :1].contiguous(), palantir_launches,
             "palantir stationary")):
        d = xx.shape[1]
        got = GK.rmatvec(idx, w, xx, n, order=order)
        want = GK.rmatvec_plain(idx, w, xx, n)
        err = within(got, want, 1e-5, 1e-6,
                     scale=GK.rmatvec_plain(idx, w.abs(), xx.abs(), n))
        slices = check_slices(
            lambda x1: GK.rmatvec(idx, w, x1, n, order=order), xx, got,
            f"rmatvec ({what})")
        with true_f32():
            lib_err = float((torch.sparse.mm(csr, xx) - want).abs().max())
        del got, want
        reps = cuda_times(lambda: GK.rmatvec(idx, w, xx, n, order=order),
                          warmup=False)
        plain_ms = cuda_ms(lambda: GK.rmatvec_plain(idx, w, xx, n))
        with true_f32():
            library_ms = cuda_ms(lambda: torch.sparse.mm(csr, xx))
        bms, by = bound(2.0 * edges * d, 2.0 * n * d * 4 + edges * 8.0,
                        peaks)
        rows.append({
            "name": "graph_rmatvec", "route": "cuda",
            "source": "sctools_tpu_torch/csrc/graph_rmatvec.cu",
            "replaces": "sctools_tpu/ops/pallas_graph.py:200",
            "shape": f"{n}x{k} edges -> x {n}x{d} float32 ({what})",
            "launches": launches, "max_abs_err": err,
            "ms": statistics.median(reps), "ms_reps": reps,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "library": "torch.sparse.mm(CSR P^T, dense x)",
            "library_max_abs_err": lib_err,
            "order_build_ms": meta["order_ms"], "bound_ms": bms,
            "bound_by": by, "column_slices_bitwise": slices, "card": card})
    return rows


def matvec_row(idx, w, x, launches: int, what: str, card: str,
               peaks: dict, **extra) -> dict:
    """``graph_matvec`` against its plain version on one path's edge list
    and input, with times (CUDA events, the kernel's five repetitions
    kept): kernel, plain version, ``torch.sparse.mm`` on the CSR P in
    true float32, and the bound."""
    import torch

    from sctools_tpu_torch.config import true_f32
    from sctools_tpu_torch.ops import graph_kernels as GK

    n, k = idx.shape
    d = x.shape[1]
    got = GK.matvec(idx, w, x)
    want = GK.matvec_plain(idx, w, x)
    # signed terms cancel: hold each output against Σ_t |w|·|x|
    err = within(got, want, 1e-5, 1e-6,
                 scale=GK.matvec_plain(idx, w.abs(), x.abs()))
    slices = check_slices(lambda xx: GK.matvec(idx, w, xx), x, got,
                          f"matvec ({what})")
    csr = edge_list_csr(idx, w, cols=x.shape[0])
    with true_f32():
        lib_err = float((torch.sparse.mm(csr, x) - want).abs().max())
    del got, want
    reps = cuda_times(lambda: GK.matvec(idx, w, x), warmup=False)
    plain_ms = cuda_ms(lambda: GK.matvec_plain(idx, w, x))
    with true_f32():
        library_ms = cuda_ms(lambda: torch.sparse.mm(csr, x))
    edges = int((idx >= 0).sum())
    bms, by = bound(2.0 * edges * d, (x.shape[0] + n) * d * 4.0 + n * k * 8.0,
                    peaks)
    return {
        "name": "graph_matvec", "route": "cuda",
        "source": "sctools_tpu_torch/csrc/graph_matvec.cu",
        "replaces": "sctools_tpu/ops/pallas_graph.py:172",
        "shape": f"{n}x{k} edges -> x {x.shape[0]}x{d} float32 ({what})",
        "launches": launches, "max_abs_err": err,
        "ms": statistics.median(reps), "ms_reps": reps,
        "plain_ms": plain_ms, "library_ms": library_ms,
        "library": "torch.sparse.mm(CSR P, dense x)",
        "library_max_abs_err": lib_err, "bound_ms": bms, "bound_by": by,
        "column_slices_bitwise": slices, "card": card, **extra}


def graph_kernels_phase(graph: dict, cluster: dict, card: str,
                        peaks: dict) -> list:
    """The three graph kernels against their plain versions at the
    graph phase's shapes, in the RCM layout the path runs them in
    (``ms``; ``ms_natural`` in the caller's order), with times.
    graph_jaccard's launches are the graph path's and
    ``cluster.phenograph``'s (phase cluster, one run)."""
    import torch

    from sctools_tpu_torch.ops import graph as G
    from sctools_tpu_torch.ops import graph_kernels as GK

    idx, P, x, y = graph["idx"], graph["P"], graph["x"], graph["y"]
    launches = graph["launches"]
    n, k = idx.shape
    perm = torch.from_numpy(G.reorder_permutation(idx)).to(idx.device)
    r_idx = remap_rows(idx, perm)
    r_P, r_x = P[perm].contiguous(), x[perm].contiguous()
    layout = {"bandwidth": [G.graph_bandwidth(idx), G.graph_bandwidth(r_idx)],
              "tile_density_256": [G.tile_density(idx),
                                   G.tile_density(r_idx)]}
    edges = int((idx >= 0).sum())
    common = {"route": "cuda", "card": card,
              "layout_natural_then_rcm": layout}
    rows = []

    ms_nat = cuda_ms(lambda: GK.matvec(idx, P, x))
    rows.append(matvec_row(r_idx, r_P, r_x, launches["matvec"], "MAGIC t=3",
                           card, peaks, ms_natural=ms_nat,
                           layout_natural_then_rcm=layout))

    check(torch.equal(GK.jaccard(r_idx), GK.jaccard_plain(r_idx)),
          "jaccard differs from jaccard_plain at the path's shape")
    ms = cuda_ms(lambda: GK.jaccard(r_idx), warmup=False)
    ms_nat = cuda_ms(lambda: GK.jaccard(idx))
    plain_ms = cuda_ms(lambda: GK.jaccard_plain(r_idx))
    device, recorded = graph["jaccard_device"]
    late = {}
    device_late = device_us({"fn": lambda: GK.jaccard(r_idx)},
                            counts=late)["fn"]
    bms, by = bound(2.0 * edges * k * k, 2.0 * n * k * 4, peaks)
    int_ms, int_by = bound(1.0 * edges * k * k, 2.0 * n * k * 4, peaks,
                           "int32")
    kernel_us = sum(t for name, t in device.items() if "jaccard" in name)
    check(kernel_us >= 1e3 * max(bms, int_ms),
          f"graph_jaccard: {kernel_us} µs of device time beats its bounds "
          f"{bms} / {int_ms} ms: a bound rule counts work the kernel does "
          "not need")
    rows.append({
        "name": "graph_jaccard",
        "source": "sctools_tpu_torch/csrc/graph_jaccard.cu",
        "replaces": "sctools_tpu/ops/pallas_graph.py:432",
        "shape": f"{n}x{k} int32",
        "launches": launches["jaccard"] + cluster["jaccard_launches"],
        "launches_by_path": {"graph_tail": launches["jaccard"],
                             "cluster.phenograph":
                                 cluster["jaccard_launches"]},
        "max_abs_err": 0.0, "ms": ms, "ms_natural": ms_nat,
        "device_us": device, "device_launches_recorded": recorded,
        "device_us_late": device_late,
        "device_launches_recorded_late": late["fn"],
        "plain_ms": plain_ms, "library_ms": None,
        "library": "none: no single PyTorch call intersects neighbour "
                   "lists per edge",
        "bound_ms": bms, "bound_by": by, "bound_ms_int32": int_ms,
        "bound_by_int32": int_by, **common})

    f, z = GK.tsne_repulsion(y, n)
    pf, pz = GK.tsne_repulsion_plain(y, n)
    terms = tsne_term_scale(y)
    err = within(f, pf, 1e-5, TSNE_FULL_ATOL * terms)
    within(z.reshape(1), pz.reshape(1), 1e-5, 0.0)
    # split partial sums combined in a fixed order: the bits repeat
    f2, z2 = GK.tsne_repulsion(y, n)
    check(torch.equal(f, f2) and torch.equal(z, z2),
          "tsne_repulsion: two calls at the full shape give other bits")
    del f, pf, f2
    ms = cuda_ms(lambda: GK.tsne_repulsion(y, n), warmup=False)
    plain_ms = cuda_ms(lambda: GK.tsne_repulsion_plain(y, n))
    dim = y.shape[1]
    pairs = float(n) * (n - 1)
    bms, by = bound((5.0 * dim + 3) * pairs, (2.0 * n * dim + n) * 4, peaks)
    # PR 2's rule counted the expanded form's dot, clamp and self mask
    earlier, _ = bound((4.0 * dim + 10) * pairs, (2.0 * n * dim + n) * 4,
                       peaks)
    rows.append({
        "name": "tsne_repulsion",
        "source": "sctools_tpu_torch/csrc/tsne_repulsion.cu",
        "replaces": "sctools_tpu/ops/pallas_graph.py:537",
        "shape": f"{n}x{dim} float32 (the final layout)",
        "launches": launches["tsne_repulsion"], "max_abs_err": err,
        "term_scale": terms, "z_rel_err": abs(float(z) / float(pz) - 1.0),
        "ms": ms, "plain_ms": plain_ms, "library_ms": None,
        "library": "none: no single PyTorch call computes the Student-t "
                   "repulsion and its normaliser",
        "bound_ms": bms, "bound_by": by, "bound_ms_earlier_rule": earlier,
        "route": "cuda", "card": card})
    return rows


def kernels_phase(x_pca, launches: int, binned_launches: int, card: str,
                  peaks: dict, stream: dict, mesh: dict,
                  atlas: dict) -> list:
    import torch

    from sctools_tpu_torch import configure
    from sctools_tpu_torch.data.synthetic import gaussian_blobs
    from sctools_tpu_torch.ops.knn import _prep, knn_arrays, knn_numpy

    out = []
    n = x_pca.shape[0]
    host_pca = x_pca.cpu().numpy()
    q = _prep(x_pca, "cosine", torch.float32)
    oracle, _ = knn_numpy(host_pca[:N_COMPARE], host_pca, k=15,
                          metric="cosine", chunk=256)
    out.append(kernel_case(
        f"{n}x{n}x50 k=15 float32 (main path)", q, q, 15, "cosine",
        oracle, launches, card, peaks))
    out.append(kernel_case(
        f"{n}x{n}x50 k=15 float32, 1024 bins (binned path)", q, q, 15,
        "cosine", oracle, binned_launches, card, peaks, n_bins=1024))
    del q

    # the recipes phase's launches: atlas_knn's kNN (knn_multichip's
    # ring on a one-card mesh) on that recipe's own embedding
    emb = atlas["x_pca"]
    host = emb.cpu().numpy()
    orc, _ = knn_numpy(host[:N_COMPARE], host, k=15, metric="cosine",
                       chunk=256)
    q = _prep(emb, "cosine", torch.float32)
    out.append(kernel_case(
        f"{n}x{n}x50 k=15 float32 (atlas_knn recipe: knn_multichip ring, "
        "one card)", q, q, 15, "cosine", orc, atlas["launches"], card,
        peaks, plain_reps=1, library_reps=2, all_bins=False))
    del q

    pts, _ = gaussian_blobs(WIDE_CANDS, DIM, n_clusters=50, seed=0)
    c_raw = torch.from_numpy(pts).cuda()
    q_raw = c_raw[:WIDE_QUERIES]
    oracle, _ = knn_numpy(pts[:N_COMPARE], pts, k=15, metric="cosine",
                          chunk=256)
    for dtype, k in ((torch.float32, 15), (torch.bfloat16, 32)):
        q = _prep(q_raw, "cosine", dtype)
        c = _prep(c_raw, "cosine", dtype)
        refined = None
        if dtype == torch.bfloat16:
            with configure(matmul_dtype="bfloat16"):
                refined, _ = knn_arrays(q_raw, c_raw, k=15,
                                        metric="cosine", refine=k)
        out.append(kernel_case(
            f"{WIDE_QUERIES}x{WIDE_CANDS}x{DIM} k={k} {str(dtype)[6:]}"
            + (" then refine to 15" if refined is not None else ""),
            q, c, k, "cosine", oracle, launches, card, peaks,
            ids_for_recall=refined))
        if dtype == torch.float32:
            out.append(kernel_case(
                f"{WIDE_QUERIES}x{WIDE_CANDS}x{DIM} k=15 float32, 1024 "
                "bins", q, c, 15, "cosine", oracle, binned_launches, card,
                peaks, n_bins=1024))
        del q, c, refined
    del c_raw, q_raw

    # the streamed path's launches: its first query chunk against all
    # 1.3M cells of its own embedding (one timing of the plain version,
    # seconds a call)
    emb = stream["scores"]
    host = emb.cpu().numpy()
    oracle, _ = knn_numpy(host[:N_COMPARE], host, k=15, metric="cosine",
                          chunk=256)
    c = _prep(emb, "cosine", torch.float32)
    k = STREAM_REFINE
    out.append(kernel_case(
        f"{STREAM_CHUNK}x{emb.shape[0]}x{DIM} k={k} float32 (stream path, "
        "first chunk)", c[:STREAM_CHUNK], c, k, "cosine", oracle,
        stream["launches"], card, peaks, plain_reps=1, library_reps=2))

    # the mesh phase's launches on the 4 shards of cuda:0: shard 0's
    # queries against its own chunk (a ring step) and against all rows
    # (an all_gather search)
    runs = {r["strategy"]: r for r in mesh["runs"]
            if r["mesh"] == f"cuda:0 x {MESH_SHARDS}"}
    m = mesh["shard_rows"]
    shard = c[:m]
    own, _ = knn_numpy(host[:N_COMPARE], host[:m], k=15, metric="cosine",
                       chunk=256)
    for strategy, cand, orc, what in (
            ("ring", shard, own, "ring step"),
            ("all_gather", c, oracle, "all_gather search")):
        out.append(kernel_case(
            f"{m}x{cand.shape[0]}x{DIM} k=15 float32 (knn_multichip "
            f"{what}, {MESH_SHARDS} shards of cuda:0)", shard, cand, 15,
            "cosine", orc, runs[strategy]["knn_select_launches"], card,
            peaks, plain_reps=1, library_reps=2, all_bins=False))
    return out


def stream_mesh_kernel_row(smesh: dict, card: str, peaks: dict) -> list:
    """knn_select at the stream_mesh phase's ring step: shard 0's
    queries against its own chunk (325,632² × 50, k=15) of that phase's
    4-shard embedding, with that run's launches."""
    import torch

    from sctools_tpu_torch.ops.knn import _prep, knn_numpy

    emb = smesh["emb"]
    n = emb.shape[0]
    m = mesh_shard_rows(n, MESH_SHARDS)
    host = emb[:m].cpu().numpy()
    own, _ = knn_numpy(host[:N_COMPARE], host, k=15, metric="cosine",
                       chunk=256)
    shard = _prep(emb[:m], "cosine", torch.float32)
    return [kernel_case(
        f"{m}x{m}x{DIM} k=15 float32 (stream_pipeline(mesh=) ring step, "
        f"{MESH_SHARDS} shards of cuda:0, its own embedding)", shard, shard,
        15, "cosine", own, smesh["launches"], card, peaks, plain_reps=1,
        library_reps=2, all_bins=False)]


def main() -> int:
    try:
        return run()
    finally:
        if _POOL:  # a failed phase leaves no CPU job running
            _POOL[0].shutdown(wait=True, cancel_futures=True)


def run() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    import sctools_tpu_torch  # noqa: F401  (fails alone, without the repo)

    card = card_phase()
    main_out = main_phase(card)
    sharded_phase(main_out["raw"], card)
    atlas, recipes_finish = recipes_phase(main_out, card)
    binned_launches = binned_phase(main_out, card)
    graph = graph_phase(main_out["out"], card)
    meta = metacells_phase(main_out, card)
    pal = palantir_phase(main_out, card)
    neighbors_phase(main_out, card)
    cluster = cluster_phase(main_out, card)
    stats = stats_phase(main_out, card)
    integ = integrate_phase(main_out, card)
    lay = layouts_phase(graph, card)
    vel = velocity_phase(card)
    recipes_finish()  # the recipes' CPU runs, on the worker meanwhile
    x_pca, launches = main_out["x_pca"], main_out["launches"]
    del main_out
    stream = stream_phase(card)
    smesh = stream_mesh_phase(stream, card)
    mesh = mesh_phase(stream, graph, card)
    edges_phase()
    binned_edges_phase()
    graph_edges_phase()
    peaks = bounds_phase()
    kernels = kernels_phase(x_pca, launches, binned_launches, card, peaks,
                            stream, mesh, atlas)
    kernels += stream_mesh_kernel_row(smesh, card, peaks)
    kernels += graph_kernels_phase(graph, cluster, card, peaks)
    kernels += path_matvec_rows(meta, pal, card, peaks)
    kernels.append(matvec_row(stats["idx"], stats["w"], stats["x"],
                              stats["launches"],
                              "metrics.morans_i, 256-gene block", card,
                              peaks))
    kernels += diffuse_matvec_rows(mesh, card, peaks)
    kernels += rmatvec_rows(meta, pal["launches"], card, peaks)
    kernels += velocity_kernel_rows(lay, vel, card, peaks)
    kernels += integrate_kernel_rows(integ, card, peaks)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
