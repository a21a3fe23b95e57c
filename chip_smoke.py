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
             oracle on 4,096 sampled cells;
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
7. edges   — the kNN kernels against their plain versions at small
             shapes that reach their corners (k = 1 to 256, d = 1 and
             256, euclidean, self exclusion, bf16, fewer candidates than
             k or than bins, n_bins 128 to 1024, exact ties); then the
             graph kernels at theirs (-1 ids, empty rows and
             destinations, repeated ids, a hub of 5,000 incoming edges,
             rectangular rmatvec, k = 1 and 64, odd d, t-SNE dim 1–4
             at 2 rows and at row counts one off the repulsion kernel's
             query tile, candidate tile and split boundaries),
             and matvec and rmatvec at every width path (d = 1 to 914):
             a column slice of x gives that slice of the result bit for
             bit, and an x 4 bytes off alignment the same bits;
8. kernels — each kernel against its plain version on the card at the
             path's shapes (kNN also at the configs[3] candidate width:
             1.3M points, 65,536 queries; f32 k=15, binned k=15 and
             bf16 k=32 then the f32 refine to 15, with recall against
             the float64 oracle), and times: kernel, plain version, one library
             yardstick where a single PyTorch call computes the same
             function (timed here and used nowhere in the port) and the
             card's bound (the published peaks and the bound rules are
             printed on a line of their own).  graph_matvec is timed at
             each path's width on that path's edges (MAGIC 2000,
             SEACells 914, spectral 21, Palantir's fates), graph_rmatvec
             at SEACells' 914 and Palantir's 1; each holds the column-
             slice identity there too.  tsne_repulsion gives the same
             bits in two calls at the path's final layout.

The line before the last is the ``kernels`` JSON; the last is
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without
the package beside it, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import json
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
    "H100 SXM": {"float32": 67e12, "bfloat16": 989e12, "bytes": 3.35e12},
    "H100 PCIe": {"float32": 51e12, "bfloat16": 756e12, "bytes": 2.0e12},
}


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise SmokeFailure(msg)


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


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


def peaks_for(name: str) -> tuple[str, dict]:
    key = "H100 PCIe" if "PCIe" in name else "H100 SXM"
    return key, PEAKS[key]


# ----------------------------------------------------------------------
# 1. card
# ----------------------------------------------------------------------


def card_phase() -> str:
    import torch

    from sctools_tpu_torch import cuda_build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    line = smi.stdout.strip().splitlines()[0]
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
    emit({"phase": "main", "card": card, "cells": MAIN_CELLS,
          "genes": MAIN_GENES, "generate_s": gen_s, "run_s": run_s,
          "stages": stages, "knn_select_launches": launches,
          "recall_at_10": recall, "recall_queries": N_RECALL})
    return {"raw": ds, "out": out, "x_pca": x_pca, "launches": launches,
            "sample": sample, "oracle": oracle}


def staged(steps, data, dev) -> tuple:
    """Run ``steps`` (Transforms) one by one on ``dev``: the output and
    each stage's wall time and peak device memory."""
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
    return data, stages


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
    emit({"phase": "graph", "card": card, "cells": n,
          "genes": data.n_genes, "k": int(idx0.shape[1]), "run_s": run_s,
          "stages": stages, "launches": launches,
          "x_magic_max_abs_err": magic_err,
          "tsne_purity": pur_tsne, "graph_purity": pur_graph,
          "tsne_profile": tsne_profile(data)})
    return {"idx": idx0, "P": P, "x": x, "y": emb.contiguous(),
            "launches": launches}


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
    kernels = {}
    for ev in prof.key_averages():
        t = getattr(ev, "device_time_total",
                    getattr(ev, "cuda_time_total", 0.0)) / 1e3 / iters
        if t <= 0:
            continue
        kernels[ev.key[:60]] = t
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
            "device_ms_per_iter_by_kernel": kernels}


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


def edges_phase() -> None:
    import torch

    from sctools_tpu_torch.ops.knn import _prep
    from sctools_tpu_torch.ops.knn_kernel import knn_select, knn_select_plain

    rng = np.random.default_rng(1)
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
    ]
    results = []
    for nq, nc, d, k, metric, dtype, excl, integer in cases:
        if integer:
            base = rng.integers(-3, 4, size=(40, d)).astype(np.float32)
            pts = base[rng.integers(0, 40, size=max(nq, nc))]
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
    emit({"phase": "edges", "cases": results})


def binned_edges_phase() -> None:
    """The binned kNN kernel against its plain version at the corners of
    its merge: fewer candidates than bins (then bitwise the exact
    kernel), candidate counts that are no multiple of n_bins, k = 1 and
    256, n_bins 128 and 1024 (and one rounded up from 300), bf16,
    euclidean, self exclusion, and integer points with exact ties inside
    and across bins (then ids identical)."""
    import torch

    from sctools_tpu_torch.ops.knn import _prep
    from sctools_tpu_torch.ops.knn_kernel import knn_binned, knn_select

    rng = np.random.default_rng(3)
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
    ]
    results = []
    for nq, nc, d, k, n_bins, metric, dtype, excl, integer in cases:
        if integer:
            base = rng.integers(-3, 4, size=(40, d)).astype(np.float32)
            pts = base[rng.integers(0, 40, size=max(nq, nc))]
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
    emit({"phase": "binned_edges", "cases": results})


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
                ids_for_recall=None, n_bins: int | None = None) -> dict:
    """Kernel against plain version on the first N_COMPARE queries,
    recall@10 of those queries against the float64 ``oracle`` ids, and
    the times: the exact kernel, or the binned one with ``n_bins`` (its
    ids held with the bin-aware near-tie rule, recall gated at 0.98).
    The comparison calls are the timings' warm-up; the plain version is
    timed over 3 calls (seconds each at the wide shape)."""
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
    plain_ms = cuda_ms(lambda: plain(q), reps=3, warmup=False)
    with true_f32():
        library_ms = cuda_ms(lambda: library_topk(q, c, k))
    nq, d = q.shape
    nc = c.shape[0]
    t_ops = 2.0 * nq * nc * d / peaks[dtype] * 1e3
    t_bytes = ((nq + nc) * d * q.element_size() + nq * k * 8) \
        / peaks["bytes"] * 1e3
    return {"name": name, "route": "cuda",
            "source": f"sctools_tpu_torch/csrc/{name}.cu",
            "replaces": f"sctools_tpu/ops/pallas_knn.py:{line}",
            "shape": name_shape, "launches": launches,
            "max_abs_err": stats["max_abs_err"],
            "idx_agree": stats["idx_agree"], "recall_at_10": recall,
            "ms": ms, "kernel_ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "card": card}


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
                     "in)",
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


def edge_list_csr(idx, w, transpose: bool = False):
    """The (n, k) edge list as an (n, n) CSR tensor P, or Pᵀ, for the
    library yardstick (duplicate edges summed)."""
    import torch

    n, k = idx.shape
    rows = torch.arange(n, device=idx.device).repeat_interleave(k)
    cols = idx.reshape(-1).long()
    keep = cols >= 0
    pair = [rows[keep], cols[keep]]
    coo = torch.sparse_coo_tensor(torch.stack(pair[::-1] if transpose
                                              else pair),
                                  w.reshape(-1)[keep], (n, n))
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
    csr = edge_list_csr(idx, w)
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


def graph_kernels_phase(graph: dict, card: str, peaks: dict) -> list:
    """The three graph kernels against their plain versions at the
    graph phase's shapes, in the RCM layout the path runs them in
    (``ms``; ``ms_natural`` in the caller's order), with times."""
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
    bms, by = bound(2.0 * edges * k * k, 2.0 * n * k * 4, peaks)
    rows.append({
        "name": "graph_jaccard",
        "source": "sctools_tpu_torch/csrc/graph_jaccard.cu",
        "replaces": "sctools_tpu/ops/pallas_graph.py:432",
        "shape": f"{n}x{k} int32", "launches": launches["jaccard"],
        "max_abs_err": 0.0, "ms": ms, "ms_natural": ms_nat,
        "plain_ms": plain_ms, "library_ms": None,
        "library": "none: no single PyTorch call intersects neighbour "
                   "lists per edge",
        "bound_ms": bms, "bound_by": by, **common})

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
                  peaks: dict) -> list:
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
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    import sctools_tpu_torch  # noqa: F401  (fails alone, without the repo)

    card = card_phase()
    main_out = main_phase(card)
    binned_launches = binned_phase(main_out, card)
    graph = graph_phase(main_out["out"], card)
    meta = metacells_phase(main_out, card)
    pal = palantir_phase(main_out, card)
    x_pca, launches = main_out["x_pca"], main_out["launches"]
    del main_out
    edges_phase()
    binned_edges_phase()
    graph_edges_phase()
    peaks = bounds_phase()
    kernels = kernels_phase(x_pca, launches, binned_launches, card, peaks)
    kernels += graph_kernels_phase(graph, card, peaks)
    kernels += path_matvec_rows(meta, pal, card, peaks)
    kernels += rmatvec_rows(meta, pal["launches"], card, peaks)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
