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
3. edges   — the kNN kernel against its plain version at small shapes
             that reach its corners (k = 1 and 200, d = 1 and 256,
             euclidean, self exclusion, bf16, fewer candidates than k,
             exact ties);
4. kernels — the kernel against its plain version on the card at the
             main path's shape and at the configs[3] candidate width
             (1.3M points, 65,536 queries; f32 k=15 and bf16 k=32 then
             the f32 refine to 15), recall against the float64 oracle,
             and times: kernel, plain version, one library yardstick
             (blocked ``torch.matmul`` + ``torch.topk``, timed here and
             used nowhere in the port) and the card's bound (the
             published peaks it uses are printed on a line of their
             own).

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


def cuda_ms(fn, reps: int = 5, warmup: bool = True) -> float:
    """Median over ``reps`` timed calls of ``fn`` by CUDA events, after
    one untimed call unless the caller has just made one."""
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
    return statistics.median(times)


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
    stages = []
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    data = ds.to_device(dev)
    sync()
    stages.append({"stage": "to_device", "s": time.perf_counter() - t0,
                   "peak_gb": torch.cuda.max_memory_allocated() / 1e9})
    for t in pipe:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        data = t(data, device=dev)
        sync()
        stages.append({"stage": t.name, "s": time.perf_counter() - t0,
                       "peak_gb": torch.cuda.max_memory_allocated() / 1e9})
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
    return x_pca, launches


# ----------------------------------------------------------------------
# kernel against plain version
# ----------------------------------------------------------------------


def compare(kernel_out, plain_out, tol: float) -> dict:
    """Kernel rows against the plain version's: values within ``tol``
    (equal where infinite); ids equal except where the two values lie
    within ``tol`` of each other (a swap of near-ties, or the k-th
    slot)."""
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
        bad += not (swapped or boundary)
    check(bad == 0, f"{bad} ids differ beyond near-ties")
    return {"max_abs_err": err, "idx_agree": float((ki == pi).mean())}


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
                ids_for_recall=None) -> dict:
    """Kernel against plain version on the first N_COMPARE queries,
    recall@10 of those queries against the float64 ``oracle`` ids, and
    the times.  The comparison calls are the timings' warm-up."""
    import torch

    from sctools_tpu_torch.config import true_f32
    from sctools_tpu_torch.ops.knn import recall_at_k
    from sctools_tpu_torch.ops.knn_kernel import knn_select, knn_select_plain

    dtype = "bfloat16" if q.dtype == torch.bfloat16 else "float32"
    tol = 1e-3 if dtype == "bfloat16" else 1e-5
    kv, ki = knn_select(q, c, k=k, metric=metric)
    pv, pi = knn_select_plain(q[:N_COMPARE], c, k=k, metric=metric,
                              query_block=PLAIN_BLOCK,
                              cand_block=PLAIN_BLOCK)
    sync()
    stats = compare((kv[:N_COMPARE], ki[:N_COMPARE]), (pv, pi), tol)
    pred = (ki[:N_COMPARE] if ids_for_recall is None
            else ids_for_recall[:N_COMPARE]).cpu().numpy()
    recall = recall_at_k(pred, oracle, k=10)
    check(recall >= 0.99, f"{name_shape}: recall@10 {recall} < 0.99")
    del kv, ki, pv, pi

    ms = cuda_ms(lambda: knn_select(q, c, k=k, metric=metric),
                 warmup=False)
    plain_ms = cuda_ms(lambda: knn_select_plain(
        q, c, k=k, metric=metric, query_block=PLAIN_BLOCK,
        cand_block=PLAIN_BLOCK), warmup=False)
    with true_f32():
        library_ms = cuda_ms(lambda: library_topk(q, c, k))
    nq, d = q.shape
    nc = c.shape[0]
    t_ops = 2.0 * nq * nc * d / peaks[dtype] * 1e3
    t_bytes = ((nq + nc) * d * q.element_size() + nq * k * 8) \
        / peaks["bytes"] * 1e3
    return {"name": "knn_select", "route": "cuda",
            "source": "sctools_tpu_torch/csrc/knn_select.cu",
            "replaces": "sctools_tpu/ops/pallas_knn.py:84",
            "shape": name_shape, "launches": launches,
            "max_abs_err": stats["max_abs_err"],
            "idx_agree": stats["idx_agree"], "recall_at_10": recall,
            "ms": ms, "kernel_ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "card": card}


def kernels_phase(x_pca, launches: int, card: str) -> list:
    import torch

    from sctools_tpu_torch import configure
    from sctools_tpu_torch.data.synthetic import gaussian_blobs
    from sctools_tpu_torch.ops.knn import _prep, knn_arrays, knn_numpy

    peak_key, peaks = peaks_for(torch.cuda.get_device_name(0))
    emit({"phase": "bounds", "peaks": peaks,
          "source": f"NVIDIA {peak_key} data sheet, dense rates",
          "rule": "bound_ms = max(2*nq*nc*d / peak[dtype], "
                  "((nq + nc)*d*elt + nq*k*8) / peak['bytes'])"})
    out = []
    n = x_pca.shape[0]
    host_pca = x_pca.cpu().numpy()
    q = _prep(x_pca, "cosine", torch.float32)
    oracle, _ = knn_numpy(host_pca[:N_COMPARE], host_pca, k=15,
                          metric="cosine", chunk=256)
    out.append(kernel_case(
        f"{n}x{n}x50 k=15 float32 (main path)", q, q, 15, "cosine",
        oracle, launches, card, peaks))
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
        del q, c, refined
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    import sctools_tpu_torch  # noqa: F401  (fails alone, without the repo)

    card = card_phase()
    x_pca, launches = main_phase(card)
    edges_phase()
    kernels = kernels_phase(x_pca, launches, card)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
