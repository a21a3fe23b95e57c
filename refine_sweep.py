#!/usr/bin/env python3
"""The kNN refine's two gathers timed against each other on one NVIDIA
card, over candidate tables of growing size.

    python3 refine_sweep.py        # from the repository root

``knn_arrays(refine=r)`` (``sctools_tpu_torch/ops/knn.py``) re-ranks each
query's r coarse candidates exactly in float32, gathering their rows by
query block (``_refine``, ``knn_refine_mode="blocked"``) or in ascending
id order (``_refine_sorted``, ``"sorted"``); ``"auto"`` picks by the
candidate count against ``config.refine_sorted_min_cand``.  This script
times both on the same lists, in turns blocked, sorted, sorted,
blocked, each turn the median of 5 CUDA-event timings of one call:

* ``path``: ``chip_smoke.py``'s streamed embedding (1.3M synthetic cells
  × 28,672 genes through ``stream_stats``, ``stream_hvg`` and
  ``stream_pca``, 50 PCs), its first n_c rows as the table, its first
  min(131,072, n_c) rows as the queries (the streamed path's query
  chunk) and their k = 32 cosine lists from ``knn_select`` (the streamed
  path's refine 32), re-ranked to 15;
* ``random``: a seeded Gaussian table of n_c × 50 beyond the stand-in,
  up to configs[4]'s 10M cells, 131,072 queries from it and 32 ids a
  query drawn uniformly over the table (a list spread over the whole
  table, as a table of few clusters gives).

At each size both gathers must give distances within 1e-5 and the same
id sets on at least 0.9999 of the rows (a near-tie at the 15th place
may fall either way).  Prints the card's name and power limit, then one
JSON line a size.
"""

from __future__ import annotations

import json
import statistics
import sys

import chip_smoke as smoke

PATH_SIZES = (4_096, 16_384, 68_579, 262_144, 786_432, 1_300_000)
RANDOM_SIZES = (2_600_000, 5_200_000, 10_000_000)
QUERIES, K_SEARCH, K = 131_072, 32, 15


def stream_embedding():
    """The streamed path's 1.3M × 50 PCs, as ``chip_smoke.py`` phase
    ``stream`` makes them."""
    import torch

    from sctools_tpu_torch.data import stream as ST
    from sctools_tpu_torch.data.synthetic import DeviceSyntheticSource

    src = DeviceSyntheticSource(
        smoke.STREAM_CELLS, smoke.STREAM_GENES,
        capacity=smoke.STREAM_CAPACITY, shard_rows=smoke.STREAM_SHARD_ROWS,
        n_clusters=8, seed=0, device=torch.device(smoke.DEVICE))
    stats = ST.stream_stats(src)
    genes = ST.stream_hvg(stats, n_top=smoke.STREAM_TOP, flavor="seurat_v3",
                          src=src)
    scores, _, _ = ST.stream_pca(src, genes, stats["gene_mean"],
                                 n_components=50, n_iter=2)
    return scores


def turns(query, cand, lists) -> dict:
    """Both refines on the same lists, timed in turns; their results
    held to each other."""
    import torch

    from sctools_tpu_torch.ops.knn import _refine, _refine_sorted

    fns = {"blocked": _refine, "sorted": _refine_sorted}
    times = {"blocked": [], "sorted": []}
    out = {}
    for mode in ("blocked", "sorted", "sorted", "blocked"):
        def call(fn=fns[mode]):
            return fn(query, cand, lists, k=K, metric="cosine")
        out.setdefault(mode, call())
        times[mode].append(smoke.cuda_ms(call))
    (bi, bd), (si, sd) = out["blocked"], out["sorted"]
    err = float((bd - sd).abs().max().item())
    same = float((torch.sort(bi, dim=1)[0] == torch.sort(si, dim=1)[0])
                 .all(dim=1).float().mean().item())
    smoke.check(err <= 1e-5, f"refines' distances differ by {err}")
    smoke.check(same >= 0.9999, f"refines' id sets agree on {same}")
    ms = {m: statistics.median(t) for m, t in times.items()}
    return {"ms": times, "blocked_ms": ms["blocked"],
            "sorted_ms": ms["sorted"],
            "sorted_over_blocked": ms["sorted"] / ms["blocked"],
            "max_abs_dist_diff": err, "id_sets_equal": same}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("refine_sweep.py: no CUDA device", file=sys.stderr)
        return 1
    from sctools_tpu_torch.ops.knn import _prep
    from sctools_tpu_torch.ops.knn_kernel import knn_select

    print(smoke.smi_line(), flush=True)
    emb = stream_embedding()
    for n_c in PATH_SIZES:
        cand = emb[:n_c]
        query = cand[:min(QUERIES, n_c)]
        c = _prep(cand, "cosine", torch.float32)
        _, lists = knn_select(c[:query.shape[0]], c, k=K_SEARCH,
                              metric="cosine")
        del c
        row = {"table": "path", "n_cand": n_c, "queries": query.shape[0],
               "k_search": K_SEARCH, "k": K}
        print(json.dumps(row | turns(query, cand, lists)), flush=True)
    del emb
    torch.cuda.empty_cache()
    gen = torch.Generator(device=smoke.DEVICE).manual_seed(0)
    for n_c in RANDOM_SIZES:
        cand = torch.randn((n_c, smoke.DIM), generator=gen,
                           device=smoke.DEVICE)
        lists = torch.randint(0, n_c, (QUERIES, K_SEARCH), generator=gen,
                              device=smoke.DEVICE, dtype=torch.int32)
        row = {"table": "random", "n_cand": n_c, "queries": QUERIES,
               "k_search": K_SEARCH, "k": K}
        print(json.dumps(row | turns(cand[:QUERIES], cand, lists)),
              flush=True)
        del cand, lists
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
