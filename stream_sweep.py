#!/usr/bin/env python3
"""Sentinel-slot A/B of the PCA's ``Xᵀ Q`` product on one NVIDIA card.

    python3 stream_sweep.py        # from the repository root

The HVG subset maps every gene outside it onto the subset's sentinel
id, so most slots of a matrix carry that id.  ``spmm_t``
(``sctools_tpu_torch/data/sparse.py``) leaves them out before its
``index_add_``; adding them into a sentinel row of their own instead
puts every one of them on the same ``d`` addresses.  This script times
the product both ways, in turns dropped, scattered, scattered, dropped
(wall s ending in a sync), at two shapes:

* ``stream``: one centred ``X_cᵀ Q`` sweep of ``stream_pca`` over
  ``chip_smoke.py``'s streamed source (1.3M cells × 28,672 genes,
  capacity 512, 131,072-row shards, generated on the card), its stats
  and seurat_v3 HVG set (2000), with Q 1.3M × 60;
* ``main``: one ``spmm_t`` of ``pca.randomized`` on the main path's
  HVG-subset matrix (68,579 × 32,738 synthetic counts through
  ``chip_smoke.MAIN_STEPS`` up to ``hvg.select``), with Q 68,579 × 60.

At each shape the two products must agree within 1e-4 of the largest
entry.  Prints the card's name and power limit, then one JSON line per
shape.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np

import chip_smoke as smoke

L = 60  # 50 components + 10 oversampling columns


def scatter_all_slots(x, w, block: int = 2048):
    """``Xᵀ W`` with every slot in the scatter: sentinel slots add into
    a row of their own, dropped at the end."""
    import torch

    d = w.shape[-1]
    acc = torch.zeros((x.n_genes + 1, d), dtype=w.dtype, device=x.device)
    for r0 in range(0, x.rows_padded, block):
        ind = x.indices[r0:r0 + block]
        vals = x.data[r0:r0 + block, :, None] * w[r0:r0 + ind.shape[0],
                                                  None, :]
        part = torch.zeros_like(acc)
        part.index_add_(0, ind.reshape(-1), vals.reshape(-1, d))
        acc = acc + part
    return acc[:x.n_genes]


def turns(run) -> tuple[dict, float]:
    """``run(product)`` -> (result, s) in turns dropped, scattered,
    scattered, dropped: the times and the two results' largest
    difference over the largest entry."""
    from sctools_tpu_torch.data.sparse import spmm_t

    times = {"dropped": [], "scattered": []}
    out = {}
    for key in ("dropped", "scattered", "scattered", "dropped"):
        acc, s = run(spmm_t if key == "dropped" else scatter_all_slots)
        times[key].append(s)
        out.setdefault(key, acc)
    a, b = out["dropped"], out["scattered"]
    err = float(((a - b).abs().max() / b.abs().max()).item())
    smoke.check(err <= 1e-4, f"the two products differ by {err}")
    return times, err


def stream_case() -> dict:
    import torch

    from sctools_tpu_torch.data import stream as ST
    from sctools_tpu_torch.data.synthetic import DeviceSyntheticSource

    dev = torch.device(smoke.DEVICE)
    src = DeviceSyntheticSource(
        smoke.STREAM_CELLS, smoke.STREAM_GENES,
        capacity=smoke.STREAM_CAPACITY, shard_rows=smoke.STREAM_SHARD_ROWS,
        n_clusters=8, seed=0, device=dev)
    stats = ST.stream_stats(src)
    genes = ST.stream_hvg(stats, n_top=smoke.STREAM_TOP,
                          flavor="seurat_v3", src=src)
    g_sub = len(genes)
    mapping = np.full(src.n_genes + 1, g_sub, np.int32)
    mapping[genes] = np.arange(g_sub, dtype=np.int32)
    mapping = torch.from_numpy(mapping).to(dev)
    mu = torch.from_numpy(
        stats["gene_mean"][genes].astype(np.float32)).to(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    Q = torch.randn((src.n_shards * src.shard_rows, L), generator=gen,
                    device=dev) / float(np.sqrt(src.n_cells))
    Q[src.n_cells:] = 0.0

    def run(product):
        smoke.sync()
        t0 = time.perf_counter()
        acc = torch.zeros((g_sub, L), device=dev)
        for off, sh in src:
            sub = ST._normalised_subset(sh, mapping, 1e4, g_sub)
            Qm = torch.where(sub.row_mask()[:, None],
                             Q[off:off + sh.rows_padded], 0.0)
            acc = acc + product(sub, Qm) - torch.outer(mu, Qm.sum(dim=0))
        smoke.sync()
        return acc, time.perf_counter() - t0

    times, err = turns(run)
    slots = sum(sh.indices.numel() for _, sh in src)
    return {"shape": "stream", "cells": src.n_cells, "genes": src.n_genes,
            "g_sub": g_sub, "slots": slots, "sweep_s": times,
            "max_rel_diff": err}


def main_case() -> dict:
    import torch

    from sctools_tpu_torch import Pipeline
    from sctools_tpu_torch.data.synthetic import synthetic_counts

    dev = torch.device(smoke.DEVICE)
    ds = synthetic_counts(smoke.MAIN_CELLS, smoke.MAIN_GENES, density=0.02,
                          n_clusters=10, seed=0)
    steps = [s for s in smoke.MAIN_STEPS if s[0] != "pca.randomized"
             and s[0] != "neighbors.knn"]
    X = Pipeline(steps).run(ds, device=dev).X
    gen = torch.Generator(device=dev).manual_seed(0)
    Q = torch.randn((X.rows_padded, L), generator=gen, device=dev)
    Q[X.n_cells:] = 0.0

    def run(product):
        smoke.sync()
        t0 = time.perf_counter()
        acc = product(X, Q)
        smoke.sync()
        return acc, time.perf_counter() - t0

    times, err = turns(run)
    return {"shape": "main", "cells": X.n_cells, "genes": X.n_genes,
            "capacity": X.capacity,
            "stored": int((X.indices != X.sentinel).sum().item()),
            "slots": X.indices.numel(), "product_s": times,
            "max_rel_diff": err}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("stream_sweep.py: no CUDA device", file=sys.stderr)
        return 1
    print(smoke.smi_line(), flush=True)
    for case in (stream_case, main_case):
        print(json.dumps(case()), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
