#!/usr/bin/env python3
"""The gene-axis segment sums of ``sparse.segment_reduce`` on one NVIDIA
card: atomics against the fixed-order sort, by first-level block size.

    python3 segment_sweep.py        # from the repository root

``segment_reduce`` sums per-slot values by gene id over 2048-row chunks
of a padded-ELL matrix (the per-gene sums of QC, HVG and the streamed
stats).  The port adds each chunk's slots in a fixed order
(``_gene_segment_sum``: a stable sort by block of ``_SEG_ROWS`` rows and
gene id, ``torch.segment_reduce``, then a sum over the blocks), so that
the sums repeat their bits.  This script times ``sparse.gene_stats``
(three sums a slot) with that order at ``_SEG_ROWS`` 2048 (one block a
chunk: each gene's slots of a chunk in one sequential loop), 256, 32 and
8, and with the ``index_add_`` scatter it replaced (a copy of the old
body kept here), in turns forward then backward, medians of 5 CUDA-event
timings after a warm-up, at two shapes:

* ``stream``: one shard of ``chip_smoke.py``'s streamed source (131,072
  cells × 28,672 genes, capacity 512, generated on the card);
* ``main``: the main path's raw counts (68,579 × 32,738, density 0.02).

Each fixed-order variant must give the same bits in two calls and agree
with ``index_add_`` within 1e-5 of the largest sum.  Prints the card's
name and power limit, then one JSON line per shape.
"""

from __future__ import annotations

import json
import sys

import numpy as np

import chip_smoke as smoke

SEG_ROWS = (2048, 256, 32, 8)


def index_add_sum(ind, vals, n_genes: int):
    """The scatter the fixed order replaced: every slot added into its
    gene's row by ``index_add_`` (sentinel slots into a dropped row)."""
    import torch

    part = torch.zeros((n_genes + 1, vals.shape[1]), dtype=vals.dtype,
                       device=vals.device)
    part.index_add_(0, ind.reshape(-1), vals)
    return part[:n_genes]


def shapes(dev) -> dict:
    from sctools_tpu_torch.data.synthetic import (DeviceSyntheticSource,
                                                  synthetic_counts)

    src = DeviceSyntheticSource(smoke.STREAM_SHARD_ROWS, smoke.STREAM_GENES,
                                capacity=smoke.STREAM_CAPACITY,
                                shard_rows=smoke.STREAM_SHARD_ROWS, seed=0,
                                device=dev)
    (_, shard), = list(src)
    raw = synthetic_counts(smoke.MAIN_CELLS, smoke.MAIN_GENES, density=0.02,
                           n_clusters=10, seed=0)
    return {"stream": shard, "main": raw.to_device(dev).X}


def sweep(x) -> dict:
    import torch

    from sctools_tpu_torch.data import sparse as S

    fixed = S._gene_segment_sum
    base = S._SEG_ROWS
    variants = [f"seg_rows={r}" for r in SEG_ROWS] + ["index_add_"]

    def use(name):
        if name == "index_add_":
            S._gene_segment_sum = index_add_sum
        else:
            S._gene_segment_sum = fixed
            S._SEG_ROWS = int(name.split("=")[1])

    def run():
        return torch.stack(S.gene_stats(x), dim=1)

    times = {v: [] for v in variants}
    outs = {}
    try:
        for order in (variants, variants[::-1]):
            for v in order:
                use(v)
                times[v] += smoke.cuda_times(run, reps=5)
                outs.setdefault(v, []).append(run())
    finally:
        S._gene_segment_sum = fixed
        S._SEG_ROWS = base
    ref = outs["index_add_"][0]
    scale = float(ref.abs().max())
    rows = {}
    for v in variants:
        a, b = outs[v]
        err = float((a - ref).abs().max()) / scale
        repeat = bool(torch.equal(a, b))
        if v != "index_add_":
            smoke.check(repeat, f"{v}: two calls differ")
            smoke.check(err <= 1e-5, f"{v}: {err} from index_add_")
        rows[v] = {"ms": float(np.median(times[v])), "ms_reps": times[v],
                   "repeats_bitwise": repeat, "max_rel_diff": err}
    return rows


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("segment_sweep: no CUDA device is available", file=sys.stderr)
        return 2
    card = smoke.smi_line()
    print(card, flush=True)
    dev = torch.device("cuda")
    for name, x in shapes(dev).items():
        print(json.dumps({"shape": name, "card": card, "rows": x.rows_padded,
                          "genes": x.n_genes, "capacity": x.capacity,
                          "variants": sweep(x)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
