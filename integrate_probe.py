#!/usr/bin/env python3
"""Phase ``integrate`` of ``chip_smoke.py`` on its own, at a chosen size
and batch-factor strength, reporting its checks instead of stopping.

    python3 integrate_probe.py                        # the card, full width
    python3 integrate_probe.py --cells 32000 --device cpu --sigma 0.5,1.0

For each σ it cuts ``synthetic_counts(cells, 32,738, density=0.02,
n_clusters=10, seed=0)`` into four batches with the per-gene factor
exp(σ·N(0, 1)) (``chip_smoke.integrate_batches``), runs
``chip_smoke.integrate_phase`` (its JSON lines: walls, launches, the
batch mixing and cluster purity of each embedding, ingest's transfer,
then the card-against-CPU compare on the cut) and prints each check
that failed.  On the CPU the launch checks fail by design (the plain
versions launch no kernel).  With ``--rows`` it adds the phase's
``knn_select`` rows of the kernels line (the card only).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import chip_smoke as cs


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cells", type=int, default=cs.MAIN_CELLS)
    ap.add_argument("--sigma", default=str(cs.INTEGRATE_SIGMA))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--cut", type=int, default=cs.INTEGRATE_CUT)
    ap.add_argument("--rows", action="store_true")
    args = ap.parse_args()

    import torch

    from sctools_tpu_torch.data.synthetic import synthetic_counts

    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("integrate_probe: no CUDA device", file=sys.stderr)
            return 2
        card = cs.card_phase()
    else:
        card = f"cpu ({args.device})"
        cs.DEVICE = args.device
        cs.sync = lambda: None
        torch.cuda.synchronize = lambda *a, **k: None
        torch.cuda.reset_peak_memory_stats = lambda *a, **k: None
        torch.cuda.max_memory_allocated = lambda *a, **k: 0
    failed = []

    def check(ok: bool, msg: str) -> None:
        if not ok:
            failed.append(msg)

    cs.check = check
    cs.INTEGRATE_CUT = args.cut
    t0 = time.perf_counter()
    raw = synthetic_counts(args.cells, cs.MAIN_GENES, density=0.02,
                           n_clusters=10, seed=0)
    cs.emit({"probe": "generate", "s": time.perf_counter() - t0})
    try:
        for sigma in (float(x) for x in args.sigma.split(",")):
            failed.clear()
            integ = cs.integrate_phase({"raw": raw}, card, sigma=sigma)
            integ["finish"]()  # the card-against-CPU compare on the cut
            print(json.dumps({"sigma": sigma, "failed_checks": failed}),
                  flush=True)
            if args.rows and args.device == "cuda":
                peaks = cs.bounds_phase()
                cs.emit({"kernels": cs.integrate_kernel_rows(integ, card,
                                                             peaks)})
            del integ
    finally:
        if cs._POOL:
            cs._POOL[0].shutdown(wait=True, cancel_futures=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
