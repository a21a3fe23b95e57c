#!/usr/bin/env python3
"""The single-process mesh across cards: ``neighbors.knn_multichip`` and
``impute.magic(mesh=)`` over every visible card, against their
single-device results.

    python3 mesh_probe.py        # on a host with several cards

``chip_smoke.py`` phase ``mesh`` runs these paths on one card (4 shards
of cuda:0, and a mesh of every card, which is one card there); this
script runs them where the ring's chunk copies and the all-gather cross
devices.  On a seeded 1.3M × 50 embedding of Gaussian blobs
(``MESH_CELLS`` × ``DIM``): single-device ``neighbors.knn`` (k=15),
then ``neighbors.knn_multichip`` over ``make_mesh()`` with the ring and
with all_gather (ids bit for bit and recall ≥ 0.999 against the single
device, knn_select launched P² or P times); then a k=15 graph on the
first 68,579 cells and ``impute.magic(t=3)`` of a seeded 68,579 × 2000
matrix, over the mesh with both strategies, within atol 1e-4 of the
single device (graph_matvec 3 × P² or 3 × P launches).  Each run is
timed at its second call, to the drain of every card: the first starts
the cards.  Prints one JSON line a check, with the cards' name and
power limit, and exits non-zero on a failed check or without a CUDA
device.
"""

from __future__ import annotations

import sys
import time

import numpy as np

from chip_smoke import (DIM, MAGIC_T, MAIN_CELLS, WIDE_CANDS, check, emit,
                        mesh_launches, smi_line)

MESH_CELLS = WIDE_CANDS
MAGIC_GENES = 2000


def timed(transform, data, dev):
    """``transform(data)`` twice: the first call starts every card (its
    context, the kernels' modules, the allocator's pools), the second is
    timed to the drain of every card."""
    import torch

    transform(data, device=dev)
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)
    t0 = time.perf_counter()
    out = transform(data, device=dev)
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)
    return out, time.perf_counter() - t0


def knn_checks(mesh, card: str, dev) -> list:
    import torch

    from sctools_tpu_torch import Transform
    from sctools_tpu_torch.data.dataset import CellData
    from sctools_tpu_torch.data.synthetic import gaussian_blobs
    from sctools_tpu_torch.ops.knn import recall_at_k
    from sctools_tpu_torch.ops.knn_kernel import knn_select

    pts, _ = gaussian_blobs(MESH_CELLS, DIM, n_clusters=50, seed=0)
    n = pts.shape[0]
    data = CellData(torch.zeros((n, 1), device=dev),
                    obsm={"X_pca": torch.from_numpy(pts).to(dev)})
    single, single_s = timed(Transform("neighbors.knn", k=15), data, dev)
    one_i = single.obsp["knn_indices"][:n]
    one_d = single.obsp["knn_distances"][:n]
    rows = []
    for strategy in ("ring", "all_gather"):
        knn_select.launches = 0
        out, wall = timed(Transform("neighbors.knn_multichip", k=15,
                                    mesh=mesh, strategy=strategy), data,
                          dev)
        launches = knn_select.launches // 2
        want = mesh_launches(n, mesh.size, strategy)
        check(launches == want, f"knn_multichip {strategy}: {launches} "
                                f"knn_select launches, expected {want}")
        idx = out.obsp["knn_indices"][:n]
        dist = out.obsp["knn_distances"][:n]
        recall = recall_at_k(idx.cpu().numpy(), one_i.cpu().numpy())
        check(recall >= 0.999, f"knn_multichip {strategy}: recall "
                               f"{recall} against the single device")
        rows.append({"strategy": strategy, "s": wall,
                     "knn_select_launches": launches,
                     "recall_vs_single": recall,
                     "bitwise_equal_to_single": bool(
                         torch.equal(idx, one_i)
                         and torch.equal(dist, one_d))})
    emit({"phase": "mesh_knn", "card": card, "cells": n, "k": 15,
          "devices": [str(d) for d in mesh.devices],
          "single_knn_s": single_s, "runs": rows})
    return rows


def magic_checks(mesh, card: str, dev) -> list:
    import torch

    from sctools_tpu_torch import Transform
    from sctools_tpu_torch.data.dataset import CellData
    from sctools_tpu_torch.data.synthetic import gaussian_blobs
    from sctools_tpu_torch.ops import graph_kernels as GK

    pts, _ = gaussian_blobs(MAIN_CELLS, DIM, n_clusters=10, seed=1)
    x = np.random.default_rng(2).random((MAIN_CELLS, MAGIC_GENES),
                                        dtype=np.float32)
    data = CellData(torch.from_numpy(x).to(dev),
                    obsm={"X_pca": torch.from_numpy(pts).to(dev)})
    data = Transform("neighbors.knn", k=15)(data, device=dev)
    data = Transform("graph.diffusion_operator")(data, device=dev)
    ref = Transform("impute.magic", t=MAGIC_T)(data, device=dev)
    want = ref.obsm["X_magic"]
    rows = []
    for strategy in ("ring", "all_gather"):
        GK.matvec.launches = 0
        out, wall = timed(Transform("impute.magic", t=MAGIC_T, mesh=mesh,
                                    strategy=strategy), data, dev)
        launches = GK.matvec.launches // 2
        expect = MAGIC_T * (mesh.size ** 2 if strategy == "ring"
                            else mesh.size)
        check(launches == expect, f"impute.magic(mesh=) {strategy}: "
                                  f"{launches} launches, expected {expect}")
        err = float((out.obsm["X_magic"] - want).abs().max())
        check(err <= 1e-4, f"impute.magic(mesh=) {strategy}: max |error| "
                           f"{err} > 1e-4")
        rows.append({"strategy": strategy, "s": wall,
                     "matvec_launches": launches, "max_abs_err": err})
    emit({"phase": "mesh_magic", "card": card, "cells": MAIN_CELLS,
          "genes": MAGIC_GENES, "t": MAGIC_T,
          "devices": [str(d) for d in mesh.devices], "runs": rows})
    return rows


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("mesh_probe: no CUDA device is available", file=sys.stderr)
        return 2
    from sctools_tpu_torch import cuda_build
    from sctools_tpu_torch.parallel import make_mesh

    card = smi_line()
    print(card, flush=True)
    cuda_build.build()
    mesh = make_mesh()
    dev = torch.device("cuda", 0)
    knn_checks(mesh, card, dev)
    magic_checks(mesh, card, dev)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
