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
single device (graph_matvec 3 × P² or 3 × P launches); then configs[4]'s
streamed composition: ``stream_pipeline(mesh=make_mesh(), k=15)`` on
the 1.3M × 28,672 stand-in (``DeviceSyntheticSource``, materialized on
cuda:0) against the single-device streamed path, with
``chip_smoke.stream_mesh_phase``'s checks (obs bit for bit, HVG
near-ties only, explained variance rtol 1e-3, recall@10 ≥ 0.99 of the
single device's ids and of the float64 oracle on 1,024 cells,
knn_select P² times, the stats pass twice); and the in-memory ops on
cell-sharded data: ``shard_celldata`` of configs[1]'s 68,579 × 32,738
counts over ``make_mesh()`` through QC → library size → log1p → HVG →
PCA, with ``chip_smoke.sharded_phase``'s checks (obs bit for bit, HVG
near-ties only, explained variance rtol 1e-3).  Each kNN and MAGIC run is
timed at its second call, to the drain of every card: the first starts
the cards; the streamed runs follow them, on started cards.  Last,
on two or more cards, ``init_distributed`` in two processes of one
card each over NCCL (``coordination_sum`` and an all-reduce).  Prints
one JSON line a check, with the cards' name and power limit, and exits
non-zero on a failed check or without a CUDA device.
"""

from __future__ import annotations

import sys
import time

import numpy as np

import chip_smoke
from chip_smoke import (DIM, MAGIC_T, MAIN_CELLS, MAIN_GENES,
                        STREAM_CAPACITY, STREAM_CELLS, STREAM_CHUNK,
                        STREAM_GENES, STREAM_REFINE, STREAM_SHARD_ROWS,
                        STREAM_TOP, WIDE_CANDS, check, emit, mesh_launches,
                        sharded_phase, smi_line, stream_mesh_phase)

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


def stream_checks(mesh, card: str, dev) -> dict:
    """The single-device streamed path (stats, HVG scores, PCA, chunked
    kNN) on the stand-in, then ``stream_mesh_phase`` over ``mesh``."""
    import torch

    from sctools_tpu_torch.data import stream as ST
    from sctools_tpu_torch.data.synthetic import DeviceSyntheticSource

    src = DeviceSyntheticSource(
        STREAM_CELLS, STREAM_GENES, capacity=STREAM_CAPACITY,
        shard_rows=STREAM_SHARD_ROWS, n_clusters=8, seed=0, device=dev)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    one = ST.stream_pipeline(src, k=15, seed=0, n_top=STREAM_TOP,
                             n_components=DIM, knn_chunk=STREAM_CHUNK,
                             refine=STREAM_REFINE, device=dev)
    torch.cuda.synchronize(dev)
    path_s = time.perf_counter() - t0
    stats = ST.stream_stats(src)
    scores = ST.stream_hvg_scores(stats, src=src)
    check(np.array_equal(np.sort(np.argsort(-scores, kind="stable")
                                 [:STREAM_TOP]), one["hvg_genes"]),
          "single-device stream: HVG genes differ from its scores' top")
    stream = {"src": src, "stats": stats, "path_s": path_s,
              "hvg": (one["hvg_genes"], scores),
              "ev": one["pca_explained_variance"].cpu().numpy(),
              "idx": one["knn_indices"]}
    label = f"{mesh.size} card(s)"
    return stream_mesh_phase(stream, card, meshes={label: mesh})


def sharded_checks(mesh, card: str) -> dict:
    """``chip_smoke.sharded_phase`` over ``mesh`` on the main phase's
    seeded raw counts."""
    from sctools_tpu_torch.data.synthetic import synthetic_counts

    raw = synthetic_counts(MAIN_CELLS, MAIN_GENES, density=0.02,
                           n_clusters=10, seed=0)
    return sharded_phase(raw, card, mesh=mesh,
                         label=f"{mesh.size} card(s)")


BRINGUP_CHILD = """
import sys, torch, torch.distributed as dist
from sctools_tpu_torch.parallel.mesh import coordination_sum, init_distributed
pid, port = int(sys.argv[1]), sys.argv[2]
info = init_distributed(f"127.0.0.1:{port}", num_processes=2,
                        process_id=pid, timeout_s=60)
assert info["num_processes"] == 2 and info["process_id"] == pid, info
total = coordination_sum(float(pid + 1), "probe")
t = torch.full((4,), float(pid + 1), device="cuda")
dist.all_reduce(t)
torch.cuda.synchronize()
assert total == 3.0 and bool((t == 3.0).all()), (total, t)
dist.destroy_process_group()
print("OK", pid, info["global_devices"], flush=True)
"""


def bringup_checks(card: str) -> dict:
    """``init_distributed`` on the card: two processes, one card each
    (``CUDA_VISIBLE_DEVICES``), join an NCCL group over a ``TCPStore``
    on localhost; ``coordination_sum`` and an NCCL all-reduce each give
    3.  Each process has 120 s."""
    import os
    import socket
    import subprocess

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-c", BRINGUP_CHILD, str(i), str(port)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=here, env={**os.environ, "CUDA_VISIBLE_DEVICES": str(i),
                       "PYTHONPATH": here}) for i in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120)[0])
    except subprocess.TimeoutExpired:
        outs.append("timed out")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    for i, (p, out) in enumerate(zip(procs, outs)):
        check(p.returncode == 0 and f"OK {i} 2" in out,
              f"init_distributed on NCCL, process {i}: {out[-1500:]}")
    row = {"phase": "bringup", "card": card, "backend": "nccl",
           "processes": 2, "s": wall}
    emit(row)
    return row


def main() -> int:
    try:
        return run()
    finally:
        if chip_smoke._POOL:  # no CPU job is left running
            chip_smoke._POOL[0].shutdown(wait=True, cancel_futures=True)


def run() -> int:
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
    stream_checks(mesh, card, dev)
    sharded_checks(mesh, card)
    if torch.cuda.device_count() >= 2:
        bringup_checks(card)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
