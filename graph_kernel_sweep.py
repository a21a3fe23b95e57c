#!/usr/bin/env python3
"""Tile and slab sweep of the graph gather kernels on one NVIDIA card.

    python3 graph_kernel_sweep.py        # from the repository root
    python3 graph_kernel_sweep.py --ab PARENT_ROOT

``graph_matvec`` and ``graph_rmatvec`` (``sctools_tpu_torch/csrc``) take
two compile-time sizes from ``graph_gather.cuh``: the column tile a lane
group walks its pairs for (TILE_COLS) and the L2 slab the grid sweeps
x in (SLAB_BYTES).  This script compiles each kernel's launcher once
more, with both sizes as arguments, into a library of its own under
``sctools_tpu_torch/_build/`` and times it at the paths' widest shapes:
68,579 rows with k = 15 random neighbour ids (the natural order of the
synthetic clusters, whose labels are random), x of 914 columns
(SEACells) and 2000 (MAGIC), and d = 1 and 10.  Each time is the median
of 10 CUDA-event timings; every configuration must give the shipped
kernel's bits, and ``torch.sparse.mm`` on the CSR matrix (true
float32) is timed beside it.  ``graph_jaccard`` is timed on the same
graph: CUDA-event ms, host µs to enqueue a launch and until the card has
run it, and ``torch.profiler`` device µs of its kernel.  Prints one JSON
line per shape and the card's name and power limit first.

``--ab PARENT_ROOT`` times ``graph_jaccard`` against the one of a
checkout of another commit (``git archive`` of it, unpacked at
PARENT_ROOT) in one process: on the random graph and on one whose rows
repeat no id, as kNN lists do, in turns parent, this tree, this tree,
parent (CUDA-event ms of one call, 10 each), with each kernel's
profiler device µs; the two must give equal bits.
"""

from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

import chip_smoke as smoke

N, K = 68_579, 15
TILES = (32, 64, 128)
SLABS_MB = (8, 16, 24, 40, 1 << 20)  # 1 << 20 MB: one slab, no sweep
REPS = 10

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
PROBES = {
    # entry point: (kernel source, launcher, C arguments before the sizes)
    "sweep_rmatvec": ("graph_rmatvec.cu", "graph_rmatvec_launch",
                      "const void* a0, const void* a1, const void* a2, "
                      "const void* a3, int a4, int a5, int a6, void* a7, "
                      "void* a8", [_P, _P, _P, _P, _I, _I, _I, _P, _P]),
    "sweep_matvec": ("graph_matvec.cu", "graph_matvec_launch",
                     "const void* a0, const void* a1, const void* a2, "
                     "int a3, int a4, int a5, int a6, void* a7, void* a8",
                     [_P, _P, _P, _I, _I, _I, _I, _P, _P]),
}


def build_probe() -> ctypes.CDLL:
    from sctools_tpu_torch import cuda_build

    out_dir = cuda_build.BUILD_DIR / "sweep"
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = cuda_build.nvcc_path()
    objs = []
    for name, (src, launcher, params, _) in PROBES.items():
        if launcher not in (cuda_build.CSRC / src).read_text():
            continue  # a kernel without the sized launcher
        tu = out_dir / f"{name}.cu"
        args = ", ".join(f"a{i}" for i in range(params.count(",") + 1))
        tu.write_text(
            f'#include "{cuda_build.CSRC / src}"\n'
            f'extern "C" int {name}({params}, int tile_cols, '
            f"long long slab_bytes) {{\n"
            f"  return {launcher}({args}, tile_cols, slab_bytes);\n}}\n")
        obj = out_dir / f"{name}.o"
        subprocess.run([nvcc, *cuda_build.ARCH_FLAGS, "-std=c++17", "-O3",
                        "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-c",
                        str(tu), "-o", str(obj)], check=True)
        objs.append(str(obj))
    lib_path = out_dir / "libsweep.so"
    subprocess.run([nvcc, *cuda_build.ARCH_FLAGS, "-shared", "-o",
                    str(lib_path), *objs], check=True)
    lib = ctypes.CDLL(str(lib_path))
    for name, (*_, argtypes) in PROBES.items():
        if not hasattr(lib, name):
            continue
        fn = getattr(lib, name)
        fn.argtypes = argtypes + [_I, _L]
        fn.restype = _I
    return lib


def event_ms(fn) -> list:
    """REPS CUDA-event timings (ms, sorted) of one call of ``fn`` each,
    after one untimed call."""
    import torch

    fn()
    times = []
    for _ in range(REPS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)


def cuda_ms(fn) -> float:
    return statistics.median(event_ms(fn))


def guard(dev) -> None:
    import torch

    with torch.cuda.device(dev):
        pass


def graphs(dev) -> dict:
    """The random 68,579 × 15 graph of the sweep (seed 0; every 13th row
    pads slot 3) and one whose rows repeat no id: row r lists (7 r + p)
    mod N for 15 distinct offsets p, drawn per r mod 64."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(0)
    rand = torch.randint(0, N, (N, K), generator=gen, device=dev,
                         dtype=torch.int32)
    rand[::13, 3] = -1
    offs = torch.stack([torch.randperm(N, generator=torch.Generator()
                                       .manual_seed(i))[:K]
                        for i in range(64)]).to(dev)
    rows = torch.arange(N, device=dev)
    distinct = ((rows[:, None] * 7 + offs[rows % 64]) % N).to(torch.int32)
    return {"random": rand, "distinct": distinct.contiguous()}


def ab(parent_root: str) -> int:
    import importlib

    import torch

    from sctools_tpu_torch.ops import graph_kernels as GK

    print(smoke.smi_line(), flush=True)
    smoke.load_package(parent_root, "sct_parent")
    parent = importlib.import_module("sct_parent.ops.graph_kernels")
    for name, idx in graphs(torch.device("cuda")).items():
        a, b = parent.jaccard(idx), GK.jaccard(idx)
        torch.cuda.synchronize()
        if not (torch.equal(a, b) and torch.equal(b, GK.jaccard_plain(idx))):
            raise SystemExit(f"jaccard ({name}): bits differ")
        runs = {"parent": parent.jaccard, "this": GK.jaccard}
        turns = [[who, event_ms(lambda f=runs[who]: f(idx))]
                 for who in ("parent", "this", "this", "parent")]
        print(json.dumps({
            "kernel": "graph_jaccard", "graph": name, "n": N, "k": K,
            "bitwise_equal": True, "event_ms_in_turns": turns,
            "device_us": smoke.device_us({w: (lambda f=f: f(idx))
                                    for w, f in runs.items()}),
            "host_us_enqueue_then_done": {
                w: smoke.host_us(lambda f=f: f(idx))
                for w, f in runs.items()}}),
            flush=True)
    return 0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("graph_kernel_sweep: no CUDA device", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--ab"]:
        return ab(sys.argv[2])
    from sctools_tpu_torch.config import true_f32
    from sctools_tpu_torch.ops import graph_kernels as GK

    print(smoke.smi_line(), flush=True)
    lib = build_probe()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    idx = torch.randint(0, N, (N, K), generator=gen, device=dev,
                        dtype=torch.int32)
    w = torch.rand((N, K), generator=gen, device=dev)
    order = GK.rmatvec_order(idx, N)
    rows = torch.arange(N, device=dev).repeat_interleave(K)
    pair = torch.stack([rows, idx.reshape(-1).long()])
    csr = {}
    for name, ij in (("matvec", pair), ("rmatvec", pair.flip(0))):
        csr[name] = torch.sparse_coo_tensor(
            ij, w.reshape(-1), (N, N)).coalesce().to_sparse_csr()
    stream = torch.cuda.current_stream().cuda_stream
    probes = {
        "rmatvec": (lambda x: GK.rmatvec(idx, w, x, N, order=order),
                    lambda x, y, tile, slab: lib.sweep_rmatvec(
                        order[0].data_ptr(), order[1].data_ptr(),
                        w.data_ptr(), x.data_ptr(), K, N, x.shape[1],
                        y.data_ptr(), stream, tile, slab)),
    }
    if hasattr(lib, "sweep_matvec"):
        probes["matvec"] = (
            lambda x: GK.matvec(idx, w, x),
            lambda x, y, tile, slab: lib.sweep_matvec(
                idx.data_ptr(), w.data_ptr(), x.data_ptr(), N, K, N,
                x.shape[1], y.data_ptr(), stream, tile, slab))
    for d in (914, 2000, 10, 1):
        x = torch.randn((N, d), generator=gen, device=dev)
        for name, (shipped, raw) in probes.items():
            want = shipped(x)
            y = torch.empty_like(want)
            res = {"kernel": f"graph_{name}", "n": N, "k": K, "d": d,
                   "shipped_ms": cuda_ms(lambda: shipped(x))}
            with true_f32():
                res["library_ms"] = cuda_ms(
                    lambda: torch.sparse.mm(csr[name], x))
            sweep = {}
            for tile in TILES:
                for mb in SLABS_MB:
                    def run():
                        code = raw(x, y, tile, mb << 20)
                        if code:
                            raise RuntimeError(f"CUDA error {code}")
                    run()
                    torch.cuda.synchronize()
                    if not torch.equal(y, want):
                        raise SystemExit(
                            f"{name} d={d} tile {tile} slab {mb} MB: other "
                            "bits than the shipped kernel")
                    sweep[f"tile{tile}_slab{mb}MB"] = cuda_ms(run)
            res["sweep_ms"] = sweep
            if d <= 10:
                def lib_call():
                    with true_f32():
                        torch.sparse.mm(csr[name], x)
                res["host_us_enqueue_then_done"] = {
                    "shipped": smoke.host_us(lambda: shipped(x)),
                    "raw": smoke.host_us(lambda: raw(x, y, 64, 24 << 20)),
                    "library": smoke.host_us(lib_call)}
                res["device_us"] = smoke.device_us(
                    {"shipped": lambda: shipped(x), "library": lib_call})
            print(json.dumps(res), flush=True)
    jaccard = lambda: GK.jaccard(idx)  # noqa: E731
    print(json.dumps({
        "kernel": "graph_jaccard", "n": N, "k": K,
        "event_ms": cuda_ms(jaccard),
        "host_us_enqueue_then_done": smoke.host_us(jaccard),
        "device_us": smoke.device_us({"shipped": jaccard})["shipped"]}),
        flush=True)
    pieces = {
        "current_stream": lambda: torch.cuda.current_stream(dev).cuda_stream,
        "device_guard": lambda: guard(dev),
        "empty_68579x1": lambda: torch.empty((N, 1), device=dev),
        "to_contiguous": lambda: w.to(torch.float32).contiguous(),
    }
    print(json.dumps({"wrapper_pieces_host_us": {
        k: smoke.host_us(f, 2000)[0] for k, f in pieces.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    sys.exit(main())
