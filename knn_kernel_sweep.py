#!/usr/bin/env python3
"""Size sweep and parent comparison of the kNN kernels on one NVIDIA
card.

    python3 knn_kernel_sweep.py                     # from the repo root
    python3 knn_kernel_sweep.py --binned
    python3 knn_kernel_sweep.py --sass-only LIB.so [LIB.so ...]
    python3 knn_kernel_sweep.py --ab PARENT_ROOT

``csrc/knn_select.cu`` and ``csrc/knn_binned.cu`` share their core
(``csrc/knn_core.cuh``) and take six compile-time sizes as ``-D`` macros:
score rows and columns a lane (KNN_TM, KNN_TN: the query tile is
16·TM rows, the candidate tile 16·TN), candidate splits (KNN_SPLITS)
the most feature rows a stage holds (KNN_KC), the stages in flight
(KNN_RING) and the blocks an SM its registers must allow (KNN_MINB), and
optionally a seventh, the feature rows a turn of the score loop
(KNN_UNROLL, 2 unless a variant names it).  The sweep
compiles ``knn_select.cu`` (or, with ``--binned``, ``knn_binned.cu``, whose
SPLITS is the most bin-chunk splits) once more for each of VARIANTS (or
BINNED_VARIANTS) into a library of its
own under ``sctools_tpu_torch/_build/sweep/`` (all compilers started
together), and times each through its own ``sct_knn_select`` (or
``sct_knn_binned`` with 1024 bins) at the
main shape (68,579 × 68,579 × 50, k = 15, f32 cosine, on ten Gaussian
clusters made from seed 0) and at configs[3]'s width (65,536 × 1.3M ×
50, k = 15, fifty clusters).  Each time is the median of CUDA-event
timings of one call (packing included, as the wrapper packs).  Every
variant must give the shipped kernel's bits: all of them compute every
score by the same fmaf chain and select by the same order.

It prints the card's name and power limit first, then one JSON line per
variant (ms at both shapes, ``ptxas`` registers and spill stores of the
K = 16 and K = 32 kernels), the shipped wrapper's CUDA-event ms against
``torch.profiler`` device µs per kernel (pack copies, score, merge),
the SM clock and power under load, and the SASS of the shipped build's
inner loop: the instructions of the K = 16 kernel's score loop (the loop
with the largest FFMA share), and their FFMA share.  ``--sass-only`` prints only that for
the libraries named, for instance one built from another commit.

``--ab PARENT_ROOT`` compares the shipped kernels with those of a
checkout of another commit (``git archive`` of it, unpacked at
PARENT_ROOT) in one process on one card: the main path's 50-PC
embedding (QC → HVG → PCA of the 68,579 × 32,738 synthetic counts, as
``chip_smoke.py`` runs it; also ``knn_select`` at k = 393 and
``knn_binned`` at k = 300, whose lists wait in device memory), then
both widths of configs[3] (f32 k = 15
and bf16 k = 32) for ``knn_select``, and ``knn_binned`` on the embedding
at AB_BINS_MAIN bins and on the f32 width at AB_BINS_WIDE, in turns
parent, this tree, this tree, parent.  The two trees' kernels must give
equal bits.
"""

from __future__ import annotations

import ctypes
import importlib
import json
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

MAIN_N, WIDE_Q, WIDE_C, DIM, K = 68_579, 65_536, 1_300_000, 50, 15
# (rows a lane, columns a lane, splits, most feature rows a stage, stages
# in flight at most, blocks an SM the registers must allow)
VARIANTS = ((4, 8, 2, 64, 2, 2), (4, 8, 1, 64, 2, 2), (4, 8, 4, 64, 2, 2),
            (4, 8, 2, 64, 2, 1), (8, 8, 1, 64, 4, 1), (8, 8, 2, 64, 4, 1),
            (8, 8, 4, 64, 4, 1), (8, 4, 2, 64, 2, 2), (4, 4, 2, 64, 2, 2),
            (4, 4, 4, 64, 2, 2))
# knn_binned.cu: splits are the most bin-chunk splits (1024 bins: 8
# chunks of 128)
BINNED_VARIANTS = ((8, 8, 8, 64, 3, 1, 8), (8, 8, 8, 64, 3, 1, 2),
                   (8, 8, 8, 64, 3, 1, 4), (8, 8, 8, 64, 3, 1, 10),
                   (8, 8, 8, 64, 3, 1, 16), (8, 8, 8, 64, 3, 1, 25),
                   (8, 8, 4, 64, 3, 1, 8), (8, 8, 8, 64, 2, 1, 8),
                   (4, 8, 4, 64, 2, 2, 8), (4, 8, 4, 64, 2, 2, 16))
N_BINS = 1024
# The A/B's bin counts: config.knn_bins's default, larger settings (more
# bin chunks a split), and every candidate its own bin (68,579 rounded up
# to the 128-bin chunk).
AB_BINS_MAIN = (1024, 2048, 4096, 8192, 16384, 32768, 68608)
AB_BINS_WIDE = (1024, 16384)
REPS = 5

_P, _I = ctypes.c_void_p, ctypes.c_int
SELECT_ARGS = [_P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P]
BINNED_ARGS = [_P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P]
# the kernel, its source, its entry point and arguments, its layout entry
KERNELS = {
    "select": ("knn_select_kernel", "knn_select.cu", "sct_knn_select",
               SELECT_ARGS, "sct_knn_select_layout"),
    "binned": ("knn_binned_kernel", "knn_binned.cu", "sct_knn_binned",
               BINNED_ARGS, "sct_knn_binned_layout"),
}


def ptxas_regs(log: str, kernel: str = "knn_select_kernel") -> dict:
    """{kernel: [registers, spill store bytes, stack frame bytes]} of the
    K = 16 and 32 score kernels in ``-Xptxas -v`` output."""
    out = {}
    for m in re.finditer(r"Compiling entry function '(\S+)'.*?"
                         r"(\d+) bytes stack frame, (\d+) bytes spill "
                         r"stores.*?Used (\d+) registers", log, re.S):
        for kk in (16, 32):
            if f"{kernel}ILi{kk}E" in m.group(1):
                out[f"K{kk}"] = [int(m.group(4)), int(m.group(3)),
                                 int(m.group(2))]
    return out


def build_variants(which: str = "select") -> dict:
    """One library per variant of ``csrc/knn_select.cu`` (or
    ``knn_binned.cu``); returns {variant: (C entry, layout list, ptxas
    registers)}."""
    from sctools_tpu_torch import cuda_build

    kernel, source, entry, argtypes, layout_entry = KERNELS[which]
    variants = VARIANTS if which == "select" else BINNED_VARIANTS
    out_dir = cuda_build.BUILD_DIR / "sweep"
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = cuda_build.nvcc_path()
    src = cuda_build.CSRC / source

    def one(v):
        tm, tn, splits, kc, ring, minb, unroll = (*v, 2)[:7]
        tag = (f"knn_{which}_tm{tm}_tn{tn}_s{splits}_kc{kc}_r{ring}"
               f"_b{minb}_u{unroll}")
        lib = out_dir / f"lib{tag}.so"
        r = subprocess.run(
            [nvcc, *cuda_build.ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
             "-Xcompiler", "-fPIC", "-Xptxas", "-v", f"-DKNN_TM={tm}",
             f"-DKNN_TN={tn}", f"-DKNN_SPLITS={splits}", f"-DKNN_KC={kc}",
             f"-DKNN_RING={ring}", f"-DKNN_MINB={minb}",
             f"-DKNN_UNROLL={unroll}",
             str(src), "-o", str(lib)], capture_output=True, text=True)
        if r.returncode:
            raise RuntimeError(f"nvcc {tag}:\n{r.stdout}{r.stderr}")
        return v, lib, ptxas_regs(r.stdout + r.stderr, kernel)

    libs = {}
    with ThreadPoolExecutor(max_workers=8) as pool:
        for v, path, regs in pool.map(one, variants):
            lib = ctypes.CDLL(str(path))
            fn = getattr(lib, entry)
            fn.argtypes = argtypes
            fn.restype = _I
            lay = (ctypes.c_int * 10)()
            getattr(lib, layout_entry).argtypes = [_P]
            code = getattr(lib, layout_entry)(ctypes.addressof(lay))
            if code:
                raise RuntimeError(f"variant {v}: layout error {code}")
            libs[v] = (fn, list(lay), regs)
    return libs


def sass_loop(lib: Path) -> list:
    """For the K = 16 score kernels of ``lib``: the inner loop of the
    score core, the loop (a backward branch and the instructions from its
    target to it) with the largest FFMA share, its instruction count
    (NOPs left out), FFMA, LDS and the FFMA share."""
    from sctools_tpu_torch import cuda_build

    cuobjdump = Path(cuda_build.nvcc_path()).parent / "cuobjdump"
    text = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    out = []
    for fn in re.split(r"\n\s*Function : ", text)[1:]:
        name = fn.split("\n", 1)[0].strip()
        if not re.search(r"knn_(select|binned)_kernel\w*?Li16E", name):
            continue
        instr = [(int(m.group(1), 16), m.group(2).strip()) for m in
                 re.finditer(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", fn)]
        best = None
        for addr, op in instr:
            b = re.search(r"\bBRA\b.*?0x([0-9a-f]+)", op)
            if not b or int(b.group(1), 16) >= addr:
                continue
            body = [re.sub(r"^@!?U?P\w+\s+", "", o) for a, o in instr
                    if int(b.group(1), 16) <= a <= addr and "NOP" not in o]
            ffma = sum(o.startswith("FFMA") for o in body)
            if ffma >= 16 and (best is None or ffma / len(body)
                               > best["ffma_share"]):
                lds = sum(o.startswith("LDS") for o in body)
                best = {"kernel": name[:90], "instructions": len(body),
                        "ffma": ffma, "lds": lds,
                        "ffma_share": ffma / len(body)}
        if best:
            out.append(best)
    return out


def blobs(n: int, n_clusters: int):
    """Cosine-prepared float32 rows of ``gaussian_blobs`` (seed 0)."""
    import torch

    from sctools_tpu_torch.data.synthetic import gaussian_blobs
    from sctools_tpu_torch.ops.knn import _prep

    pts, _ = gaussian_blobs(n, DIM, n_clusters=n_clusters, seed=0)
    return _prep(torch.from_numpy(pts).cuda(), "cosine", torch.float32)


def sweep(which: str = "select") -> int:
    import torch

    import chip_smoke as smoke
    import tsne_kernel_sweep as tks
    from sctools_tpu_torch import cuda_build
    from sctools_tpu_torch.ops import knn_kernel as KK

    print(smoke.smi_line(), flush=True)
    cmain = blobs(MAIN_N, 10)
    cwide = blobs(WIDE_C, 50)
    qwide = cwide[:WIDE_Q]
    shapes = {"main": (cmain, cmain), "wide": (qwide, cwide)}
    if which == "select":
        shipped = KK.knn_select
        kw = {}
        layout = KK.knn_select_layout()
    else:
        shipped = KK.knn_binned
        kw = {"n_bins": N_BINS}
        layout = KK.knn_binned_layout()
    want = {s: shipped(q, c, k=K, **kw) for s, (q, c) in shapes.items()}
    print(json.dumps({"kernel": which, "shipped": layout,
                      "sass": sass_loop(cuda_build.library_path())}),
          flush=True)
    for s, (q, c) in shapes.items():
        call = lambda: shipped(q, c, k=K, **kw)  # noqa: E731
        print(json.dumps({
            "kernel": f"knn_{which} (shipped wrapper)", "shape": s,
            "event_ms": smoke.cuda_times(call, REPS),
            "device_us": smoke.device_us({"shipped": call}, calls=5)[
                "shipped"],
            "sm_clock_power_under_load": tks.clocks_under_load(call)
            if s == "main" else None}), flush=True)

    t0 = time.perf_counter()
    libs = build_variants(which)
    build_s = time.perf_counter() - t0
    stream = torch.cuda.current_stream().cuda_stream
    best = None
    for v, (fn, lay, regs) in libs.items():
        res = {"kernel": which, "rows_a_lane": v[0], "cols_a_lane": v[1],
               "splits": v[2], "kc": v[3], "ring": v[4], "min_blocks": v[5],
               "unroll": (*v, 2)[6],
               "tile": lay[:2],
               "ptxas_registers_spill_stack_bytes": regs,
               "layout_registers_local_bytes_k16": lay[6:8], "ms": {}}
        for s, (q, c) in shapes.items():
            nq, d = q.shape
            out_v = torch.empty((nq, K), device=q.device)
            out_i = torch.empty((nq, K), dtype=torch.int32, device=q.device)
            scratch = torch.empty((2 * lay[2] * nq * K,), device=q.device)
            extra = () if which == "select" else (N_BINS,)

            def run():
                qp = KK.pack_tiles(q, lay[0])
                cp = qp if c is q and lay[0] == lay[1] else KK.pack_tiles(
                    c, lay[1])
                code = fn(qp.data_ptr(), cp.data_ptr(), nq, c.shape[0], d,
                          K, *extra, 0, 0, out_v.data_ptr(),
                          out_i.data_ptr(), scratch.data_ptr(), stream)
                if code:
                    raise RuntimeError(f"variant {v}: CUDA error {code}")

            run()
            torch.cuda.synchronize()
            smoke.check(torch.equal(out_v, want[s][0])
                        and torch.equal(out_i, want[s][1]),
                        f"variant {v} {s}: bits differ from the shipped "
                        "kernel's")
            res["ms"][s] = smoke.cuda_ms(run, REPS if s == "main" else 3)
        print(json.dumps(res), flush=True)
        if best is None or res["ms"]["main"] < best[0]:
            best = (res["ms"]["main"], v)
    print(json.dumps({"kernel": which, "build_s": build_s,
                      "best_main_ms": best[0],
                      "best": dict(zip(("rows_a_lane", "cols_a_lane",
                                        "splits", "kc", "ring",
                                        "min_blocks"), best[1]))}),
          flush=True)
    return 0


def main_embedding():
    """The main path's 50-PC embedding, cosine-prepared: the 68,579 ×
    32,738 synthetic counts through ``chip_smoke.MAIN_STEPS`` up to
    ``pca.randomized``."""
    import torch

    import chip_smoke as smoke
    from sctools_tpu_torch import Pipeline
    from sctools_tpu_torch.data.synthetic import synthetic_counts
    from sctools_tpu_torch.ops.knn import _prep

    ds = synthetic_counts(smoke.MAIN_CELLS, smoke.MAIN_GENES, density=0.02,
                          n_clusters=10, seed=0)
    out = Pipeline(smoke.MAIN_STEPS[:-1]).run(ds, device=torch.device(
        "cuda"))
    return _prep(out.obsm["X_pca"][:out.n_cells], "cosine", torch.float32)


def ab(parent_root: str) -> int:
    import torch

    import chip_smoke as smoke
    from sctools_tpu_torch.ops import knn_kernel as KK
    from sctools_tpu_torch.ops.knn import _prep

    print(smoke.smi_line(), flush=True)
    smoke.load_package(parent_root, "sct_parent")
    parent = importlib.import_module("sct_parent.ops.knn_kernel")
    x = main_embedding()
    cwide = blobs(WIDE_C, 50)
    main = "68579x68579x50 k=15 float32 (main path)"
    # k = 393 (lists in device memory: qc.doublet_score's k_adj) too
    cases = [("knn_select", main, x, x, 15, {}),
             ("knn_select", main.replace("k=15", "k=393"), x, x, 393, {}),
             ("knn_binned", main.replace("k=15", "k=300") + ", 1024 bins",
              x, x, 300, {"n_bins": 1024})]
    for dtype, k in ((torch.float32, 15), (torch.bfloat16, 32)):
        c = _prep(cwide, "cosine", dtype)
        cases.append(("knn_select",
                      f"{WIDE_Q}x{WIDE_C}x{DIM} k={k} {str(dtype)[6:]}",
                      c[:WIDE_Q], c, k, {}))
    for n_bins in AB_BINS_MAIN:
        cases.append(("knn_binned", main + f", {n_bins} bins", x, x, 15,
                      {"n_bins": n_bins}))
    for n_bins in AB_BINS_WIDE:
        cases.append(("knn_binned",
                      f"{WIDE_Q}x{WIDE_C}x{DIM} k=15 float32, {n_bins} bins",
                      cwide[:WIDE_Q], cwide, 15, {"n_bins": n_bins}))
    for name, shape, q, c, k, kw in cases:
        runs = {"parent": getattr(parent, name), "this": getattr(KK, name)}
        a = runs["parent"](q, c, k=k, **kw)
        b = runs["this"](q, c, k=k, **kw)
        torch.cuda.synchronize()
        smoke.check(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]),
                    f"{name} {shape}: this tree's bits differ from the "
                    "parent's")
        del a, b
        times = []
        for who in ("parent", "this", "this", "parent"):
            fn = runs[who]
            times.append([who, smoke.cuda_times(
                lambda: fn(q, c, k=k, **kw), REPS)])
        print(json.dumps({"kernel": name, "shape": shape,
                          "bitwise_equal": True,
                          "event_ms_in_turns": times}), flush=True)
    return 0


def main(argv: list) -> int:
    if argv[:1] == ["--sass-only"]:
        for lib in argv[1:]:
            print(json.dumps({"library": lib, "loops": sass_loop(Path(lib))}),
                  flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("knn_kernel_sweep: no CUDA device", file=sys.stderr)
        return 2
    if argv[:1] == ["--ab"]:
        return ab(argv[1])
    return sweep("binned" if argv[:1] == ["--binned"] else "select")


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    sys.exit(main(sys.argv[1:]))
