#!/usr/bin/env python3
"""Size sweep and parent comparison of the exact kNN kernel on one
NVIDIA card.

    python3 knn_kernel_sweep.py                     # from the repo root
    python3 knn_kernel_sweep.py --sass-only LIB.so [LIB.so ...]
    python3 knn_kernel_sweep.py --ab PARENT_ROOT

``csrc/knn_select.cu`` takes six compile-time sizes as ``-D`` macros:
score rows and columns a lane (KNN_TM, KNN_TN: the query tile is
16·TM rows, the candidate tile 16·TN), candidate splits (KNN_SPLITS)
the most feature rows a stage holds (KNN_KC), the stages in flight
(KNN_RING) and the blocks an SM its registers must allow (KNN_MINB).  The sweep
compiles the file once more for each of VARIANTS into a library of its
own under ``sctools_tpu_torch/_build/sweep/`` (all compilers started
together), and times each through its own ``sct_knn_select`` at the
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

``--ab PARENT_ROOT`` compares the shipped kernel with the one of a
checkout of another commit (``git archive`` of it, unpacked at
PARENT_ROOT) in one process on one card: the main path's 50-PC
embedding (QC → HVG → PCA of the 68,579 × 32,738 synthetic counts, as
``chip_smoke.py`` runs it), then both widths of configs[3] (f32 k = 15
and bf16 k = 32), in turns parent, this tree, this tree, parent.  The
two kernels must give equal bits.
"""

from __future__ import annotations

import ctypes
import importlib
import importlib.util
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
REPS = 5

_P, _I = ctypes.c_void_p, ctypes.c_int
SELECT_ARGS = [_P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P]


def smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout
    return out.strip().splitlines()[0]


def ptxas_regs(log: str) -> dict:
    """{kernel: [registers, spill store bytes]} of the K = 16 and 32
    score kernels in ``-Xptxas -v`` output."""
    out = {}
    for m in re.finditer(r"Compiling entry function '(\S+)'.*?"
                         r"(\d+) bytes spill stores.*?Used (\d+) registers",
                         log, re.S):
        for kk in (16, 32):
            if f"knn_select_kernelILi{kk}E" in m.group(1):
                out[f"K{kk}"] = [int(m.group(3)), int(m.group(2))]
    return out


def build_variants() -> dict:
    """One library per variant of ``csrc/knn_select.cu``; returns
    {variant: (sct_knn_select, layout dict, ptxas registers)}."""
    from sctools_tpu_torch import cuda_build

    out_dir = cuda_build.BUILD_DIR / "sweep"
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = cuda_build.nvcc_path()
    src = cuda_build.CSRC / "knn_select.cu"

    def one(v):
        tm, tn, splits, kc, ring, minb = v
        tag = f"knn_tm{tm}_tn{tn}_s{splits}_kc{kc}_r{ring}_b{minb}"
        lib = out_dir / f"lib{tag}.so"
        r = subprocess.run(
            [nvcc, *cuda_build.ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
             "-Xcompiler", "-fPIC", "-Xptxas", "-v", f"-DKNN_TM={tm}",
             f"-DKNN_TN={tn}", f"-DKNN_SPLITS={splits}", f"-DKNN_KC={kc}",
             f"-DKNN_RING={ring}", f"-DKNN_MINB={minb}",
             str(src), "-o", str(lib)], capture_output=True, text=True)
        if r.returncode:
            raise RuntimeError(f"nvcc {tag}:\n{r.stdout}{r.stderr}")
        return v, lib, ptxas_regs(r.stdout + r.stderr)

    libs = {}
    with ThreadPoolExecutor(max_workers=8) as pool:
        for v, path, regs in pool.map(one, VARIANTS):
            lib = ctypes.CDLL(str(path))
            fn = lib.sct_knn_select
            fn.argtypes = SELECT_ARGS
            fn.restype = _I
            lay = (ctypes.c_int * 10)()
            lib.sct_knn_select_layout.argtypes = [_P]
            code = lib.sct_knn_select_layout(ctypes.addressof(lay))
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


def sweep() -> int:
    import torch

    import chip_smoke as smoke
    import graph_kernel_sweep as gks
    import tsne_kernel_sweep as tks
    from sctools_tpu_torch import cuda_build
    from sctools_tpu_torch.ops import knn_kernel as KK

    print(smi_line(), flush=True)
    cmain = blobs(MAIN_N, 10)
    cwide = blobs(WIDE_C, 50)
    qwide = cwide[:WIDE_Q]
    shapes = {"main": (cmain, cmain), "wide": (qwide, cwide)}
    want = {s: KK.knn_select(q, c, k=K) for s, (q, c) in shapes.items()}
    print(json.dumps({"shipped": KK.knn_select_layout(),
                      "sass": sass_loop(cuda_build.library_path())}),
          flush=True)
    for s, (q, c) in shapes.items():
        call = lambda: KK.knn_select(q, c, k=K)  # noqa: E731
        print(json.dumps({
            "kernel": "knn_select (shipped wrapper)", "shape": s,
            "event_ms": smoke.cuda_times(call, REPS),
            "device_us": gks.device_us({"shipped": call}, calls=5)[
                "shipped"],
            "sm_clock_power_under_load": tks.clocks_under_load(call)
            if s == "main" else None}), flush=True)

    t0 = time.perf_counter()
    libs = build_variants()
    build_s = time.perf_counter() - t0
    stream = torch.cuda.current_stream().cuda_stream
    best = None
    for v, (fn, lay, regs) in libs.items():
        res = {"rows_a_lane": v[0], "cols_a_lane": v[1],
               "splits": v[2], "kc": v[3], "ring": v[4], "min_blocks": v[5],
               "tile": lay[:2],
               "ptxas_registers_spill_bytes": regs,
               "layout_registers_local_bytes_k16": lay[6:8], "ms": {}}
        for s, (q, c) in shapes.items():
            nq, d = q.shape
            out_v = torch.empty((nq, K), device=q.device)
            out_i = torch.empty((nq, K), dtype=torch.int32, device=q.device)
            scratch = torch.empty((2 * lay[2] * nq * K,), device=q.device)

            def run():
                qp = KK.pack_tiles(q, lay[0])
                cp = qp if c is q and lay[0] == lay[1] else KK.pack_tiles(
                    c, lay[1])
                code = fn(qp.data_ptr(), cp.data_ptr(), nq, c.shape[0], d,
                          K, 0, 0, out_v.data_ptr(), out_i.data_ptr(),
                          scratch.data_ptr(), stream)
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
    print(json.dumps({"build_s": build_s, "best_main_ms": best[0],
                      "best": dict(zip(("rows_a_lane", "cols_a_lane",
                                        "splits", "kc", "ring",
                                        "min_blocks"), best[1]))}),
          flush=True)
    return 0


def load_knn_kernel(root: Path, name: str):
    """The ``ops.knn_kernel`` module of the package ``sctools_tpu_torch``
    under ``root``, imported as the package ``name``."""
    init = root / "sctools_tpu_torch" / "__init__.py"
    spec = importlib.util.spec_from_file_location(
        name, init, submodule_search_locations=[str(init.parent)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return importlib.import_module(f"{name}.ops.knn_kernel")


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

    print(smi_line(), flush=True)
    parent = load_knn_kernel(Path(parent_root).resolve(), "sct_parent")
    x = main_embedding()
    cwide = blobs(WIDE_C, 50)
    cases = [("68579x68579x50 k=15 float32 (main path)", x, x, 15)]
    for dtype, k in ((torch.float32, 15), (torch.bfloat16, 32)):
        c = _prep(cwide, "cosine", dtype)
        cases.append((f"{WIDE_Q}x{WIDE_C}x{DIM} k={k} {str(dtype)[6:]}",
                      c[:WIDE_Q], c, k))
    for shape, q, c, k in cases:
        runs = {"parent": parent.knn_select, "this": KK.knn_select}
        a = runs["parent"](q, c, k=k)
        b = runs["this"](q, c, k=k)
        torch.cuda.synchronize()
        smoke.check(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]),
                    f"{shape}: this tree's bits differ from the parent's")
        del a, b
        times = []
        for who in ("parent", "this", "this", "parent"):
            fn = runs[who]
            times.append([who, smoke.cuda_times(
                lambda: fn(q, c, k=k), REPS)])
        print(json.dumps({"shape": shape, "bitwise_equal": True,
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
    return sweep()


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    sys.exit(main(sys.argv[1:]))
