#!/usr/bin/env python3
"""Size sweep of the t-SNE repulsion kernel on one NVIDIA card.

    python3 tsne_kernel_sweep.py               # from the repository root
    python3 tsne_kernel_sweep.py --sass-only LIB.so [LIB.so ...]

``csrc/tsne_repulsion.cu`` takes four compile-time sizes: threads a
block, query rows a thread, candidate rows a staged tile and candidate
splits.  This script compiles the kernel's launcher once more for each
(threads, queries, tile) of VARIANTS, one library each under
``sctools_tpu_torch/_build/sweep/`` (all compilers started together),
and times each with each split count of SPLITS at 68,579 × 2, the
main path's t-SNE shape, on a layout of ten Gaussian clusters made
from seed 0.  Each time is the median of 10 CUDA-event timings of one
launch pair (split sweep + combine).  Every variant must lie within
the card checks' tolerance of the plain version (``chip_smoke.py``:
rtol 1e-5, atol TSNE_FULL_ATOL × the force terms' scale, Z rtol 1e-5)
and repeat its own bits.

It prints the card's name and power limit first, then one JSON line
per variant, the shipped wrapper's CUDA-event µs against
``torch.profiler`` device µs per kernel and host µs per call, and the
SASS instructions per pair of the inner loops (``cuobjdump -sass`` on
the shipped library: each loop that holds MUFU.RCP, one reciprocal a
pair).  ``--sass-only`` prints only the SASS counts of the libraries
named, for instance one built from another commit.
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

N, DIM = 68_579, 2
# (threads a block, query rows a thread, candidate rows a tile)
VARIANTS = ((128, 3, 256), (64, 3, 256), (64, 4, 256), (64, 8, 256),
            (128, 2, 256), (128, 4, 256), (128, 4, 512), (256, 2, 256),
            (256, 4, 256))
SPLITS = (8, 12, 16, 24, 33, 48)
REPS = 10

_P, _I = ctypes.c_void_p, ctypes.c_int


def build_variants() -> dict:
    """One library per variant, exporting ``sweep_tsne(y, n, splits,
    part, forces, zrow, stream)`` at D = 2; returns {variant: CDLL}."""
    from sctools_tpu_torch import cuda_build

    out_dir = cuda_build.BUILD_DIR / "sweep"
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = cuda_build.nvcc_path()
    src = cuda_build.CSRC / "tsne_repulsion.cu"

    def one(v):
        threads, qpt, tile = v
        tag = f"tsne_t{threads}_q{qpt}_c{tile}"
        tu = out_dir / f"{tag}.cu"
        tu.write_text(
            f'#include "{src}"\n'
            'extern "C" int sweep_tsne(const void* y, int n, int splits, '
            "void* part, void* forces, void* zrow, void* stream) {\n"
            f"  return (int)launch_sized<2, {threads}, {qpt}, {tile}>(\n"
            "      static_cast<const float*>(y), n, splits,\n"
            "      static_cast<float*>(part), static_cast<float*>(forces),\n"
            "      static_cast<float*>(zrow),\n"
            "      static_cast<cudaStream_t>(stream));\n}\n")
        lib = out_dir / f"lib{tag}.so"
        r = subprocess.run(
            [nvcc, *cuda_build.ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
             "-Xcompiler", "-fPIC", "-Xptxas", "-v", str(tu), "-o",
             str(lib)], capture_output=True, text=True)
        if r.returncode:
            raise RuntimeError(f"nvcc {tag}:\n{r.stdout}{r.stderr}")
        want = f"tsne_split_kernelILi2ELi{threads}ELi{qpt}ELi{tile}E"
        regs = [m.group(2, 3) for m in re.finditer(
            r"entry function '(\S+)'.*?(\d+) bytes spill stores.*?"
            r"Used (\d+) registers", r.stdout + r.stderr, re.S)
            if want in m.group(1)]
        return v, lib, regs

    libs = {}
    with ThreadPoolExecutor(max_workers=8) as pool:
        for v, path, regs in pool.map(one, VARIANTS):
            fn = ctypes.CDLL(str(path)).sweep_tsne
            fn.argtypes = [_P, _I, _I, _P, _P, _P, _P]
            fn.restype = _I
            libs[v] = (fn, regs)
    return libs


def sass_loops(lib: Path) -> list:
    """For the D = 2 repulsion kernels of ``lib``: each loop (a backward
    branch and the instructions from its target to it) that holds
    MUFU.RCP, with its instruction count (NOPs left out), reciprocals
    and instructions per reciprocal, one reciprocal being one pair."""
    from sctools_tpu_torch import cuda_build

    cuobjdump = Path(cuda_build.nvcc_path()).parent / "cuobjdump"
    text = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    out = []
    for fn in re.split(r"\n\s*Function : ", text)[1:]:
        name = fn.split("\n", 1)[0].strip()
        if not re.search(r"(tsne_split_kernel|tsne_rep_kernel)ILi2E", name):
            continue  # the pair loops at D = 2
        instr = []  # (address, text)
        for m in re.finditer(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", fn):
            instr.append((int(m.group(1), 16), m.group(2).strip()))
        for addr, op in instr:
            b = re.search(r"\bBRA\b.*?0x([0-9a-f]+)", op)
            if not b or int(b.group(1), 16) >= addr:
                continue
            body = [o for a, o in instr
                    if int(b.group(1), 16) <= a <= addr and "NOP" not in o]
            rcp = sum("MUFU.RCP" in o for o in body)
            if rcp:
                out.append({"kernel": name[:90], "instructions": len(body),
                            "mufu_rcp": rcp,
                            "instructions_per_pair": len(body) / rcp,
                            "lds": sum(o.split()[0].startswith("LDS")
                                       or " LDS" in o for o in body)})
    return out


def clocks_under_load(fn, seconds: float = 3.0) -> list:
    """nvidia-smi's SM clock and power draw, sampled every 200 ms while
    ``fn`` runs back to back."""
    import torch

    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader", "-lms", "200"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            for _ in range(50):
                fn()
            torch.cuda.synchronize()
    finally:
        smi.terminate()
        out, _ = smi.communicate(timeout=30)
    return out.strip().splitlines()


def layout(seed: int = 0):
    """A t-SNE-like 2-D layout: ten Gaussian clusters, centres spread
    over ±40, spread 3."""
    import numpy as np

    rng = np.random.default_rng(seed)
    centres = rng.uniform(-40, 40, (10, DIM))
    lab = rng.integers(0, 10, N)
    return (centres[lab] + 3.0 * rng.standard_normal((N, DIM))).astype(
        np.float32)


def main(argv: list) -> int:
    import torch

    if argv[:1] == ["--sass-only"]:
        for lib in argv[1:]:
            print(json.dumps({"library": lib, "loops": sass_loops(Path(lib))}),
                  flush=True)
        return 0
    if not torch.cuda.is_available():
        print("tsne_kernel_sweep: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as smoke
    import graph_kernel_sweep as gks
    from sctools_tpu_torch import cuda_build
    from sctools_tpu_torch.ops import graph_kernels as GK

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    dev = torch.device("cuda")
    y = torch.from_numpy(layout()).to(dev)
    shipped = GK.tsne_repulsion_layout()
    print(json.dumps({"shipped": shipped,
                      "sass": sass_loops(cuda_build.library_path())}),
          flush=True)
    pf, pz = GK.tsne_repulsion_plain(y, N)
    terms = smoke.tsne_term_scale(y)
    atol = smoke.TSNE_FULL_ATOL * terms

    f, z = GK.tsne_repulsion(y, N)
    smoke.within(f, pf, 1e-5, atol)
    smoke.within(z.reshape(1), pz.reshape(1), 1e-5, 0.0)
    call = lambda: GK.tsne_repulsion(y, N)  # noqa: E731
    print(json.dumps({
        "kernel": "tsne_repulsion (shipped wrapper)", "n": N, "dim": DIM,
        "event_ms": smoke.cuda_times(call, REPS),
        "device_us": gks.device_us({"shipped": call})["shipped"],
        "host_us_enqueue_then_done": gks.host_us(call, 50),
        "sm_clock_power_under_load": clocks_under_load(call)}), flush=True)

    t0 = time.perf_counter()
    libs = build_variants()
    build_s = time.perf_counter() - t0
    stream = torch.cuda.current_stream().cuda_stream
    forces = torch.empty((N, DIM), device=dev)
    zrow = torch.empty((N,), device=dev)
    best = None
    for v, (fn, regs) in libs.items():
        res = {"threads": v[0], "qpt": v[1], "tile": v[2],
               "split_kernel_spill_stores_registers": regs, "ms": {}}
        for s in SPLITS:
            part = torch.empty((s, DIM + 1, N), device=dev)

            def run():
                code = fn(y.data_ptr(), N, s, part.data_ptr(),
                          forces.data_ptr(), zrow.data_ptr(), stream)
                if code:
                    raise RuntimeError(f"CUDA error {code}")

            run()
            first = (forces.clone(), zrow.clone())
            smoke.within(forces, pf, 1e-5, atol)
            smoke.within(torch.clamp(zrow.sum(), min=1e-12).reshape(1),
                         pz.reshape(1), 1e-5, 0.0)
            ms = smoke.cuda_ms(run, REPS)
            smoke.check(torch.equal(forces, first[0])
                        and torch.equal(zrow, first[1]),
                        f"variant {v} splits {s}: bits differ between runs")
            res["ms"][str(s)] = ms
            if best is None or ms < best[0]:
                best = (ms, v, s)
        print(json.dumps(res), flush=True)
    print(json.dumps({"build_s": build_s, "best_ms": best[0],
                      "best": {"threads": best[1][0], "qpt": best[1][1],
                               "tile": best[1][2], "splits": best[2]}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    sys.exit(main(sys.argv[1:]))
