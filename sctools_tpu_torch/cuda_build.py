"""Build and load the port's CUDA kernels.

Every ``*.cu`` file under ``csrc/`` is compiled by ``nvcc`` for
``sm_90a`` (one compiler process per source, all started together) and
linked into one shared library with a plain C interface,
``_build/libsct_kernels_<hash of the sources>.so``, which is loaded with
``ctypes``.  The build runs at the first launch of a kernel, never at
import, and a library whose hash matches the sources is reused.  The
library is looked up once per process: later launches neither hash nor
stat the sources.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry points and their argument types: pointers and the stream as
# c_void_p, ints as c_int.
_SIGNATURES = {
    "sct_knn_select": ([_P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P],
                       _I),
    "sct_knn_select_layout": ([_P], _I),
    "sct_knn_select_build": ([_I, _I, _P], _I),
    "sct_knn_binned": ([_P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P,
                        _P], _I),
    "sct_knn_binned_layout": ([_P], _I),
    "sct_knn_binned_build": ([_I, _I, _P], _I),
    "sct_graph_matvec": ([_P, _P, _P, _I, _I, _I, _I, _P, _P], _I),
    "sct_graph_rmatvec": ([_P, _P, _P, _P, _I, _I, _I, _P, _P], _I),
    "sct_graph_jaccard": ([_P, _I, _I, _P, _P], _I),
    "sct_tsne_repulsion": ([_P, _I, _I, _P, _P, _P, _P], _I),
    "sct_tsne_repulsion_layout": ([_P], _I),
    "sct_cuda_error_string": ([_I], ctypes.c_char_p),
}

_loaded: ctypes.CDLL | None = None


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256()
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(ARCH_FLAGS).encode())
    return h.hexdigest()[:16]


def nvcc_path() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        cand = Path(CUDA_HOME) / "bin" / "nvcc"
        if cand.exists():
            return str(cand)
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError(
        "nvcc not found (neither CUDA_HOME/bin/nvcc nor on PATH); the "
        "port's CUDA kernels are built from source at first use")


def library_path() -> Path:
    return BUILD_DIR / f"libsct_kernels_{source_hash()}.so"


def build(verbose: bool = False) -> Path:
    """Compile the sources into the shared library unless it exists;
    returns its path.  ``verbose`` adds ``-Xptxas -v`` and prints the
    compiler's output (registers, shared memory and spills per
    kernel)."""
    out = library_path()
    if out.exists():
        return out
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    flags = [*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC"]
    if verbose:
        flags += ["-Xptxas", "-v"]
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in sources():
            obj = Path(tmp) / (src.stem + ".o")
            objs.append(obj)
            procs.append((src, subprocess.Popen(
                [nvcc, *flags, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for src, proc in procs:
            log, _ = proc.communicate()
            if verbose and log:
                print(f"[nvcc {src.name}]\n{log}", flush=True)
            if proc.returncode != 0:
                failed.append(f"{src.name}:\n{log}")
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
        tmp_lib = Path(tmp) / out.name
        link = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp_lib),
             *map(str, objs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp_lib, out)  # atomic: a concurrent loader sees all
    return out


def load(path: Path, signatures: dict) -> ctypes.CDLL:
    """Load a built library with ``ctypes`` and declare each entry point
    of ``signatures`` (name → (argument types, return type)) once."""
    lib = ctypes.CDLL(str(path))
    for name, (argtypes, restype) in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed; every launch
    calls this, so after the first call it only returns the handle."""
    global _loaded
    if _loaded is None:
        _loaded = load(build(), _SIGNATURES)
    return _loaded


def check(code: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if code != 0:
        msg = library().sct_cuda_error_string(code)
        raise RuntimeError(
            f"{what} failed: CUDA error {code} "
            f"({msg.decode() if msg else 'unknown'})")
