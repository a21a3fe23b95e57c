"""Build and load the port's host library, ``csrc/scio.cpp``: the CSR →
padded-ELL packers that ``sctools_tpu_torch/native`` binds.

The source is compiled by ``$CXX`` (``g++`` when unset) with ``FLAGS``
into ``_build/libscio_<hash of the source and flags>.so`` and loaded
with ``ctypes``, as ``cuda_build.py`` builds the kernels: at the first
call, never at import, and a library whose hash matches is reused.  The
library is written under a temporary name and renamed into place, so
processes that build at once never load a half-written file.  A missing
compiler or a failed build raises with the compiler's output: there is
no numpy fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shlex
import shutil
import subprocess
import tempfile
from pathlib import Path

from .cuda_build import BUILD_DIR, CSRC, load

SOURCE = CSRC / "scio.cpp"
# no -march=native: the library may be loaded on another host than the
# one that built it
FLAGS = ["-O3", "-fPIC", "-std=c++17", "-pthread", "-shared"]

_P64 = ctypes.POINTER(ctypes.c_int64)
_P32 = ctypes.POINTER(ctypes.c_int32)
_PF = ctypes.POINTER(ctypes.c_float)
_I64 = ctypes.c_int64
# C entry points: (argument types, return type)
_SIGNATURES = {
    "scio_pack_ell_f32": ([_P64, _P32, _PF, _I64, _I64, _I64,
                           ctypes.c_int32, _P32, _PF, _I64], None),
    "scio_pack_ell_f32_chunks": ([ctypes.POINTER(_P64),
                                  ctypes.POINTER(_P32),
                                  ctypes.POINTER(_PF), _P64, _P64, _I64,
                                  _I64, _P32, _PF, _I64], None),
}

_loaded: ctypes.CDLL | None = None


def compiler() -> list[str]:
    """The compiler command: ``$CXX`` split as a shell would, else
    ``g++``; raises when it is not found."""
    cmd = shlex.split(os.environ.get("CXX") or "g++")
    if not cmd or shutil.which(cmd[0]) is None:
        raise RuntimeError(
            f"C++ compiler {cmd[0] if cmd else '(empty $CXX)'!r} not found; "
            f"the port's host library is built from {SOURCE.name} at "
            "first use (set CXX or install g++)")
    return cmd


def library_path(build_dir=None) -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(FLAGS).encode())
    return Path(build_dir or BUILD_DIR) / f"libscio_{h.hexdigest()[:16]}.so"


def build(build_dir=None) -> Path:
    """Compile ``SOURCE`` into ``build_dir`` (default ``BUILD_DIR``)
    unless its library exists; returns the library's path."""
    out = library_path(build_dir)
    if out.exists():
        return out
    cmd = compiler()
    out.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        tmp_lib = Path(tmp) / out.name
        r = subprocess.run([*cmd, *FLAGS, "-o", str(tmp_lib), str(SOURCE)],
                           stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                           text=True)
        if r.returncode != 0:
            raise RuntimeError(
                f"{' '.join(cmd)} failed to build {SOURCE.name}:\n{r.stdout}")
        os.replace(tmp_lib, out)  # atomic: a concurrent loader sees all
    return out


def library() -> ctypes.CDLL:
    """The loaded host library, built first if needed, with its argument
    types declared; after the first call it only returns the handle."""
    global _loaded
    if _loaded is None:
        _loaded = load(build(), _SIGNATURES)
    return _loaded
