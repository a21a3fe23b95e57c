"""The port's native host library (``sctools_tpu_torch/csrc/scio.cpp``,
built at first use by ``host_build.py``) against its numpy plain
versions and the reference's.

The packers' planes must be bit for bit those of the port's numpy
``pack_ell_plain`` / ``pack_ell_chunks_plain`` and of the reference's
``_pack_ell_numpy``, whatever number of threads packs them (the cores
the process may use).  A build that cannot run raises and leaves nothing
in numpy's place.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from sctools_tpu.native import _pack_ell_numpy as ref_pack_numpy
from sctools_tpu_torch import host_build, native
from sctools_tpu_torch.data.sparse import (SparseCells, pack_ell_chunks,
                                           pack_ell_chunks_plain,
                                           pack_ell_plain)

torch.set_num_threads(2)

_ROOT = Path(__file__).resolve().parents[1]


def _csr(n_rows, n_cols, density, seed, dtype=np.float32):
    X = sp.random(n_rows, n_cols, density=density, format="csr",
                  random_state=np.random.default_rng(seed), dtype=dtype)
    X.sort_indices()
    return X


def _edge_csr():
    """Empty rows (first, middle, last), one row exactly at capacity 128,
    one with a single entry, a -0.0 value and a NaN."""
    dense = np.zeros((9, 300), np.float32)
    dense[2, :128] = np.arange(1, 129)
    dense[4, 7] = 3.5
    dense[5, ::3] = np.linspace(-1, 1, 100)
    X = sp.csr_matrix(dense)
    X.data[X.indices == 0] = -0.0
    X.data[-1] = np.nan
    return X


def _same(a, b):
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert np.array_equal(x.view(np.uint8), y.view(np.uint8))


@pytest.mark.parametrize("case", ["random", "edges", "threaded",
                                  "padded", "float64"])
def test_pack_ell_is_bit_for_bit_the_plain_and_reference_versions(case):
    dtype = np.float64 if case == "float64" else np.float32
    if case == "edges":
        X, rows_padded, cap = _edge_csr(), 16, 128
    elif case == "threaded":  # ≥ 32,768 rows: the C side starts threads
        X, rows_padded, cap = _csr(40_000, 64, 0.1, 2), 40_000, 128
    elif case == "padded":
        X, rows_padded, cap = _csr(13, 40, 0.3, 3), 64, 256
    else:
        X, rows_padded, cap = _csr(50, 40, 0.3, 4, dtype), 56, 128
    args = (X.indptr.astype(np.int64), X.indices.astype(np.int32),
            X.data.astype(dtype))
    got = native.pack_ell(*args, rows_padded, cap, sentinel=X.shape[1])
    _same(got, pack_ell_plain(*args, rows_padded, cap, X.shape[1]))
    _same(got, ref_pack_numpy(*args, rows_padded, cap, X.shape[1]))
    assert got[1].dtype == dtype  # float64 goes through numpy, as float64


def test_from_scipy_csr_planes_equal_the_plain_pack():
    X = _csr(300, 500, 0.05, 5)
    sc = SparseCells.from_scipy_csr(X, device="cpu")
    idx, val = pack_ell_plain(X.indptr.astype(np.int64), X.indices,
                              X.data, sc.rows_padded, sc.capacity, 500)
    assert np.array_equal(sc.indices.numpy(), idx)
    assert np.array_equal(sc.data.numpy().view(np.int32),
                          val.view(np.int32))


@pytest.mark.parametrize("how", ["random", "edges", "empty", "unordered"])
def test_pack_ell_chunks_is_bit_for_bit_the_plain_version(how):
    X = _edge_csr() if how == "edges" else _csr(256, 400, 0.1, 6)
    rows_padded, cap = (16 if how == "edges" else 256), 128
    step = 3 if how == "edges" else 64
    chunks = [(X[r: r + step].indptr, X[r: r + step].indices,
               X[r: r + step].data, r) for r in range(0, X.shape[0], step)]
    if how == "empty":
        chunks = []
    if how == "unordered":
        chunks = chunks[::-1]
    got = pack_ell_chunks(chunks, rows_padded, cap, sentinel=X.shape[1])
    _same(got, pack_ell_chunks_plain(chunks, rows_padded, cap, X.shape[1]))
    if chunks:
        _same(got, ref_pack_numpy(X.indptr.astype(np.int64), X.indices,
                                  X.data, rows_padded, cap, X.shape[1]))


def test_pack_ell_chunks_of_float64_go_through_numpy():
    X = _csr(64, 50, 0.2, 7, np.float64)
    chunks = [(X[r: r + 16].indptr, X[r: r + 16].indices, X[r: r + 16].data,
               r) for r in range(0, 64, 16)]
    got = pack_ell_chunks(chunks, 64, 128, sentinel=50)
    assert got[1].dtype == np.float64
    _same(got, pack_ell_chunks_plain(chunks, 64, 128, 50))


def test_packers_refuse_what_would_drop_counts_or_leave_the_buffer():
    X = _csr(20, 300, 0.5, 8)
    args = (X.indptr.astype(np.int64), X.indices, X.data)
    with pytest.raises(ValueError, match="refusing to drop counts"):
        native.pack_ell(*args, 24, 128, sentinel=300)
    with pytest.raises(ValueError, match="do not fit"):
        native.pack_ell(*args, 16, 256, sentinel=300)
    bad = args[0].copy()
    bad[3] = bad[4] + 1  # a row whose end lies before its start
    with pytest.raises(ValueError, match="non-decreasing"):
        native.pack_ell(bad, *args[1:], 24, 256, sentinel=300)
    with pytest.raises(ValueError, match="past the"):
        native.pack_ell(args[0], args[1][:-1], args[2], 24, 256,
                        sentinel=300)
    chunk = (X[:10].indptr, X[:10].indices, X[:10].data)
    with pytest.raises(ValueError, match="refusing to drop counts"):
        pack_ell_chunks([(*chunk, 0)], 24, 128, sentinel=300)
    with pytest.raises(ValueError, match="overlap"):
        pack_ell_chunks([(*chunk, 0), (*chunk, 5)], 24, 256, sentinel=300)
    with pytest.raises(ValueError, match="overlap"):
        pack_ell_chunks([(*chunk, 20)], 24, 256, sentinel=300)


@pytest.mark.parametrize("packer", ["pack_ell", "pack_ell_chunks"])
@pytest.mark.parametrize("threads", [1, 3])
def test_any_thread_count_packs_the_same_planes(monkeypatch, packer,
                                                threads):
    monkeypatch.setattr(native, "_threads", lambda: threads)
    X = _csr(40_000, 64, 0.1, 11)  # ≥ 32,768 rows: pack_ell splits them
    args = (X.indptr.astype(np.int64), X.indices, X.data)
    if packer == "pack_ell":
        got = native.pack_ell(*args, 40_000, 128, sentinel=64)
    else:
        chunks = [(X[r: r + 5000].indptr, X[r: r + 5000].indices,
                   X[r: r + 5000].data, r) for r in range(0, 40_000, 5000)]
        got = native.pack_ell_chunks(chunks, 40_000, 128, sentinel=64)
    _same(got, pack_ell_plain(*args, 40_000, 128, 64))


def test_the_thread_count_follows_the_process_affinity():
    """A process held to one core packs on one thread: the count is the
    cores it may use, not the machine's."""
    code = ("import os\n"
            "os.sched_setaffinity(0, {min(os.sched_getaffinity(0))})\n"
            "from sctools_tpu_torch import native\n"
            "print(native._threads())\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(_ROOT)
    out = subprocess.run([sys.executable, "-c", code], env=env, check=True,
                         stdout=subprocess.PIPE, text=True).stdout
    assert out.strip() == "1"
    assert native._threads() == len(os.sched_getaffinity(0))


def test_a_missing_compiler_raises_and_nothing_falls_back(tmp_path,
                                                          monkeypatch):
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-c++"))
    with pytest.raises(RuntimeError, match="not found"):
        host_build.build(build_dir=tmp_path)
    # the packers reach the same build, and raise
    monkeypatch.setattr(host_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(host_build, "_loaded", None)
    X = _csr(10, 20, 0.3, 10)
    with pytest.raises(RuntimeError, match="not found"):
        native.pack_ell(X.indptr, X.indices, X.data, 16, 128, sentinel=20)
    with pytest.raises(RuntimeError, match="not found"):
        SparseCells.from_scipy_csr(X, device="cpu")
    with pytest.raises(RuntimeError, match="not found"):
        native.have_native()
    assert not (tmp_path / "build").exists() or not list(
        (tmp_path / "build").glob("*.so"))


def test_a_failed_compile_raises_with_the_compiler_log(tmp_path,
                                                       monkeypatch):
    bad = tmp_path / "scio.cpp"
    bad.write_text("int broken = ;\n")
    monkeypatch.setattr(host_build, "SOURCE", bad)
    with pytest.raises(RuntimeError, match="failed to build scio.cpp"):
        host_build.build(build_dir=tmp_path / "build")
    assert not list((tmp_path / "build").glob("*.so"))


def test_concurrent_builds_leave_one_whole_library(tmp_path):
    """Four processes build into one empty directory at once (as pytest
    workers do); each loads a whole library and packs right, and one
    ``.so`` is left, with no temporary directory beside it."""
    code = (
        "import sys, numpy as np\n"
        "from pathlib import Path\n"
        "from sctools_tpu_torch import host_build, native\n"
        "host_build.BUILD_DIR = Path(sys.argv[1])\n"
        "ip = np.array([0, 2, 3], np.int64)\n"
        "idx, val = native.pack_ell(ip, np.array([1, 4, 2], np.int32),\n"
        "    np.array([1, 2, 3], np.float32), 8, 128, sentinel=9)\n"
        "assert idx[0, :3].tolist() == [1, 4, 9]\n"
        "assert val[1, 0] == 3.0 and idx[1, 1] == 9\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(_ROOT)
    build = tmp_path / "build"
    procs = [subprocess.Popen([sys.executable, "-c", code, str(build)],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for _ in range(4)]
    for p in procs:
        out, _ = p.communicate(timeout=240)
        assert p.returncode == 0, out
    assert [p.name for p in build.iterdir()] == [
        host_build.library_path(build).name]


def test_the_library_is_named_by_the_hash_of_source_and_flags(monkeypatch):
    name = host_build.library_path().name
    assert name.startswith("libscio_") and name.endswith(".so")
    monkeypatch.setattr(host_build, "FLAGS", [*host_build.FLAGS, "-g"])
    assert host_build.library_path().name != name
