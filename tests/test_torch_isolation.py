"""The PyTorch port stands alone: it imports neither jax nor the JAX
package, its entry points refuse to fall back to the CPU, and its kernel
wrapper never catches a failed launch."""

import ast
import inspect
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import sctools_tpu_torch as sctt
from sctools_tpu_torch.ops import knn_kernel

torch.set_num_threads(2)

_ROOT = Path(__file__).resolve().parents[1]
_PKG = _ROOT / "sctools_tpu_torch"


def test_import_loads_no_jax_and_no_reference():
    code = (
        "import sys, sctools_tpu_torch\n"
        "import sctools_tpu_torch.carry\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'sctools_tpu' or "
        "m.startswith('sctools_tpu.'))\n"
        "print(repr(bad))\n"
        "assert not bad, bad\n")
    # PYTHONPATH replaced, not appended: no site customisation on the
    # inherited path may load jax first
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(_ROOT)
    r = subprocess.run([sys.executable, "-c", code], cwd=str(_ROOT),
                       env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.strip() == "[]"


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize(
    "path", sorted(_PKG.rglob("*.py")),
    ids=lambda p: str(p.relative_to(_ROOT)))
def test_no_module_imports_jax_or_reference(path):
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "sctools_tpu"), (
            f"{path.name} imports {name}")


def test_pipeline_without_device_raises_instead_of_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: None resolves to it")
    ds = sctt.data.synthetic.synthetic_counts(40, 30, seed=0)
    pipe = sctt.Pipeline([("normalize.log1p", {})])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pipe.run(ds)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sctt.apply("normalize.log1p", ds)
    out = pipe.run(ds, device="cpu")
    assert out.X.device.type == "cpu"


def test_kernel_wrapper_has_no_exception_handler():
    tree = ast.parse(inspect.getsource(knn_kernel.knn_select))
    assert not any(isinstance(n, (ast.Try, ast.ExceptHandler))
                   for n in ast.walk(tree))


def test_wrapper_dispatches_by_device_and_counts_only_launches():
    q = torch.from_numpy(np.random.default_rng(0).normal(
        size=(20, 8)).astype(np.float32))
    before = knn_kernel.knn_select.launches
    v, i = knn_kernel.knn_select(q, q, k=3)
    pv, pi = knn_kernel.knn_select_plain(q, q, k=3)
    assert torch.equal(i, pi) and torch.equal(v, pv)
    # the plain version on a CPU tensor is not a kernel launch
    assert knn_kernel.knn_select.launches == before
    with pytest.raises(ValueError, match="runs on cpu or cuda"):
        knn_kernel.knn_select(q.to("meta"), q.to("meta"), k=3)


@pytest.mark.parametrize("bad", [
    dict(k=0), dict(k=knn_kernel.K_MAX + 1), dict(d=knn_kernel.D_MAX + 1),
    dict(dtype=torch.float64), dict(metric="manhattan")])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    d = bad.get("d", 8)
    q = torch.zeros((4, d), dtype=bad.get("dtype", torch.float32))
    with pytest.raises(ValueError):
        knn_kernel.knn_select(q, q, k=bad.get("k", 2),
                              metric=bad.get("metric", "cosine"))


def test_registry_is_separate_from_the_reference():
    assert sctt.names() == [
        "hvg.select", "neighbors.knn", "normalize.library_size",
        "normalize.log1p", "pca.randomized", "qc.per_cell_metrics"]
    assert sctt.registry.metadata("pca.randomized")["mem_cost"] == 4.0
    with pytest.raises(NotImplementedError):
        sctt.Pipeline(["normalize.log1p"]).run(
            sctt.data.synthetic.synthetic_counts(8, 8), device="cpu",
            fuse=True)
    with pytest.raises(sctt.registry.UnknownBackendError):
        sctt.Transform("normalize.log1p", backend="tpu")
