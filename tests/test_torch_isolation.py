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
from sctools_tpu_torch import cuda_build
from sctools_tpu_torch.carry import graph_from_numpy
from sctools_tpu_torch.ops import graph_kernels, knn_kernel

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


def test_mesh_modules_load_no_jax_and_no_reference():
    """The cell-sharded data, its ops and the multi-process bring-up
    (some imported only when used) load neither jax nor the JAX
    package."""
    code = (
        "import sys\n"
        "import sctools_tpu_torch.data.sharded\n"
        "import sctools_tpu_torch.parallel.sharded_ops\n"
        "from sctools_tpu_torch.parallel.mesh import (init_distributed, "
        "shard_celldata, coordination_sum, mesh_host_groups)\n"
        "from sctools_tpu_torch.data.stream import ShardSource\n"
        "import torch.distributed\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'sctools_tpu' or "
        "m.startswith('sctools_tpu.'))\n"
        "print(repr(bad))\n"
        "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(_ROOT)
    r = subprocess.run([sys.executable, "-c", code], cwd=str(_ROOT),
                       env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.strip() == "[]"


def test_mesh_entry_points_default_to_the_card_and_raise_without_one():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: None resolves to it")
    from sctools_tpu_torch.parallel import init_distributed, make_mesh

    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_distributed()
    with pytest.raises(RuntimeError, match="devices=\\['cpu'\\]"):
        make_mesh()
    ds = sctt.data.synthetic.synthetic_counts(64, 16, seed=0)
    src = sctt.data.stream.ShardSource.from_scipy(ds.X, shard_rows=64,
                                                  device="cpu")
    mesh = make_mesh(devices=["cpu"] * 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sctt.data.stream.stream_pipeline(src, mesh=mesh)
    sharded = sctt.parallel.shard_celldata(ds, mesh)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sctt.Pipeline(["normalize.log1p"]).run(sharded)


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


@pytest.mark.parametrize("script", ["chip_smoke.py",
                                    "graph_kernel_sweep.py",
                                    "knn_kernel_sweep.py",
                                    "tsne_kernel_sweep.py",
                                    "stream_sweep.py",
                                    "refine_sweep.py",
                                    "segment_sweep.py",
                                    "mesh_probe.py",
                                    "integrate_probe.py"])
def test_card_scripts_import_no_jax_or_reference(script):
    for name in _imports(_ROOT / script):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "sctools_tpu"), (
            f"{script} imports {name}")


def _c_entry_points() -> dict:
    """{name: (argument kinds, return kind)} of every ``sct_*`` function
    the CUDA sources define, kinds "ptr" and "int"."""
    import re

    found = {}
    for src in sorted((_PKG / "csrc").glob("*.cu")):
        for ret, name, params in re.findall(
                r"^(int|const char\*) (sct_\w+)\(([^)]*)\)",
                src.read_text(), re.M):
            kinds = ["ptr" if "*" in p else "int" if p.split()[0] == "int"
                     else p for p in params.split(",")]
            found[name] = (kinds, "ptr" if "*" in ret else ret)
    return found


@pytest.mark.parametrize("name", sorted(cuda_build._SIGNATURES))
def test_ctypes_signature_matches_the_c_entry_point(name):
    """ctypes passes each argument as ``_SIGNATURES`` says: a pointer
    given as c_int would be cut to 32 bits, an int as c_void_p misread.
    So each entry's argument and return types follow the C definition
    in ``csrc/``."""
    import ctypes

    argtypes, restype = cuda_build._SIGNATURES[name]
    kinds, ret = _c_entry_points()[name]
    as_kind = {ctypes.c_void_p: "ptr", ctypes.c_int: "int",
               ctypes.c_char_p: "ptr"}
    assert [as_kind[t] for t in argtypes] == kinds
    assert as_kind[restype] == ret


def test_every_c_entry_point_has_a_signature():
    assert sorted(_c_entry_points()) == sorted(cuda_build._SIGNATURES)


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


@pytest.mark.parametrize("name", ["matvec", "rmatvec", "jaccard",
                                  "tsne_repulsion", "knn_binned"])
def test_graph_kernel_wrapper_has_no_exception_handler(name):
    wrapper = getattr(graph_kernels, name, None) or getattr(knn_kernel, name)
    tree = ast.parse(inspect.getsource(wrapper))
    assert not any(isinstance(n, (ast.Try, ast.ExceptHandler))
                   for n in ast.walk(tree))
    assert wrapper.launches >= 0  # the launch counter exists


@pytest.mark.parametrize("op", [
    "graph.connectivities", "graph.jaccard", "graph.diffusion_operator",
    "impute.magic", "graph.reorder", "graph.restore_order", "embed.tsne",
    "embed.spectral", "embed.diffmap", "dpt.pseudotime", "palantir.run",
    "metacells.seacells", "metacells.aggregate", "cluster.leiden",
    "cluster.louvain", "cluster.leiden_like", "cluster.phenograph",
    "cluster.kmeans", "cluster.dendrogram", "graph.paga", "embed.umap",
    "embed.force_directed", "embed.draw_graph", "velocity.moments",
    "velocity.estimate", "velocity.graph", "velocity.embedding",
    "velocity.terminal_states", "velocity.fate_probabilities",
    "velocity.lineage_drivers", "velocity.recover_dynamics",
    "velocity.latent_time", "de.rank_genes_groups",
    "de.filter_rank_genes_groups", "score.genes", "score.cell_cycle",
    "metrics.morans_i", "metrics.gearys_c", "integrate.combat",
    "integrate.harmony", "integrate.mnn", "model.scvi", "model.scanvi"])
def test_graph_ops_default_to_the_card_and_raise_without_one(op):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: None resolves to it")
    ds = sctt.data.synthetic.synthetic_counts(16, 8, seed=0)
    ds = graph_from_numpy(
        ds, np.tile(np.arange(3, dtype=np.int32), (16, 1)),
        np.zeros((16, 3), np.float32), knn_k=3).with_obs(
        metacell=np.zeros(16, np.int32))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sctt.apply(op, ds)


def test_ingest_defaults_to_the_card_and_raises_without_one():
    """``integrate.ingest`` takes its reference as ``ref=``."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: None resolves to it")
    ds = sctt.data.synthetic.synthetic_counts(16, 8, seed=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sctt.apply("integrate.ingest", ds, ref=ds)


def test_concat_and_the_new_modules_load_no_jax_and_no_reference():
    code = (
        "import sys\n"
        "from sctools_tpu_torch import concat, from_dense, from_scipy\n"
        "import sctools_tpu_torch.ops.integrate, sctools_tpu_torch.ops.mnn\n"
        "import sctools_tpu_torch.ops.ingest\n"
        "import sctools_tpu_torch.models, sctools_tpu_torch.models.scvi\n"
        "import sctools_tpu_torch.utils.optim\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'sctools_tpu' or "
        "m.startswith('sctools_tpu.'))\n"
        "print(repr(bad))\n"
        "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(_ROOT)
    r = subprocess.run([sys.executable, "-c", code], cwd=str(_ROOT),
                       env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.strip() == "[]"


def test_streamed_training_and_fault_modules_load_no_jax_and_no_reference():
    code = (
        "import sys\n"
        "import sctools_tpu_torch.models.train_stream\n"
        "import sctools_tpu_torch.memory, sctools_tpu_torch.runner\n"
        "import sctools_tpu_torch.utils.chaos\n"
        "import sctools_tpu_torch.utils.telemetry\n"
        "from sctools_tpu_torch.data.shardstore import ShardReadScheduler\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'sctools_tpu' or "
        "m.startswith('sctools_tpu.'))\n"
        "print(repr(bad))\n"
        "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(_ROOT)
    r = subprocess.run([sys.executable, "-c", code], cwd=str(_ROOT),
                       env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.strip() == "[]"


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
    dict(k=0), dict(dtype=torch.float64), dict(metric="manhattan")])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    q = torch.zeros((4, 8), dtype=bad.get("dtype", torch.float32))
    with pytest.raises(ValueError):
        knn_kernel.knn_select(q, q, k=bad.get("k", 2),
                              metric=bad.get("metric", "cosine"))


@pytest.mark.parametrize("n,d,k", [(700, 20, 600), (300, 300, 20)])
def test_knn_answers_past_the_former_caps(n, d, k):
    """The shapes the kernels once refused (k above 512, rows wider
    than 256 features) answer, as the reference does: ``knn_arrays`` on
    the CPU against the float64 oracle (distances within 1e-5, ids
    equal but on near-ties)."""
    from sctools_tpu_torch.ops.knn import knn_arrays, knn_numpy, recall_at_k

    x = np.random.default_rng(k).normal(size=(n, d)).astype(np.float32)
    t = torch.from_numpy(x)
    idx, dist = knn_arrays(t, t, k=k, metric="euclidean",
                           exclude_self=True)
    want_i, want_d = knn_numpy(x, x, k=k, metric="euclidean",
                               exclude_self=True)
    assert idx[:n].shape == (n, k)
    np.testing.assert_allclose(dist[:n].numpy(), want_d, rtol=1e-5,
                               atol=1e-5)
    assert recall_at_k(idx[:n].numpy(), want_i) >= 0.999


def test_registry_is_separate_from_the_reference():
    assert sctt.names() == [
        "cluster.dendrogram", "cluster.kmeans", "cluster.leiden",
        "cluster.leiden_like", "cluster.louvain", "cluster.phenograph",
        "da.neighborhoods", "de.filter_rank_genes_groups",
        "de.marker_gene_overlap", "de.rank_genes_groups",
        "distance.pairwise", "dpt.pseudotime", "embed.density",
        "embed.diffmap", "embed.draw_graph", "embed.force_directed",
        "embed.phate", "embed.spectral", "embed.tsne", "embed.umap",
        "graph.connectivities",
        "graph.diffusion_operator", "graph.jaccard", "graph.paga",
        "graph.reorder", "graph.restore_order", "hvg.select",
        "impute.magic", "integrate.combat", "integrate.harmony",
        "integrate.ingest", "integrate.mnn",
        "metacells.aggregate", "metacells.seacells", "metrics.gearys_c",
        "metrics.morans_i", "model.scanvi", "model.scvi",
        "model.scvi_stream", "neighbors.bbknn",
        "neighbors.knn", "neighbors.knn_multichip", "normalize.clr",
        "normalize.downsample_counts", "normalize.library_size",
        "normalize.log1p", "normalize.pearson_residuals",
        "normalize.regress_out", "normalize.scale",
        "palantir.gene_trends", "palantir.run", "pca.exact",
        "pca.randomized", "qc.doublet_score", "qc.filter_cells",
        "qc.filter_genes", "qc.per_cell_metrics", "qc.per_gene_metrics",
        "qc.subsample", "recipe.pearson_residuals", "recipe.seurat",
        "recipe.weinreb17", "recipe.zheng17", "score.cell_cycle",
        "score.genes", "util.snapshot_layer",
        "velocity.embedding", "velocity.estimate",
        "velocity.fate_probabilities", "velocity.graph",
        "velocity.latent_time", "velocity.lineage_drivers",
        "velocity.moments", "velocity.recover_dynamics",
        "velocity.terminal_states", "wishbone.run"]
    assert len(sctt.names()) == 76  # of the reference's 79
    assert sctt.registry.metadata("pca.randomized")["mem_cost"] == 4.0
    meta = sctt.registry.metadata("neighbors.knn_multichip")
    assert meta["sharding"] == "cells" and meta["collective"] is True
    with pytest.raises(NotImplementedError):
        sctt.Pipeline(["normalize.log1p"]).run(
            sctt.data.synthetic.synthetic_counts(8, 8), device="cpu",
            fuse=True)
    with pytest.raises(sctt.registry.UnknownBackendError):
        sctt.Transform("normalize.log1p", backend="tpu")
