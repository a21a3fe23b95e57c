"""sctools_tpu_torch — the PyTorch/CUDA port of sctools-tpu.

A package beside ``sctools_tpu`` (the JAX reference, which it never
imports), with the same dotted op names and containers:

    import sctools_tpu_torch as sct
    ds = sct.data.synthetic.synthetic_counts(68_579, 32_738, density=0.02)
    out = sct.Pipeline([
        ("qc.per_cell_metrics", {}),
        ("normalize.library_size", {"target_sum": 1e4}),
        ("normalize.log1p", {}),
        ("hvg.select", {"n_top": 2000, "subset": True}),
        ("pca.randomized", {"n_components": 50}),
        ("neighbors.knn", {"k": 15, "metric": "cosine"}),
    ]).run(ds)                    # on the card; device="cpu" to test
    host = out.to_host()

The kNN search runs through the hand-written CUDA kernel
``csrc/knn_select.cu``, built with nvcc at its first launch.
"""

from . import data, ops
from .config import config, configure
from .data.dataset import CellData
from .data.sparse import SparseCells
from .registry import Pipeline, Transform, apply, get, names, register

__all__ = ["CellData", "Pipeline", "SparseCells", "Transform", "apply",
           "config", "configure", "data", "get", "names", "ops",
           "register"]
