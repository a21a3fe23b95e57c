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
    out = sct.recipe_pipeline("graph_tail", t=3, jaccard=True).run(out)
    out = sct.apply("embed.tsne", out)
    host = out.to_host()

The kNN search, the graph tail's diffusion steps and Jaccard weights,
and the t-SNE repulsion run through hand-written CUDA kernels
(``csrc/*.cu``), built with nvcc at the first launch.
"""

from . import data, ops, utils
from .config import config, configure
from .data.dataset import CellData
from .data.sparse import SparseCells
from .recipes import recipe_pipeline
from .registry import Pipeline, Transform, apply, get, names, register

__all__ = ["CellData", "Pipeline", "SparseCells", "Transform", "apply",
           "config", "configure", "data", "get", "names", "ops",
           "recipe_pipeline", "register"]
