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

Files are read on the host (``read_h5ad``, ``read_10x_mtx``,
``read_10x_h5``, ``read_loom``, ``read_csv``, ``read_text``,
``read_mtx``, ``read`` by suffix; ``write_h5ad``, ``write_loom``), and
packed to padded ELL by a native host library built at first use
(``native``, ``host_build.py``):

    ds = sct.read_10x_mtx("filtered_feature_bc_matrix/")
    ds = ds.var_names_make_unique()

Samples are merged on the host with ``concat`` and integrated on the
card (``integrate.combat``, ``harmony``, ``mnn``, ``ingest``):

    merged = sct.concat([run_a, run_b], label="batch", keys=["a", "b"])
    out = sct.Pipeline(steps[:5]).run(merged)     # the steps above to PCA
    out = sct.apply("integrate.harmony", out)     # obsm["X_harmony"]

The kNN search, the graph tail's diffusion steps and Jaccard weights,
and the t-SNE repulsion run through hand-written CUDA kernels
(``csrc/*.cu``), built with nvcc at the first launch.  ``parallel``
runs the kNN and the diffusion over a single-process mesh of devices
(``parallel.make_mesh``).  ``models`` trains scVI and scANVI
(``model.scvi``, ``model.scanvi``) on the card.
"""

from . import data, models, ops, parallel, utils
from .config import config, configure
from .data.concat import concat
from .data.dataset import CellData
from .data.io import (from_dense, from_scipy, read, read_10x_h5,
                      read_10x_mtx, read_csv, read_h5ad, read_loom,
                      read_mtx, read_text, write_h5ad, write_loom)
from .data.sparse import SparseCells
from .recipes import recipe_pipeline
from .registry import Pipeline, Transform, apply, get, names, register

__all__ = ["CellData", "Pipeline", "SparseCells", "Transform", "apply",
           "concat", "config", "configure", "data", "from_dense",
           "from_scipy", "get", "models", "names", "ops", "parallel",
           "read", "read_10x_h5", "read_10x_mtx", "read_csv", "read_h5ad",
           "read_loom", "read_mtx", "read_text", "recipe_pipeline",
           "register", "write_h5ad", "write_loom"]
