"""The port's ops; importing this package registers them."""

from . import (abundance, cluster, de, density, distance, doublet, graph,
               graph_kernels, hvg, ingest, integrate, knn, knn_kernel,
               metacells, metrics, mnn, normalize, palantir, pca, phate, qc,
               score, tsne, umap, velocity, wishbone)

__all__ = ["abundance", "cluster", "de", "density", "distance", "doublet",
           "graph", "graph_kernels", "hvg", "ingest", "integrate", "knn",
           "knn_kernel", "metacells", "metrics", "mnn", "normalize",
           "palantir", "pca", "phate", "qc", "score", "tsne", "umap",
           "velocity", "wishbone"]
