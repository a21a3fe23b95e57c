"""The port's ops; importing this package registers them."""

from . import (cluster, distance, graph, graph_kernels, hvg, knn,
               knn_kernel, metacells, normalize, palantir, pca, qc, tsne,
               umap, velocity)

__all__ = ["cluster", "distance", "graph", "graph_kernels", "hvg", "knn",
           "knn_kernel", "metacells", "normalize", "palantir", "pca", "qc",
           "tsne", "umap", "velocity"]
