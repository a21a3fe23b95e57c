"""The port's ops; importing this package registers them."""

from . import (graph, graph_kernels, hvg, knn, knn_kernel, metacells,
               normalize, palantir, pca, qc, tsne)

__all__ = ["graph", "graph_kernels", "hvg", "knn", "knn_kernel",
           "metacells", "normalize", "palantir", "pca", "qc", "tsne"]
