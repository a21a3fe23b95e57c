"""The port's ops; importing this package registers them."""

from . import (distance, graph, graph_kernels, hvg, knn, knn_kernel,
               metacells, normalize, palantir, pca, qc, tsne)

__all__ = ["distance", "graph", "graph_kernels", "hvg", "knn",
           "knn_kernel", "metacells", "normalize", "palantir", "pca", "qc",
           "tsne"]
