"""The port's ops; importing this package registers them."""

from . import (cluster, de, distance, graph, graph_kernels, hvg, knn,
               knn_kernel, metacells, metrics, normalize, palantir, pca, qc,
               score, tsne, umap, velocity)

__all__ = ["cluster", "de", "distance", "graph", "graph_kernels", "hvg",
           "knn", "knn_kernel", "metacells", "metrics", "normalize",
           "palantir", "pca", "qc", "score", "tsne", "umap", "velocity"]
