"""The port's ops; importing this package registers them."""

from . import (cluster, de, distance, graph, graph_kernels, hvg, ingest,
               integrate, knn, knn_kernel, metacells, metrics, mnn,
               normalize, palantir, pca, qc, score, tsne, umap, velocity)

__all__ = ["cluster", "de", "distance", "graph", "graph_kernels", "hvg",
           "ingest", "integrate", "knn", "knn_kernel", "metacells",
           "metrics", "mnn", "normalize", "palantir", "pca", "qc", "score",
           "tsne", "umap", "velocity"]
