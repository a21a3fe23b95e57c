"""The port's ops; importing this package registers them."""

from . import hvg, knn, knn_kernel, normalize, pca, qc

__all__ = ["hvg", "knn", "knn_kernel", "normalize", "pca", "qc"]
