"""Containers and data sources of the port."""

from . import dataset, io, shardstore, sparse, stream, synthetic

__all__ = ["dataset", "io", "shardstore", "sparse", "stream", "synthetic"]
