"""Containers and data sources of the port."""

from . import concat, dataset, io, shardstore, sparse, stream, synthetic

__all__ = ["concat", "dataset", "io", "shardstore", "sparse", "stream",
           "synthetic"]
