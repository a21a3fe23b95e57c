"""Containers and data sources of the port."""

from . import dataset, sparse, synthetic

__all__ = ["dataset", "sparse", "synthetic"]
