"""Deep probabilistic models.  Importing registers their ops."""

from . import scvi, train_stream  # noqa: F401
