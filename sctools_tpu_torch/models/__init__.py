"""Deep probabilistic models.  Importing registers their ops."""

from . import scvi  # noqa: F401
