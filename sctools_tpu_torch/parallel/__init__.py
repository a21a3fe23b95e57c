"""Multi-device execution on a single-process mesh: the ring and
all-gather kNN and the sharded graph products.

Importing registers ``neighbors.knn_multichip``."""

from . import knn_multichip  # noqa: F401  (registers the op)
from .graph_multichip import (diffuse_sharded, knn_matvec_sharded,
                              smooth_layers_sharded)
from .knn_multichip import knn_multichip_arrays
from .mesh import CELL_AXIS, Mesh, active_mesh, make_mesh, mesh_signature

__all__ = [
    "CELL_AXIS", "Mesh", "active_mesh", "make_mesh", "mesh_signature",
    "knn_multichip_arrays", "knn_matvec_sharded", "smooth_layers_sharded",
    "diffuse_sharded",
]
