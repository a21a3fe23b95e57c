"""Multi-device execution on a single-process mesh: the ring and
all-gather kNN, the sharded graph products, cell-sharded data
(``shard_celldata``) and the multi-process bring-up.

Importing registers ``neighbors.knn_multichip``."""

from . import knn_multichip, sharded_ops  # noqa: F401  (register ops)
from .graph_multichip import (diffuse_sharded, knn_matvec_sharded,
                              smooth_layers_sharded)
from .knn_multichip import knn_multichip_arrays
from .mesh import (CELL_AXIS, Mesh, active_mesh, cholesky_qr_blocks,
                   classify_bringup_error, coordination_sum,
                   init_distributed, make_mesh, mesh_host_groups,
                   mesh_signature, reduce_sum, shard_celldata)

__all__ = [
    "CELL_AXIS", "Mesh", "active_mesh", "make_mesh", "mesh_signature",
    "knn_multichip_arrays", "knn_matvec_sharded", "smooth_layers_sharded",
    "diffuse_sharded", "reduce_sum", "cholesky_qr_blocks",
    "shard_celldata", "init_distributed", "coordination_sum",
    "mesh_host_groups", "classify_bringup_error",
]
