"""Pairwise distance matrices: ``distance.pairwise``.

Counterpart of ``sctools_tpu/ops/distance.py``.  The op materialises the
full (n × n) matrix, so it is meant for small and medium n; the kNN
path (``neighbors.knn``) never does.  The reference computes it in one
XLA matmul outside any Pallas kernel; here it is plain torch, a
``torch.matmul`` per block of ``config.row_block`` query rows.
"""

from __future__ import annotations

import torch

from ..config import config, resolve_device, true_f32
from ..data.dataset import CellData
from ..registry import register
from .knn import _get_rep


def pairwise_arrays(query: torch.Tensor, cand: torch.Tensor,
                    metric: str = "cosine") -> torch.Tensor:
    """The (n_query, n_cand) float32 distance matrix: ``1 - cos`` for
    cosine, the L2 distance for euclidean.  The inputs are cast to
    ``config.matmul_dtype`` (and normalised there for cosine, as the
    reference does) and multiplied as their float32 values in true
    float32."""
    if metric not in ("cosine", "euclidean"):
        raise ValueError(f"unknown metric {metric!r}")
    mm = config.matmul_torch_dtype()
    q, c = query.to(mm), cand.to(mm)
    if metric == "cosine":
        q = q / torch.clamp(torch.linalg.vector_norm(q, dim=1, keepdim=True),
                            min=1e-12)
        c = c / torch.clamp(torch.linalg.vector_norm(c, dim=1, keepdim=True),
                            min=1e-12)
    qf, cf = q.float(), c.float()
    cn2 = (cf * cf).sum(dim=1)
    out = torch.empty((qf.shape[0], cf.shape[0]), dtype=torch.float32,
                      device=qf.device)
    block = config.row_block
    for q0 in range(0, qf.shape[0], block):
        qb = qf[q0:q0 + block]
        with true_f32():
            s = qb @ cf.T
        if metric == "cosine":
            out[q0:q0 + block] = 1.0 - s
        else:
            d2 = ((qb * qb).sum(dim=1)[:, None] - 2.0 * s) + cn2[None, :]
            out[q0:q0 + block] = torch.sqrt(torch.clamp(d2, min=0.0))
    return out


@register("distance.pairwise")
def pairwise(data: CellData, metric: str = "cosine", use_rep: str = "X_pca",
             device=None) -> CellData:
    """Adds obsp ``pairwise_distances`` ((n_cells, n_cells) float32) and
    uns ``pairwise_metric``."""
    data = data.to_device(resolve_device(device))
    rep = _get_rep(data, use_rep)[:data.n_cells]
    return data.with_obsp(
        pairwise_distances=pairwise_arrays(rep, rep, metric=metric)
    ).with_uns(pairwise_metric=metric)
