"""Fused distance + exact top-k for ``neighbors.knn``: the wrapper of
the CUDA kernel ``csrc/knn_select.cu`` and its plain PyTorch version.

Counterpart of ``sctools_tpu/ops/pallas_knn.py`` (``_knn_kernel``).
``knn_select`` takes rows already prepared by ``knn._prep`` (normalised
for cosine, cast to the matmul dtype) and returns, for each query row,
the top ``k`` scores by (value descending, candidate id ascending):
``s = q·c`` for cosine, ``s = -(‖q‖² − 2·q·c + ‖c‖²)`` for euclidean,
in float32, with the self pair masked under ``exclude_self``.  Slots
with no finite candidate hold ``-inf`` and id ``-1``.

It picks between the two by the tensor's device alone: the plain
version for a CPU tensor, the kernel for a CUDA tensor (or it raises).
There is no fallback from the kernel to the plain version.
"""

from __future__ import annotations

import torch

from .. import cuda_build
from ..config import config, true_f32

# Limits of the kernel (csrc/knn_select.cu K_MAX, D_MAX); the wrapper
# raises past them on every device so both versions take the same
# inputs.
K_MAX = 256
D_MAX = 256


def _check(q: torch.Tensor, c: torch.Tensor, k: int, metric: str) -> None:
    if metric not in ("cosine", "euclidean"):
        raise ValueError(f"unknown metric {metric!r}")
    if q.ndim != 2 or c.ndim != 2 or q.shape[1] != c.shape[1]:
        raise ValueError(
            f"expected q (nq, d) and c (nc, d), got {tuple(q.shape)} and "
            f"{tuple(c.shape)}")
    if q.device != c.device:
        raise ValueError(f"q on {q.device}, c on {c.device}")
    if q.dtype != c.dtype or q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(
            f"q and c must share dtype float32 or bfloat16, got {q.dtype} "
            f"and {c.dtype}")
    if not 1 <= k <= K_MAX:
        raise ValueError(f"k={k} outside 1..{K_MAX} (the kernel's K_MAX)")
    if not 1 <= q.shape[1] <= D_MAX:
        raise ValueError(
            f"d={q.shape[1]} outside 1..{D_MAX} (the kernel stages whole "
            "rows in shared memory)")
    if max(q.shape[0], c.shape[0]) >= 2 ** 31:
        raise ValueError("more than 2**31 - 1 rows (int32 ids)")


def knn_select(q: torch.Tensor, c: torch.Tensor, *, k: int,
               metric: str = "cosine", exclude_self: bool = False
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-``k`` scores of each row of ``q`` (nq, d) against ``c``
    (nc, d): ``(values (nq, k) float32, ids (nq, k) int32)``.  CPU
    tensors go to ``knn_select_plain``; CUDA tensors to the kernel."""
    _check(q, c, k, metric)
    if q.device.type == "cpu":
        return knn_select_plain(q, c, k=k, metric=metric,
                                exclude_self=exclude_self)
    if q.device.type != "cuda":
        raise ValueError(f"knn_select runs on cpu or cuda, not {q.device}")
    q = q.contiguous()
    c = c.contiguous()
    nq, d = q.shape
    out_v = torch.empty((nq, k), dtype=torch.float32, device=q.device)
    out_i = torch.empty((nq, k), dtype=torch.int32, device=q.device)
    if nq == 0:
        return out_v, out_i
    lib = cuda_build.library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = lib.sct_knn_select(
            q.data_ptr(), c.data_ptr(), nq, c.shape[0], d, k,
            int(q.dtype == torch.bfloat16), int(metric == "euclidean"),
            int(exclude_self), out_v.data_ptr(), out_i.data_ptr(), stream)
        knn_select.launches += 1
    cuda_build.check(code, "knn_select launch")
    return out_v, out_i


knn_select.launches = 0  # kernel launches, for checks that a run used it


def knn_select_plain(q: torch.Tensor, c: torch.Tensor, *, k: int,
                     metric: str = "cosine", exclude_self: bool = False,
                     query_block: int | None = None,
                     cand_block: int | None = None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of ``knn_select`` (the counterpart of
    the blocked ``_knn_jit`` in ``sctools_tpu/ops/knn.py``).  Candidate
    blocks are swept in ascending order; each score tile is merged into
    the running top-k by a stable descending sort of ``[running,
    tile]``, so equal values keep the lower id.  bf16 inputs are
    multiplied as their f32 values (``torch.matmul`` on bf16 would
    round the product to bf16).  Blocks default to the reference
    kernel's tiles, ``min(row_block, 256)`` × ``min(col_block, 1024)``."""
    _check(q, c, k, metric)
    query_block = query_block or min(config.row_block, 256)
    cand_block = cand_block or min(config.col_block, 1024)
    nq, nc = q.shape[0], c.shape[0]
    qf, cf = q.float(), c.float()
    euclid = metric == "euclidean"
    cn2 = (cf * cf).sum(dim=1) if euclid else None
    out_v = torch.empty((nq, k), dtype=torch.float32, device=q.device)
    out_i = torch.empty((nq, k), dtype=torch.int32, device=q.device)
    with true_f32():
        for q0 in range(0, nq, query_block):
            qb = qf[q0:q0 + query_block]
            b = qb.shape[0]
            qn2 = (qb * qb).sum(dim=1) if euclid else None
            qids = torch.arange(q0, q0 + b, device=q.device)
            bv = torch.full((b, k), float("-inf"), device=q.device)
            bi = torch.full((b, k), -1, dtype=torch.int64, device=q.device)
            for c0 in range(0, nc, cand_block):
                c1 = min(nc, c0 + cand_block)
                s = qb @ cf[c0:c1].T
                if euclid:
                    s = -((qn2[:, None] - 2.0 * s) + cn2[None, c0:c1])
                gcol = torch.arange(c0, c1, device=q.device)
                if exclude_self:
                    s = s.masked_fill(gcol[None, :] == qids[:, None],
                                      float("-inf"))
                allv = torch.cat([bv, s], dim=1)
                alli = torch.cat([bi, gcol.expand(b, -1)], dim=1)
                v, sel = torch.sort(allv, dim=1, descending=True,
                                    stable=True)
                bv = v[:, :k]
                bi = torch.gather(alli, 1, sel[:, :k])
            bi = torch.where(torch.isfinite(bv), bi, -1)
            out_v[q0:q0 + b] = bv
            out_i[q0:q0 + b] = bi.to(torch.int32)
    return out_v, out_i
