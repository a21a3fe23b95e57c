"""Fused distance + top-k for ``neighbors.knn``: the wrappers of the
CUDA kernels ``csrc/knn_select.cu`` (exact merge) and
``csrc/knn_binned.cu`` (binned merge, ``knn_impl="pallas_binned"``) and
their plain PyTorch versions.

Counterpart of ``sctools_tpu/ops/pallas_knn.py`` (``_knn_kernel`` and
``_knn_kernel_binned``).  ``knn_select`` takes rows already prepared by ``knn._prep`` (normalised
for cosine, cast to the matmul dtype) and returns, for each query row,
the top ``k`` scores by (value descending, candidate id ascending):
``s = q·c`` for cosine, ``s = -(‖q‖² − 2·q·c + ‖c‖²)`` for euclidean,
in float32, with the self pair masked under ``exclude_self``.  Slots
with no finite candidate hold ``-inf`` and id ``-1``.

Each wrapper picks by the tensor's device alone: the plain
version for a CPU tensor, the kernel for a CUDA tensor (or it raises).
There is no fallback from the kernel to the plain version.
"""

from __future__ import annotations

import torch

from .. import cuda_build
from ..config import config, round_up, true_f32

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
    nq = q.shape[0]
    out_v = torch.empty((nq, k), dtype=torch.float32, device=q.device)
    out_i = torch.empty((nq, k), dtype=torch.int32, device=q.device)
    for q0, b, tiles in _score_tiles(q, c, metric, exclude_self, query_block,
                                     cand_block):
        bv = torch.full((b, k), float("-inf"), device=q.device)
        bi = torch.full((b, k), -1, dtype=torch.int64, device=q.device)
        for gcol, s in tiles:
            allv = torch.cat([bv, s], dim=1)
            alli = torch.cat([bi, gcol.expand(b, -1)], dim=1)
            v, sel = torch.sort(allv, dim=1, descending=True, stable=True)
            bv = v[:, :k]
            bi = torch.gather(alli, 1, sel[:, :k])
        _write_top(bv, bi, out_v[q0:q0 + b], out_i[q0:q0 + b])
    return out_v, out_i


def _score_tiles(q: torch.Tensor, c: torch.Tensor, metric: str,
                 exclude_self: bool, query_block: int, cand_block: int):
    """The plain versions' score loop: per block of ``query_block``
    queries, ``(q0, rows, tiles)`` where ``tiles`` yields ``(gcol, s)``
    for the candidate blocks in ascending order: the global candidate
    ids and the (rows, len(gcol)) float32 scores of ``knn_select``'s
    docstring, in true float32."""
    nq, nc = q.shape[0], c.shape[0]
    qf, cf = q.float(), c.float()
    euclid = metric == "euclidean"
    cn2 = (cf * cf).sum(dim=1) if euclid else None

    def tiles(qb, q0):
        qn2 = (qb * qb).sum(dim=1) if euclid else None
        qids = torch.arange(q0, q0 + qb.shape[0], device=q.device)
        for c0 in range(0, nc, cand_block):
            c1 = min(nc, c0 + cand_block)
            with true_f32():
                s = qb @ cf[c0:c1].T
            if euclid:
                s = -((qn2[:, None] - 2.0 * s) + cn2[None, c0:c1])
            gcol = torch.arange(c0, c1, device=q.device)
            if exclude_self:
                s = s.masked_fill(gcol[None, :] == qids[:, None],
                                  float("-inf"))
            yield gcol, s

    for q0 in range(0, nq, query_block):
        qb = qf[q0:q0 + query_block]
        yield q0, qb.shape[0], tiles(qb, q0)


def _write_top(v: torch.Tensor, ids: torch.Tensor, out_v: torch.Tensor,
               out_i: torch.Tensor) -> None:
    """Store a top-k block; slots without a finite value get id -1."""
    out_v.copy_(v)
    out_i.copy_(torch.where(torch.isfinite(v), ids, -1))


# ----------------------------------------------------------------------
# binned merge
# ----------------------------------------------------------------------

BINS_MULTIPLE = 128  # the reference rounds n_bins to its lane width


def binned_bins(k: int, n_bins: int) -> int:
    """``n_bins`` rounded up to a multiple of 128, after checking that
    the ``n_bins`` asked for holds ``k`` survivors
    (``sctools_tpu/ops/pallas_knn.py:268-272``)."""
    if k > n_bins:
        raise ValueError(f"k={k} > n_bins={n_bins}")
    return round_up(max(int(n_bins), 1), BINS_MULTIPLE)


def knn_binned(q: torch.Tensor, c: torch.Tensor, *, k: int, n_bins: int,
               metric: str = "cosine", exclude_self: bool = False
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """The binned-approximate top ``k`` of each row of ``q`` against
    ``c``: the scores of ``knn_select``, one survivor per bin ``b`` =
    the best of the columns ``j ≡ b (mod n_bins)`` (ties to the lowest
    column; a bin with no finite score keeps id -1), then the top ``k``
    of the survivors by value descending, ties to the lowest BIN (not
    the lowest id).  Exact when ``c`` has at most ``n_bins`` rows.
    ``n_bins`` must be ≥ k and is rounded up to a multiple of 128.
    Returns ``(values (nq, k) float32, ids (nq, k) int32)``.  CPU
    tensors go to ``knn_binned_plain``; CUDA tensors to the kernel
    ``csrc/knn_binned.cu``."""
    _check(q, c, k, metric)
    n_bins = binned_bins(k, n_bins)
    if q.device.type == "cpu":
        return knn_binned_plain(q, c, k=k, n_bins=n_bins, metric=metric,
                                exclude_self=exclude_self)
    if q.device.type != "cuda":
        raise ValueError(f"knn_binned runs on cpu or cuda, not {q.device}")
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
        code = lib.sct_knn_binned(
            q.data_ptr(), c.data_ptr(), nq, c.shape[0], d, k, n_bins,
            int(q.dtype == torch.bfloat16), int(metric == "euclidean"),
            int(exclude_self), out_v.data_ptr(), out_i.data_ptr(), stream)
        knn_binned.launches += 1
    cuda_build.check(code, "knn_binned launch")
    return out_v, out_i


knn_binned.launches = 0


def bin_survivors(q: torch.Tensor, c: torch.Tensor, *, n_bins: int,
                  metric: str = "cosine", exclude_self: bool = False,
                  query_block: int | None = None,
                  cand_block: int | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Each query's survivor of every bin, ``(values (nq, n_bins),
    ids (nq, n_bins) int64)``, by the explicit fold of the reference's
    binned kernel: per candidate block (a multiple of ``n_bins``
    columns) the first fold holding a bin's maximum, then a strictly
    greater test across blocks, so ties go to the lowest column and the
    result does not depend on the blocking.  ``n_bins`` is used as
    given (``knn_binned`` rounds it)."""
    query_block = query_block or min(config.row_block, 256)
    cand_block = round_up(cand_block or min(config.col_block, 1024),
                          n_bins)
    nq = q.shape[0]
    dev = q.device
    acc_v = torch.empty((nq, n_bins), dtype=torch.float32, device=dev)
    acc_i = torch.empty((nq, n_bins), dtype=torch.int64, device=dev)
    bins = torch.arange(n_bins, device=dev)
    for q0, b, tiles in _score_tiles(q, c, metric, exclude_self, query_block,
                                     cand_block):
        bv = torch.full((b, n_bins), float("-inf"), device=dev)
        bi = torch.full((b, n_bins), -1, dtype=torch.int64, device=dev)
        for gcol, s in tiles:
            folds = -(-s.shape[1] // n_bins)
            pad = folds * n_bins - s.shape[1]
            s3 = torch.nn.functional.pad(s, (0, pad), value=float("-inf")
                                         ).reshape(b, folds, n_bins)
            tile_max = s3.amax(dim=1)
            fold_iota = torch.arange(folds, device=dev)[None, :, None]
            fold_sel = torch.where(s3 >= tile_max[:, None, :], fold_iota,
                                   folds).amin(dim=1)
            tile_idx = gcol[0] + fold_sel * n_bins + bins
            better = tile_max > bv
            bv = torch.where(better, tile_max, bv)
            bi = torch.where(better & torch.isfinite(tile_max), tile_idx, bi)
        acc_v[q0:q0 + b] = bv
        acc_i[q0:q0 + b] = bi
    return acc_v, acc_i


def knn_binned_plain(q: torch.Tensor, c: torch.Tensor, *, k: int,
                     n_bins: int, metric: str = "cosine",
                     exclude_self: bool = False,
                     query_block: int | None = None,
                     cand_block: int | None = None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of ``knn_binned``: ``bin_survivors``,
    then a stable descending sort of the survivors, so equal values keep
    the lower bin."""
    _check(q, c, k, metric)
    n_bins = binned_bins(k, n_bins)
    acc_v, acc_i = bin_survivors(q, c, n_bins=n_bins, metric=metric,
                                 exclude_self=exclude_self,
                                 query_block=query_block,
                                 cand_block=cand_block)
    v, sel = torch.sort(acc_v, dim=1, descending=True, stable=True)
    out_v = torch.empty((q.shape[0], k), dtype=torch.float32,
                        device=q.device)
    out_i = torch.empty((q.shape[0], k), dtype=torch.int32, device=q.device)
    _write_top(v[:, :k], torch.gather(acc_i, 1, sel[:, :k]), out_v, out_i)
    return out_v, out_i
