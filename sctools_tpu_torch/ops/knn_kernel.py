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

Both kernels take any ``k ≥ 1`` and any width ``d ≥ 1``, as the
reference does (it pads k and d to the lane and sets no cap); both C
entry points choose the build by shape through one rule
(``csrc/knn_core.cuh`` ``by_shape``, read back by ``knn_select_build``
/ ``knn_binned_build``):

* ``k ≤ 256`` keeps each query's list in the warp's registers (builds
  for k ≤ 16, 32, 64, 128, 256); above it one build keeps the lists in
  device memory at the rows' output slots and merges them slot by slot,
  with no upper bound (``csrc/knn_core.cuh`` ``MemList``);
* ``d ≤ 256`` keeps a block's query tile resident in shared memory;
  wider rows take the WIDE builds, whose stages carry the query tile's
  feature rows beside the candidates'.  Every score is the same fmaf
  chain over the features either way, so the choice moves no bit.
"""

from __future__ import annotations

import ctypes

import torch

from .. import cuda_build
from ..config import config, round_up, true_f32

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
    if k < 1:
        raise ValueError(f"k={k} must be at least 1")
    if q.shape[1] < 1:
        raise ValueError("rows of no feature")
    if max(q.shape[0], c.shape[0], k) >= 2 ** 31:
        raise ValueError("more than 2**31 - 1 rows (int32 ids)")


def knn_select(q: torch.Tensor, c: torch.Tensor, *, k: int,
               metric: str = "cosine", exclude_self: bool = False
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-``k`` scores of each row of ``q`` (nq, d) against ``c``
    (nc, d): ``(values (nq, k) float32, ids (nq, k) int32)``.  CPU
    tensors go to ``knn_select_plain``; CUDA tensors to the kernel, which
    takes both operands packed by ``pack_tiles`` and merges its candidate
    splits in a second launch, after a norms launch for euclidean (one
    count in ``knn_select.launches`` a call)."""
    _check(q, c, k, metric)
    if q.device.type == "cpu":
        return knn_select_plain(q, c, k=k, metric=metric,
                                exclude_self=exclude_self)
    if q.device.type != "cuda":
        raise ValueError(f"knn_select runs on cpu or cuda, not {q.device}")
    out_v, out_i, launch = _packed_launch("sct_knn_select",
                                          knn_select_layout(), q, c, k,
                                          metric, exclude_self)
    if launch is None:
        return out_v, out_i
    with torch.cuda.device(q.device):
        code = launch()
        knn_select.launches += 1
    cuda_build.check(code, "knn_select launch")
    return out_v, out_i


knn_select.launches = 0  # kernel launches, for checks that a run used it

_LAYOUT_KEYS = ("query_tile", "cand_tile", "splits", "ring", "rows_a_lane",
                "cols_a_lane", "registers_k16", "local_bytes_k16",
                "registers_k32", "local_bytes_k32")
_LAYOUTS: dict = {}


def _layout(entry: str) -> dict:
    if entry not in _LAYOUTS:
        out = (ctypes.c_int * len(_LAYOUT_KEYS))()
        code = getattr(cuda_build.library(), entry)(ctypes.addressof(out))
        cuda_build.check(code, entry)
        _LAYOUTS[entry] = dict(zip(_LAYOUT_KEYS, out))
    return _LAYOUTS[entry]


def knn_select_layout() -> dict:
    """The exact kernel's compile-time sizes (``csrc/knn_select.cu``;
    builds the library on first use): queries a block (``query_tile``),
    candidates a tile (``cand_tile``), candidate splits (``splits``),
    candidate stages in flight at most (``ring``), score rows and columns
    a lane, and the registers and local-memory bytes a thread of the
    K = 16 and K = 32 builds."""
    return _layout("sct_knn_select_layout")


def knn_binned_layout() -> dict:
    """The binned kernel's sizes (``csrc/knn_binned.cu``), under the keys
    of ``knn_select_layout``; ``splits`` is the most bin-chunk splits
    (a launch takes ``min(splits, n_bins / cand_tile)``)."""
    return _layout("sct_knn_binned_layout")


def _build(entry: str, k: int, d: int) -> dict:
    out = (ctypes.c_int * 4)()
    code = getattr(cuda_build.library(), entry)(k, d, ctypes.addressof(out))
    cuda_build.check(code, entry)
    return {"list_size": out[0], "wide": bool(out[1]),
            "registers": out[2], "local_bytes": out[3]}


def knn_select_build(k: int, d: int) -> dict:
    """The build of ``csrc/knn_select.cu`` that a search at (k, d)
    launches, chosen as the launch chooses it (``by_shape`` in
    ``knn_core.cuh``): its ``list_size``, ``wide``, and the
    ``registers`` and ``local_bytes`` a thread of it takes."""
    return _build("sct_knn_select_build", k, d)


def knn_binned_build(k: int, d: int) -> dict:
    """``knn_select_build`` for ``csrc/knn_binned.cu``."""
    return _build("sct_knn_binned_build", k, d)


def _packed_launch(entry: str, layout: dict, q: torch.Tensor,
                   c: torch.Tensor, k: int, metric: str, exclude_self: bool,
                   *extra: int):
    """The outputs of a kernel launch on packed operands and the launch
    itself, ``(out_v, out_i, launch)``: ``launch()`` calls the C entry
    ``entry`` (q, c, nq, nc, d, k, *extra, euclid, exclude_self, out_v,
    out_i, scratch, stream) on the current stream and returns its error
    code; it is None when there is no query.  Packing (``pack_tiles`` at
    the layout's tiles) and the scratch (the split lists, then the
    euclidean norms) are made here."""
    nq, d = q.shape
    out_v = torch.empty((nq, k), dtype=torch.float32, device=q.device)
    out_i = torch.empty((nq, k), dtype=torch.int32, device=q.device)
    if nq == 0:
        return out_v, out_i, None
    lib = cuda_build.library()
    qb, cb, splits = (layout["query_tile"], layout["cand_tile"],
                      layout["splits"])
    qp = pack_tiles(q, qb)
    cp = qp if c is q and qb == cb else pack_tiles(c, cb)
    euclid = metric == "euclidean"
    lists = 2 * splits * nq * k if splits > 1 else 0
    norms = round_up(nq, qb) + round_up(c.shape[0], cb) if euclid else 0
    scratch = torch.empty((lists + norms,), dtype=torch.float32,
                          device=q.device)

    def launch() -> int:
        stream = torch.cuda.current_stream(q.device).cuda_stream
        return getattr(lib, entry)(
            qp.data_ptr(), cp.data_ptr(), nq, c.shape[0], d, k, *extra,
            int(euclid), int(exclude_self), out_v.data_ptr(),
            out_i.data_ptr(), scratch.data_ptr(), stream)

    return out_v, out_i, launch


def pack_tiles(x: torch.Tensor, width: int) -> torch.Tensor:
    """``x`` (n, d) as the kernel reads it: float32 tiles of ``width``
    rows, tile-major and feature-major inside, (ceil(n / width), d,
    width), zero past row n (bf16 widens exactly)."""
    n, d = x.shape
    tiles = -(-n // width)
    out = torch.empty((tiles, d, width), dtype=torch.float32,
                      device=x.device)
    rows = out.permute(0, 2, 1)  # (tiles, width, d) view of the same memory
    whole = n // width
    rows[:whole].copy_(x[:whole * width].reshape(whole, width, d))
    if whole < tiles:
        rows[whole, :n - whole * width].copy_(x[whole * width:])
        rows[whole, n - whole * width:].zero_()
    return out


def knn_merge_plain(vals: torch.Tensor, ids: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version of the kernel's merge launch: the top ``k`` of
    each query over ``S`` lists ``vals``/``ids`` (S, nq, k), each sorted
    by (value descending, id ascending) over ascending id ranges, by
    (value descending, lower list first); ``(values (nq, k) float32,
    ids (nq, k) int32)``, id -1 where no finite value is left."""
    s, nq, k = vals.shape
    allv = vals.permute(1, 0, 2).reshape(nq, s * k)
    alli = ids.permute(1, 0, 2).reshape(nq, s * k)
    v, sel = torch.sort(allv, dim=1, descending=True, stable=True)
    out_v = torch.empty((nq, k), dtype=torch.float32, device=vals.device)
    out_i = torch.empty((nq, k), dtype=torch.int32, device=vals.device)
    _write_top(v[:, :k], torch.gather(alli, 1, sel[:, :k]), out_v, out_i)
    return out_v, out_i


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
    ``csrc/knn_binned.cu``, which takes both operands packed by
    ``pack_tiles`` and merges its bin-chunk splits in a second launch,
    after a norms launch for euclidean (one count in
    ``knn_binned.launches`` a call)."""
    _check(q, c, k, metric)
    n_bins = binned_bins(k, n_bins)
    if c.shape[0] + n_bins >= 2 ** 31:
        raise ValueError("nc + n_bins >= 2**31 (int32 bin keys)")
    if q.device.type == "cpu":
        return knn_binned_plain(q, c, k=k, n_bins=n_bins, metric=metric,
                                exclude_self=exclude_self)
    if q.device.type != "cuda":
        raise ValueError(f"knn_binned runs on cpu or cuda, not {q.device}")
    out_v, out_i, launch = _packed_launch("sct_knn_binned",
                                          knn_binned_layout(), q, c, k,
                                          metric, exclude_self, n_bins)
    if launch is None:
        return out_v, out_i
    with torch.cuda.device(q.device):
        code = launch()
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
