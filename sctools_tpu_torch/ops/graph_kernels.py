"""Graph kernels of the post-kNN tail: the wrappers of the CUDA kernels
``csrc/graph_matvec.cu``, ``csrc/graph_rmatvec.cu``,
``csrc/graph_jaccard.cu`` and ``csrc/tsne_repulsion.cu``, and their
plain PyTorch versions.

Counterpart of ``sctools_tpu/ops/pallas_graph.py``:

* ``matvec``  — ``P @ x`` on the padded (n, k) edge list, ``y[r] =
  Σ_t w[r,t]·x[idx[r,t]]`` with -1 ids weighing nothing
  (``_matvec_kernel``);
* ``rmatvec`` — ``Pᵀ @ x``, the segment-sum adjoint ``y[c] =
  Σ_{idx[r,t]=c} w[r,t]·x[r]`` (``_rmatvec_kernel``), over a
  destination order that ``rmatvec_order`` builds once per graph;
* ``jaccard`` — per-edge ``|N(i)∩N(j)| / |N(i)∪N(j)|`` with the
  reference's pairwise count (``_jaccard_kernel``);
* ``tsne_repulsion`` — the exact all-pairs t-SNE repulsion and its
  normaliser Z (``_tsne_rep_kernel``);
* ``gather_rows`` — ``x[idx]`` in row blocks (plain torch; the
  reference's ``gather_rows`` is no Pallas kernel either).

Each wrapper picks by the tensor's device alone: the plain version for
a CPU tensor, the kernel for a CUDA tensor (or it raises).  There is no
fallback from a kernel to its plain version, and each wrapper counts
its kernel launches in ``.launches``.

The CUDA kernels gather rows directly, so they need no band:
``band_rows`` (the bandwidth ``graph.reorder`` records) is accepted for
signature parity with the reference and unused.  The layout still
matters for speed, since a reordered graph gathers from nearby rows.
"""

from __future__ import annotations

import contextlib
import ctypes

import torch

from .. import cuda_build
from ..config import config, true_f32

# Limits of the kernels (csrc/*.cu K_MAX, D_MAX); the wrappers raise
# past them on every device so both versions take the same inputs.
K_MAX = 256
TSNE_D_MAX = 4


def _check_edges(knn_idx: torch.Tensor, weights: torch.Tensor | None = None
                 ) -> None:
    config.resolved_graph_impl()
    if knn_idx.ndim != 2:
        raise ValueError(f"knn_idx must be (n, k), got {tuple(knn_idx.shape)}")
    if knn_idx.dtype not in (torch.int32, torch.int64):
        raise ValueError(
            f"knn_idx must be int32 or int64, not {knn_idx.dtype}")
    if not 1 <= knn_idx.shape[1] <= K_MAX:
        raise ValueError(
            f"k={knn_idx.shape[1]} outside 1..{K_MAX} (the kernels' K_MAX)")
    if knn_idx.shape[0] >= 2 ** 31:
        raise ValueError("more than 2**31 - 1 rows (int32 ids)")
    if weights is not None:
        if weights.shape != knn_idx.shape:
            raise ValueError(
                f"weights {tuple(weights.shape)} must match knn_idx "
                f"{tuple(knn_idx.shape)}")
        if weights.device != knn_idx.device:
            raise ValueError(
                f"weights on {weights.device}, knn_idx on {knn_idx.device}")


def _kernel_device(t: torch.Tensor, what: str) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU one
    (run the plain version); raises for any other device."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{what} runs on cpu or cuda, not {t.device}")
    return True


def _stream(device: torch.device) -> int:
    # the raw handle, without building a torch.cuda.Stream object
    return torch._C._cuda_getCurrentRawStream(device.index)


def _as(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``t`` as a contiguous ``dtype`` tensor, itself when it is one (no
    dispatch: a narrow launch costs less on the card than two no-op
    conversions on the host)."""
    if t.dtype == dtype and t.is_contiguous():
        return t
    return t.to(dtype).contiguous()


def _guard(device: torch.device):
    """Makes ``device`` current for a launch, or nothing when it already
    is: entering a device guard takes as much host time as a narrow
    matvec takes on the card."""
    if device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


# ----------------------------------------------------------------------
# matvec
# ----------------------------------------------------------------------


def matvec(knn_idx: torch.Tensor, weights: torch.Tensor, x: torch.Tensor,
           *, band_rows: int | None = None) -> torch.Tensor:
    """``P @ x``: (n, d) float32 with ``y[r] = Σ_t w[r,t]·x[idx[r,t]]``
    for ``knn_idx`` (n, k) ids in ``[-1, x.shape[0])`` (-1 weighs
    nothing), ``weights`` (n, k) and ``x`` (m, d).  ``band_rows`` is
    unused (module docstring).  CPU tensors go to ``matvec_plain``.

    One difference from the reference's ``0·x[0]`` on a -1 slot: the
    kernel skips the slot, so a NaN or inf in ``x[0]`` does not leak
    into rows with padding there."""
    del band_rows  # the kernel gathers directly; no band to bound
    _check_edges(knn_idx, weights)
    if x.ndim != 2 or x.device != knn_idx.device:
        raise ValueError(
            f"x must be (m, d) on {knn_idx.device}, got {tuple(x.shape)} "
            f"on {x.device}")
    if not _kernel_device(knn_idx, "matvec"):
        return matvec_plain(knn_idx, weights, x)
    n, k = knn_idx.shape
    idx = _as(knn_idx, torch.int32)
    w = _as(weights, torch.float32)
    xf = _as(x, torch.float32)
    d = xf.shape[1]
    out = torch.empty((n, d), dtype=torch.float32, device=x.device)
    if n == 0 or d == 0:
        return out
    lib = cuda_build.library()
    with _guard(x.device):
        code = lib.sct_graph_matvec(
            idx.data_ptr(), w.data_ptr(), xf.data_ptr(), n, k, xf.shape[0],
            d, out.data_ptr(), _stream(x.device))
        matvec.launches += 1
    cuda_build.check(code, "graph_matvec launch")
    return out


matvec.launches = 0  # kernel launches, for checks that a run used it


def matvec_plain(knn_idx: torch.Tensor, weights: torch.Tensor,
                 x: torch.Tensor, block: int = 2048) -> torch.Tensor:
    """The plain PyTorch version of ``matvec``: per block of rows,
    gather the (block, k, d) neighbour rows and contract the k slots
    (``pallas_graph.py:_matvec_blocked_xla``), in true float32.  A -1
    slot gathers ``x[0]`` with weight 0, as the reference does."""
    n, k = knn_idx.shape
    dead = knn_idx < 0
    safe = torch.where(dead, 0, knn_idx).long()
    w = torch.where(dead, 0.0, weights.float())
    xf = x.float()
    d = xf.shape[1]
    out = torch.empty((n, d), dtype=torch.float32, device=x.device)
    with true_f32():
        for r0 in range(0, n, block):
            s = safe[r0:r0 + block]
            g = xf.index_select(0, s.reshape(-1)).reshape(*s.shape, d)
            out[r0:r0 + s.shape[0]] = torch.einsum(
                "nk,nkd->nd", w[r0:r0 + block], g)
    return out


# ----------------------------------------------------------------------
# rmatvec
# ----------------------------------------------------------------------


def rmatvec_order(knn_idx: torch.Tensor, n: int | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """The destination order of the edge list that ``rmatvec``'s kernel
    reads: ``(edges, offsets)``, int32 on ``knn_idx``'s device.
    ``edges`` holds the flat slot ids ``r·k + t`` of the edges with an id
    in ``[0, n)``, stably sorted by that id, so each destination keeps
    its incoming edges in ascending (r, t) order; destination c owns
    ``edges[offsets[c]:offsets[c + 1]]``.  ``n`` defaults to the number
    of rows.  Index bookkeeping only (sort, count, cumsum): build it
    once per graph and pass it to every ``rmatvec`` on that graph."""
    rows, k = knn_idx.shape
    n = rows if n is None else int(n)
    if not 0 <= n < 2 ** 31 or rows * k >= 2 ** 31:
        raise ValueError(f"n={n} or {rows}x{k} slots beyond int32 ids")
    flat = knn_idx.reshape(-1).long()
    slots = torch.nonzero((flat >= 0) & (flat < n)).reshape(-1)
    dest = flat[slots]
    edges = slots[torch.sort(dest, stable=True).indices]
    offsets = torch.zeros(n + 1, dtype=torch.int64, device=knn_idx.device)
    torch.cumsum(torch.bincount(dest, minlength=n), 0, out=offsets[1:])
    return edges.to(torch.int32), offsets.to(torch.int32)


def rmatvec(knn_idx: torch.Tensor, weights: torch.Tensor, x: torch.Tensor,
            n: int | None = None, *, band_rows: int | None = None,
            order: tuple[torch.Tensor, torch.Tensor] | None = None
            ) -> torch.Tensor:
    """``Pᵀ @ x``: (n, d) float32 with ``y[c] = Σ_{idx[r,t]=c}
    w[r,t]·x[r]`` for ``knn_idx`` and ``weights`` (rows, k) and ``x``
    (rows, d); ``n`` (default rows) may differ from rows, and ids
    outside ``[0, n)`` (-1 is the padding) add nothing.  ``order`` is
    ``rmatvec_order(knn_idx, n)``, built here when not given; callers
    that apply one graph many times build it once.  ``band_rows`` is
    unused (module docstring).  CPU tensors go to ``rmatvec_plain``,
    which needs no order.

    On the card each destination sums its edges in ascending (r, t)
    order with ``fmaf``, so the result is the same bit for bit from run
    to run."""
    del band_rows
    _check_edges(knn_idx, weights)
    rows = knn_idx.shape[0]
    n = rows if n is None else int(n)
    if x.ndim != 2 or x.shape[0] != rows or x.device != knn_idx.device:
        raise ValueError(
            f"x must be ({rows}, d) on {knn_idx.device}, got "
            f"{tuple(x.shape)} on {x.device}")
    if not _kernel_device(knn_idx, "rmatvec"):
        return rmatvec_plain(knn_idx, weights, x, n)
    edges, offsets = order if order is not None else rmatvec_order(
        knn_idx, n)
    if offsets.shape != (n + 1,) or edges.dtype != torch.int32 \
            or offsets.dtype != torch.int32 or edges.device != x.device:
        raise ValueError(
            "order must be rmatvec_order(knn_idx, n) on x's device: int32 "
            f"edges and ({n + 1},) int32 offsets")
    k = knn_idx.shape[1]
    w = _as(weights, torch.float32)
    xf = _as(x, torch.float32)
    d = xf.shape[1]
    out = torch.empty((n, d), dtype=torch.float32, device=x.device)
    if n == 0 or d == 0:
        return out
    lib = cuda_build.library()
    with _guard(x.device):
        code = lib.sct_graph_rmatvec(
            edges.contiguous().data_ptr(), offsets.contiguous().data_ptr(),
            w.data_ptr(), xf.data_ptr(), k, n, d, out.data_ptr(),
            _stream(x.device))
        rmatvec.launches += 1
    cuda_build.check(code, "graph_rmatvec launch")
    return out


rmatvec.launches = 0


def rmatvec_plain(knn_idx: torch.Tensor, weights: torch.Tensor,
                  x: torch.Tensor, n: int | None = None, block: int = 2048
                  ) -> torch.Tensor:
    """The plain PyTorch version of ``rmatvec``: the reference's segment
    sum (``sctools_tpu/ops/graph.py:_knn_rmatvec_segsum``) with
    ``index_add_``, in blocks of rows; ids outside ``[0, n)`` go to a
    dropped bin n."""
    rows, k = knn_idx.shape
    n = rows if n is None else int(n)
    ids = knn_idx.long()
    dead = (ids < 0) | (ids >= n)
    seg = torch.where(dead, n, ids)
    w = torch.where(dead, 0.0, weights.float())
    xf = x.float()
    d = xf.shape[1]
    out = torch.zeros((n + 1, d), dtype=torch.float32, device=x.device)
    for r0 in range(0, rows, block):
        contrib = w[r0:r0 + block, :, None] * xf[r0:r0 + block, None, :]
        out.index_add_(0, seg[r0:r0 + block].reshape(-1),
                       contrib.reshape(-1, d))
    return out[:n]


# ----------------------------------------------------------------------
# jaccard
# ----------------------------------------------------------------------


def jaccard(knn_idx: torch.Tensor, *, band_rows: int | None = None
            ) -> torch.Tensor:
    """Per-edge Jaccard weights (n, k) float32 of the kNN graph
    ``knn_idx`` (n, k), ids in ``[-1, n)``: for slot t of row i with
    j = idx[i, t] ≥ 0, ``inter / max(|N(i)| + |N(j)| − inter, 1)``
    where ``inter`` counts the pairs (s, u) with ``idx[j, s] ==
    idx[i, u]`` (duplicates count, as in the reference) and |N| counts
    a row's valid slots; 0 on padded edges.  Exact: the counts are
    integers and the one division is IEEE.  ``band_rows`` is unused.
    CPU tensors go to ``jaccard_plain``."""
    del band_rows
    _check_edges(knn_idx)
    if not _kernel_device(knn_idx, "jaccard"):
        return jaccard_plain(knn_idx)
    n, k = knn_idx.shape
    idx = knn_idx.to(torch.int32).contiguous()
    out = torch.empty((n, k), dtype=torch.float32, device=idx.device)
    if n == 0:
        return out
    lib = cuda_build.library()
    with torch.cuda.device(idx.device):
        code = lib.sct_graph_jaccard(idx.data_ptr(), n, k, out.data_ptr(),
                                     _stream(idx.device))
        jaccard.launches += 1
    cuda_build.check(code, "graph_jaccard launch")
    return out


jaccard.launches = 0


def jaccard_plain(knn_idx: torch.Tensor, block: int = 1024) -> torch.Tensor:
    """The plain PyTorch version of ``jaccard``: the reference's slot
    loop (``pallas_graph.py:_jaccard_slotloop_xla``).  Row n of the
    lookup table is all -2, where -1 neighbours map; the row's own list
    pads with -3, so padding never matches."""
    n, k = knn_idx.shape
    idx = knn_idx.long()
    tab = torch.cat([torch.where(idx < 0, -2, idx),
                     torch.full((1, k), -2, dtype=idx.dtype,
                                device=idx.device)])
    out = torch.empty((n, k), dtype=torch.float32, device=idx.device)
    for r0 in range(0, n, block):
        iblk = idx[r0:r0 + block]
        own = torch.where(iblk < 0, -3, iblk)
        safe = torch.where(iblk < 0, n, iblk)
        inter = torch.empty(iblk.shape, dtype=torch.float32,
                            device=idx.device)
        vj = torch.empty_like(inter)
        for t in range(k):
            nbr_t = tab[safe[:, t]]  # (block, k)
            eq = nbr_t[:, :, None] == own[:, None, :]
            inter[:, t] = eq.sum(dim=(1, 2)).float()
            vj[:, t] = (nbr_t >= 0).sum(dim=1).float()
        vi = (iblk >= 0).sum(dim=1).float()
        union = vi[:, None] + vj - inter
        out[r0:r0 + iblk.shape[0]] = torch.where(
            iblk < 0, 0.0, inter / torch.clamp(union, min=1.0))
    return out


# ----------------------------------------------------------------------
# t-SNE repulsion
# ----------------------------------------------------------------------


def tsne_repulsion(y: torch.Tensor, n: int
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact t-SNE repulsion over the first ``n`` rows of ``y``
    (≥ n, dim ≤ 4) float32: ``(forces (n, dim), Z)`` with ``w_ij =
    1/(1 + ‖y_i − y_j‖²)`` for j ≠ i, ``forces_i = y_i·Σ_j w_ij² −
    Σ_j w_ij²·y_j`` and ``Z = max(Σ_ij w_ij, 1e-12)``.  The kernel sums
    ``w_ij²·(y_i − y_j)`` over the differences themselves; the plain
    version keeps the reference's expanded form, ``‖y_i − y_j‖² =
    max(‖y_i‖² − 2 y_i·y_j + ‖y_j‖², 0)``.  CPU tensors go to
    ``tsne_repulsion_plain``."""
    config.resolved_graph_impl()
    if y.ndim != 2 or not 1 <= y.shape[1] <= TSNE_D_MAX:
        raise ValueError(
            f"y must be (rows, dim) with 1 <= dim <= {TSNE_D_MAX} (the "
            f"kernel's D_MAX), got {tuple(y.shape)}")
    if not 0 <= n <= y.shape[0] or n >= 2 ** 31:
        raise ValueError(f"n={n} outside 0..{y.shape[0]} rows of y")
    if not _kernel_device(y, "tsne_repulsion"):
        return tsne_repulsion_plain(y, n)
    yf = _as(y[:n], torch.float32)
    dim = yf.shape[1]
    dev = y.device
    forces = torch.empty((n, dim), dtype=torch.float32, device=dev)
    zrow = torch.empty((n,), dtype=torch.float32, device=dev)
    if n:
        lib = cuda_build.library()
        # the partial sums of each candidate split, combined in the kernel
        splits = tsne_repulsion_layout()["splits"]
        scratch = torch.empty((splits, dim + 1, n), dtype=torch.float32,
                              device=dev)
        with _guard(dev):
            code = lib.sct_tsne_repulsion(
                yf.data_ptr(), n, dim, forces.data_ptr(), zrow.data_ptr(),
                scratch.data_ptr(), _stream(dev))
            tsne_repulsion.launches += 1
        cuda_build.check(code, "tsne_repulsion launch")
    # Z summed outside the kernel, where the reference sums it: no
    # atomics, so it is the same from run to run
    return forces, torch.clamp(zrow.sum(), min=1e-12)


tsne_repulsion.launches = 0

_TSNE_LAYOUT: dict | None = None


def tsne_repulsion_layout() -> dict:
    """The repulsion kernel's compile-time sizes (``csrc/tsne_repulsion.cu``;
    builds the library on first use): query rows a block
    (``query_tile``), candidate rows a staged tile (``cand_tile``),
    candidate splits (``splits``) and query rows a thread (``qpt``)."""
    global _TSNE_LAYOUT
    if _TSNE_LAYOUT is None:
        out = (ctypes.c_int * 4)()
        cuda_build.library().sct_tsne_repulsion_layout(ctypes.addressof(out))
        _TSNE_LAYOUT = dict(zip(("query_tile", "cand_tile", "splits", "qpt"),
                                out))
    return _TSNE_LAYOUT


def tsne_repulsion_plain(y: torch.Tensor, n: int, block: int = 2048
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of ``tsne_repulsion``: the reference's
    blocked two-matmul sweep (``sctools_tpu/ops/tsne.py:114-141``) in
    true float32, with the self pair masked to w = 0 as the kernel
    masks it (the sweep there keeps it and subtracts 1 from Z)."""
    yf = y[:n].float()
    dim = yf.shape[1]
    yn2 = (yf * yf).sum(dim=1)
    forces = torch.empty((n, dim), dtype=torch.float32, device=y.device)
    zrow = torch.empty((n,), dtype=torch.float32, device=y.device)
    with true_f32():
        for r0 in range(0, n, block):
            yb = yf[r0:r0 + block]
            b = yb.shape[0]
            s = yb @ yf.T
            d2 = torch.clamp((yn2[r0:r0 + b, None] - 2.0 * s)
                             + yn2[None, :], min=0.0)
            w = 1.0 / (1.0 + d2)
            rows = torch.arange(b, device=y.device)
            w[rows, rows + r0] = 0.0  # the self pair
            w2 = w * w
            zrow[r0:r0 + b] = w.sum(dim=1)
            forces[r0:r0 + b] = yb * w2.sum(dim=1)[:, None] - w2 @ yf
    return forces, torch.clamp(zrow.sum(), min=1e-12)


# ----------------------------------------------------------------------
# gather_rows
# ----------------------------------------------------------------------


def gather_rows(x: torch.Tensor, idx: torch.Tensor, block: int = 2048
                ) -> torch.Tensor:
    """``x[idx]`` (n, k, *x.shape[1:]) for an (n, k) non-negative index
    matrix, gathered in blocks of rows (``pallas_graph.gather_rows``)."""
    n, k = idx.shape
    out = torch.empty((n, k) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    for r0 in range(0, n, block):
        s = idx[r0:r0 + block]
        out[r0:r0 + s.shape[0]] = x.index_select(
            0, s.reshape(-1).long()).reshape(s.shape + x.shape[1:])
    return out
