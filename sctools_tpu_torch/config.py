"""Configuration of the PyTorch/CUDA port.

The knobs mirror ``sctools_tpu/config.py`` where this package uses
them, with the same numerics contract:

* per-cell / per-gene element ops and reductions (``normalize.*``,
  ``qc.*``, gene stats and moments, segment sums) run float32 always;
  ``matmul_dtype`` does not touch them;
* the kNN coarse scoring and the PCA matvecs follow ``matmul_dtype``:
  ``"float32"`` is true float32 (TF32 off, the counterpart of the
  reference's ``Precision.HIGHEST``), ``"bfloat16"`` rounds the inputs
  to bf16 and accumulates in float32;
* decompositions and gates stay true float32 whatever the policy:
  ``cholesky_qr``'s Gram matrix and the kNN refine re-rank.

The port has no jit: every op runs eagerly, so a ``configure(...)``
change takes effect at the next call.
"""

from __future__ import annotations

import dataclasses
from contextlib import contextmanager

import torch


@dataclasses.dataclass
class Config:
    # Row alignment of padded-ELL matrices (``rows_padded`` rounds up
    # to it) and their capacity rounding.
    sublane: int = 8
    capacity_multiple: int = 128

    # Query rows per block of the kNN refine and of the blocked "xla"
    # search; the rows of ``knn_arrays``'s result are padded to
    # ``min(row_block, 256)``, as the reference's fused kernel pads them.
    row_block: int = 1024
    # Candidate rows per tile of the blocked "xla" search, and of the
    # kNN plain version (at most 1024 there, the reference kernel's
    # tile).
    col_block: int = 2048

    matmul_dtype: str = "float32"  # or "bfloat16"

    # kNN search implementation: "auto" and "pallas" (the names the
    # reference takes) both mean the exact fused distance + top-k kernel
    # (ops/knn_kernel.py:knn_select); "pallas_binned" the binned merge
    # (knn_binned, one survivor per bin of knn_bins columns).  Each runs
    # its CUDA kernel on a CUDA tensor and its plain version on a CPU
    # tensor.  "xla" is the reference's blocked search (one
    # row_block × col_block score tile at a time, merged into a running
    # top k), in plain torch.  Unlike the reference, "auto" never
    # resolves to "xla": the exact kernel is the default everywhere.
    knn_impl: str = "auto"
    # Bin count of the binned merge (rounded up to a multiple of 128);
    # two true neighbours share a bin with odds ~k²/(2·knn_bins).
    knn_bins: int = 1024

    # Coarse top k of the blocked "xla" search: "topk" or "approx", the
    # reference's names.  "approx" is an alias: the reference's
    # lax.approx_max_k is exact off the TPU, so on every device the port
    # runs both select the same ids, and the blocked search runs its one
    # exact merge for either.
    knn_coarse: str = "topk"

    # Gather of the float32 refine: "blocked" (each query block gathers
    # its candidates' rows) or "sorted" (all candidate ids argsorted,
    # rows gathered in ascending order, only the scores scattered back).
    # "auto": sorted from refine_sorted_min_cand candidates on.  Both
    # select the same neighbours; scores may differ by float32
    # reduction-order ulps.  The reference's cutoff, 786432, is where
    # its TPU's table leaves on-chip memory.  On an H100 (700 W) sorted
    # took 0.16-0.62x blocked's time at every table of 4,096 to 10M
    # candidates (refine_sweep.py: 32 lists a query re-ranked to 15,
    # 50 dims), the launches of blocked's 1024-query blocks costing more
    # than any gather; below 4,096 neither was measured.
    knn_refine_mode: str = "auto"
    refine_sorted_min_cand: int = 4096

    # Refine width of the reference's benchmarked kNN (bench.py's atlas
    # path), kept for the reference's surface: no code of the port reads
    # it.
    bench_knn_refine: int = 32

    # Graph-kernel implementation (matvec, jaccard, t-SNE repulsion).
    # Only "auto" exists: the wrappers of ops/graph_kernels.py pick by
    # the tensor's device (the CUDA kernel on the card, its plain
    # version on the CPU); there is no dispatcher between impls.
    graph_impl: str = "auto"

    def resolved_knn_impl(self) -> str:
        """"select" (the exact kernel), "binned" or "xla"."""
        if self.knn_impl in ("auto", "pallas"):
            return "select"
        if self.knn_impl == "pallas_binned":
            return "binned"
        if self.knn_impl == "xla":
            return "xla"
        raise ValueError(
            f"knn_impl={self.knn_impl!r}: use 'auto' / 'pallas' (exact "
            "kernel), 'pallas_binned' or 'xla' (blocked search)")

    def resolved_refine_mode(self, n_cand: int) -> str:
        """"blocked" or "sorted" for a refine over ``n_cand``
        candidates."""
        if self.knn_refine_mode == "auto":
            return ("sorted" if n_cand >= self.refine_sorted_min_cand
                    else "blocked")
        if self.knn_refine_mode in ("blocked", "sorted"):
            return self.knn_refine_mode
        raise ValueError(
            f"knn_refine_mode={self.knn_refine_mode!r}: use 'auto', "
            "'blocked' or 'sorted'")

    def resolved_graph_impl(self) -> str:
        if self.graph_impl != "auto":
            raise ValueError(
                f"graph_impl={self.graph_impl!r}: only 'auto' (the "
                "graph kernels on the card, their plain versions on the "
                "CPU) exists in this port")
        return "kernel"

    def matmul_torch_dtype(self) -> torch.dtype:
        if self.matmul_dtype == "float32":
            return torch.float32
        if self.matmul_dtype == "bfloat16":
            return torch.bfloat16
        raise ValueError(
            f"matmul_dtype={self.matmul_dtype!r}: use 'float32' or "
            "'bfloat16'")


config = Config()


@contextmanager
def configure(**kw):
    """Temporarily override config fields.

    >>> with configure(matmul_dtype="bfloat16"):
    ...     ...
    """
    for k in kw:
        if not hasattr(config, k):
            raise AttributeError(f"unknown config field {k!r}")
    old = {k: getattr(config, k) for k in kw}
    try:
        for k, v in kw.items():
            setattr(config, k, v)
        yield config
    finally:
        for k, v in old.items():
            setattr(config, k, v)


@contextmanager
def true_f32():
    """Run float32 matrix products in full float32: TF32 off for both
    cuBLAS and cuDNN for the duration, restored after."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on.  ``None`` means the card;
    without one this raises instead of running on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "the port on the CPU")
        return torch.device("cuda")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={device} was asked for but no CUDA device is "
            "available; pass device='cpu' to run on the CPU")
    return device


def round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m
