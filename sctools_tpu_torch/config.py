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

    # Query rows per block of the kNN refine; the rows of
    # ``knn_arrays``'s result are padded to ``min(row_block, 256)``, as
    # the reference's fused kernel pads them.
    row_block: int = 1024
    # Candidate rows per tile of the kNN plain version (at most 1024,
    # the reference kernel's tile).
    col_block: int = 2048

    matmul_dtype: str = "float32"  # or "bfloat16"

    # kNN search implementation.  Only "auto" exists in this port so
    # far: the fused distance + top-k kernel (ops/knn_kernel.py) on a
    # CUDA tensor, its plain version on a CPU tensor.
    knn_impl: str = "auto"

    def resolved_knn_impl(self) -> str:
        if self.knn_impl != "auto":
            raise ValueError(
                f"knn_impl={self.knn_impl!r}: only 'auto' (the fused "
                "kernel) is ported so far")
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
