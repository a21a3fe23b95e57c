"""``optax.adam``'s step, shared by ``de.rank_genes_groups(method=
"logreg")`` and the scVI trainers (``models/scvi.py``)."""

from __future__ import annotations

import torch


def bias_corrections(t: int, b1: float = 0.9, b2: float = 0.999
                     ) -> tuple:
    """The bias corrections of Adam's step ``t``, ``1 − b1^t`` and
    ``1 − b2^t``, as the float32 values ``adam_step_all`` divides by."""
    return (float(torch.tensor(1 - b1 ** t, dtype=torch.float32)),
            float(torch.tensor(1 - b2 ** t, dtype=torch.float32)))


def adam_step_all(params: list, grads: list, ms: list, vs: list, corr,
                  lr: float, b1: float = 0.9, b2: float = 0.999,
                  eps: float = 1e-8) -> None:
    """One step of ``optax.adam(lr)`` (its defaults) on lists of
    tensors, in place, a few ``torch._foreach_*`` launches for the whole
    list.  Each tensor takes optax's operations in optax's order: m ←
    b1·m + (1−b1)·g, v ← b2·v + (1−b2)·g², p ← p + (−lr)·((m / c1) /
    (√(v / c2) + eps)) (``b1·m + (1−b1)·g`` is optax's ``(1−b1)·g +
    b1·m``: an IEEE sum does not depend on the order of its two terms).
    ``corr`` is the step's ``bias_corrections``, as floats or as 0-dim
    tensors holding them (a recorded CUDA graph reads them from device
    memory)."""
    c1, c2 = corr
    torch._foreach_mul_(ms, b1)
    torch._foreach_add_(ms, torch._foreach_mul(grads, 1 - b1))
    torch._foreach_mul_(vs, b2)
    torch._foreach_add_(vs, torch._foreach_mul(
        torch._foreach_mul(grads, grads), 1 - b2))
    den = torch._foreach_sqrt(torch._foreach_div(vs, c2))
    torch._foreach_add_(den, eps)
    upd = torch._foreach_div(torch._foreach_div(ms, c1), den)
    torch._foreach_add_(params, torch._foreach_mul(upd, -lr))
