"""A device drain that ends in a host read.

``hard_sync(t)`` waits for the card (``torch.cuda.synchronize()``) and
then fetches one element of ``t`` to the host: the bytes cannot arrive
before the work that produces them has run.  A wall time of streamed
work ends in it (``DeviceSyntheticSource.materialize``'s per-shard
progress).
"""

from __future__ import annotations

import torch

__all__ = ["hard_sync"]


def hard_sync(*tensors):
    """Wait for every tensor's producer: synchronize the card once if a
    tensor lies on one, then fetch one element of each to the host.
    ``SparseCells`` (anything with a tensor ``.data``) drains through
    its values.  Returns the last fetched element, or ``None``."""
    ts = []
    for t in tensors:
        if t is None:
            continue
        if not isinstance(t, torch.Tensor) and isinstance(
                getattr(t, "data", None), torch.Tensor):
            t = t.data
        if isinstance(t, torch.Tensor):
            ts.append(t)
    if any(t.is_cuda for t in ts):
        torch.cuda.synchronize()
    out = None
    for t in ts:
        if t.numel():
            out = t.reshape(-1)[0].item()
    return out
