"""The run journal and the retry policy of resilient execution.

Counterpart of two pieces of ``sctools_tpu/runner.py``:

* :class:`_Journal`: an append-only JSONL event log, one
  ``open``/``write``/``close`` a record under a lock (a killed run keeps
  every line written before the kill; threads share one file).  Records
  carry the reference's layout (``{"event", "ts", **bound, **fields}``),
  so ``tools/sctreport.py`` reads the port's journals unchanged.
* :class:`RetryPolicy`: exponential backoff with seeded jitter, the
  schedule the shard read scheduler (``data/shardstore.py``) retries
  transient reads by.

``ResilientRunner`` (per-step retry, degrade, isolation, checkpointed
resume) is not ported yet: ROADMAP.md Queue 1 item 13.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import time


@dataclasses.dataclass
class RetryPolicy:
    """Attempt ``n`` (1-based) that fails transiently waits
    ``min(base_delay_s · multiplier^(n−1), max_delay_s)`` times a jitter
    factor uniform in ``[1 − jitter, 1 + jitter)`` drawn from the
    caller's ``random.Random``: the same seed gives the same schedule."""

    max_attempts: int = 3
    base_delay_s: float = 0.5
    multiplier: float = 2.0
    max_delay_s: float = 30.0
    jitter: float = 0.5
    seed: int = 0

    def delay_s(self, attempt: int, rng) -> float:
        d = min(self.base_delay_s * self.multiplier ** max(attempt - 1, 0),
                self.max_delay_s)
        if self.jitter > 0:
            d *= 1.0 + self.jitter * (2.0 * rng.random() - 1.0)
        return d


class _Journal:
    """Append-only JSONL event log at ``path`` (``None``: writes are
    dropped).  ``bound`` fields are stamped onto every record."""

    def __init__(self, path: str | None, bound: dict | None = None):
        self.path = path
        self.bound = dict(bound) if bound else {}
        self._lock = threading.Lock()
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)),
                        exist_ok=True)

    def write(self, event: str, **fields) -> None:
        if not self.path:
            return
        rec = {"event": event, "ts": round(time.time(), 3),
               **self.bound, **fields}
        with self._lock:
            # this lock exists only to serialize the appends of threads
            # that share the file, so the write happens under it
            with open(self.path, "a") as f:  # sctlint: disable=SCT011
                f.write(json.dumps(rec) + "\n")  # sctlint: disable=SCT011


def as_journal(j):
    """``j`` itself when it is ``None`` or has ``write``; else a
    :class:`_Journal` at the path ``j``."""
    if j is None or hasattr(j, "write"):
        return j
    return _Journal(str(j))
