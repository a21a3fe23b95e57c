"""Deterministic fault injection on the shard-read IO channel.

Counterpart of ``sctools_tpu/utils/chaos.py``'s :class:`Fault` and the
IO channel of its ``ChaosMonkey``.  The shard read scheduler
(``data/shardstore.py``) consults :meth:`ChaosMonkey.on_io` before each
chunk read; a fault's ``op`` pattern matches chunk basenames
(``"chunk-00002"``) and fires on that chunk's reads ``on_call`` …
``on_call + times − 1`` (1-based, ``times=-1``: for ever), each firing
gated by probability ``p`` from the monkey's seeded stream.  Modes:

* ``io_error``: the scheduler raises a transient error (retried);
* ``slow_read``: the scheduler defers the read's result by ``slow_s``
  on its injectable clock (the hedge and deadline rulings see a
  straggler with no real sleep);
* ``truncate_shard``: the monkey truncates the chunk file to half its
  bytes, and the verified read rules it corrupt (quarantine).

The same faults and seed inject the same failures at the same reads.
The other channels of the reference (op calls, checkpoints, admission,
workers, serving, memory, the factory, the network) are not ported: a
:class:`Fault` of one of their modes raises ``NotImplementedError``
(ROADMAP.md Queue 1 item 13).
"""

from __future__ import annotations

import dataclasses
import fnmatch
import os
import random
import threading

#: the reference's modes, every channel
MODES = ("unavailable", "hang", "wedge", "corrupt",
         "corrupt_checkpoint", "crash", "kill", "reject_storm",
         "slow_read", "truncate_shard", "io_error",
         "kill_worker", "lease_wedge", "preempt",
         "evict_state", "corrupt_model",
         "oom", "mem_pressure", "stage_crash",
         "net_drop", "net_delay", "net_dup", "net_partition")

# the hook channel each mode fires on (the rest: the op-call channel)
_MODE_CHANNEL = {"corrupt_checkpoint": "checkpoint",
                 "reject_storm": "admission",
                 "slow_read": "io", "truncate_shard": "io",
                 "io_error": "io",
                 "kill_worker": "worker", "lease_wedge": "worker",
                 "preempt": "worker",
                 "evict_state": "serving", "corrupt_model": "serving",
                 "mem_pressure": "memory",
                 "stage_crash": "factory",
                 "net_drop": "net", "net_delay": "net",
                 "net_dup": "net", "net_partition": "net"}

#: the channels the port has
PORTED_CHANNELS = ("io",)


@dataclasses.dataclass
class Fault:
    """One injected failure rule (module docstring)."""

    op: str
    mode: str  # one of MODES
    on_call: int = 1
    times: int = 1
    backend: str | None = None
    p: float = 1.0

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(
                f"Fault mode {self.mode!r}: use one of {MODES}")
        channel = _MODE_CHANNEL.get(self.mode, "call")
        if channel not in PORTED_CHANNELS:
            raise NotImplementedError(
                f"Fault mode {self.mode!r} fires on the {channel!r} "
                f"channel, which is not ported yet (ROADMAP.md Queue 1 "
                f"item 13); the port injects {PORTED_CHANNELS} faults")


class ChaosMonkey:
    """Injects :class:`Fault` rules on the IO channel (module
    docstring).  ``calls`` counts consults per chunk under
    ``"<chunk>@io"``; ``injected`` logs every firing as ``{"op",
    "call", "mode", "backend"}`` (``backend`` None), as the
    reference's."""

    def __init__(self, faults, seed: int = 0, slow_s: float = 30.0):
        self.faults = list(faults)
        self.slow_s = float(slow_s)
        self.calls: dict[str, int] = {}
        self.injected: list[dict] = []
        self._rng = random.Random(seed)
        # reader threads consult one monkey: counting, matching and
        # logging a consult is one atomic step
        self._lock = threading.RLock()

    def on_io(self, name: str, path: str | None = None) -> dict | None:
        """Consulted before every read of chunk ``name`` (its file at
        ``path``): ``None``, or ``{"mode", "slow_s"}`` for a firing
        fault.  ``truncate_shard`` damages the file here; the other
        modes only rule, and the scheduler acts on them."""
        key = f"{name}@io"
        with self._lock:
            call_no = self.calls.get(key, 0) + 1
            self.calls[key] = call_no
            f = self._firing(name, call_no)
            if f is None:
                return None
            self.injected.append({"op": name, "call": call_no,
                                  "mode": f.mode, "backend": None})
        if f.mode == "truncate_shard" and path is not None:
            try:
                size = os.path.getsize(path)
                with open(path, "r+b") as fh:
                    fh.truncate(max(size // 2, 1))
            except OSError:
                pass  # already moved aside: the ruling stands
        return {"mode": f.mode, "slow_s": self.slow_s}

    def _firing(self, name: str, call_no: int):
        # every fault is an IO fault (Fault refuses the other channels);
        # the IO channel has no backend, so a fault restricted to one
        # never fires, as in the reference
        for f in self.faults:
            if not fnmatch.fnmatchcase(name, f.op):
                continue
            if f.backend is not None:
                continue
            if call_no < f.on_call:
                continue
            if f.times >= 0 and call_no >= f.on_call + f.times:
                continue
            if f.p < 1.0 and self._rng.random() >= f.p:
                continue
            return f
        return None
