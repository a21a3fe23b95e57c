"""Device memory as a budget: a reservation ledger and the scope that
hands it to code deep inside an op.

Counterpart of the budget half of ``sctools_tpu/memory.py``:

* :class:`MemoryBudget`: a thread-safe ledger of named reservations
  against a capacity.  DYNAMIC holds (a run, the streamed trainer's
  feed window) tighten :meth:`~MemoryBudget.fits`; STANDING holds
  (service-lifetime residents) also shrink what admission may ever
  promise (:meth:`~MemoryBudget.admissible_bytes`).  ``set_pressure``
  shrinks the apparent capacity for ``fits`` only.  Reserving a name
  again replaces its amount.
* :class:`budget_scope` / :func:`current_budget`: the thread-local
  handoff, so ``models/train_stream.py`` takes its feed reservation
  against the budget of the scope it runs in.
* :func:`detect_budget_bytes`: the ``SCTOOLS_MEM_BUDGET_BYTES`` cap
  when set, else the card's capacity from ``torch.cuda.mem_get_info``,
  else ``None`` (a CPU reports none, as the reference's CPU does).

The peak estimates (``MemoryEstimates``, ``step_estimate``,
``estimate_run_peak``) wait for the runner: ROADMAP.md Queue 1 item 13.
Nothing here sleeps or journals.
"""

from __future__ import annotations

import os
import threading

import torch

from .utils import telemetry


def detect_budget_bytes(device=None) -> int | None:
    """Device-memory capacity for this process: the
    ``SCTOOLS_MEM_BUDGET_BYTES`` cap when set, else the total memory
    ``torch.cuda.mem_get_info(device)`` reports for ``device`` (the
    current card when ``None``), else ``None`` (no card, or a CPU
    ``device``)."""
    env = os.environ.get("SCTOOLS_MEM_BUDGET_BYTES")
    if env:
        try:
            return int(env)
        except ValueError:
            raise ValueError(
                f"SCTOOLS_MEM_BUDGET_BYTES={env!r} is not an integer "
                f"byte count") from None
    if device is not None and torch.device(device).type != "cuda":
        return None
    if not torch.cuda.is_available():
        return None
    return int(torch.cuda.mem_get_info(device)[1])


class MemoryBudget:
    """A device-memory reservation ledger (module docstring).
    ``capacity_bytes`` ``None`` means :func:`detect_budget_bytes`; a
    budget without a capacity raises."""

    def __init__(self, capacity_bytes: int | None = None, *,
                 name: str = "device", metrics=None):
        if capacity_bytes is None:
            capacity_bytes = detect_budget_bytes()
        if capacity_bytes is None:
            raise ValueError(
                "MemoryBudget: no capacity — pass capacity_bytes=, "
                "set SCTOOLS_MEM_BUDGET_BYTES, or run where a CUDA "
                "device reports its memory")
        if capacity_bytes < 1:
            raise ValueError("MemoryBudget: capacity must be >= 1 byte")
        self.name = str(name)
        self.capacity_bytes = int(capacity_bytes)
        self.metrics = (metrics if metrics is not None
                        else telemetry.default_registry())
        self._lock = threading.RLock()
        self._held: dict[str, dict] = {}  # name -> {bytes, tenant, standing}
        self._pressure = 1.0
        self.peak_reserved_bytes = 0
        self.metrics.gauge("mem.budget_bytes").set(self.capacity_bytes)
        self.metrics.gauge("mem.reserved_bytes").set(0)

    # -- pressure ------------------------------------------------------
    def set_pressure(self, frac: float) -> None:
        """Shrink the apparent capacity to ``frac`` of the nameplate for
        :meth:`fits`; holds already taken are untouched."""
        with self._lock:
            self._pressure = min(max(float(frac), 0.0), 1.0)

    def clear_pressure(self) -> None:
        with self._lock:
            self._pressure = 1.0

    @property
    def pressure(self) -> float:
        with self._lock:
            return self._pressure

    # -- ledger --------------------------------------------------------
    def _reserved_locked(self, standing_only: bool = False) -> int:
        return sum(r["bytes"] for r in self._held.values()
                   if r["standing"] or not standing_only)

    def reserved_bytes(self) -> int:
        with self._lock:
            return self._reserved_locked()

    def standing_bytes(self) -> int:
        with self._lock:
            return self._reserved_locked(standing_only=True)

    def available_bytes(self) -> int:
        """The pressure-scaled capacity less everything held."""
        with self._lock:
            return int(self.capacity_bytes * self._pressure) \
                - self._reserved_locked()

    def admissible_bytes(self) -> int:
        """The nameplate capacity less the standing holds (pressure is
        transient and left out)."""
        with self._lock:
            return self.capacity_bytes \
                - self._reserved_locked(standing_only=True)

    def fits(self, nbytes: int) -> bool:
        return int(nbytes) <= self.available_bytes()

    def reserve(self, name: str, nbytes: int, *, tenant: str | None = None,
                standing: bool = False) -> int:
        """Hold ``nbytes`` under ``name`` (replacing its previous hold).
        Returns the total reserved after."""
        nbytes = max(int(nbytes), 0)
        with self._lock:
            self._held[str(name)] = {"bytes": nbytes, "tenant": tenant,
                                     "standing": bool(standing)}
            total = self._reserved_locked()
            if total > self.peak_reserved_bytes:
                self.peak_reserved_bytes = total
            self.metrics.gauge("mem.reserved_bytes").set(total)
        return total

    def release(self, name: str) -> int:
        """Drop the hold under ``name`` (idempotent).  Returns the total
        reserved after."""
        with self._lock:
            self._held.pop(str(name), None)
            total = self._reserved_locked()
            self.metrics.gauge("mem.reserved_bytes").set(total)
        return total

    def holders(self) -> dict:
        """``{name: {bytes, tenant, standing}}``."""
        with self._lock:
            return {k: dict(v) for k, v in self._held.items()}

    def snapshot(self) -> dict:
        with self._lock:
            return {"name": self.name,
                    "capacity_bytes": self.capacity_bytes,
                    "reserved_bytes": self._reserved_locked(),
                    "standing_bytes":
                        self._reserved_locked(standing_only=True),
                    "peak_reserved_bytes": self.peak_reserved_bytes,
                    "pressure": self._pressure,
                    "holders": {k: dict(v) for k, v in self._held.items()}}

    def __repr__(self):
        s = self.snapshot()
        return (f"MemoryBudget({self.name!r}, "
                f"{s['reserved_bytes']}/{s['capacity_bytes']} bytes "
                f"reserved, pressure={s['pressure']:g})")


_BUDGETS = threading.local()


def _budget_stack() -> list:
    stack = getattr(_BUDGETS, "stack", None)
    if stack is None:
        stack = _BUDGETS.stack = []
    return stack


class budget_scope:
    """Make ``budget`` this thread's current memory budget for the
    enclosed block."""

    def __init__(self, budget: MemoryBudget | None):
        self.budget = budget

    def __enter__(self):
        _budget_stack().append(self.budget)
        return self.budget

    def __exit__(self, *exc):
        _budget_stack().remove(self.budget)
        return False


def current_budget() -> MemoryBudget | None:
    stack = _budget_stack()
    return stack[-1] if stack else None
