"""Injectable wall-clock.

Code that waits or measures elapsed time for a schedule (the prefetch
worker's retry backoff, its stall and overlap accounting) does so
through a :class:`Clock` object instead of calling ``time.sleep`` /
``time.monotonic`` directly.  Tests hand it a :class:`VirtualClock`, on
which time moves only when someone sleeps or calls ``advance``, so a
backoff schedule runs with zero real sleeps.

Copy of ``sctools_tpu/utils/vclock.py``.
"""

from __future__ import annotations

import time


class Clock:
    """``monotonic()`` for elapsed-time arithmetic (never wall time: it
    must survive NTP steps) and ``sleep(seconds)`` for waiting."""

    def monotonic(self) -> float:
        raise NotImplementedError

    def sleep(self, seconds: float) -> None:
        raise NotImplementedError


class SystemClock(Clock):
    """The real clock."""

    def monotonic(self) -> float:
        return time.monotonic()

    def sleep(self, seconds: float) -> None:
        time.sleep(max(0.0, seconds))


class VirtualClock(Clock):
    """Deterministic test clock: starts at ``start``; ``sleep`` advances
    virtual time at once (and records the request in ``.sleeps``);
    ``advance`` moves time without a sleeper."""

    def __init__(self, start: float = 0.0):
        self._now = float(start)
        self.sleeps: list[float] = []

    def monotonic(self) -> float:
        return self._now

    def sleep(self, seconds: float) -> None:
        self.sleeps.append(float(seconds))
        self._now += max(0.0, float(seconds))

    def advance(self, seconds: float) -> None:
        self._now += max(0.0, float(seconds))


#: module-level default, shared by every caller that passes no clock
SYSTEM_CLOCK = SystemClock()
