"""The metrics registry: counters, gauges and fixed-bucket histograms
keyed by ``(name, labels)``.

Counterpart of the registry half of ``sctools_tpu/utils/telemetry.py``,
with its series keys (``"train.preemptions{reason=priority}"``: labels
sorted by name), its snapshot layouts and its process-wide default
registry, so that a snapshot of either package reads the same.

Recording a metric touches Python scalars only, never a device tensor:
telemetry adds no device sync.

Not ported yet (ROADMAP.md Queue 1 item 13): the call instrumentation
(``CallInstrumentor``, ``instrument_calls``), timers, the time-series
ring and its deltas, the bucket presets, the exporters and the event
vocabulary.
"""

from __future__ import annotations

import threading

#: fixed histogram upper bounds (seconds); a terminal +inf bucket is
#: implicit.  Fixed so that snapshots of different runs merge bucket by
#: bucket.
DURATION_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5,
                    1.0, 5.0, 10.0, 30.0, 60.0, 300.0)


class Counter:
    """Monotonic sum; ``inc`` only.  Mutation holds the owning
    registry's lock (``+=`` is a read-modify-write)."""

    __slots__ = ("value", "_lock")

    def __init__(self, lock=None):
        self.value = 0.0
        self._lock = lock if lock is not None else threading.RLock()

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError("Counter.inc(n) requires n >= 0 — use a "
                             "Gauge for values that go down")
        with self._lock:
            self.value += n


class Gauge:
    """Last-written value."""

    __slots__ = ("value", "_lock")

    def __init__(self, lock=None):
        self.value = 0.0
        self._lock = lock if lock is not None else threading.RLock()

    def set(self, v: float) -> None:
        with self._lock:
            self.value = float(v)


class Histogram:
    """Fixed-boundary histogram: per-bucket counts plus count, sum and
    max.  ``observe(v)`` counts ``v`` in the first bucket whose upper
    bound holds it; :meth:`to_dict` gives cumulative counts per bound
    (``le`` style), ``"+inf"`` last."""

    __slots__ = ("buckets", "counts", "count", "sum", "max", "_lock")

    def __init__(self, buckets=DURATION_BUCKETS, lock=None):
        self.buckets = tuple(float(b) for b in buckets)
        if list(self.buckets) != sorted(set(self.buckets)):
            raise ValueError("histogram buckets must be strictly "
                             "increasing")
        self.counts = [0] * (len(self.buckets) + 1)  # +1: the +inf bucket
        self.count = 0
        self.sum = 0.0
        self.max = 0.0
        self._lock = lock if lock is not None else threading.RLock()

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self.count += 1
            self.sum += v
            if v > self.max:
                self.max = v
            for i, b in enumerate(self.buckets):
                if v <= b:
                    self.counts[i] += 1
                    return
            self.counts[-1] += 1

    def to_dict(self) -> dict:
        with self._lock:
            cum, acc = {}, 0
            for b, c in zip(self.buckets, self.counts):
                acc += c
                cum[f"{b:g}"] = acc
            cum["+inf"] = acc + self.counts[-1]
            return {"count": self.count, "sum": round(self.sum, 6),
                    "max": round(self.max, 6), "buckets": cum}


def _series_key(name: str, labels: dict) -> str:
    if not labels:
        return name
    inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return f"{name}{{{inner}}}"


def split_series_key(key: str) -> tuple:
    """Inverse of the series-key encoding: ``"name{a=b,c=d}"`` →
    ``("name", {"a": "b", "c": "d"})``."""
    if "{" not in key or not key.endswith("}"):
        return key, {}
    name, _, inner = key.partition("{")
    labels = {}
    for part in inner[:-1].split(","):
        if part:
            k, _, v = part.partition("=")
            labels[k] = v
    return name, labels


class MetricsRegistry:
    """Thread-safe registry of labelled series.  ``counter``, ``gauge``
    and ``histogram`` get or create the ``(name, labels)`` series.  One
    reentrant lock guards the maps and every cell's mutation, so a
    snapshot never tears."""

    def __init__(self):
        self._lock = threading.RLock()
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._histograms: dict[str, Histogram] = {}

    def counter(self, name: str, **labels) -> Counter:
        key = _series_key(name, labels)
        with self._lock:
            c = self._counters.get(key)
            if c is None:
                c = self._counters[key] = Counter(lock=self._lock)
        return c

    def gauge(self, name: str, **labels) -> Gauge:
        key = _series_key(name, labels)
        with self._lock:
            g = self._gauges.get(key)
            if g is None:
                g = self._gauges[key] = Gauge(lock=self._lock)
        return g

    def histogram(self, name: str, buckets=DURATION_BUCKETS,
                  **labels) -> Histogram:
        key = _series_key(name, labels)
        with self._lock:
            h = self._histograms.get(key)
            if h is None:
                h = self._histograms[key] = Histogram(buckets,
                                                      lock=self._lock)
        return h

    def snapshot(self) -> dict:
        """``{"counters", "gauges", "histograms"}``, each keyed
        ``name{label=value,...}`` in sorted order."""
        with self._lock:
            return {
                "counters": {k: c.value
                             for k, c in sorted(self._counters.items())},
                "gauges": {k: g.value
                           for k, g in sorted(self._gauges.items())},
                "histograms": {k: h.to_dict() for k, h
                               in sorted(self._histograms.items())},
            }

    def snapshot_compact(self) -> dict:
        """The counters only."""
        with self._lock:
            return {k: c.value for k, c in sorted(self._counters.items())}


#: the process-wide registry every layer records into when it is given
#: no ``metrics=``
_DEFAULT = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    return _DEFAULT
