"""The retryable-error taxonomy (``classify_error`` and its four
classes) and cooperative preemption.

The prefetch worker of ``data/stream.py`` and the shard read scheduler
(``data/shardstore.py``) retry a failed read only when the error is
TRANSIENT (a flaky-disk EIO, a dropped connection): a DETERMINISTIC
error replays identically, a RESOURCE one (device memory) recurs at the
same shapes, and a FATAL one (``BaseException``: interpreter exit,
keyboard interrupt) is never retried.

A long job (the streamed trainer, ``models/train_stream.py``) polls
:func:`check_preempt` at its safe boundaries; on a pending request of
the current :class:`PreemptToken` it saves its cursor and raises
:class:`JobPreempted`.  Tokens are scoped per thread
(:func:`preempt_scope`).

Counterpart of ``classify_error`` and the preemption section of
``sctools_tpu/utils/failsafe.py``; the rest of that module (probes,
isolation, deadlines, breakers) is not ported (ROADMAP.md Queue 1 item
13).
"""

from __future__ import annotations

import contextlib
import threading

import torch

TRANSIENT = "transient"
DETERMINISTIC = "deterministic"
FATAL = "fatal"
RESOURCE = "resource"


class TransientDeviceError(RuntimeError):
    """A condition worth retrying, raised to assert transience when the
    wrapped error type alone cannot prove it."""


# Lowercased substrings that mark an error of no known type as
# transient: gRPC-style statuses of a dropped remote and socket noise,
# and the host-IO "Input/output error" of a flaky disk (ENOENT and
# ENOSPC recur identically and are not listed).
_TRANSIENT_MARKERS = (
    "unavailable",
    "deadline_exceeded",
    "deadline exceeded",
    "aborted",
    "connection reset",
    "connection refused",
    "connection closed",
    "socket closed",
    "broken pipe",
    "failed to connect",
    "heartbeat",
    "input/output error",
    "been deleted",
)

# Lowercased substrings of a device-memory exhaustion; checked before
# the transient scan, so an OOM message never reads as an outage.
_RESOURCE_MARKERS = (
    "resource_exhausted",
    "resource exhausted",
    "out of memory",
    "ran out of memory",
)

_TRANSIENT_TYPES = (TransientDeviceError, TimeoutError, ConnectionError,
                    InterruptedError)
# Program errors: identical inputs give an identical raise.  Checked
# before the message scan, so a ValueError whose text contains
# "aborted" stays deterministic.
_DETERMINISTIC_TYPES = (ValueError, TypeError, KeyError, IndexError,
                        AttributeError, ArithmeticError, AssertionError,
                        NotImplementedError)


def classify_error(exc: BaseException) -> str:
    """:data:`TRANSIENT`, :data:`DETERMINISTIC`, :data:`RESOURCE` or
    :data:`FATAL`.  Type beats message: known transient types, the
    device-memory error (``torch.cuda.OutOfMemoryError``) and known
    deterministic types are decided
    outright; only the rest falls through to the message scan, the
    RESOURCE markers first.  Unknown errors are DETERMINISTIC: failing
    fast on a novel error is cheap to diagnose, retrying a permanent
    one is not."""
    if not isinstance(exc, Exception):
        return FATAL
    if isinstance(exc, torch.cuda.OutOfMemoryError):
        return RESOURCE
    if isinstance(exc, _TRANSIENT_TYPES):
        return TRANSIENT
    if isinstance(exc, _DETERMINISTIC_TYPES):
        return DETERMINISTIC
    msg = f"{type(exc).__name__}: {exc}".lower()
    if any(m in msg for m in _RESOURCE_MARKERS):
        return RESOURCE
    if any(m in msg for m in _TRANSIENT_MARKERS):
        return TRANSIENT
    return DETERMINISTIC


# ----------------------------------------------------------------------
# Cooperative preemption (checkpoint, then yield)
# ----------------------------------------------------------------------


class JobPreempted(Exception):
    """A long job yielded at a safe boundary after saving its state:
    ``reason`` says why (``"cancelled"`` or a preemption), ``cursor`` is
    its machine-readable resume position.  Neither transient nor
    deterministic: it is not retried."""

    def __init__(self, msg: str, *, reason: str = "preempt",
                 cursor: dict | None = None):
        super().__init__(msg)
        self.reason = reason
        self.cursor = cursor or {}


#: innermost-last stack of active tokens, per thread: one thread's
#: preemption never yields another thread's job
_PREEMPTS = threading.local()


def _preempt_stack() -> list:
    stack = getattr(_PREEMPTS, "stack", None)
    if stack is None:
        stack = _PREEMPTS.stack = []
    return stack


class PreemptToken:
    """A cooperative yield signal.  ``request(reason)`` arms it (the
    first reason wins); ``probe``, when given, is a zero-argument
    callable consulted on every :meth:`pending` poll that may return a
    reason (a fault injector's seam: a preemption at the Nth boundary)."""

    def __init__(self, probe=None):
        self.probe = probe
        self._reason: str | None = None
        self._lock = threading.Lock()

    def request(self, reason: str = "preempt") -> None:
        with self._lock:
            if self._reason is None:
                self._reason = reason

    def requested(self) -> str | None:
        """The armed reason, without consulting the probe."""
        with self._lock:
            return self._reason

    def pending(self) -> str | None:
        """The pending reason or ``None``, after consulting the probe
        (so an injected preemption counts polls)."""
        if self._reason is None and self.probe is not None:
            r = self.probe()
            if r:
                self.request(str(r))
        with self._lock:
            return self._reason


@contextlib.contextmanager
def preempt_scope(token: PreemptToken):
    """Make ``token`` this thread's current preemption signal for the
    enclosed block."""
    stack = _preempt_stack()
    stack.append(token)
    try:
        yield token
    finally:
        stack.remove(token)


def current_preempt() -> PreemptToken | None:
    stack = _preempt_stack()
    return stack[-1] if stack else None


def check_preempt() -> str | None:
    """The pending reason of this thread's innermost token, or ``None``
    (also outside any scope).  Only the poll: the job saves its state
    before it raises :class:`JobPreempted`."""
    tok = current_preempt()
    return tok.pending() if tok is not None else None
