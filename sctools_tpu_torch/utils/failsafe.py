"""The retryable-error taxonomy: ``classify_error`` and its four
classes.

The prefetch worker of ``data/stream.py`` retries a failed shard
preparation only when the error is TRANSIENT (a flaky-disk EIO, a
dropped connection): a DETERMINISTIC error replays identically, a
RESOURCE one (device memory) recurs at the same shapes, and a FATAL
one (``BaseException``: interpreter exit, keyboard interrupt) is never
retried.  Counterpart of ``classify_error`` in
``sctools_tpu/utils/failsafe.py``; the rest of that module (probes,
isolation, deadlines, breakers) is not ported.
"""

from __future__ import annotations

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
