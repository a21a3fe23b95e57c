"""Utilities of the port: the injectable clock, the error taxonomy the
prefetch worker retries by, the verified-npz checkpoint layer and the
device drain."""

from . import checkpoint, failsafe, sync, vclock

__all__ = ["checkpoint", "failsafe", "sync", "vclock"]
