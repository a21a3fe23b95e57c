"""Utilities of the port: the injectable clock, the error taxonomy the
prefetch worker retries by, the verified-npz checkpoint layer, the
device drain and the Adam step."""

from . import checkpoint, failsafe, optim, sync, vclock

__all__ = ["checkpoint", "failsafe", "optim", "sync", "vclock"]
