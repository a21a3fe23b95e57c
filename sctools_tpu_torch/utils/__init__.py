"""Utilities of the port: the injectable clock, the error taxonomy and
cooperative preemption, the verified-npz checkpoint layer, the metrics
registry, the IO fault injector, the device drain and the Adam step."""

from . import chaos, checkpoint, failsafe, optim, sync, telemetry, vclock

__all__ = ["chaos", "checkpoint", "failsafe", "optim", "sync", "telemetry",
           "vclock"]
