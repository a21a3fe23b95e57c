"""A single-process device mesh.

Counterpart of the single-host part of ``sctools_tpu/parallel/mesh.py``.
The reference's mesh is single-controller: one process holds every
device, and one call (``knn_multichip_arrays``, ``diffuse_sharded``)
shards the rows over them and returns the whole result.  Here a
:class:`Mesh` is an ordered list of ``torch.device``s along one axis,
``CELL_AXIS``, driven by one process, so the reference's collectives
become copies:

* the ring's ``ppermute`` (:func:`ring`): each shard's chunk moves one
  position on at every step, a copy into a second buffer on a side
  stream of the receiving position, ordered by CUDA events against the
  steps that read the buffers;
* ``all_gather`` (:func:`all_gather`): copies to one device and a
  ``torch.cat``.

A device may appear more than once: a mesh of P shards that all name
``cuda:0`` makes every copy that a host of P cards makes.  A mesh of CPU
devices (``make_mesh(devices=["cpu"] * 8)``) runs the same code without
streams, as the tests do.

Multi-host bring-up (the reference's ``init_distributed``,
``coordination_sum``, ``mesh_host_groups``, ``classify_bringup_error``)
is not ported: ROADMAP.md Queue 1 item 9.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Callable

import torch

CELL_AXIS = "cells"

_CONTEXT = threading.local()  # the stack of meshes entered by ``with``


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: ``devices`` in shard order along ``axis_name``.
    ``with mesh:`` makes it :func:`active_mesh` in this thread."""

    devices: tuple
    axis_name: str = CELL_AXIS

    def __post_init__(self):
        devs = tuple(torch.device(d) for d in self.devices)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        kinds = {d.type for d in devs}
        if len(kinds) > 1 or not kinds <= {"cpu", "cuda"}:
            raise ValueError(
                f"a mesh holds cpu or cuda devices of one kind, got "
                f"{sorted(kinds)}")
        object.__setattr__(self, "devices", devs)

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def shape(self) -> dict:
        return {self.axis_name: self.size}

    @property
    def axis_names(self) -> tuple:
        return (self.axis_name,)

    @property
    def is_cuda(self) -> bool:
        return self.devices[0].type == "cuda"

    def __enter__(self) -> "Mesh":
        if not hasattr(_CONTEXT, "stack"):
            _CONTEXT.stack = []
        _CONTEXT.stack.append(self)
        return self

    def __exit__(self, *exc) -> None:
        _CONTEXT.stack.pop()


def make_mesh(n_devices: int | None = None, axis_name: str = CELL_AXIS,
              devices=None) -> Mesh:
    """A 1-D mesh over the first ``n_devices`` CUDA devices (all of them
    by default; raises without one), or over the explicit ``devices=``
    list, which may name one device several times (``["cuda:0"] * 4``,
    ``["cpu"] * 8``)."""
    if devices is not None:
        if n_devices is not None:
            raise ValueError("make_mesh: pass n_devices or devices=, not both")
        devs = [torch.device(d) for d in devices]
        if not devs:
            raise ValueError("make_mesh: devices= is empty")
        if any(d.type == "cuda" for d in devs):
            _require_cuda(max(d.index or 0 for d in devs) + 1)
            devs = [torch.device("cuda", d.index or 0)
                    if d.type == "cuda" else d for d in devs]
        return Mesh(tuple(devs), axis_name)
    _require_cuda(n_devices or 1)
    count = torch.cuda.device_count()
    n = count if n_devices is None else n_devices
    return Mesh(tuple(torch.device("cuda", i) for i in range(n)), axis_name)


def _require_cuda(n: int) -> None:
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass devices=['cpu'] * n for a "
            "mesh on the CPU")
    if n > torch.cuda.device_count():
        raise ValueError(
            f"requested {n} CUDA devices, have {torch.cuda.device_count()}")


def active_mesh() -> Mesh | None:
    """The innermost mesh entered by ``with mesh:`` in this thread, or
    None."""
    stack = getattr(_CONTEXT, "stack", None)
    return stack[-1] if stack else None


def mesh_signature(mesh: Mesh) -> tuple:
    """Hashable identity of a mesh: axis names, shape and the devices in
    order.  A mesh rebuilt over the same devices has the same
    signature."""
    return (mesh.axis_names, (mesh.size,),
            tuple(str(d) for d in mesh.devices))


def pad_rows(x: torch.Tensor, rows: int, fill=0) -> torch.Tensor:
    """``x`` with rows appended up to ``rows``, each element ``fill``."""
    if x.shape[0] >= rows:
        return x
    pad = torch.full((rows - x.shape[0],) + tuple(x.shape[1:]), fill,
                     dtype=x.dtype, device=x.device)
    return torch.cat([x, pad])


def split_rows(x: torch.Tensor, mesh: Mesh) -> list:
    """The rows of ``x`` cut into ``mesh.size`` equal shards, shard i on
    ``mesh.devices[i]``; the row count must divide (pad it first)."""
    if x.shape[0] % mesh.size:
        raise ValueError(
            f"{x.shape[0]} rows do not divide over {mesh.size} devices; "
            "pad rows first")
    m = x.shape[0] // mesh.size
    return [x[i * m:(i + 1) * m].to(dev).contiguous()
            for i, dev in enumerate(mesh.devices)]


def all_gather(parts: list, device) -> torch.Tensor:
    """The shards ``parts`` concatenated in order on ``device``."""
    device = torch.device(device)
    return torch.cat([p.to(device, non_blocking=True) for p in parts])


def ring(mesh: Mesh, chunks: list,
         step: Callable[[int, int, int, torch.Tensor], None]) -> None:
    """The ring pipeline: ``chunks[i]`` (one per shard, on
    ``mesh.devices[i]``, all of one shape) circulate, and at step ``t``
    (0 to P − 1) ``step(t, i, src, chunk)`` runs for every shard ``i``
    with the chunk that started on shard ``src = (i − t) mod P``, on
    shard i's device (current there).  ``chunks`` are read, never
    written.

    Between two steps every chunk moves one position on, a copy into a
    buffer of the receiving position (two a position, used in turns).
    On CUDA devices the copy runs on the receiving position's side
    stream, so it overlaps the step; CUDA events order it after every
    reader of the buffer it overwrites (the receiving position's
    previous step, and the copy that sent that buffer on) and the next
    step after it.  The buffers are allocated before the first step and
    the side streams wait for the current streams' earlier work: a
    buffer the caching allocator hands out during the steps may be
    memory that a step still reads on the current stream, which a side
    stream's copy would overwrite.  The current streams wait for the
    side streams before this returns."""
    p = mesh.size
    devs = mesh.devices
    cuda = mesh.is_cuda
    cur = list(chunks)
    buffers = [[torch.empty_like(c) for c in chunks]
               for _ in range(min(2, p - 1))]
    if cuda:
        side = [torch.cuda.Stream(device=d) for d in devs]
        for s in side:
            s.wait_stream(torch.cuda.current_stream(s.device))
        ready = [_record(torch.cuda.current_stream(d)) for d in devs]
        used = [None] * p  # each position's last step
        sent = [None] * p  # the copy that last read each position's buffer
    for t in range(p):
        if cuda:
            used_before, used = used, [None] * p
        for i in range(p):
            if not cuda:
                step(t, i, (i - t) % p, cur[i])
                continue
            with torch.cuda.device(devs[i]):
                main = torch.cuda.current_stream(devs[i])
                main.wait_event(ready[i])
                step(t, i, (i - t) % p, cur[i])
                used[i] = _record(main)
        if t + 1 == p:
            break
        spare = buffers[t % 2]
        arrived = [None] * p
        for j in range(p):
            i = (j - 1) % p
            if not cuda:
                spare[j].copy_(cur[i])
                continue
            for ev in (ready[i], used_before[j], sent[j]):
                if ev is not None:
                    side[j].wait_event(ev)
            # the inner context wins where both name one device; across
            # devices torch copies on the source's current stream
            with torch.cuda.stream(side[i]), torch.cuda.stream(side[j]):
                spare[j].copy_(cur[i], non_blocking=True)
            arrived[j] = _record(side[j])
        if cuda:
            sent = [arrived[(j + 1) % p] for j in range(p)]
            ready = arrived
        cur = spare
    if cuda:
        for s in side:
            torch.cuda.current_stream(s.device).wait_stream(s)


def _record(stream) -> "torch.cuda.Event":
    ev = torch.cuda.Event()
    ev.record(stream)
    return ev
