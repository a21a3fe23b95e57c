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

Cell-sharded data (``data/sharded.py``): :func:`shard_celldata` cuts a
``CellData``'s rows into one block a device.  Two helpers are
re-exported here: GSPMD's ``psum`` becomes ``data.sharded.reduce_sum``,
the per-device partials added in mesh order on the first device, and
``ops.pca.cholesky_qr_blocks`` orthonormalises row blocks that lie on
several devices through one reduced Gram matrix.  The per-gene sums of
a sparse block add in a fixed order too (``sparse.segment_reduce``), so
the stats and HVG passes on a mesh repeat their bits on every device;
the PCA's ``Xᵀ Q`` (``sparse.spmm_t``) adds by the card's atomics, and
its result repeats its bits on the CPU only.

Multi-host bring-up runs on ``torch.distributed``: :func:`init_distributed`
joins a process group over a ``TCPStore`` (NCCL on the card, gloo on the
CPU) with the reference's hardening, and :func:`coordination_sum` adds a
float across processes through the store.  A mesh stays inside one
process: the data plane across processes (a ``Mesh`` over several
processes' devices, the ring over ``send``/``recv``) is not ported,
ROADMAP.md Queue 1 item 9.
"""

from __future__ import annotations

import dataclasses
import os
import threading
from datetime import timedelta
from typing import Callable

import numpy as np
import torch

from ..data.sharded import reduce_sum  # noqa: F401  (re-exported)
from ..ops.pca import cholesky_qr_blocks  # noqa: F401  (re-exported)

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


# ----------------------------------------------------------------------
# Cell-sharded data
# ----------------------------------------------------------------------


def shard_celldata(data, mesh: Mesh):
    """``data`` with its X cut into ``mesh.size`` row blocks, block d on
    ``mesh.devices[d]`` (``data/sharded.py:ShardedRows``).  Rows are
    padded to ``round_up(rows, P × sublane)`` first: a sparse X (scipy
    or ``SparseCells``) becomes padded-ELL blocks, a dense one float32
    row blocks.  obs, var, obsm, varm, obsp, uns and layers are carried
    as they are, as the reference carries them (per-cell fields on the
    host, sharded where an op writes them).  ``to_host`` gathers the
    blocks back, bit for bit."""
    import scipy.sparse as sp

    from ..config import config, round_up
    from ..data.dataset import CellData
    from ..data.sharded import ShardedRows, split_blocks
    from ..data.sparse import SparseCells

    X = data.X
    if isinstance(X, ShardedRows):
        raise ValueError("shard_celldata: the data is already sharded")
    mult = mesh.size * config.sublane
    if sp.issparse(X):
        X = SparseCells.from_scipy_csr(X)
    if isinstance(X, SparseCells):
        Xs = split_blocks(X.pad_rows_to(round_up(X.rows_padded, mult)), mesh)
    else:
        X = (X if isinstance(X, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(X, dtype=np.float32)))
        n = X.shape[0]
        Xs = split_blocks(pad_rows(X, round_up(max(n, 1), mult)), mesh,
                          n_cells=n)
    return CellData(Xs, dict(data.obs), dict(data.var), dict(data.obsm),
                    dict(data.varm), dict(data.obsp), dict(data.uns),
                    dict(data.layers))


# ----------------------------------------------------------------------
# Multi-host bring-up on torch.distributed
# ----------------------------------------------------------------------

#: bring-up failure signatures that are transient at the transport
#: level: the coordinator's port still in TIME_WAIT from an earlier
#: incarnation, workers racing the coordinator's start (connection
#: refused, a barrier's deadline) and the socket noise in between.  A
#: bounded retry gives the port time to free and the coordinator time to
#: come up; anything else recurs as it is and surfaces at once.
_BRINGUP_TRANSIENT_MARKERS = (
    "address already in use",
    "address in use",
    "failed to bind",
    "bind failed",
    "deadline exceeded",
    "deadline_exceeded",
    "timed out",
    "timeout",
    "unavailable",
    "failed to connect",
    "connection refused",
    "connection reset",
    "connection closed",
    "socket closed",
    "broken pipe",
)

#: hosts whose port a bind probe from this process can test (process 0
#: binds the store's server locally; a remote NIC cannot be probed here)
_LOCAL_BIND_HOSTS = ("127.0.0.1", "localhost", "0.0.0.0", "::1", "")

#: environment variables of a launcher (torchrun and its kin): a bare
#: call under one refuses to run this process alone, as a job of its own
_LAUNCHER_ENV = ("MASTER_ADDR", "WORLD_SIZE", "TORCHELASTIC_RUN_ID")

_DIST: dict = {}  # the bring-up's store and its answer, once made


def classify_bringup_error(exc: BaseException) -> str:
    """``"transient"`` when a bring-up failure is worth a bounded retry
    (the port in TIME_WAIT, the coordinator not up yet, a barrier's
    timeout), ``"deterministic"`` otherwise (a misconfiguration recurs
    as it is; a retry only hides the message)."""
    msg = f"{type(exc).__name__}: {exc}".lower()
    if any(m in msg for m in _BRINGUP_TRANSIENT_MARKERS):
        return "transient"
    return "deterministic"


def _await_coordinator_port(host: str, port: int, attempts: int,
                            retry_delay_s: float, clock) -> None:
    """Bind-probe the coordinator's port before the store's server binds
    it, with up to ``attempts`` tries and a linear backoff on ``clock``:
    a port in TIME_WAIT frees within seconds, one held by a live
    listener never does, and then this raises a ``RuntimeError`` that
    says what to do."""
    import socket

    family = socket.AF_INET6 if ":" in (host or "") else socket.AF_INET
    last = None
    for attempt in range(1, attempts + 1):
        try:
            with socket.socket(family) as s:
                # the store's own bind semantics: SO_REUSEADDR lets a
                # TIME_WAIT port pass, a listening holder still refuses
                s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
                s.bind((host or "127.0.0.1", port))
            return
        except OSError as e:
            last = e
        if attempt < attempts:
            clock.sleep(retry_delay_s * attempt)
    raise RuntimeError(
        f"init_distributed: coordinator port {host or '127.0.0.1'}:{port} "
        f"is still in use after {attempts} bind attempt(s) (last: "
        f"{type(last).__name__}: {last}); pick a free port, or raise "
        "attempts=/retry_delay_s= to wait out a TIME_WAIT holder") from last


def _validate_bringup_args(coordinator_address, num_processes,
                           process_id) -> None:
    """Misconfigurations raise a ``ValueError`` with advice before any
    socket is touched."""
    if (num_processes is None) != (process_id is None):
        raise ValueError(
            "init_distributed: pass num_processes and process_id TOGETHER "
            f"(got num_processes={num_processes!r}, process_id="
            f"{process_id!r}); every process must agree on the cluster "
            "size and hold a rank of its own")
    if num_processes is not None:
        if num_processes < 1:
            raise ValueError(f"init_distributed: num_processes="
                             f"{num_processes} must be >= 1")
        if not 0 <= process_id < num_processes:
            raise ValueError(
                f"init_distributed: process_id={process_id} out of range "
                f"for num_processes={num_processes}; ids are 0-based and "
                f"distinct (valid: 0..{num_processes - 1})")
    if coordinator_address is not None:
        host, sep, port = str(coordinator_address).rpartition(":")
        if not sep or not host or not port.isdigit():
            raise ValueError(
                f"init_distributed: coordinator_address="
                f"{coordinator_address!r} is not 'host:port'; every process "
                "passes the same address, which the process of id 0 binds "
                "(e.g. '10.0.0.1:29500')")


def _local_devices(device: torch.device) -> int:
    return torch.cuda.device_count() if device.type == "cuda" else 1


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None, *,
                     attempts: int = 3, retry_delay_s: float = 2.0,
                     timeout_s: float | None = None, clock=None,
                     device=None) -> dict:
    """Multi-process bring-up: ``torch.distributed.init_process_group``
    over a ``TCPStore`` that the process of id 0 serves at
    ``coordinator_address`` ("host:port"), with the NCCL backend on the
    card or gloo where ``device="cpu"`` (``device=None`` is the card,
    and raises without one).  The counterpart of the reference's
    ``init_distributed`` on ``jax.distributed``, with its contract:

    * a bare call in a single process is a no-op that reports one
      process and this process's devices, and raises under a
      launcher's environment (``MASTER_ADDR``, ``WORLD_SIZE``,
      ``TORCHELASTIC_RUN_ID``) rather than run the process alone: pass
      the address, count and id; a repeat call returns the first
      call's answer;
    * a misconfiguration raises a ``ValueError`` with advice before any
      socket is touched, and explicit arguments that cannot be joined
      raise (never a silent single-process fallback);
    * the process that binds the store (id 0 on a loopback or wildcard
      host) bind-probes its port first, with a bounded retry;
    * transient failures (:func:`classify_bringup_error`) are retried up
      to ``attempts`` times with a linear backoff on ``clock``
      (``utils/vclock.py``), half-made state torn down in between, then
      raise a ``RuntimeError`` naming the count; deterministic ones
      surface at once;
    * ``timeout_s`` bounds each attempt's wait for the other processes
      (default 300 s).

    Returns {"process_id", "num_processes", "local_devices",
    "global_devices"}; the global count is the sum of every process's
    local devices, added through the store."""
    from ..config import resolve_device
    from ..utils.vclock import SYSTEM_CLOCK

    import torch.distributed as dist

    clock = clock if clock is not None else SYSTEM_CLOCK
    if attempts < 1:
        raise ValueError(f"init_distributed: attempts={attempts} must be "
                         ">= 1")
    _validate_bringup_args(coordinator_address, num_processes, process_id)
    dev = resolve_device(device)
    if "info" in _DIST:
        return dict(_DIST["info"])
    if coordinator_address is None and num_processes is None:
        launcher = [v for v in _LAUNCHER_ENV if os.environ.get(v)]
        if launcher:
            raise RuntimeError(
                f"init_distributed: a launcher's environment is set "
                f"({', '.join(launcher)}); pass coordinator_address, "
                "num_processes and process_id rather than run this "
                "process alone")
        local = _local_devices(dev)
        return {"process_id": 0, "num_processes": 1,
                "local_devices": local, "global_devices": local}
    if coordinator_address is None or num_processes is None:
        raise ValueError(
            "init_distributed: explicit num_processes/process_id need a "
            "coordinator_address ('host:port') every process can reach")
    host, _, port = str(coordinator_address).rpartition(":")
    port = int(port)
    if process_id == 0 and host in _LOCAL_BIND_HOSTS:
        _await_coordinator_port(host, port, attempts, retry_delay_s, clock)
    wait = timedelta(seconds=300 if timeout_s is None else max(1, timeout_s))
    backend = "nccl" if dev.type == "cuda" else "gloo"
    last = None
    for attempt in range(1, attempts + 1):
        store = None
        try:
            store = dist.TCPStore(host, port, num_processes,
                                  is_master=process_id == 0, timeout=wait,
                                  wait_for_workers=True)
            dist.init_process_group(backend, store=store, rank=process_id,
                                    world_size=num_processes, timeout=wait)
            last = None
            break
        except (RuntimeError, OSError, ValueError) as e:
            last = e
        if dist.is_initialized():  # a half-made group must not linger
            dist.destroy_process_group()
        del store
        if classify_bringup_error(last) != "transient" or attempt >= attempts:
            break
        clock.sleep(retry_delay_s * attempt)
    if last is not None:
        if classify_bringup_error(last) == "transient":
            raise RuntimeError(
                f"init_distributed: bring-up failed {attempts} time(s) on a "
                f"transient transport error (last: {type(last).__name__}: "
                f"{last}); the coordinator's port may be held by another "
                "process: pick a free port, or raise attempts=/"
                "retry_delay_s= if the coordinator is slow to start"
            ) from last
        raise last
    _DIST["store"] = store
    _DIST["wait"] = wait
    local = _local_devices(dev)
    info = {"process_id": dist.get_rank(),
            "num_processes": dist.get_world_size(),
            "local_devices": local,
            "global_devices": int(coordination_sum(
                local, "init_distributed/local_devices",
                timeout_s=wait.total_seconds()))}
    _DIST["info"] = info
    return dict(info)


def coordination_sum(value: float, tag: str,
                     timeout_s: float = 60.0) -> float:
    """Sum one float across every process through the bring-up's store
    (its key-value API, no device collective): each process writes
    ``sctools/<tag>/<rank>`` once and reads every rank's key, added in
    rank order, so every process gets the same bits.  ``tag`` names one
    reduction (a key is written once; a reused tag raises).  Without a
    process group of more than one process: ``value`` as it is."""
    import torch.distributed as dist

    store = _DIST.get("store")
    if store is None or not dist.is_initialized() \
            or dist.get_world_size() <= 1:
        return float(value)
    rank, n = dist.get_rank(), dist.get_world_size()
    mine = f"sctools/{tag}/{rank}"
    if store.check([mine]):
        raise ValueError(f"coordination_sum: tag {tag!r} was used already")
    store.set(mine, repr(float(value)))
    keys = [f"sctools/{tag}/{i}" for i in range(n)]
    store.wait(keys, timedelta(seconds=timeout_s))
    total = 0.0
    for k in keys:
        total += float(store.get(k).decode())
    return total


def mesh_host_groups(mesh: Mesh) -> list:
    """The mesh's devices grouped by the host (process) that owns them,
    in mesh order.  A port mesh lies in one process, so that is one
    group, unless ``SCTOOLS_MESH_HOSTS=N`` splits a mesh that spans
    every device this process sees (every visible card; any CPU mesh)
    into N equal contiguous groups, as the reference's single-process
    harness does to drive a lost host on one box.  A mesh over fewer
    cards is one surviving host, as in the reference."""
    devs = list(mesh.devices)
    fake = os.environ.get("SCTOOLS_MESH_HOSTS", "")
    full = (not mesh.is_cuda or len({d.index for d in devs})
            == torch.cuda.device_count())
    if fake.isdigit() and int(fake) > 1 and len(devs) % int(fake) == 0 \
            and full:
        per = len(devs) // int(fake)
        return [devs[i * per:(i + 1) * per] for i in range(int(fake))]
    return [devs]
