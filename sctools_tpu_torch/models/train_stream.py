"""``model.scvi_stream``: scVI trained out of core over a shard store,
on the card, resumable at every shard boundary.

Counterpart of ``sctools_tpu/models/train_stream.py``, with its
arguments, results, journal events, ``train.*`` metrics and cursor file.

* **The feed.**  Each epoch walks the store in a block-permuted shard
  order (:func:`epoch_shard_order`: blocks of consecutive shards
  shuffled, ascending inside a block), read plainly or through a
  ``ShardReadScheduler`` (``data/shardstore.py``), and the prefetch
  worker of ``data/stream.py`` reads, packs and copies shard N+1 on a
  side stream while the card trains on shard N (``train.overlap_s`` /
  ``train.stall_s``).  The steps on a shard are
  the in-memory epoch's (``models/scvi.py``: ``ShardSteps`` over
  ``_Epochs``), the rows a permutation of the shard's real rows
  (:func:`_shard_perm`), the noise ``scvi.shard_noise``.  Every draw is
  a pure function of (seed, epoch, position or shard).
* **The cursor.**  With ``checkpoint=`` the parameters, Adam's state
  and the position (epoch, position in the epoch's order, global step,
  the epoch's partial loss sums, the history) are saved after every
  ``checkpoint_every`` shards through the verified npz generations
  (``utils/checkpoint.py``).  The file is the reference's
  (``scvi-stream-v1``): ``p000…`` the parameters in the reference's
  leaf order (its dict keys sorted, each weight (in, out)), ``o000…``
  optax's Adam state (``count``, then ``mu``, then ``nu`` in that
  order), so a cursor either package writes resumes in the other.  A
  resumed run reaches the bits of an uninterrupted one.
* **Preemption.**  At every shard boundary the trainer polls
  ``failsafe.check_preempt()`` and its ``preempt=`` token; on a request
  it saves its cursor, then raises ``failsafe.JobPreempted``.

Journal events: ``train_resume``, then ``train_shard`` …
``train_checkpoint`` … ``train_epoch``, then ``preempted`` or the end;
``mem_reserved`` / ``mem_released`` around a ``memory.MemoryBudget``'s
hold on the feed window.
"""

from __future__ import annotations

import os
import warnings

import numpy as np
import torch

from .. import memory as _memory
from ..config import resolve_device, true_f32
from ..data.shardstore import ShardStore
from ..data.stream import (_consume_on_current_stream, _copy_to_card,
                           _prefetch_iter)
from ..registry import register
from ..runner import as_journal
from ..utils import telemetry
from ..utils.checkpoint import (clear_npz_generations, load_npz_generations,
                                save_npz_generations)
from ..utils.failsafe import JobPreempted, check_preempt
from ..utils.vclock import SYSTEM_CLOCK
from . import scvi as _scvi

#: identity fingerprint of the cursor file, the reference's
_CURSOR_FP = "scvi-stream-v1"


def epoch_shard_order(n_shards: int, epoch: int, seed: int,
                      block: int = 4) -> np.ndarray:
    """The epoch's shard order: blocks of ``block`` consecutive shards
    in a permuted order, ascending inside a block; a pure function of
    (seed, epoch).  The reference's numpy draws."""
    if n_shards <= 0:
        return np.zeros(0, np.int64)
    block = max(1, int(block))
    rng = np.random.default_rng([int(seed) & 0x7FFFFFFF, int(epoch),
                                 0x5EED])
    n_blocks = -(-n_shards // block)
    out = []
    for b in rng.permutation(n_blocks):
        out.extend(range(b * block, min((b + 1) * block, n_shards)))
    return np.asarray(out, np.int64)


def _shard_perm(rows: int, take: int, seed: int, epoch: int,
                shard: int) -> np.ndarray:
    """The first ``take`` of a permutation of the shard's ``rows`` real
    rows, a pure function of (seed, epoch, shard).  The reference's
    numpy draws."""
    rng = np.random.default_rng([int(seed) & 0x7FFFFFFF, int(epoch),
                                 int(shard), 0xBA7C4])
    return rng.permutation(rows)[:take].astype(np.int32)


def _leaf_order(model: _scvi.SCVIModel) -> list:
    """The model's parameters in the reference's pytree leaf order
    (``dec``, ``enc``, ``log_theta``; each layer ``b`` then ``w``), each
    with whether it is stored transposed there (a weight: (in, out))."""
    out = []
    for mlp in (model.dec, model.enc):
        for lyr in mlp.layers:
            out += [(lyr.bias, False), (lyr.weight, True)]
    out.append((model.log_theta, False))
    return out


def _adam_slots(model, trainer) -> list:
    """For each parameter in the reference's leaf order: (parameter,
    transposed, its Adam ``m``, its ``v``)."""
    pos = {id(p): i for i, p in enumerate(trainer.params[0])}
    return [(p, t, trainer.m[pos[id(p)]], trainer.v[pos[id(p)]])
            for p, t in _leaf_order(model)]


def _host(t: torch.Tensor, transposed: bool) -> np.ndarray:
    a = t.detach().cpu().numpy()
    return np.ascontiguousarray(a.T) if transposed else a.copy()


def _pack_state(model, trainer, step: int) -> dict:
    """``p000…`` the parameters, ``o000`` Adam's step count (int32),
    then ``mu`` and ``nu``: the reference's leaves, as numpy."""
    slots = _adam_slots(model, trainer)
    out = {f"p{i:03d}": _host(p, t) for i, (p, t, _, _) in enumerate(slots)}
    opt = [np.asarray(step, np.int32)]
    opt += [_host(m, t) for _, t, m, _ in slots]
    opt += [_host(v, t) for _, t, _, v in slots]
    out.update({f"o{i:03d}": a for i, a in enumerate(opt)})
    return out


def _unpack_state(z: dict, model, trainer) -> None:
    """Load a cursor's parameters and Adam moments into ``model`` and
    ``trainer`` in place (a recorded graph keeps reading the same
    tensors); Adam's step count is the cursor's ``step``."""
    slots = _adam_slots(model, trainer)
    k = len(slots)

    def put(dst, key, transposed):
        a = torch.from_numpy(np.asarray(z[key], np.float32))
        dst.copy_(a.T if transposed else a)

    with torch.no_grad():
        for i, (p, t, m, v) in enumerate(slots):
            put(p, f"p{i:03d}", t)
            put(m, f"o{1 + i:03d}", t)
            put(v, f"o{1 + k + i:03d}", t)
        for ps in trainer.params[1:]:
            torch._foreach_copy_(ps, [p.to(q.device) for p, q in
                                      zip(trainer.params[0], ps)])


class _Cursor:
    """The training position one checkpoint freezes: epoch, position in
    the epoch's shard order, global step, the epoch's partial loss sums
    (so a resumed epoch reports the uninterrupted mean) and the
    history."""

    __slots__ = ("epoch", "pos", "step", "loss_sum", "loss_steps",
                 "history")

    def __init__(self):
        self.epoch = 0
        self.pos = 0
        self.step = 0
        self.loss_sum = 0.0
        self.loss_steps = 0
        self.history: list[float] = []

    def as_dict(self) -> dict:
        return {"epoch": self.epoch, "pos": self.pos, "step": self.step}


def fit_scvi_stream(store, *, n_latent: int = 10, n_hidden: int = 128,
                    epochs: int = 10, batch_size: int = 512,
                    seed: int = 0, kl_warmup: int = 10,
                    scheduler=None, checkpoint: str | None = None,
                    checkpoint_every: int = 1, order_block: int = 4,
                    prefetch: bool = True, prefetch_depth: int = 2,
                    encode: bool = False, preempt=None,
                    clock=None, metrics=None, journal=None,
                    mem_budget=None, params_out: str | None = None,
                    device=None) -> dict:
    """Train the NB-VAE (no batch covariate) over the shard store
    ``store`` (a ``ShardStore`` or its directory) on ``device`` (``None``:
    the card, raising without one); the module docstring has the
    contract.  ``scheduler`` routes every read through a
    ``ShardReadScheduler`` of the same store (its ``on_corrupt`` must be
    ``"fail"``); ``checkpoint`` is the cursor's path (``None``: a
    preemption loses the progress, with a warning);
    ``checkpoint_every`` its cadence in shards; ``order_block`` the
    shard order's block; ``encode`` one more pass for the posterior
    mean latent of every cell; ``preempt`` a ``PreemptToken`` polled
    beside the thread's scope; ``journal`` a ``runner._Journal`` or a
    path; ``mem_budget`` a ``memory.MemoryBudget`` (default the
    thread's ``current_budget()``) on which the feed window (``depth +
    1`` dense shards) holds a dynamic reservation while the call runs;
    ``params_out`` a path for the trained model (``scvi.save_model``),
    written before the cursor is cleared.

    Returns ``{"params", "history", "epochs_run", "resumed_from",
    "latent"}`` (``params`` the reference's tree as numpy; ``latent``
    with ``encode``) and ``params_digest`` with ``params_out``."""
    if scheduler is not None:
        want = os.path.realpath(store if isinstance(store, str)
                                else store.directory)
        if os.path.realpath(scheduler.store.directory) != want:
            raise ValueError("scheduler serves a different store")
        store = scheduler.store
        if scheduler.on_corrupt == "skip":
            raise ValueError(
                "fit_scvi_stream: on_corrupt='skip' would silently "
                "shift shard positions under the training cursor; "
                "use on_corrupt='fail'")
    elif isinstance(store, str):
        store = ShardStore.open(store)
    dev = resolve_device(device)
    clock = clock if clock is not None else SYSTEM_CLOCK
    m = metrics if metrics is not None else telemetry.default_registry()
    journal = as_journal(journal)
    n_shards, n_genes = store.n_shards, store.n_genes
    if n_shards == 0:
        raise ValueError("fit_scvi_stream: empty store")
    checkpoint_every = max(1, int(checkpoint_every))
    digest = str(store.manifest.get("store_digest", ""))

    # the in-memory model.scvi's start at this seed
    model = _scvi.initial_model(torch.Generator().manual_seed(seed),
                                n_genes, 0, n_latent, n_hidden).to(dev)
    trainer = _scvi.Trainer(model)
    steps = _scvi.ShardSteps(trainer, _scvi.elbo, n_latent)
    cur = _Cursor()
    resumed_from = None

    z = (load_npz_generations(checkpoint, fingerprint=_CURSOR_FP)
         if checkpoint is not None else None)
    if z is not None:
        want = dict(n_cells=store.n_cells, n_genes=n_genes,
                    n_latent=n_latent, n_hidden=n_hidden,
                    batch_size=batch_size, seed=seed,
                    kl_warmup=kl_warmup, order_block=order_block)
        got = {k: int(z[k]) for k in want}
        if got != want:
            raise ValueError(
                f"fit_scvi_stream: checkpoint {checkpoint!r} was "
                f"written for different arguments ({got} != {want}); "
                f"delete it or pass a fresh path")
        if str(z["store_digest"]) != digest:
            raise ValueError(
                f"fit_scvi_stream: checkpoint {checkpoint!r} belongs "
                f"to a different store (digest mismatch); delete it "
                f"or pass a fresh path")
        _unpack_state(z, model, trainer)
        cur.epoch = int(z["epoch"])
        cur.pos = int(z["pos"])
        cur.step = int(z["step"])
        cur.loss_sum = float(z["loss_sum"])
        cur.loss_steps = int(z["loss_steps"])
        cur.history = [float(x) for x in z["history"]]
        resumed_from = cur.as_dict()
        m.counter("train.resumes").inc()
        if journal is not None:
            journal.write("train_resume", **cur.as_dict(),
                          checkpoint=checkpoint)

    last_saved = [None]

    def save_cursor() -> None:
        if checkpoint is None:
            return
        if last_saved[0] == (cur.epoch, cur.pos):
            # already saved at this cursor: a second write would rotate
            # the real previous generation out of .prev
            return
        last_saved[0] = (cur.epoch, cur.pos)
        save_npz_generations(
            checkpoint, fingerprint=_CURSOR_FP,
            n_cells=store.n_cells, n_genes=n_genes,
            n_latent=n_latent, n_hidden=n_hidden,
            batch_size=batch_size, seed=seed, kl_warmup=kl_warmup,
            order_block=order_block, store_digest=digest,
            epoch=cur.epoch, pos=cur.pos, step=cur.step,
            loss_sum=np.float64(cur.loss_sum),
            loss_steps=cur.loss_steps,
            history=np.asarray(cur.history, np.float64),
            **_pack_state(model, trainer, cur.step))
        m.counter("runner.checkpoint_writes").inc()
        if journal is not None:
            journal.write("train_checkpoint", **cur.as_dict())

    if resumed_from is None:
        # generation 0 before the first read: a kill while the prefetch
        # worker reads ahead of the first step resumes through the
        # verified cursor too
        save_cursor()
    else:
        last_saved[0] = (cur.epoch, cur.pos)

    def poll_preempt() -> str | None:
        r = preempt.pending() if preempt is not None else None
        return r or check_preempt()

    def yield_now(reason: str) -> None:
        if checkpoint is None:
            warnings.warn(
                "fit_scvi_stream: preempted without a checkpoint= — "
                "progress is lost; the requeued run restarts from "
                "scratch", RuntimeWarning, stacklevel=3)
        else:
            save_cursor()
        m.counter("train.preemptions", reason=reason).inc()
        if journal is not None:
            journal.write("preempted", reason=reason, **cur.as_dict())
        raise JobPreempted(
            f"training yielded at epoch {cur.epoch} pos {cur.pos} "
            f"({reason})", reason=reason, cursor=cur.as_dict())

    if dev.type == "cuda":
        side = torch.cuda.Stream(device=dev)
        prepare = lambda sh: _copy_to_card(sh, dev, side)  # noqa: E731
    else:
        prepare = lambda sh: (sh.to(dev), None)  # noqa: E731
    stall_c = m.counter("train.stall_s")
    overlap_c = m.counter("train.overlap_s")
    budget = (mem_budget if mem_budget is not None
              else _memory.current_budget())
    feed_name = f"train:feed:{id(cur)}"
    feed_bytes = 0
    feed_reserved = False
    try:
        if budget is not None:
            # inside the try: a raising journal write must still reach
            # the release
            depth = prefetch_depth if prefetch else 0
            feed_bytes = (depth + 1) * store.shard_rows * n_genes * 4
            reserved = budget.reserve(feed_name, feed_bytes)
            feed_reserved = True
            if journal is not None:
                journal.write("mem_reserved", name=feed_name,
                              bytes=feed_bytes, reserved_total=reserved)
        with true_f32():
            while cur.epoch < epochs:
                ep = cur.epoch
                order = epoch_shard_order(n_shards, ep, seed,
                                          block=order_block)
                klw = min(1.0, (ep + 1) / max(kl_warmup, 1))
                tail = [int(s) for s in order[cur.pos:]]

                def feed(tail=tail):
                    if scheduler is not None:
                        yield from scheduler.iter_order(tail)
                    else:
                        for si in tail:
                            yield store.read_shard(si)

                it = (_prefetch_iter(feed, depth=prefetch_depth,
                                     prepare=prepare, clock=clock,
                                     on_stall=stall_c.inc,
                                     on_overlap=overlap_c.inc)
                      if prefetch else (prepare(sh) for sh in feed()))
                try:
                    for sh, done in it:
                        if done is not None:
                            sh = _consume_on_current_stream(sh, done)
                        Xd, rows = sh.to_dense(), sh.n_cells
                        shard = int(order[cur.pos])
                        bs = min(batch_size, rows)
                        n_steps = max(rows // bs, 1)
                        perm = torch.from_numpy(_shard_perm(
                            rows, n_steps * bs, seed, ep, shard).astype(
                            np.int64).reshape(n_steps, bs))
                        eps = _scvi.shard_noise(seed, ep, cur.pos, n_steps,
                                                bs, n_latent)
                        # the loss read is the per-shard sync: the cursor
                        # and the journal need it
                        loss_f = steps.run(Xd, perm, eps, klw, cur.step)
                        cur.loss_sum += loss_f * n_steps
                        cur.loss_steps += n_steps
                        cur.step += n_steps
                        cur.pos += 1
                        m.counter("train.steps").inc(n_steps)
                        m.counter("train.shards").inc()
                        # saved before the shard is journaled: a kill
                        # between the two leaves a gap, never a replay
                        if (cur.pos % checkpoint_every == 0
                                or cur.pos >= len(order)):
                            save_cursor()
                        if journal is not None:
                            journal.write("train_shard", epoch=ep,
                                          pos=cur.pos - 1, shard=shard,
                                          loss=round(loss_f, 6),
                                          steps=n_steps)
                        r = poll_preempt()
                        if r is not None:
                            yield_now(r)
                finally:
                    close = getattr(it, "close", None)
                    if close is not None:
                        close()  # ends the prefetch worker, flushes counters
                loss_ep = cur.loss_sum / max(cur.loss_steps, 1)
                cur.history.append(loss_ep)
                cur.epoch += 1
                cur.pos = 0
                cur.loss_sum = 0.0
                cur.loss_steps = 0
                m.counter("train.epochs").inc()
                m.gauge("train.loss", epoch=ep).set(loss_ep)
                save_cursor()
                if journal is not None:
                    journal.write("train_epoch", epoch=ep,
                                  loss=round(loss_ep, 6), step=cur.step)

            out = {"params": model.tree(),
                   "history": np.asarray(cur.history, np.float64),
                   "epochs_run": cur.epoch, "resumed_from": resumed_from,
                   "latent": None}
            if encode:
                parts = []
                shards = (scheduler.iter_shards() if scheduler is not None
                          else store.iter_shards())
                with torch.no_grad():
                    for sh in shards:
                        X = sh.to(dev).to_dense()
                        oh = torch.zeros((X.shape[0], 0), device=dev)
                        parts.append(_scvi.encode(model, X, oh).cpu())
                out["latent"] = torch.cat(parts).numpy()
    finally:
        if budget is not None and feed_reserved:
            total = budget.release(feed_name)
            if journal is not None:
                journal.write("mem_released", name=feed_name,
                              bytes=feed_bytes, reserved_total=total)
    if params_out is not None:
        # before the cursor is cleared: a kill between the two resumes
        # from a finished cursor and writes the same artifact again
        out["params_digest"] = _scvi.save_model(
            model, params_out,
            meta={"epochs": cur.epoch, "seed": seed,
                  "n_latent": n_latent, "n_hidden": n_hidden})
    if checkpoint is not None:
        clear_npz_generations(checkpoint)  # done: the cursor is stale
    return out


@register("model.scvi_stream")
def scvi_stream(data, store_dir: str = "", n_latent: int = 10,
                n_hidden: int = 128, epochs: int = 10,
                batch_size: int = 512, seed: int = 0,
                kl_warmup: int = 10, checkpoint: str | None = None,
                checkpoint_every: int = 1, order_block: int = 4,
                encode: bool = False, journal: str | None = None,
                params_out: str | None = None, device=None):
    """Train scVI out of core on the shard store at ``store_dir``
    (:func:`fit_scvi_stream`).  ``data`` only carries the results, in
    its uns: ``scvi_stream_elbo_history`` (the negative ELBO of each
    epoch), ``scvi_stream_epochs``, with ``encode`` ``scvi_stream_latent``
    ((store cells, n_latent) posterior means) and with ``params_out``
    ``scvi_stream_params_digest``.  Runs on ``device`` (``None``: the
    card, raising without one)."""
    res = fit_scvi_stream(
        ShardStore.open(store_dir), n_latent=n_latent,
        n_hidden=n_hidden, epochs=epochs, batch_size=batch_size,
        seed=seed, kl_warmup=kl_warmup, checkpoint=checkpoint,
        checkpoint_every=checkpoint_every, order_block=order_block,
        encode=encode, journal=journal, params_out=params_out,
        device=device)
    uns = {"scvi_stream_elbo_history": res["history"],
           "scvi_stream_epochs": np.int64(res["epochs_run"])}
    if res["latent"] is not None:
        uns["scvi_stream_latent"] = res["latent"]
    if "params_digest" in res:
        uns["scvi_stream_params_digest"] = res["params_digest"]
    return data.with_uns(**uns)
