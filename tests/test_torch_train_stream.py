"""The port's streamed scVI training (``sctools_tpu_torch/models/
train_stream.py``) against the reference's (``sctools_tpu/models/
train_stream.py``), on the CPU, at the reference's test sizes
(``tests/test_train_stream.py``: 1,024 × 64 counts, 256-row shards of
64-row chunks, ``HYPER``).

Both packages train on one store on disk.  The numpy draws (the shard
order, the rows of each shard) are the same in both; the reference's
``jax.random`` draws come in by patching: its initial weights
(``scvi.initial_model``) and each shard's noise (``scvi.shard_noise``,
from ``fold_in(fold_in(key, epoch), pos)`` and the per-step splits of
``_train_epoch``).  Tolerances are those of ``tests/test_torch_scvi.py``:
histories rtol 1e-5, parameters and latents within ``STATE_TOL`` of each
array's largest value, with one exception.  A gene with one count in a
minibatch has a ``log_theta`` gradient below float32's resolution of its
sum (float64 6.9e-7 where the reference's float32 gives 1.8e-6 and the
port's 2.6e-6, of a largest gradient 1.8), and Adam turns that rounding
into steps of ±lr: such genes (``noise_genes``: first-step float64
gradient under 1e-5 of the largest) may differ by up to 2 lr; every
other gene and parameter is held to ``STATE_TOL``.  Within the port,
scheduled reads and a preempted then resumed run are bit for bit the
uninterrupted run.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sctools_tpu as sct
from sctools_tpu.data.shardstore import ShardReadScheduler as RefScheduler
from sctools_tpu.data.synthetic import synthetic_counts
from sctools_tpu.models import scvi as RS
from sctools_tpu.models import train_stream as R
from sctools_tpu.utils.failsafe import JobPreempted as RefPreempted
from sctools_tpu.utils.failsafe import PreemptToken as RefToken
from sctools_tpu.utils.telemetry import MetricsRegistry as RefRegistry
import sctools_tpu_torch as sctt
from sctools_tpu_torch.carry import scvi_params_from_numpy
from sctools_tpu_torch.data.shardstore import (ShardReadScheduler, ShardStore,
                                               write_store)
from sctools_tpu_torch.memory import MemoryBudget, budget_scope
from sctools_tpu_torch.models import scvi as P
from sctools_tpu_torch.models import train_stream as T
from sctools_tpu_torch.utils.failsafe import JobPreempted, PreemptToken
from sctools_tpu_torch.utils.telemetry import MetricsRegistry

torch.set_num_threads(2)

HYPER = dict(n_latent=4, n_hidden=16, epochs=2, batch_size=128, seed=0)
STATE_TOL = 2e-4  # of each compared array's largest value
NOISE_STEP = 2e-3  # 2 × Adam's lr: the most a noise gene may differ
CPU = dict(HYPER, device="cpu")


@pytest.fixture(scope="module")
def counts():
    return synthetic_counts(1024, 64, density=0.2, n_clusters=3, seed=0)


@pytest.fixture(scope="module")
def store(counts, tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_train_store")
    return write_store(counts.X, str(d / "store"), shard_rows=256,
                       chunk_rows=64)


@pytest.fixture(scope="module")
def ref_store(store):
    from sctools_tpu.data.shardstore import ShardStore as RefStore

    return RefStore.open(store.directory)


@pytest.fixture(scope="module")
def ref(ref_store):
    """The reference's uninterrupted run, with its latents."""
    return R.fit_scvi_stream(ref_store, encode=True, **HYPER)


@pytest.fixture(scope="module")
def port(store):
    """The port's own uninterrupted run (its own draws)."""
    return T.fit_scvi_stream(store, **CPU)


def _ref_noise(seed, ep, pos, n_steps, rows, n_latent):
    """The reference's noise of one shard (``train_stream.py:444,468``
    and ``_train_epoch``'s splits)."""
    key, _ = jax.random.split(jax.random.PRNGKey(seed))
    ks = jax.random.fold_in(jax.random.fold_in(key, ep), pos)
    steps = []
    for _ in range(n_steps):
        ks, k = jax.random.split(ks)
        steps.append(np.asarray(jax.random.normal(k, (rows, n_latent))))
    return torch.from_numpy(np.stack(steps))


def _ref_init(seed, n_genes):
    _, ki = jax.random.split(jax.random.PRNGKey(seed))
    tree = RS.init_params(ki, n_genes, 0, HYPER["n_latent"],
                          HYPER["n_hidden"])
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


@pytest.fixture
def carried(monkeypatch, store):
    """The reference's initial weights and per-shard noise in the port."""
    tree = _ref_init(HYPER["seed"], store.n_genes)
    monkeypatch.setattr(P, "initial_model",
                        lambda *a, **k: scvi_params_from_numpy(tree))
    monkeypatch.setattr(P, "shard_noise", _ref_noise)


@pytest.fixture(scope="module")
def noise_genes(store):
    """Genes whose ``log_theta`` gradient at the first step (epoch 0's
    first shard, its first rows and noise, the reference's start) is,
    in float64, under 1e-5 of the largest: below what a float32 sum of
    the minibatch resolves."""
    tree = _ref_init(HYPER["seed"], store.n_genes)
    model = scvi_params_from_numpy(tree).double()
    shard = int(T.epoch_shard_order(store.n_shards, 0, HYPER["seed"])[0])
    X = store.read_shard(shard).to_dense().double()
    B = HYPER["batch_size"]
    rows = torch.from_numpy(T._shard_perm(X.shape[0], B, HYPER["seed"], 0,
                                          shard).astype(np.int64))
    eps = _ref_noise(HYPER["seed"], 0, 0, 1, B, HYPER["n_latent"])[0]
    P.elbo(model, X[rows], torch.zeros((B, 0), dtype=torch.float64),
           eps.double(), 1.0 / 10).backward()
    g = model.log_theta.grad.abs()
    return set(np.flatnonzero((g < 1e-5 * g.max()).numpy()).tolist())


def _close_trees(got, want, noise=frozenset(), tol=STATE_TOL):
    """Each leaf within ``tol`` of the reference leaf's largest value;
    ``log_theta``'s ``noise`` genes within ``NOISE_STEP``."""
    g = jax.tree_util.tree_leaves_with_path(got)
    w = dict(jax.tree_util.tree_leaves_with_path(want))
    assert len(g) == len(w)
    for path, a in g:
        b = np.asarray(w[path])
        assert np.shape(a) == b.shape, path
        scale = max(float(np.abs(b).max()), 1e-30)
        err = np.abs(np.asarray(a) - b)
        name = jax.tree_util.keystr(path)
        if name == "['log_theta']":
            off = set(np.flatnonzero(err > tol * scale).tolist())
            assert off <= noise, (off, noise)
            assert float(err.max()) <= NOISE_STEP, float(err.max())
        else:
            assert float(err.max()) <= tol * scale, (name, float(err.max()),
                                                     scale)


def _same_trees(a, b):
    la, lb = (jax.tree_util.tree_leaves(t) for t in (a, b))
    return len(la) == len(lb) and all(
        np.array_equal(np.asarray(x), np.asarray(y)) for x, y in zip(la, lb))


def _preempt_at(boundary, token_cls):
    polls = [0]

    def probe():
        polls[0] += 1
        return "priority" if polls[0] == boundary else None

    return token_cls(probe=probe)


def _events(path):
    return [json.loads(line) for line in open(path)]


# ------------------------------------------------------- the numpy draws


@pytest.mark.parametrize("n_shards,seed,block", [
    (10, 7, 4), (9, 0, 4), (1, 3, 4), (17, 123456789, 3), (8, -5, 1)])
def test_shard_order_and_rows_equal_the_reference(n_shards, seed, block):
    for ep in range(4):
        np.testing.assert_array_equal(
            T.epoch_shard_order(n_shards, ep, seed, block=block),
            R.epoch_shard_order(n_shards, ep, seed, block=block))
        for shard in (0, n_shards - 1):
            np.testing.assert_array_equal(
                T._shard_perm(300, 256, seed, ep, shard),
                R._shard_perm(300, 256, seed, ep, shard))
    assert len(T.epoch_shard_order(0, 0, seed)) == 0


def test_shard_noise_is_a_pure_function_of_seed_epoch_position():
    a = P.shard_noise(0, 1, 2, 3, 8, 4)
    assert a.shape == (3, 8, 4) and a.dtype == torch.float32
    assert torch.equal(a, P.shard_noise(0, 1, 2, 3, 8, 4))
    for other in ((1, 1, 2), (0, 2, 2), (0, 1, 3)):
        assert not torch.equal(a, P.shard_noise(*other, 3, 8, 4))


# --------------------------------------------------- against the reference


def test_fit_matches_the_reference(store, ref, carried, noise_genes):
    """The same store, the reference's weights and noise carried in:
    its history, parameters and latents."""
    got = T.fit_scvi_stream(store, encode=True, **CPU)
    np.testing.assert_allclose(got["history"], ref["history"], rtol=1e-5)
    _close_trees(got["params"], jax.tree_util.tree_map(np.asarray,
                                                       ref["params"]),
                 noise_genes)
    assert len(noise_genes) <= 4, noise_genes  # of 64
    want = np.asarray(ref["latent"])
    assert got["latent"].shape == want.shape == (store.n_cells, 4)
    assert np.abs(got["latent"] - want).max() <= STATE_TOL * np.abs(
        want).max()
    assert got["epochs_run"] == 2 and got["resumed_from"] is None


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_a_cursor_resumes_in_the_other_package(store, ref_store, ref,
                                               carried, noise_genes, writer,
                                               tmp_path):
    """Preempted at (0, 3) in one package, resumed in the other: the
    reference's uninterrupted parameters and history."""
    ck = str(tmp_path / "cursor.npz")
    if writer == "reference":
        with pytest.raises(RefPreempted) as ei:
            R.fit_scvi_stream(ref_store, checkpoint=ck,
                              preempt=_preempt_at(3, RefToken), **HYPER)
        got = T.fit_scvi_stream(store, checkpoint=ck, **CPU)
    else:
        with pytest.raises(JobPreempted) as ei:
            T.fit_scvi_stream(store, checkpoint=ck,
                              preempt=_preempt_at(3, PreemptToken), **CPU)
        got = R.fit_scvi_stream(ref_store, checkpoint=ck, **HYPER)
        got["params"] = jax.tree_util.tree_map(np.asarray, got["params"])
    assert ei.value.cursor == {"epoch": 0, "pos": 3, "step": 6}
    assert got["resumed_from"] == {"epoch": 0, "pos": 3, "step": 6}
    np.testing.assert_allclose(got["history"], ref["history"], rtol=1e-5)
    _close_trees(got["params"], jax.tree_util.tree_map(np.asarray,
                                                       ref["params"]),
                 noise_genes)
    assert not os.path.exists(ck)


def test_cursor_layout_is_the_references(store, ref_store, carried,
                                         tmp_path):
    """The same keys, shapes and dtypes as a reference cursor at the
    same position; ``o000`` is Adam's int32 step count."""
    from sctools_tpu_torch.utils.checkpoint import load_npz_verified

    a, b = str(tmp_path / "port.npz"), str(tmp_path / "ref.npz")
    with pytest.raises(JobPreempted):
        T.fit_scvi_stream(store, checkpoint=a,
                          preempt=_preempt_at(2, PreemptToken), **CPU)
    with pytest.raises(RefPreempted):
        R.fit_scvi_stream(ref_store, checkpoint=b,
                          preempt=_preempt_at(2, RefToken), **HYPER)
    za = load_npz_verified(a, expect_fingerprint=T._CURSOR_FP)
    zb = load_npz_verified(b, expect_fingerprint=T._CURSOR_FP)
    assert sorted(za) == sorted(zb)
    for k in zb:
        assert np.asarray(za[k]).shape == np.asarray(zb[k]).shape, k
        assert np.asarray(za[k]).dtype == np.asarray(zb[k]).dtype, k
    assert za["o000"].dtype == np.int32 and int(za["o000"]) == 4
    for k in ("epoch", "pos", "step", "loss_steps", "n_cells", "seed"):
        assert int(za[k]) == int(zb[k]), k
    assert str(za["store_digest"]) == str(zb["store_digest"])


def test_loss_parity_with_the_in_memory_model(counts, port):
    """The reference's own gate (``tests/test_train_stream.py:97``): the
    streamed and in-memory histories fall and agree within 5 %."""
    out = sctt.apply("model.scvi", sctt.CellData(counts.X), device="cpu",
                     **HYPER)
    inram = np.asarray(out.uns["scvi_elbo_history"])
    stream = port["history"]
    assert stream[-1] < stream[0] and inram[-1] < inram[0]
    assert (np.abs(stream - inram) / np.abs(inram)).max() < 0.05


# ------------------------------------------------------ within the port


def test_scheduled_reads_equal_plain_reads(store, port):
    m = MetricsRegistry()
    with ShardReadScheduler(store, metrics=m) as sched:
        got = T.fit_scvi_stream(store, scheduler=sched, metrics=m, **CPU)
    assert np.array_equal(got["history"], port["history"])
    assert _same_trees(got["params"], port["params"])
    c = m.snapshot_compact()
    assert c["train.shards"] == store.n_shards * HYPER["epochs"]
    assert c["ingest.reads{outcome=served}"] == store.n_shards * HYPER[
        "epochs"]
    with ShardReadScheduler(store) as sched:
        again = T.fit_scvi_stream(store.directory, scheduler=sched,
                                  prefetch=False, **CPU)
    assert np.array_equal(again["history"], port["history"])


def test_preempt_resume_is_bitwise_and_journals_as_the_reference(
        store, ref_store, port, tmp_path):
    """The reference's ``test_preempt_resume_bitwise`` in both packages:
    the port's resumed run is bit for bit its uninterrupted one, and its
    cursor, counters and journal equal the reference's (times, losses
    and digests aside)."""
    runs = {}
    for name, fit, st, tok, exc, reg, kw in (
            ("port", T.fit_scvi_stream, store, PreemptToken, JobPreempted,
             MetricsRegistry, CPU),
            ("ref", R.fit_scvi_stream, ref_store, RefToken, RefPreempted,
             RefRegistry, HYPER)):
        ck = str(tmp_path / f"{name}.npz")
        jp = str(tmp_path / f"{name}.jsonl")
        m = reg()
        with pytest.raises(exc) as ei:
            fit(st, checkpoint=ck, journal=jp, metrics=m,
                preempt=_preempt_at(3, tok), **kw)
        assert ei.value.reason == "priority"
        got = fit(st, checkpoint=ck, journal=jp, metrics=m, **kw)
        assert not os.path.exists(ck)
        runs[name] = (ei.value.cursor, got, m.snapshot_compact(),
                      _events(jp))
    cursor, got, counters, events = runs["port"]
    assert cursor == runs["ref"][0] == {"epoch": 0, "pos": 3, "step": 6}
    assert got["resumed_from"] == runs["ref"][1]["resumed_from"]
    assert np.array_equal(got["history"], port["history"])
    assert _same_trees(got["params"], port["params"])
    timed = ("train.overlap_s", "train.stall_s")
    assert sorted(counters) == sorted(runs["ref"][2])
    assert {k: v for k, v in counters.items() if k not in timed} == {
        k: v for k, v in runs["ref"][2].items() if k not in timed}
    assert counters["train.resumes"] == 1
    assert counters["train.preemptions{reason=priority}"] == 1

    def shape(evs):
        return [(e["event"], sorted(set(e) - {"ts", "loss", "checkpoint"}),
                 tuple(e.get(k) for k in ("epoch", "pos", "step", "shard",
                                          "steps", "reason")))
                for e in evs]

    assert shape(events) == shape(runs["ref"][3])
    pairs = [(e["epoch"], e["pos"]) for e in events
             if e["event"] == "train_shard"]
    assert len(pairs) == len(set(pairs)) == store.n_shards * HYPER["epochs"]


def test_cursor_mismatch_and_other_stores_raise(store, tmp_path):
    ck = str(tmp_path / "cursor.npz")
    with pytest.raises(JobPreempted):
        T.fit_scvi_stream(store, checkpoint=ck,
                          preempt=_preempt_at(2, PreemptToken), **CPU)
    with pytest.raises(ValueError, match="different arguments"):
        T.fit_scvi_stream(store, checkpoint=ck, **dict(CPU, batch_size=64))
    assert os.path.exists(ck)  # wrong, not corrupt: never quarantined
    other = write_store(
        synthetic_counts(1024, 64, density=0.2, seed=9).X,
        str(tmp_path / "other"), shard_rows=256, chunk_rows=64)
    with pytest.raises(ValueError, match="different store"):
        T.fit_scvi_stream(other, checkpoint=ck, **CPU)
    with pytest.raises(ValueError, match="different store"):
        T.fit_scvi_stream(store, scheduler=ShardReadScheduler(other), **CPU)
    with pytest.raises(ValueError, match="skip"):
        T.fit_scvi_stream(store, scheduler=ShardReadScheduler(
            store, on_corrupt="skip"), **CPU)


def test_preempt_without_checkpoint_warns(store):
    tok = PreemptToken()
    tok.request("preempt")
    with pytest.warns(RuntimeWarning, match="without a checkpoint"):
        with pytest.raises(JobPreempted):
            T.fit_scvi_stream(store, preempt=tok, **CPU)


def test_scvi_stream_op_uns_keys_equal_the_references(store, tmp_path):
    carrier = synthetic_counts(8, 8, density=0.3, seed=1)
    kw = dict(HYPER, store_dir=store.directory, encode=True)
    want = sct.apply("model.scvi_stream", carrier, backend="cpu",
                     params_out=str(tmp_path / "ref.npz"), **kw)
    got = sctt.apply("model.scvi_stream", sctt.CellData(carrier.X),
                     device="cpu", params_out=str(tmp_path / "port.npz"),
                     **kw)
    assert sorted(got.uns) == sorted(want.uns)
    hist = np.asarray(got.uns["scvi_stream_elbo_history"])
    assert hist.shape == (2,) and hist[-1] < hist[0]
    assert int(got.uns["scvi_stream_epochs"]) == 2
    lat = np.asarray(got.uns["scvi_stream_latent"])
    assert lat.shape == (store.n_cells, 4) and np.isfinite(lat).all()
    # the artifact is the run's model, in the reference's format
    tree, meta = RS.load_model(str(tmp_path / "port.npz"))
    model = P.SCVIModel.from_tree(jax.tree_util.tree_map(np.asarray, tree))
    with torch.no_grad():
        z = P.encode(model, torch.from_numpy(store.read_shard(0).to_dense()
                                             .numpy()), torch.zeros((256, 0)))
    np.testing.assert_array_equal(z.numpy(), lat[:256])
    assert int(meta["epochs"]) == 2


def test_op_defaults_to_the_card_and_raises_without_one(store):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: None resolves to it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sctt.apply("model.scvi_stream", sctt.CellData(np.zeros((2, 2))),
                   store_dir=store.directory)


class _Raising:
    """A journal whose write of ``event`` raises."""

    def __init__(self, path, event):
        from sctools_tpu_torch.runner import _Journal

        self.inner, self.event = _Journal(path), event

    def write(self, event, **fields):
        self.inner.write(event, **fields)
        if event == self.event:
            raise OSError("journal disk full")


@pytest.mark.parametrize("end", ["completion", "preemption", "raise"])
def test_feed_reservation_is_released_on_every_exit(store, tmp_path, end):
    jp = str(tmp_path / "journal.jsonl")
    budget = MemoryBudget(10 ** 9)
    kw = dict(CPU, checkpoint=str(tmp_path / "ck.npz"))
    if end == "completion":
        T.fit_scvi_stream(store, journal=jp, mem_budget=budget, **kw)
    elif end == "preemption":
        with budget_scope(budget), pytest.raises(JobPreempted):
            T.fit_scvi_stream(store, journal=jp,
                              preempt=_preempt_at(1, PreemptToken), **kw)
    else:
        with pytest.raises(OSError, match="disk full"):
            T.fit_scvi_stream(store, journal=_Raising(jp, "train_epoch"),
                              mem_budget=budget, **kw)
    assert budget.reserved_bytes() == 0 and budget.holders() == {}
    feed = 3 * store.shard_rows * store.n_genes * 4
    assert budget.peak_reserved_bytes == feed
    kinds = [e["event"] for e in _events(jp)]
    assert kinds.count("mem_reserved") == kinds.count("mem_released") == 1
    assert kinds.index("mem_reserved") < kinds.index("mem_released")


def test_generation_zero_is_saved_before_the_first_read(store, tmp_path):
    """A run that fails at its first shard leaves a verified cursor at
    (0, 0) that a new run resumes from."""
    ck = str(tmp_path / "ck.npz")
    jp = str(tmp_path / "j.jsonl")
    with pytest.raises(OSError):
        T.fit_scvi_stream(store, checkpoint=ck,
                          journal=_Raising(jp, "train_shard"), **CPU)
    kinds = [e["event"] for e in _events(jp)]
    assert kinds[:2] == ["train_checkpoint", "train_checkpoint"]
    got = T.fit_scvi_stream(store, checkpoint=ck, **CPU)
    assert got["resumed_from"] == {"epoch": 0, "pos": 1, "step": 2}
    assert not os.path.exists(ck)
