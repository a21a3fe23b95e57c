"""The port's pieces of the reference's fault domains against the
reference's, on the same inputs: the memory budget
(``sctools_tpu_torch/memory.py``), cooperative preemption
(``utils/failsafe.py``), the metrics registry (``utils/telemetry.py``),
the IO fault injector (``utils/chaos.py``) and the run journal and retry
policy (``runner.py``)."""

import json
import random
import threading

import pytest
import torch

from sctools_tpu import memory as ref_memory
from sctools_tpu import runner as ref_runner
from sctools_tpu.utils import chaos as ref_chaos
from sctools_tpu.utils import failsafe as ref_failsafe
from sctools_tpu.utils import telemetry as ref_telemetry
from sctools_tpu_torch import memory, runner
from sctools_tpu_torch.utils import chaos, failsafe, telemetry

# ------------------------------------------------------------- memory


def _ledger_ops(mod):
    """One sequence of reservations, pressure and releases; the
    snapshots after each."""
    reg = (telemetry if mod is memory else ref_telemetry).MetricsRegistry()
    b = mod.MemoryBudget(1000, name="dev", metrics=reg)
    out = []

    def look():
        out.append((b.snapshot(), b.available_bytes(), b.admissible_bytes(),
                    b.fits(300), b.fits(301), b.reserved_bytes(),
                    b.standing_bytes(), b.holders(), b.pressure))

    look()
    b.reserve("run:a", 400, tenant="t1")
    look()
    b.reserve("serve:model", 300, standing=True)
    look()
    b.reserve("run:a", 250)  # the same name replaces its amount
    look()
    b.set_pressure(0.6)
    look()
    b.set_pressure(7.0)  # clamped to 1
    look()
    b.release("run:a")
    b.release("run:a")  # idempotent
    look()
    b.clear_pressure()
    b.reserve("neg", -5)  # floored at 0
    look()
    out.append(reg.snapshot()["gauges"])
    return out


def test_memory_budget_arithmetic_matches_the_reference():
    assert _ledger_ops(memory) == _ledger_ops(ref_memory)
    with pytest.raises(ValueError, match="capacity must be >= 1"):
        memory.MemoryBudget(0)


def test_detect_budget_reads_the_cap_then_the_card(monkeypatch):
    monkeypatch.setenv("SCTOOLS_MEM_BUDGET_BYTES", "12345")
    assert memory.detect_budget_bytes() == 12345
    assert memory.detect_budget_bytes() == ref_memory.detect_budget_bytes()
    assert memory.MemoryBudget().capacity_bytes == 12345
    monkeypatch.setenv("SCTOOLS_MEM_BUDGET_BYTES", "lots")
    with pytest.raises(ValueError, match="not an integer"):
        memory.detect_budget_bytes()
    monkeypatch.delenv("SCTOOLS_MEM_BUDGET_BYTES")
    assert memory.detect_budget_bytes("cpu") is None
    if not torch.cuda.is_available():
        assert memory.detect_budget_bytes() is None
        with pytest.raises(ValueError, match="no capacity"):
            memory.MemoryBudget()


def test_budget_scope_is_per_thread_and_nests():
    outer, inner = memory.MemoryBudget(10), memory.MemoryBudget(20)
    assert memory.current_budget() is None
    seen = []
    with memory.budget_scope(outer):
        with memory.budget_scope(inner) as b:
            assert b is inner and memory.current_budget() is inner
            t = threading.Thread(
                target=lambda: seen.append(memory.current_budget()))
            t.start()
            t.join()
        assert memory.current_budget() is outer
    assert memory.current_budget() is None and seen == [None]


# ---------------------------------------------------------- preemption


def _preempt_trace(fs):
    """Probe polls, scopes and reasons, as a list of observations."""
    out = []
    calls = [0]

    def probe():
        calls[0] += 1
        return "chaos" if calls[0] == 2 else None

    tok = fs.PreemptToken(probe=probe)
    out.append((fs.check_preempt(), fs.current_preempt()))
    with fs.preempt_scope(tok) as t:
        out.append(t is tok)
        out += [fs.check_preempt(), tok.requested(), fs.check_preempt(),
                tok.requested(), calls[0]]
        tok.request("cancelled")  # the first reason wins
        out.append(tok.pending())
        other = fs.PreemptToken()
        with fs.preempt_scope(other):
            out.append(fs.check_preempt())
            other.request()
            out.append(fs.check_preempt())
        box = []
        th = threading.Thread(target=lambda: box.append(fs.check_preempt()))
        th.start()
        th.join()
        out.append(box)
    out.append(fs.current_preempt())
    e = fs.JobPreempted("y", reason="priority", cursor={"epoch": 1})
    out += [e.reason, e.cursor, str(e), fs.JobPreempted("z").reason,
            fs.JobPreempted("z").cursor]
    return out


def test_preempt_tokens_and_scopes_match_the_reference():
    assert _preempt_trace(failsafe) == _preempt_trace(ref_failsafe)


# ----------------------------------------------------------- telemetry


def _record(tm):
    reg = tm.MetricsRegistry()
    reg.counter("train.steps").inc(16)
    reg.counter("train.preemptions", reason="priority").inc()
    reg.counter("ingest.reads", outcome="served").inc(3)
    reg.counter("ingest.reads", outcome="served").inc()
    reg.counter("x", b="2", a="1").inc(0.5)
    reg.gauge("train.loss", epoch=0).set(512.25)
    reg.gauge("mem.reserved_bytes").set(7)
    for v in (0.0004, 0.003, 0.7, 2.0, 301.0, 0.001):
        reg.histogram("ingest.read_wait_s").observe(v)
    reg.histogram("custom", buckets=(1, 2)).observe(1.5)
    with pytest.raises(ValueError, match="n >= 0"):
        reg.counter("train.steps").inc(-1)
    return reg.snapshot(), reg.snapshot_compact()


def test_telemetry_series_and_snapshots_match_the_reference():
    got, want = _record(telemetry), _record(ref_telemetry)
    assert got == want
    assert "train.preemptions{reason=priority}" in got[1]
    assert "x{a=1,b=2}" in got[1]
    for key in got[1]:
        assert telemetry.split_series_key(key) == \
            ref_telemetry.split_series_key(key)
    assert telemetry.split_series_key("x{a=1,b=2}") == ("x", {"a": "1",
                                                              "b": "2"})
    assert telemetry.default_registry() is telemetry.default_registry()
    assert telemetry.DURATION_BUCKETS == ref_telemetry.DURATION_BUCKETS
    with pytest.raises(ValueError, match="strictly increasing"):
        telemetry.Histogram((2, 1))


# ---------------------------------------------------------------- chaos


def test_fault_validation_and_unported_channels():
    with pytest.raises(ValueError, match="use one of"):
        chaos.Fault("x", "melt")
    with pytest.raises(ValueError, match="use one of"):
        ref_chaos.Fault("x", "melt")
    assert chaos.MODES == ref_chaos.MODES
    for mode in chaos.MODES:
        if chaos._MODE_CHANNEL.get(mode) == "io":
            chaos.Fault("chunk-*", mode)
        else:
            with pytest.raises(NotImplementedError, match="item 13"):
                chaos.Fault("op", mode)


def _io_trace(mod, path):
    monkey = mod.ChaosMonkey([
        mod.Fault("chunk-0000[12]", "io_error", on_call=2, times=2),
        mod.Fault("chunk-00003", "slow_read", times=-1, p=0.5),
        mod.Fault("chunk-00004", "truncate_shard")], seed=3, slow_s=4.0)
    rulings = []
    for _ in range(4):
        for c in range(6):
            rulings.append(monkey.on_io(f"chunk-{c:05d}", path))
    return rulings, monkey.calls, monkey.injected


def test_io_channel_fires_as_the_reference(tmp_path):
    a, b = tmp_path / "a.bin", tmp_path / "b.bin"
    a.write_bytes(b"x" * 100)
    b.write_bytes(b"x" * 100)
    got = _io_trace(chaos, str(a))
    assert got == _io_trace(ref_chaos, str(b))
    assert a.stat().st_size == 50  # truncate_shard halves the file
    assert sum(r is not None and r["mode"] == "io_error"
               for r in got[0]) == 4


# ---------------------------------------------------- journal and retry


def test_journal_lines_and_retry_delays_match_the_reference(tmp_path):
    pa, pb = str(tmp_path / "a" / "j.jsonl"), str(tmp_path / "b" / "j.jsonl")
    for mod, path in ((runner, pa), (ref_runner, pb)):
        j = mod._Journal(path, bound={"trace_id": "t1"})
        j.write("train_shard", epoch=0, pos=1, shard=2, loss=1.5, steps=3)
        j.write("preempted", reason="priority", epoch=0, pos=2, step=6)
    la = [json.loads(x) for x in open(pa)]
    lb = [json.loads(x) for x in open(pb)]
    for e in la + lb:
        assert isinstance(e.pop("ts"), float)
    assert la == lb and list(la[0]) == list(lb[0])
    runner._Journal(None).write("x")  # a journal without a path drops it
    assert runner.as_journal(None) is None
    j = runner.as_journal(pa)
    assert isinstance(j, runner._Journal) and runner.as_journal(j) is j
    for kw in ({}, dict(max_attempts=5, base_delay_s=0.05, max_delay_s=2.0),
               dict(jitter=0.0, multiplier=3.0)):
        pol, ref = runner.RetryPolicy(**kw), ref_runner.RetryPolicy(**kw)
        assert vars(pol) == vars(ref)
        r1, r2 = random.Random("s"), random.Random("s")
        assert [pol.delay_s(n, r1) for n in range(1, 9)] == \
            [ref.delay_s(n, r2) for n in range(1, 9)]
