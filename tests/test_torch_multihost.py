"""The port's multi-process bring-up on ``torch.distributed``
(``parallel/mesh.py``: ``init_distributed``, ``coordination_sum``,
``mesh_host_groups``, ``classify_bringup_error``), after the
reference's ``tests/test_multihost.py``.

Two fresh processes join one gloo group (``device="cpu"``) over a
``TCPStore`` on localhost, each sums its own rows and
``coordination_sum`` adds the two through the store: the reference's
112.0.  An all-reduce over the group shows the group itself works.  The
held-port refusal, the misconfiguration messages, the error
classification, the single-process no-op and ``SCTOOLS_MESH_HOSTS``
run as the reference's do.  Children get ``PYTHONPATH`` replaced (no
site customisation may load anything first) and a timeout of 120 s
each."""

import os
import socket
import subprocess
import sys
import textwrap

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHILD = textwrap.dedent("""
    import sys
    pid = int(sys.argv[1]); port = sys.argv[2]
    import torch
    import torch.distributed as dist
    from sctools_tpu_torch.parallel.mesh import (
        coordination_sum, init_distributed, make_mesh, mesh_host_groups)

    info = init_distributed(f"127.0.0.1:{port}", num_processes=2,
                            process_id=pid, attempts=3,
                            retry_delay_s=0.5, timeout_s=60,
                            device="cpu")
    assert info["num_processes"] == 2, info
    assert info["process_id"] == pid, info
    assert info["local_devices"] == 1, info
    assert info["global_devices"] == 2, info
    assert init_distributed(f"127.0.0.1:{port}", num_processes=2,
                            process_id=pid, device="cpu") == info

    # this process's rows (pid*4 .. pid*4+3), summed on its own device
    rows = (torch.arange(4, dtype=torch.float32) + 4 * pid)[:, None] \\
        * torch.ones((1, 4))
    local = float(rows.sum())
    assert local == (6.0 if pid == 0 else 22.0) * 4, local

    # across processes through the store's key-value API
    total = coordination_sum(local, "rowsum")
    assert total == 112.0, total  # sum(0..7) * 4, both sides
    try:
        coordination_sum(local, "rowsum")
    except ValueError as e:
        assert "used already" in str(e), e
    else:
        raise AssertionError("a reused tag was accepted")

    # the group itself: a gloo all-reduce gives the same total
    t = torch.tensor([local])
    dist.all_reduce(t)
    assert float(t) == 112.0, t
    assert len(mesh_host_groups(make_mesh(devices=["cpu"] * 4))) == 1
    dist.barrier()
    dist.destroy_process_group()
    print(f"OK pid={pid} global={info['global_devices']} sum={total}",
          flush=True)
""")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _child_env() -> dict:
    return {
        "PATH": os.environ.get("PATH", "/usr/bin:/bin"),
        "HOME": os.path.expanduser("~"),
        "PYTHONPATH": REPO,  # replaced, not appended
        "OMP_NUM_THREADS": "1",
    }


def test_init_distributed_two_processes(tmp_path):
    port = _free_port()
    script = tmp_path / "child.py"
    script.write_text(CHILD)
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(i), str(port)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=_child_env(), cwd=REPO) for i in range(2)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=120)
            outs.append(out)
    except subprocess.TimeoutExpired:
        pytest.fail("multi-process bring-up hung")
    finally:
        for q in procs:
            if q.poll() is None:
                q.kill()
                q.wait()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"child {i} failed:\n{out[-2000:]}"
        assert f"OK pid={i} global=2 sum=112.0" in out, out[-2000:]


def test_init_distributed_refuses_held_coordinator_port(tmp_path):
    """A coordinator port held by a live listener is refused after the
    bounded bind attempts, with advice, on the injected clock."""
    blocker = socket.socket()
    blocker.bind(("127.0.0.1", 0))
    blocker.listen(1)
    port = blocker.getsockname()[1]
    child = textwrap.dedent(f"""
        from sctools_tpu_torch.parallel.mesh import init_distributed
        from sctools_tpu_torch.utils.vclock import VirtualClock
        clock = VirtualClock()
        try:
            init_distributed("127.0.0.1:{port}", num_processes=1,
                             process_id=0, attempts=2,
                             retry_delay_s=0.01, clock=clock,
                             device="cpu")
        except RuntimeError as e:
            assert "still in use" in str(e), e
            assert "2 bind attempt" in str(e), e
            assert clock.sleeps == [0.01], clock.sleeps
            print("REFUSED", flush=True)
        else:
            print("NOT-REFUSED", flush=True)
    """)
    script = tmp_path / "held_port.py"
    script.write_text(child)
    try:
        p = subprocess.run([sys.executable, str(script)],
                           capture_output=True, text=True,
                           env=_child_env(), cwd=REPO, timeout=120)
    finally:
        blocker.close()
    assert p.returncode == 0, p.stdout[-2000:] + p.stderr[-2000:]
    assert "REFUSED" in p.stdout, p.stdout


def test_bringup_misconfig_is_actionable():
    from sctools_tpu_torch.parallel.mesh import init_distributed

    with pytest.raises(ValueError, match="out of range"):
        init_distributed("127.0.0.1:1234", num_processes=2, process_id=5,
                         device="cpu")
    with pytest.raises(ValueError, match="TOGETHER"):
        init_distributed("127.0.0.1:1234", num_processes=2, device="cpu")
    with pytest.raises(ValueError, match="host:port"):
        init_distributed("not-an-address", num_processes=2, process_id=0,
                         device="cpu")
    with pytest.raises(ValueError, match="attempts"):
        init_distributed("127.0.0.1:1234", num_processes=2, process_id=0,
                         attempts=0, device="cpu")


def test_bringup_error_classification():
    from sctools_tpu_torch.parallel.mesh import classify_bringup_error

    transient = [
        RuntimeError("DEADLINE_EXCEEDED: Barrier timed out"),
        RuntimeError("UNAVAILABLE: failed to connect to all addresses"),
        RuntimeError("Address already in use"),
        ConnectionRefusedError("connection refused"),
        RuntimeError("The server socket has failed to listen on any local "
                     "network address. port: 29500, useIpv6: 0, code: -98, "
                     "name: EADDRINUSE, message: address already in use"),
    ]
    for e in transient:
        assert classify_bringup_error(e) == "transient", e
    deterministic = [
        RuntimeError("invalid process id"),
        ValueError("Error initializing torch.distributed using env:// "
                   "rendezvous: environment variable RANK expected"),
    ]
    for e in deterministic:
        assert classify_bringup_error(e) == "deterministic", e


def test_init_distributed_single_process_noop(monkeypatch):
    """A bare call in one process reports one process and its devices;
    a repeat call gives the same; explicit arguments that cannot be
    joined raise; without a card the default device raises."""
    from sctools_tpu_torch.parallel.mesh import init_distributed

    for var in ("MASTER_ADDR", "TORCHELASTIC_RUN_ID", "WORLD_SIZE",
                "RANK"):
        monkeypatch.delenv(var, raising=False)
    info = init_distributed(device="cpu")
    assert info == {"process_id": 0, "num_processes": 1,
                     "local_devices": 1, "global_devices": 1}
    assert init_distributed(device="cpu") == info
    assert not torch.distributed.is_initialized()
    with pytest.raises((RuntimeError, ValueError)):
        init_distributed(num_processes=2, process_id=0, device="cpu")
    monkeypatch.setenv("MASTER_ADDR", "10.0.0.1")
    with pytest.raises(RuntimeError, match="launcher's environment"):
        init_distributed(device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            init_distributed()


def test_coordination_sum_without_a_group_is_the_value():
    from sctools_tpu_torch.parallel.mesh import coordination_sum

    assert coordination_sum(3.5, "alone") == 3.5


def test_mesh_host_groups_fake_split(monkeypatch):
    from sctools_tpu_torch.parallel.mesh import make_mesh, mesh_host_groups

    mesh = make_mesh(devices=["cpu"] * 8)
    monkeypatch.delenv("SCTOOLS_MESH_HOSTS", raising=False)
    assert [len(g) for g in mesh_host_groups(mesh)] == [8]
    monkeypatch.setenv("SCTOOLS_MESH_HOSTS", "2")
    groups = mesh_host_groups(mesh)
    assert [len(g) for g in groups] == [4, 4]
    assert groups[0] + groups[1] == list(mesh.devices)
    monkeypatch.setenv("SCTOOLS_MESH_HOSTS", "3")  # does not divide 8
    assert [len(g) for g in mesh_host_groups(mesh)] == [8]
    monkeypatch.setenv("SCTOOLS_MESH_HOSTS", "junk")
    assert [len(g) for g in mesh_host_groups(mesh)] == [8]
