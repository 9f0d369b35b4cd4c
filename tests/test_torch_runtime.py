"""The port's runtime (`runtime/`), mirroring the local tests of
`tests/test_runtime.py`: worker groups, the session, env injection, the
init hook, the driver-side trampoline, fail-fast on a worker error or
death, shutdown, ship-once, the hello handshake, the standard-pickle
rule, and `launch` joining its workers in one gloo process group.

Workers run jobs from `tests/torch_jobs.py`, which imports no JAX; the
jobs of these tests import no torch either, so a worker starts in a
fraction of a second. Every run passes its own ``timeout=``.
"""
from __future__ import annotations

import functools
import os
import subprocess
import sys
import time

import pytest

from ray_lightning_tpu_torch.runtime import (
    LoopbackTransport,
    SSHTransport,
    Transport,
    WorkerError,
    WorkerGroup,
    launch,
    run_distributed,
)
from ray_lightning_tpu_torch.runtime import group as group_mod
from tests import torch_jobs

T = 60  # seconds any one run may take before the test fails


@pytest.fixture
def group(tmp_path):
    g = WorkerGroup(num_workers=2, env={"RLT_TEST_ENV": "injected"},
                    log_dir=str(tmp_path / "logs"), start_timeout=T)
    g.start()
    yield g
    # a worker still in a job (sleeping) is killed after a short grace
    g.shutdown(timeout=1.0)


def test_group_run_and_session(group):
    assert group.run(torch_jobs.rank_and_world, timeout=T) == [(0, 2), (1, 2)]


def test_env_injection_and_node_ip(group):
    assert group.run(torch_jobs.read_env, shared_args=("RLT_TEST_ENV",),
                     timeout=T) == ["injected", "injected"]
    group.set_env_vars({"RLT_LATER": "yes"})
    assert group.run(torch_jobs.read_env, shared_args=("RLT_LATER",),
                     timeout=T) == ["yes", "yes"]
    assert all(ex.get_node_ip() == "127.0.0.1" for ex in group.executors)
    assert group.run_single(1, torch_jobs.rank_and_world, timeout=T) == (1, 2)


def test_init_hook_runs_on_every_worker(tmp_path):
    marker = str(tmp_path / "hook.txt")
    g = WorkerGroup(num_workers=2, log_dir=str(tmp_path / "logs"),
                    init_hook=functools.partial(torch_jobs.write_marker,
                                                marker, "hook"))
    try:
        g.start()
        pids = g.run(torch_jobs.my_pid, timeout=T)
    finally:
        g.shutdown()
    with open(marker) as f:
        hook_pids = sorted(int(line.split()[1]) for line in f)
    assert hook_pids == sorted(pids)


def test_queue_trampoline_executes_callables_driver_side(group, tmp_path):
    marker = str(tmp_path / "trampoline.txt")
    pids = group.run(torch_jobs.queue_marker, shared_args=(marker,),
                     timeout=T)
    with open(marker) as f:
        lines = sorted(f.read().split("\n")[:-1])
    # each rank's callable ran HERE, in the driver
    assert lines == [f"rank0 {os.getpid()}", f"rank1 {os.getpid()}"]
    items = sorted(group.queue_items())
    assert items == [(0, {"rank": 0, "pid": pids[0]}),
                     (1, {"rank": 1, "pid": pids[1]})]
    # with on_queue_item, every item goes to it
    seen = []
    group.run(torch_jobs.queue_marker, shared_args=(marker,), timeout=T,
              on_queue_item=lambda rank, item: seen.append(rank))
    assert sorted(seen) == [0, 0, 1, 1]


def test_worker_error_fails_fast(group):
    t0 = time.monotonic()
    with pytest.raises(WorkerError, match="boom from rank 1") as info:
        group.run(torch_jobs.fail_on, shared_args=(1,), timeout=T)
    assert time.monotonic() - t0 < 20  # rank 0 sleeps 30 s
    assert info.value.rank == 1 and info.value.cause == "exception"


def test_run_timeout_raises(group):
    with pytest.raises(TimeoutError, match="still pending"):
        group.run(torch_jobs.sleep_for, shared_args=(30,), timeout=1)


def test_shutdown_kills_processes(tmp_path):
    g = WorkerGroup(num_workers=2, log_dir=str(tmp_path / "logs")).start()
    procs = [ex.proc for ex in g.executors]
    assert all(p.poll() is None for p in procs)
    g.shutdown()
    assert all(p.poll() is not None for p in procs)
    # a worker stuck in a job is killed after the grace window
    g = WorkerGroup(num_workers=1, log_dir=str(tmp_path / "logs")).start()
    g.executors[0].execute_async(torch_jobs.sleep_for, 60)
    t0 = time.monotonic()
    proc = g.executors[0].proc
    g.shutdown(timeout=1.0)
    assert proc.poll() is not None and time.monotonic() - t0 < 10


def test_dead_worker_fails_fast(tmp_path):
    """A worker that dies mid-job is reported with its signal."""
    g = WorkerGroup(num_workers=2, log_dir=str(tmp_path / "logs")).start()
    try:
        g.executors[1].proc.kill()
        t0 = time.monotonic()
        with pytest.raises(WorkerError, match="SIGKILL") as info:
            g.run(torch_jobs.sleep_for, shared_args=(5,), timeout=T)
        assert info.value.cause == "signal"
        assert time.monotonic() - t0 < 5
    finally:
        g.shutdown(timeout=1.0)


def test_eof_waits_for_a_slow_death(tmp_path):
    """A worker whose channel closed but whose process dies seconds
    later (a SIGKILL'd process still tearing down a CUDA context) is
    classified by its signal, not reported as still running."""
    proc = subprocess.Popen([sys.executable, "-c",
                             "import os, time; time.sleep(3); "
                             "os.kill(os.getpid(), 9)"])

    class _Executor:
        rank = 0

        def log_tail(self):
            return ""

    ex = _Executor()
    ex.proc = proc
    err = WorkerGroup(1, log_dir=str(tmp_path))._eof_error(ex)
    assert (err.cause, err.signal_name) == ("signal", "SIGKILL")


def test_ship_once_serializes_job_once(group, monkeypatch):
    calls = []
    real = group_mod.dumps_by_reference

    def counting(obj, what):
        calls.append(what)
        return real(obj, what)

    monkeypatch.setattr(group_mod, "dumps_by_reference", counting)
    assert group.run(torch_jobs.read_env, shared_args=("RLT_TEST_ENV",),
                     timeout=T) == ["injected"] * 2
    assert sum(w.startswith("job") for w in calls) == 1  # not once a rank
    sent = []
    real_exec = group_mod.TpuExecutor.execute_shared

    def recording(self, digest, blob, extra):
        sent.append(blob)
        return real_exec(self, digest, blob, extra)

    monkeypatch.setattr(group_mod.TpuExecutor, "execute_shared", recording)
    group.run(torch_jobs.read_env, shared_args=("RLT_TEST_ENV",), timeout=T)
    assert sent == [None, None]  # cached by digest on both workers


class _ExitTransport(Transport):
    """Spawns a process that exits before its hello."""

    def spawn(self, *, host, connect, env, authkey_hex, log_path):
        with open(log_path, "w") as logf:
            return subprocess.Popen(
                [sys.executable, "-c",
                 "import sys; print('bootstrap failed'); sys.exit(3)"],
                stdout=logf, stderr=subprocess.STDOUT)


class _BadHelloTransport(Transport):
    """Spawns a process that authenticates, then sends ``message``."""

    def __init__(self, message):
        self.message = message

    def spawn(self, *, host, connect, env, authkey_hex, log_path):
        code = (
            "import sys, time\n"
            "from multiprocessing.connection import Client\n"
            f"c = Client(({connect[0]!r}, {connect[1]}), "
            f"authkey=bytes.fromhex({authkey_hex!r}))\n"
            f"c.send({self.message!r})\n"
            "time.sleep(30)\n")
        with open(log_path, "w") as logf:
            return subprocess.Popen([sys.executable, "-c", code],
                                    stdout=logf, stderr=subprocess.STDOUT)


def test_dead_worker_aborts_the_start(tmp_path):
    t0 = time.monotonic()
    g = WorkerGroup(num_workers=2, log_dir=str(tmp_path / "logs"),
                    transport=_ExitTransport(), start_timeout=T)
    with pytest.raises(WorkerError, match="exited rc=3") as info:
        g.start()
    assert "bootstrap failed" in info.value.log_tail
    assert time.monotonic() - t0 < 10


@pytest.mark.parametrize("message,match", [
    (("hi", 0, {}), "unexpected first message"),
    (("hello", 7, {}), "invalid rank"),
])
def test_bad_hello_aborts_the_start(tmp_path, message, match):
    g = WorkerGroup(num_workers=1, log_dir=str(tmp_path / "logs"),
                    transport=_BadHelloTransport(message), start_timeout=T)
    with pytest.raises(WorkerError, match=match):
        g.start()


def test_unpicklable_jobs_raise(group, tmp_path):
    with pytest.raises(TypeError, match="by reference"):
        group.run(lambda: 1, timeout=T)
    with pytest.raises(TypeError, match="by reference"):
        run_distributed("fit", lambda: None, torch_jobs.trainer,
                        torch_jobs.llama_data, 1, device="cpu", timeout=T,
                        log_dir=str(tmp_path / "logs"))
    # the group is still usable
    assert group.run(torch_jobs.rank_and_world, timeout=T)[0] == (0, 2)


def test_launch_joins_a_gloo_process_group(tmp_path):
    out = launch(torch_jobs.all_reduce_rank, 2, device="cpu", timeout=T,
                 log_dir=str(tmp_path / "logs"))
    assert out == [(0, 2, 1.0), (1, 2, 1.0)]


def test_unported_runtime_parts_raise(tmp_path):
    """What raised before the cross-host transports came, and what still
    raises: the transports construct now (their remote semantics are
    `test_remote_transport_two_hosts`'s), ``hosts=`` still needs a remote
    transport, and `ResilienceConfig`'s knobs are all ported (``elastic``
    with item 12: a budget the supervisor keeps, whose ladder answers
    here with no worker started)."""
    ssh = SSHTransport()
    assert ssh.is_remote and ssh._command("h") == [
        "ssh", "-o", "BatchMode=yes", "h", "--", "python3", "-u", "-"]
    loop = LoopbackTransport()
    assert loop.is_remote and loop.allows_loopback and loop.spawned == []
    with pytest.raises(ValueError, match="remote transport"):
        WorkerGroup(hosts=["a", "b"])
    from ray_lightning_tpu_torch.elastic import ElasticBudget
    from ray_lightning_tpu_torch.resilience import ResilienceConfig
    from ray_lightning_tpu_torch.resilience.supervisor import (
        _elastic_decision,
    )

    budget = ElasticBudget(min_world=1, capacity_fn=lambda: 1)
    assert ResilienceConfig(str(tmp_path), elastic=budget).elastic is budget
    # a refused same-size relaunch of 2 shrinks to the one world left
    assert _elastic_decision(budget, 2, 2, False, 0) == (1, None)
    cfg = ResilienceConfig(str(tmp_path), compile_cache_dir="x")
    assert cfg.resolved_compile_cache_dir() == "x"
    with pytest.raises(ValueError, match="kind"):
        run_distributed("train", torch_jobs.llama_module,
                        torch_jobs.trainer, torch_jobs.llama_data, 1)


# ---- the cross-host runtime (twins of tests/test_runtime.py) -----------------


def test_remote_transport_two_hosts(tmp_path):
    """LoopbackTransport runs the whole remote protocol (stdin bootstrap,
    scrubbed environment, routable listener) with the ssh prefix
    removed: ranks placed one a host, the explicit env travels, the
    driver's does not leak in."""
    transport = LoopbackTransport()
    os.environ["RLT_DRIVER_ONLY"] = "should-not-leak"
    try:
        group = WorkerGroup(hosts=["host-a", "host-b"], transport=transport,
                            env={"RLT_EXPLICIT": "42"},
                            log_dir=str(tmp_path), start_timeout=T)
        with group as g:
            assert g.is_remote and g.num_workers == 2
            assert g.run(torch_jobs.rank_and_world, timeout=T) == [
                (0, 2), (1, 2)]
            assert [ex.host for ex in g.executors] == ["host-a", "host-b"]
            assert g.run(torch_jobs.read_env, shared_args=("RLT_EXPLICIT",),
                         timeout=T) == ["42", "42"]
            assert g.run(torch_jobs.read_env,
                         shared_args=("RLT_DRIVER_ONLY",), timeout=T) == [
                None, None]
            assert g.run_single(1, torch_jobs.rank_and_world,
                                timeout=T) == (1, 2)
    finally:
        os.environ.pop("RLT_DRIVER_ONLY", None)
    assert transport.spawned == [("host-a", 0), ("host-b", 1)]


def test_per_host_env_overrides(tmp_path):
    """``host_env`` goes over the launch env for that host's workers; its
    RLT_NODE_IP is the address that worker advertises."""
    transport = LoopbackTransport(host_env={
        "host-b": {"RLT_TEST_HOSTENV": "b-only", "RLT_NODE_IP": "10.99.0.2"},
    })
    with WorkerGroup(hosts=["host-a", "host-b"], transport=transport,
                     env={"RLT_TEST_HOSTENV": "default"},
                     log_dir=str(tmp_path), start_timeout=T) as g:
        assert g.run(torch_jobs.read_env, shared_args=("RLT_TEST_HOSTENV",),
                     timeout=T) == ["default", "b-only"]
        assert g.executors[1].get_node_ip() == "10.99.0.2"
        assert g.executors[0].get_node_ip() != "10.99.0.2"


def test_unmatched_host_env_key_warns(tmp_path, monkeypatch):
    """A host_env key that matches no host is named in a warning (a
    typo'd RLT_NODE_IP override would otherwise vanish)."""
    warnings = []
    monkeypatch.setattr(
        group_mod.log, "warning",
        lambda msg, *args, **kw: warnings.append(msg % args if args
                                                 else msg))
    transport = LoopbackTransport(host_env={
        "user@host-b": {"RLT_NODE_IP": "10.99.0.2"}})
    with WorkerGroup(hosts=["host-a", "host-b"], transport=transport,
                     log_dir=str(tmp_path), start_timeout=T) as g:
        g.run(torch_jobs.my_pid, timeout=T)
    assert any("user@host-b" in w for w in warnings)


def test_ssh_transport_command_and_bootstrap():
    """The argv SSHTransport would run (no ssh binary needed) and the
    self-contained program it pipes over stdin, equal to the JAX one's
    but for the worker source it carries."""
    from ray_lightning_tpu.runtime.transport import (
        _bootstrap_source as jax_bootstrap,
    )
    from ray_lightning_tpu_torch.runtime.transport import (
        _WORKER_PATH,
        _bootstrap_source,
    )

    t = SSHTransport(ssh=("ssh", "-p", "2222"), remote_python="python3.12",
                     pythonpath=("/opt/rlt",), env={"A": "1"})
    assert t._command("10.0.0.7") == [
        "ssh", "-p", "2222", "10.0.0.7", "--", "python3.12", "-u", "-"]
    with pytest.raises(ValueError, match="host"):
        t._command(None)
    args = (("192.168.1.1", 5555, 3, 8), {"A": "1", "B": "x y"},
            "deadbeef", ["/opt/rlt"])
    src = _bootstrap_source(*args)
    compile(src, "<bootstrap>", "exec")
    assert "'RLT_WORKER_AUTHKEY': 'deadbeef'" in src
    assert "'B': 'x y'" in src and "'/opt/rlt'" in src
    assert "'192.168.1.1', '5555', '3', '8'" in src
    with open(_WORKER_PATH) as f:
        worker = f.read()
    assert src.endswith(worker) and '__name__ == "__main__"' in worker
    jsrc = jax_bootstrap(*args)
    assert src[:-len(worker)] == jsrc[:jsrc.index("\"\"\"Worker process")]


def test_remote_transport_failure_propagates(tmp_path):
    with WorkerGroup(hosts=["host-a", "host-b"],
                     transport=LoopbackTransport(), log_dir=str(tmp_path),
                     start_timeout=T) as g:
        with pytest.raises(WorkerError, match="boom from rank 1") as info:
            g.run(torch_jobs.fail_on, shared_args=(1,), timeout=T)
        assert info.value.rank == 1


def test_launch_over_a_remote_transport(tmp_path):
    """Two 'hosts' joined in one gloo process group whose rendezvous is
    worker 0's advertised address and a port probed on its host; each
    worker is local rank 0 of its host."""
    out = launch(torch_jobs.all_reduce_rank, 2, device="cpu", timeout=T,
                 hosts=["host-a", "host-b"], transport=LoopbackTransport(),
                 log_dir=str(tmp_path))
    assert out == [(0, 2, 1.0), (1, 2, 1.0)]
    from ray_lightning_tpu_torch.runtime.launch import local_ranks

    assert local_ranks(2, ["a", "b"]) == [(0, 1), (0, 1)]
    assert local_ranks(5, ["a", "b"]) == [(0, 3), (0, 2), (1, 3), (1, 2),
                                          (2, 3)]
    assert local_ranks(3, None) == [(0, 3), (1, 3), (2, 3)]


def test_fit_distributed_over_loopback_equals_the_local_fit(tmp_path):
    """A two-process gloo `fit_distributed` of the tiny Llama over two
    LoopbackTransport 'hosts' ends bitwise where the local one does."""
    toks = torch_jobs.tokens(8, 12, seed=4)
    kw = dict(device="cpu", timeout=T)
    job = (functools.partial(torch_jobs.llama_module, None),
           functools.partial(torch_jobs.trainer, "ddp"),
           functools.partial(torch_jobs.llama_data, toks))
    local = run_distributed("fit", *job, 2, log_dir=str(tmp_path / "a"),
                            **kw)
    remote = run_distributed("fit", *job, 2, log_dir=str(tmp_path / "b"),
                             hosts=["host-a", "host-b"],
                             transport=LoopbackTransport(), **kw)
    assert remote.metrics["loss"] == local.metrics["loss"]
    assert set(remote.state_dict) == set(local.state_dict)
    for k, v in local.state_dict.items():
        assert remote.state_dict[k].equal(v), k


def test_node_ip_env_override(monkeypatch):
    """RLT_NODE_IP pins the advertised address; without it the default
    route's interface address (never a socket to another machine)."""
    from ray_lightning_tpu.runtime.group import routable_ip as jax_ip
    from ray_lightning_tpu_torch.runtime.group import routable_ip

    monkeypatch.setenv("RLT_NODE_IP", "10.9.8.7")
    assert routable_ip() == jax_ip() == "10.9.8.7"
    monkeypatch.delenv("RLT_NODE_IP")
    ip = routable_ip()
    assert ip == "127.0.0.1" or group_mod._default_route_iface() is not None
    import socket

    socket.inet_aton(ip)


def test_remote_without_routable_address_fails_fast(tmp_path, monkeypatch):
    """A remote transport whose workers live elsewhere, on a machine with
    no routable address: fail in seconds naming the fix, before any
    spawn; ``advertise_host`` unblocks it."""

    class _DeadRemote(Transport):
        is_remote = True

        def spawn(self, **kw):  # must never be reached
            raise AssertionError("spawn before address validation")

    monkeypatch.setattr(group_mod, "routable_ip", lambda: "127.0.0.1")
    g = WorkerGroup(2, hosts=["host-a", "host-b"], transport=_DeadRemote(),
                    log_dir=str(tmp_path))
    with pytest.raises(RuntimeError, match="advertise_host"):
        g.start()
    g2 = WorkerGroup(2, hosts=["host-a", "host-b"], transport=_DeadRemote(),
                     advertise_host="127.0.0.1", log_dir=str(tmp_path))
    with pytest.raises(AssertionError, match="spawn"):
        g2.start()


def test_survivor_error_after_a_death_reports_the_death(tmp_path):
    """Rank 0 dies with an item still queued ahead of its EOF while rank
    1's error (a collective's echo of the death) is ready too: the pump
    reports rank 0's SIGKILL, the cause, not rank 1's error."""
    received = []

    def on_item(rank, item):
        received.append((rank, item))
        if callable(item):
            item()  # the pump is busy here while the rest piles up

    g = WorkerGroup(num_workers=2, log_dir=str(tmp_path / "logs"),
                    start_timeout=T).start()
    try:
        with pytest.raises(WorkerError, match="SIGKILL") as info:
            g.run(torch_jobs.die_behind_queue, shared_args=(1.5, 0.3),
                  on_queue_item=on_item, timeout=T)
        assert info.value.rank == 0 and info.value.cause == "signal"
        assert [r for r, _ in received] == [0, 0]
        assert received[1][1] == "last words"
    finally:
        g.shutdown(timeout=1.0)


def test_rendezvous_is_rank_zeros_own_bind(tmp_path, monkeypatch):
    """Rank 0 opens the rendezvous store on a port its own bind picks,
    before the job; the driver probes no port (a port probed free and
    bound later can be taken in between: EADDRINUSE, a FATAL failure)."""
    from ray_lightning_tpu_torch.utils import dist as dist_utils

    def no_probe(*a, **k):
        raise AssertionError("the driver probed a port")

    monkeypatch.setattr(dist_utils, "find_free_port", no_probe)
    out = launch(torch_jobs.rendezvous_seen, 2, device="cpu", timeout=T,
                 log_dir=str(tmp_path))
    (r0, addr0, port0, bound), (r1, addr1, port1, none) = out
    assert (r0, r1) == (0, 1) and none is None
    assert addr0 == addr1 == "127.0.0.1" and port0 == port1 == bound > 0
