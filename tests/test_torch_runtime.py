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
    with pytest.raises(NotImplementedError, match="Queue 1 item 14"):
        SSHTransport()
    with pytest.raises(NotImplementedError, match="Queue 1 item 14"):
        LoopbackTransport()
    with pytest.raises(NotImplementedError, match="Queue 1 item 14"):
        WorkerGroup(hosts=["a", "b"])
    # resilience is ported; its knobs that wait for later items raise
    from ray_lightning_tpu_torch.resilience import ResilienceConfig

    for knob, item in (("elastic", "Queue 1 item 12"),
                       ("compile_cache_dir", "Queue 1 item 7")):
        with pytest.raises(NotImplementedError, match=item):
            run_distributed("fit", torch_jobs.llama_module,
                            torch_jobs.trainer, torch_jobs.llama_data, 1,
                            resilience=ResilienceConfig(
                                str(tmp_path), **{knob: "x"}))
    with pytest.raises(ValueError, match="kind"):
        run_distributed("train", torch_jobs.llama_module,
                        torch_jobs.trainer, torch_jobs.llama_data, 1)
