"""Supervised runs of the port on the CPU (`resilience.supervise` over
two gloo processes, a small MLP classifier under DataParallel): the JAX
package's acceptance matrix (`tests/test_resilience.py`'s slow tests).
A SIGKILL'd worker (rank 1, or rank 0, the coordinator), a corrupted
latest checkpoint, a hang the watchdog catches: each run resumes and
ends BITWISE equal to the uninterrupted supervised run. SIGTERM drains
through an emergency checkpoint; a fatal error fails fast with its
classified cause. The jobs live in `tests/torch_jobs.py` (workers import
it by name).
"""
from __future__ import annotations

import functools
import json
import os
import time

import pytest
import torch

from ray_lightning_tpu_torch.checkpoint import verify_checkpoint
from ray_lightning_tpu_torch.resilience import (
    ResilienceConfig,
    RetryPolicy,
    fit_supervised,
)
from ray_lightning_tpu_torch.resilience.policy import FailureKind, StallError
from ray_lightning_tpu_torch.resilience.supervisor import SupervisedFailure
from ray_lightning_tpu_torch.runtime.fit import FitResult, fit_distributed
from ray_lightning_tpu_torch.runtime.group import WorkerError, WorkerGroup
from ray_lightning_tpu_torch.telemetry import (
    TelemetryConfig,
    buckets_consistent,
)
from tests import torch_jobs


def _cfg(root, name, faults=None, stall=0.0, save_every=1):
    return ResilienceConfig(
        checkpoint_dir=str(root / name),
        policy=RetryPolicy(max_restarts=2, backoff_base_s=0.2, jitter=0.0),
        save_every_n_steps=save_every, heartbeat_interval_s=1.0,
        stall_timeout_s=stall, faults=faults)


def _run(root, name, faults=None, stall=0.0, save_every=1,
         trainer=torch_jobs.sup_trainer):
    """One supervised fit; returns it and where each attempt started
    (rank 0's global step and pid at fit start)."""
    starts = []
    sup = fit_supervised(
        torch_jobs.sup_module, trainer, torch_jobs.sup_data,
        2, resilience=_cfg(root, name, faults, stall, save_every),
        device="cpu",
        timeout=120, log_dir=str(root / f"logs_{name}"),
        on_queue_item=lambda rank, item: starts.append(item[1:]))
    return sup, starts


def _same_weights(a, b):
    assert set(a.result.state_dict) == set(b.result.state_dict)
    for k, v in a.result.state_dict.items():
        assert torch.equal(v, b.result.state_dict[k]), k


def _goodput(sup, ledgers=None):
    """The assembled goodput (telemetry is on by default): its buckets
    sum to the supervised wall within 5%, with one attempt for each
    rank-0 ledger (``ledgers`` of them when given: a SIGKILL'd rank 0
    leaves none for its attempt unless its flush cadence came first)."""
    report = sup.goodput
    assert report is not None and buckets_consistent(report, 0.05)
    assert abs(report["buckets_sum_s"] - report["wall_s"]) < 1e-3
    assert report["ledgers"] == len(report["attempts"]) >= 1
    if ledgers is not None:
        assert report["ledgers"] == ledgers
    assert report["events"]["restarts"] == sup.restarts
    assert report["buckets"]["launch_s"] > 0
    return report


def _dead(pid):
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return True
    return False


@pytest.fixture(scope="module")
def base(tmp_path_factory):
    sup, starts = _run(tmp_path_factory.mktemp("base"), "base")
    assert sup.total_attempts == 1 and [s[0] for s in starts] == [0]
    report = _goodput(sup, 1)
    assert report["buckets"]["backoff_s"] == 0
    assert report["buckets"]["rollback_replay_s"] == 0
    return sup


@pytest.mark.parametrize("victim", [1, 0])  # 0: the coordinator rank
def test_supervise_worker_kill_autoresumes(tmp_path, base, victim):
    """A worker SIGKILL'd at step 2: the supervisor relaunches from the
    step-2 checkpoint and the final weights equal the uninterrupted
    run's bitwise; no worker outlives its attempt."""
    sup, starts = _run(tmp_path, f"kill{victim}", f"kill:rank={victim},step=2")
    assert sup.total_attempts == 2 and sup.restarts == 1
    [failure] = sup.failures
    assert failure["kind"] == "retryable"
    assert "SIGKILL" in failure["cause"] and failure["rank"] == victim
    assert [s[0] for s in starts] == [0, 2]
    assert all(_dead(pid) for _, pid in starts)
    _same_weights(base, sup)
    assert _goodput(sup)["buckets"]["backoff_s"] == pytest.approx(0.2)


def test_fit_distributed_resilience_returns_the_fit_result(tmp_path, base):
    """`fit_distributed(resilience=)` is the supervised fit: a FitResult
    whose weights equal the supervised run's."""
    res = fit_distributed(
        torch_jobs.sup_module, torch_jobs.sup_trainer, torch_jobs.sup_data,
        2, resilience=_cfg(tmp_path, "fd"), device="cpu", timeout=120,
        log_dir=str(tmp_path / "logs"))
    assert isinstance(res, FitResult)
    for k, v in base.result.state_dict.items():
        assert torch.equal(v, res.state_dict[k]), k


def test_supervise_skips_corrupt_latest_checkpoint(tmp_path, base):
    """corrupt-latest and a kill at the same step: the resume comes from
    the last VALID checkpoint (step 1), and the run still ends equal to
    the uninterrupted one."""
    d = tmp_path / "corrupt"
    sup, starts = _run(tmp_path, "corrupt",
                       f"corrupt_latest:rank=0,step=2,dir={d};"
                       "kill:rank=0,step=2")
    assert sup.total_attempts == 2
    assert [s[0] for s in starts] == [0, 1]
    _same_weights(base, sup)


def test_supervise_sigterm_emergency_checkpoint_and_drain(tmp_path, base):
    """SIGTERM on every rank: the flag-only handler, a batch-boundary
    emergency save, the PreemptedError drain, a PREEMPTION resume."""
    sup, starts = _run(tmp_path, "pre", "preempt:rank=*,step=2")
    assert sup.preemptions == 1 and sup.restarts == 0
    [failure] = sup.failures
    assert failure["kind"] == "preemption"
    emergency = [d for d in os.listdir(tmp_path / "pre")
                 if d.startswith("preempt-step=")]
    # the notice lands after step 2's boundary check (the injector runs
    # after the guard), so the drain comes at step 3's
    assert emergency == ["preempt-step=3"]
    ok, reason = verify_checkpoint(str(tmp_path / "pre" / emergency[0]))
    assert ok, reason
    assert [s[0] for s in starts] == [0, 3]
    _same_weights(base, sup)


def test_supervise_hang_is_restarted_by_the_watchdog(tmp_path, base):
    """A rank that stops stepping AND heartbeating: the stall watchdog in
    the driver's pump raises StallError (RETRYABLE), the hung group is
    torn down, the relaunch resumes and ends equal to the clean run."""
    t0 = time.monotonic()
    sup, starts = _run(tmp_path, "hang", "hang:rank=0,step=3", stall=4.0)
    assert time.monotonic() - t0 < 100  # not the 600 s hang
    [failure] = sup.failures
    assert (failure["kind"], failure["cause"], failure["rank"]) == (
        "retryable", "stall", 0)
    assert [s[0] for s in starts] == [0, 3]
    assert all(_dead(pid) for _, pid in starts)
    _same_weights(base, sup)


def test_supervise_fatal_fails_fast_with_classified_cause(tmp_path):
    """A deterministic user exception: NO restart; the SupervisedFailure
    names the classification and chains the rank-tagged WorkerError with
    its log tail."""
    with pytest.raises(SupervisedFailure) as exc_info:
        _run(tmp_path, "fatal", "raise:rank=0,step=2")
    exc = exc_info.value
    assert exc.classified.kind == FailureKind.FATAL and exc.attempts == 1
    cause = exc.__cause__
    assert isinstance(cause, WorkerError) and cause.rank == 0
    assert "injected fatal failure" in cause.traceback_str
    assert "worker log tail" in str(cause)
    # the post-mortem goodput lands on the fatal path too
    assert os.path.exists(tmp_path / "fatal" / "telemetry" / "goodput.json")


def test_supervised_goodput_charges_the_replay(tmp_path, base, capsys):
    """Saves every 3 steps, ledgers every step, rank 0 SIGKILL'd at step
    5: the resume starts at step 3 behind the killed attempt's end, so
    steps 4-5 are trained twice and their time goes to
    rollback_replay_s (the JAX package's `TestSupervisedGoodput`). The
    run dir's ledgers merge into one timeline whose Chrome trace
    validates."""
    from ray_lightning_tpu_torch.__main__ import main
    from ray_lightning_tpu_torch.telemetry.timeline import (
        load_timeline_events,
        to_chrome_trace,
        validate_chrome_trace,
    )

    run = str(tmp_path / "replay")
    trainer = functools.partial(torch_jobs.sup_trainer,
                                telemetry=TelemetryConfig(
                                    dir=os.path.join(run, "telemetry"),
                                    flush_every_n_steps=1))
    sup, starts = _run(tmp_path, "replay", "kill:rank=0,step=5",
                       save_every=3, trainer=trainer)
    assert sup.restarts == 1 and [s[0] for s in starts] == [0, 3]
    _same_weights(base, sup)
    report = _goodput(sup, 2)
    assert report["buckets"]["backoff_s"] > 0
    assert report["buckets"]["rollback_replay_s"] > 0
    assert [a["replay_steps"] for a in report["attempts"]] == [0, 2]
    timeline = load_timeline_events(run)
    assert {"spans", "goodput"} <= set(timeline["sources"])
    assert not validate_chrome_trace(to_chrome_trace(timeline["events"]))
    assert main(["timeline", run, "--json"]) == 0
    out = json.loads(capsys.readouterr().out.strip())
    assert out["sources"] == timeline["sources"]
    kinds = {e["kind"] for e in out["events"] if e["source"] == "spans"}
    assert {"attempt", "backoff", "dispatch", "step"} <= kinds


def test_watchdog_runs_in_the_pump(tmp_path):
    """`WorkerGroup.run(watchdog=)` calls the hook while it waits and a
    raise from it fails the run; the group still shuts down."""
    calls = []

    def watchdog():
        calls.append(time.monotonic())
        if len(calls) >= 3:
            raise StallError(0, 3.0)

    group = WorkerGroup(1, log_dir=str(tmp_path)).start()
    try:
        with pytest.raises(StallError):
            group.run(torch_jobs.sleep_for, shared_args=(30,),
                      watchdog=watchdog)
    finally:
        group.shutdown(timeout=2.0)
    assert len(calls) == 3 and calls[-1] - calls[0] < 10
