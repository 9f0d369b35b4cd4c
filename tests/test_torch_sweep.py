"""The port's sweep layer (`ray_lightning_tpu_torch.sweep`) against the
JAX package's (`ray_lightning_tpu.sweep`), in one process, mirroring
`tests/test_sweep.py`.

The stdlib parts are held to the JAX package's verdicts on shared
inputs: `expand` over seeded spaces, the ASHA and median-stopping
verdicts at every report of seeded random streams (min and max, NaN and
None values, ties at the rung cutoffs), `classify_failure` on the JAX
package's own cases. Then the slice: an inline sweep of the tiny Llama
with an lr grid that holds an lr-0 arm, under ASHA, in both packages on
the same weights and tokens. Each trial's reported validation losses
agree at 2e-5, and statuses, iterations, `best_config` and the
`dataframe()` rows are the same. The rest is the port's own surface:
GPU-indexed pools, the report callbacks, checkpoint retention, the
report server against bad peers, and the errors `run` raises.
"""
from __future__ import annotations

import functools
import math
import os
import socket
from multiprocessing.connection import Client

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_lightning_tpu import sweep as jsweep
from ray_lightning_tpu.core.callbacks import (
    ThroughputMonitor as JaxThroughputMonitor,
)
from ray_lightning_tpu.core.data import DataLoader as JaxDataLoader
from ray_lightning_tpu.core.trainer import Trainer as JaxTrainer
from ray_lightning_tpu.models.llama import Llama as JaxLlama
from ray_lightning_tpu.models.llama import LlamaConfig as JaxConfig
from ray_lightning_tpu.models.llama import LlamaModule as JaxLlamaModule
from ray_lightning_tpu.parallel.strategy import SingleDevice as JaxSingle
from ray_lightning_tpu.resilience import policy as jpolicy
from ray_lightning_tpu.runtime.group import WorkerError as JaxWorkerError
from ray_lightning_tpu_torch import sweep
from ray_lightning_tpu_torch.core.callbacks import (
    MemoryMonitor,
    ThroughputMonitor,
)
from ray_lightning_tpu_torch.core.data import DataLoader
from ray_lightning_tpu_torch.core.trainer import Trainer
from ray_lightning_tpu_torch.models.llama import (
    LlamaConfig,
    LlamaModule,
    params_from_jax,
)
from ray_lightning_tpu_torch.parallel.strategy import SingleDevice
from ray_lightning_tpu_torch.resilience import policy
from ray_lightning_tpu_torch.runtime.group import WorkerError
from ray_lightning_tpu_torch.sweep import session as trial_session
from ray_lightning_tpu_torch.sweep.analysis import Trial
from ray_lightning_tpu_torch.sweep.tuner import (
    _ReportServer,
    _visible_devices,
)
from tests import torch_jobs

# ---- search spaces ----------------------------------------------------------

SPACES = {
    "grid_and_samplers": ({
        "lr": "loguniform",
        "bs": [16, 32],
        "layers": [1, 2, 3],
        "fixed": "adam",
    }, 2),
    "samplers_only": ({"a": "choice", "b": "randint", "c": "uniform"}, 20),
    "grid_only": ({"x": [0.1, 0.5, 0.9], "y": ["a", "b"]}, 1),
}


def _space(pkg, spec):
    """The space ``spec`` in package ``pkg``: a list is a grid axis, a
    sampler name a fixed sampler of that kind, anything else passes."""
    samplers = {"loguniform": lambda: pkg.loguniform(1e-4, 1e-1),
                "choice": lambda: pkg.choice([1, 2, 3]),
                "randint": lambda: pkg.randint(0, 10),
                "uniform": lambda: pkg.uniform(0.0, 1.0)}
    out = {}
    for k, v in spec.items():
        if isinstance(v, list):
            out[k] = pkg.grid_search(v)
        elif v in samplers:
            out[k] = samplers[v]()
        else:
            out[k] = v
    return out


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("name", list(SPACES))
def test_expand_matches_jax(name, seed):
    """The same configs in the same order as the JAX `expand`, drawn from
    numpy's `default_rng(seed)` in its order."""
    spec, n = SPACES[name]
    got = sweep.expand(_space(sweep, spec), num_samples=n, seed=seed)
    want = jsweep.expand(_space(jsweep, spec), num_samples=n, seed=seed)
    assert got == want
    assert got == sweep.expand(_space(sweep, spec), num_samples=n, seed=seed)
    grid = [len(v) for v in spec.values() if isinstance(v, list)]
    assert len(got) == n * math.prod(grid)


# ---- schedulers -------------------------------------------------------------


def _stream(seed, n_trials=6, n_reports=60):
    """Seeded (trial, iteration, value) reports: interleaved trials whose
    iterations climb by 1-3 (landing on and jumping past rung edges),
    values drawn from a few levels (ties at the cutoffs), some NaN and
    some None."""
    rng = np.random.default_rng(seed)
    iters = [0] * n_trials
    levels = rng.normal(size=4)
    out = []
    for _ in range(n_reports):
        t = int(rng.integers(0, n_trials))
        iters[t] += int(rng.integers(1, 4))
        r = rng.random()
        value = (None if r < 0.07 else float("nan") if r < 0.14
                 else float(levels[int(rng.integers(0, 4))]))
        out.append((f"t{t}", iters[t], value))
    return out


ASHA_CASES = [
    # (max_t, grace_period, reduction_factor)
    (12, 1, 2), (100, 1, 3), (30, 2, 4), (4, 1, 2), (1, 1, 2), (9, 0, 3),
]


@pytest.mark.parametrize("mode", ["min", "max"])
@pytest.mark.parametrize("case", ASHA_CASES)
def test_asha_verdicts_match_jax(case, mode):
    max_t, grace, rf = case
    stops = 0
    for seed in range(4):
        mine = sweep.ASHAScheduler(metric="m", mode=mode, max_t=max_t,
                                   grace_period=grace, reduction_factor=rf)
        ref = jsweep.ASHAScheduler(metric="m", mode=mode, max_t=max_t,
                                   grace_period=grace, reduction_factor=rf)
        assert mine.milestones == ref.milestones
        for tid, it, value in _stream(seed):
            got = mine.on_result(tid, it, value)
            assert got == ref.on_result(tid, it, value), (seed, tid, it)
            stops += got == "stop"
    if mine.milestones:
        assert stops > 0  # the streams reach the stopping branch
    with pytest.raises(ValueError):
        sweep.ASHAScheduler(reduction_factor=1)


@pytest.mark.parametrize("mode", ["min", "max"])
@pytest.mark.parametrize("grace,min_samples", [(1, 3), (2, 2), (5, 1)])
def test_median_rule_verdicts_match_jax(grace, min_samples, mode):
    stops = 0
    for seed in range(4):
        mine = sweep.MedianStoppingRule(metric="m", mode=mode,
                                        grace_period=grace,
                                        min_samples=min_samples)
        ref = jsweep.MedianStoppingRule(metric="m", mode=mode,
                                        grace_period=grace,
                                        min_samples=min_samples)
        for tid, it, value in _stream(seed):
            got = mine.on_result(tid, it, value)
            assert got == ref.on_result(tid, it, value), (seed, tid, it)
            stops += got == "stop"
    assert stops > 0


# ---- resources --------------------------------------------------------------


def test_resource_pool_hands_out_disjoint_cards():
    pool = sweep.ResourcePool(total_gpus=8)
    per = sweep.GpuResources(gpus=4)
    assert pool.max_concurrent(per) == 2
    a = pool.try_acquire(per)
    b = pool.try_acquire(per)
    assert a == [0, 1, 2, 3] and b == [4, 5, 6, 7]
    assert pool.try_acquire(per) is None  # 8/8 in use
    assert pool.in_use == 8
    pool.release(a)
    assert pool.try_acquire(per) == [0, 1, 2, 3]  # reused after release
    with pytest.raises(ValueError, match="not a held block"):
        pool.release([0])  # not a block that was handed out
    with pytest.raises(ValueError, match="oversubscribed"):
        pool.try_acquire(sweep.GpuResources(gpus=16))
    with pytest.raises(ValueError):
        sweep.GpuResources(gpus=0)
    with pytest.raises(ValueError):
        sweep.ResourcePool(total_gpus=0)


def test_resource_pool_joint_gpu_cpu_caps():
    """Packing is bounded by whichever budget runs out first (the
    reference's per-worker CPU reservation,
    examples/ray_ddp_example.py:107-112)."""
    pool = sweep.ResourcePool(total_gpus=8, total_cpus=8)
    per = sweep.GpuResources(gpus=2, cpus=4)
    # GPUs alone would allow 4 at once; the CPUs cap it at 2
    assert pool.max_concurrent(per) == 2
    a = pool.try_acquire(per)
    b = pool.try_acquire(per)
    assert set(a).isdisjoint(b)
    assert pool.try_acquire(per) is None  # CPUs 8/8, GPUs 4/8
    assert (pool.in_use, pool.cpus_in_use) == (4, 8)
    pool.release(b)
    assert (pool.in_use, pool.cpus_in_use) == (2, 4)
    assert pool.try_acquire(per) == b
    with pytest.raises(ValueError):
        pool.try_acquire(sweep.GpuResources(gpus=1, cpus=99))
    # GPU-only trials are unaffected by the CPU budget
    assert pool.max_concurrent(sweep.GpuResources(gpus=4)) == 2


def test_visible_devices_map_through_the_drivers_own(monkeypatch):
    """Pool index i is the i-th card this process sees: under a
    CUDA_VISIBLE_DEVICES of the driver's own, a trial gets those names."""
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    assert _visible_devices([2, 3]) == "2,3"
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "4, 6,7")
    assert _visible_devices([1]) == "6"
    assert _visible_devices([0, 2]) == "4,7"
    with pytest.raises(sweep.SweepError, match="outside"):
        _visible_devices([3])
    # a driver with its cards hidden (a CPU-only sweep under total_gpus=)
    # hides them from its trials too
    for hidden in ("", " "):
        monkeypatch.setenv("CUDA_VISIBLE_DEVICES", hidden)
        assert _visible_devices([0]) == ""
        assert _visible_devices([0, 1]) == ""


# ---- failure classification -------------------------------------------------


def _failure_cases(worker_error, stall_error):
    """The JAX package's own classification cases
    (tests/test_resilience.py, tests/test_trainguard.py), built with one
    package's WorkerError and StallError."""
    we = worker_error
    return {
        "sigterm": we.from_death(2, -15, "tail", "(EOF on channel)"),
        "sigkill": we.from_death(2, -9, "tail", "(EOF on channel)"),
        "plain_exit": we.from_death(1, 7, "", "without returning a result"),
        "user_traceback": we(0, "Traceback (most recent call last):\n"
                                "  ...\nValueError: shapes do not match"),
        "backend_loss": we(3, "Traceback ...\njaxlib.xla_extension."
                              "XlaRuntimeError: UNAVAILABLE: socket closed"),
        "gloo_peer": we(0, "Traceback ...\nGloo all-reduce failed: "
                           "[gloo/transport/tcp/pair.cc:534] Connection "
                           "closed by peer [127.0.0.1]:14000"),
        "gloo_rendezvous": we(0, "Traceback ...\ngloo::IoException: "
                                 "[gloo/transport/tcp/pair.cc:598] Timed "
                                 "out waiting for clients"),
        "gloo_bug": we(0, "Traceback ...\ngloo::EnforceNotMet: invalid "
                          "tensor size mismatch"),
        "preempted": we(1, "Traceback ...\nPreemptedError: training drained "
                           "after preemption notice (SIGTERM)"),
        "anomaly": we(1, "Traceback ...\nTrainingAnomalyError: training "
                         "anomaly escalation: 3 anomalous step(s)"),
        "sdc": we(0, "Traceback ...\nSDCDetectedError: silent data "
                     "corruption detected at step 4"),
        "timeout": TimeoutError("pending"),
        "stall": stall_error(1, 200.0, phase="step", step=3),
        "bad_config": ValueError("bad config"),
        "connection": ConnectionResetError("reset"),
        "eof": EOFError(),
        "backend_text": RuntimeError("backend unavailable after 3 tries"),
    }


@pytest.mark.parametrize("case", list(_failure_cases(WorkerError,
                                                     policy.StallError)))
def test_classify_failure_matches_jax(case):
    got = _failure_cases(WorkerError, policy.StallError)[case]
    want = _failure_cases(JaxWorkerError, jpolicy.StallError)[case]
    assert (policy.classify_failure(got).to_dict()
            == jpolicy.classify_failure(want).to_dict())


NCCL_FAILURES = {
    "nccl_remote": "torch.distributed.DistBackendError: NCCL error in: "
                   "ProcessGroupNCCL.cpp:2025, remote process exited or "
                   "there was a network error, NCCL version 2.21.5\n"
                   "ncclRemoteError: A call failed possibly due to a "
                   "network error or a remote process exiting prematurely.",
    "nccl_system": "ncclSystemError: System call (e.g. socket, malloc) or "
                   "external library call failed or device error.",
    "watchdog": "[Rank 0] Watchdog caught collective operation timeout: "
                "WorkNCCL(SeqNum=7, OpType=ALLREDUCE, NumelIn=1) ran for "
                "600000 milliseconds before timing out.",
}

CUDA_FAILURES = {
    "illegal_address": "torch.AcceleratorError: CUDA error: an illegal "
                       "memory access was encountered",
    "oom": "torch.OutOfMemoryError: CUDA out of memory. Tried to allocate "
           "2.00 GiB. GPU 0 has a total capacity of 79.19 GiB",
    # a CUDA fault that surfaces through a collective stays the program's
    "through_nccl": "NCCL error in: ProcessGroupNCCL.cpp:1936\n"
                    "RuntimeError: CUDA error: an illegal memory access "
                    "was encountered",
}


@pytest.mark.parametrize("name", list(NCCL_FAILURES))
def test_nccl_failures_are_retryable(name):
    text = NCCL_FAILURES[name]
    in_worker = policy.classify_failure(
        WorkerError(1, f"Traceback (most recent call last):\n{text}"))
    assert in_worker.kind == policy.FailureKind.RETRYABLE
    assert (in_worker.cause, in_worker.rank) == ("worker-backend", 1)
    raised_here = policy.classify_failure(RuntimeError(text))
    assert raised_here.kind == policy.FailureKind.RETRYABLE


@pytest.mark.parametrize("name", list(CUDA_FAILURES))
def test_cuda_errors_are_fatal(name):
    text = CUDA_FAILURES[name]
    in_worker = policy.classify_failure(
        WorkerError(0, f"Traceback (most recent call last):\n{text}"))
    assert in_worker.kind == policy.FailureKind.FATAL
    assert not in_worker.restartable
    assert policy.classify_failure(RuntimeError(text)).kind == \
        policy.FailureKind.FATAL
    # but a trial process that vanished is infrastructure, whatever it
    # printed last
    died = WorkerError.from_death(0, -9, text, "(EOF on channel)")
    assert policy.classify_failure(died).kind == policy.FailureKind.RETRYABLE


def test_retry_policy_matches_jax():
    kw = dict(max_restarts=2, backoff_base_s=1.0, backoff_factor=4.0,
              backoff_max_s=5.0, jitter=0.0, max_rollbacks=1)
    mine, ref = policy.RetryPolicy(**kw), jpolicy.RetryPolicy(**kw)
    assert [mine.next_delay(i) for i in range(1, 5)] == \
        [ref.next_delay(i) for i in range(1, 5)] == [1.0, 4.0, 5.0, 5.0]
    for case in ("timeout", "sigterm", "bad_config", "anomaly"):
        fc = policy.classify_failure(
            _failure_cases(WorkerError, policy.StallError)[case])
        jfc = jpolicy.classify_failure(
            _failure_cases(JaxWorkerError, jpolicy.StallError)[case])
        for counts in ((0, 0, 0), (1, 0, 0), (2, 0, 0), (0, 0, 1)):
            assert mine.allows(*counts[:2], fc, rollbacks=counts[2]) == \
                ref.allows(*counts[:2], jfc, rollbacks=counts[2])


# ---- the slice: a sweep of the tiny Llama in both packages ------------------

#: the tiny Llama, its tokens, and the sweep over it
TINY = torch_jobs.TINY
N, S, B, STEPS, VAL_EVERY = 16, 12, 2, 8, 2
LRS = [1e-2, 3e-3, 0.0]


def _llama_inputs():
    jcfg = JaxConfig(**TINY, dtype=jnp.float32, remat=False)
    params = jax.tree.map(np.asarray, JaxLlama(jcfg).init(
        jax.random.key(2), jnp.zeros((1, 4), jnp.int32))["params"])
    # ids under 16 of 256: held-out rows share what there is to learn,
    # so a learning arm's validation loss falls and the lr-0 arm's not
    toks = torch_jobs.tokens(N, S, seed=4, vocab=16).astype(np.int32)
    val = torch_jobs.tokens(2, S, seed=5, vocab=16).astype(np.int32)
    return jcfg, params, toks, val


def _jax_llama_trainable(config, jcfg, params, toks, val):
    module = JaxLlamaModule(jcfg, lr=config["lr"], warmup_steps=1,
                            total_steps=STEPS)
    module.params = jax.tree.map(jnp.asarray, params)
    JaxTrainer(strategy=JaxSingle(), max_steps=STEPS,
               val_check_interval=VAL_EVERY, log_every_n_steps=1,
               callbacks=[jsweep.TuneReportCallback(
                   metrics={"loss": "val_loss"})],
               enable_checkpointing=False, enable_progress_bar=False,
               seed=0).fit(module, JaxDataLoader({"tokens": toks},
                                                 batch_size=B),
                           JaxDataLoader({"tokens": val}, batch_size=B))
    return "done"


def _port_llama_trainable(config, params, toks, val):
    cfg = LlamaConfig(**TINY, dtype=torch.float32)
    module = LlamaModule(cfg, lr=config["lr"], warmup_steps=1,
                         total_steps=STEPS)
    module.params = params_from_jax(params, cfg, dtype=torch.float32)
    Trainer(strategy=SingleDevice(device="cpu"), max_steps=STEPS,
            val_check_interval=VAL_EVERY, log_every_n_steps=1,
            callbacks=[sweep.TuneReportCallback(
                metrics={"loss": "val_loss"})],
            enable_checkpointing=False, enable_progress_bar=False,
            seed=0).fit(module, DataLoader({"tokens": toks}, batch_size=B),
                        DataLoader({"tokens": val}, batch_size=B))
    return "done"


def test_inline_llama_sweep_matches_jax(tmp_path):
    """Three lr arms (one of them 0, which cannot learn) of the tiny Llama
    under ASHA, each reporting the validation loss every 2 of 8 steps."""
    jcfg, params, toks, val = _llama_inputs()
    common = dict(metric="loss", mode="min", executor="inline")

    def asha(pkg):
        return pkg.ASHAScheduler(max_t=4, grace_period=1,
                                 reduction_factor=2)

    ref = jsweep.run(
        functools.partial(_jax_llama_trainable, jcfg=jcfg, params=params,
                          toks=toks, val=val),
        config={"lr": jsweep.grid_search(LRS)}, **common,
        scheduler=asha(jsweep), total_chips=8,
        storage_dir=str(tmp_path / "jax"))
    got = sweep.run(
        functools.partial(_port_llama_trainable, params=params, toks=toks,
                          val=val),
        config={"lr": sweep.grid_search(LRS)}, **common,
        scheduler=asha(sweep), total_gpus=1,
        storage_dir=str(tmp_path / "port"))

    for mine, theirs in zip(got.trials, ref.trials):
        assert (mine.config, mine.status, mine.iterations) == \
            (theirs.config, theirs.status, theirs.iterations)
        np.testing.assert_allclose([h["loss"] for h in mine.history],
                                   [h["loss"] for h in theirs.history],
                                   rtol=2e-5, atol=2e-5)
        assert [h["training_iteration"] for h in mine.history] == \
            list(range(1, mine.iterations + 1))
    by_lr = {t.config["lr"]: t for t in got.trials}
    assert by_lr[0.0].status == Trial.STOPPED and by_lr[0.0].iterations < 4
    assert by_lr[1e-2].status == Trial.DONE and by_lr[1e-2].iterations == 4
    assert got.best_config == ref.best_config
    rows, ref_rows = got.dataframe(), ref.dataframe()
    assert [sorted(r) for r in rows] == [sorted(r) for r in ref_rows]
    for r, rr in zip(rows, ref_rows):
        assert {k: v for k, v in r.items() if k != "loss"} == \
            {k: v for k, v in rr.items() if k != "loss"}
        assert r["loss"] == pytest.approx(rr["loss"], rel=2e-5, abs=2e-5)


# ---- callbacks and monitors -------------------------------------------------


class _FakeTrainer:
    def __init__(self, metrics, has_validation=True):
        self.callback_metrics = dict(metrics)
        self.has_validation = has_validation


METRIC_FORMS = {
    "all": None,
    "one": "val_loss",
    "list": ["val_loss", "acc"],
    "renamed": {"loss": "val_loss", "accuracy": "acc"},
}


@pytest.mark.parametrize("form", list(METRIC_FORMS))
def test_report_callback_metric_forms_match_jax(form):
    """The four `metrics` forms (reference tune.py:41-66) report what the
    JAX callback reports, at validation end and, with no validation, at
    epoch end; non-scalar and missing metrics are dropped."""
    trainer_metrics = {"acc": 0.5, "train_loss": np.float32(2.0),
                       "hist": np.ones(3), "step": 4}
    val_metrics = {"val_loss": 1.25}
    got, want = [], []
    trial_session.init_trial_session(trial_session.LocalTrialContext(
        "t", "/nowhere", lambda tid, m, c: got.append(m) or "continue"))
    try:
        mine = sweep.TuneReportCallback(metrics=METRIC_FORMS[form])
        mine.on_validation_epoch_end(_FakeTrainer(trainer_metrics), None,
                                     val_metrics)
        mine.on_train_epoch_end(_FakeTrainer(trainer_metrics), None)
        mine.on_train_epoch_end(
            _FakeTrainer({**trainer_metrics, **val_metrics},
                         has_validation=False), None)
    finally:
        trial_session.reset_trial_session()
    theirs = jsweep.TuneReportCallback(metrics=METRIC_FORMS[form])
    want.append(theirs._collect(_FakeTrainer(trainer_metrics), val_metrics))
    want.append(theirs._collect(_FakeTrainer(
        {**trainer_metrics, **val_metrics})))
    assert got == [w for w in want if w]
    assert all("hist" not in r for r in got)
    with pytest.raises(ValueError):
        sweep.TuneReportCallback(on="train_batch_end")


def _retention_trainable(config):
    trainer = Trainer(
        strategy=SingleDevice(device="cpu"), max_epochs=4,
        callbacks=[sweep.TuneReportCheckpointCallback(
            on="train_epoch_end", keep_last_n=2)],
        enable_checkpointing=False, enable_progress_bar=False, seed=0)
    train, _ = torch_jobs.mnist_data(rows=64, batch_size=32)
    trainer.fit(torch_jobs.mnist_module(), train)
    return "ok"


def test_checkpoint_retention_keeps_last_n(tmp_path):
    """keep_last_n prunes this callback's older checkpoints; the newest
    (the resume source, trial.checkpoints[-1]) always survives."""
    analysis = sweep.run(_retention_trainable, config={}, metric="loss",
                         executor="inline", total_gpus=1,
                         storage_dir=str(tmp_path))
    [t] = analysis.trials
    assert t.status == Trial.DONE
    assert len(t.checkpoints) == 4  # all four were registered...
    existing = [c for c in t.checkpoints if os.path.isdir(c)]
    assert existing == t.checkpoints[-2:]  # ...only the newest 2 kept
    assert all(os.path.dirname(c) == t.trial_dir for c in t.checkpoints)
    with pytest.raises(ValueError):
        sweep.TuneReportCheckpointCallback(keep_last_n=0)


@pytest.mark.parametrize("skip_first", [1, 0])
def test_throughput_monitor_matches_jax(skip_first):
    """The first interval (here a slow first step) is dropped from the
    window unless ``skip_first=0``; same numbers as the JAX monitor."""
    intervals = [10.0, 0.1, 0.1, 0.1]

    def run(cls):
        ticks = iter(np.cumsum([0.0, *intervals]))
        mon = cls(window=20, skip_first=skip_first,
                  clock=lambda: float(next(ticks)))

        class T:
            callback_metrics = {}
            last_batch_size = 32

        t = T()
        mon.on_fit_start(t, None)
        mon.on_train_epoch_start(t, None)
        for i in range(len(intervals)):
            mon.on_train_batch_end(t, None, {}, i)
        return t.callback_metrics

    got = run(ThroughputMonitor)
    assert got == run(JaxThroughputMonitor)
    want = 0.1 if skip_first else 2.575
    assert got["step_time_s"] == pytest.approx(want)
    assert got["examples_per_sec"] == pytest.approx(32 / want)


def test_monitors_in_a_cpu_fit():
    """In a real fit on the CPU: the throughput monitor feeds
    step_time_s; the memory monitor stays inert (no device stats)."""
    trainer = Trainer(strategy=SingleDevice(device="cpu"), max_epochs=1,
                      log_every_n_steps=1,
                      callbacks=[ThroughputMonitor(), MemoryMonitor()],
                      enable_checkpointing=False, enable_progress_bar=False,
                      seed=0)
    train, _ = torch_jobs.mnist_data(rows=128, batch_size=32)
    trainer.fit(torch_jobs.mnist_module(), train)
    assert trainer.callback_metrics["step_time_s"] > 0
    assert trainer.callback_metrics["examples_per_sec"] > 0
    assert "hbm_peak_bytes" not in trainer.callback_metrics
    assert MemoryMonitor._stats(torch.device("cpu")) is None


# ---- the report server and run's errors -------------------------------------


def test_report_server_survives_stalled_and_resetting_peers():
    """A peer that connects and stalls mid-challenge, or resets, must not
    wedge or kill the acceptor: real trials keep reporting."""
    server = _ReportServer(lambda tid, m, c: "continue")
    try:
        # stalled peer: connects, never answers the auth challenge
        stall = socket.create_connection(server.address)
        conn = Client(tuple(server.address),
                      authkey=bytes.fromhex(server.authkey_hex))
        conn.send(("report", "t1", {"m": 1.0}, None))
        assert conn.recv() == "continue"
        # resetting peer: connect and close at once (RST mid-challenge)
        socket.create_connection(server.address).close()
        conn.send(("report", "t1", {"m": 2.0}, None))
        assert conn.recv() == "continue"
        # a wrong key is refused without harming the others
        with pytest.raises(Exception):
            Client(tuple(server.address), authkey=b"x" * 32)
        conn.send(("report", "t1", {"m": 3.0}, None))
        assert conn.recv() == "continue"
        conn.close()
        stall.close()
    finally:
        server.close()


def test_run_refuses_hosts_and_transport(tmp_path):
    """``hosts=`` is ported (trials placed over a remote transport,
    tests/test_torch_sweep_process.py); what it still refuses, before
    any trial starts: hosts without a remote transport, and a trial
    that needs more hosts than the pool has."""
    from ray_lightning_tpu_torch.runtime import (
        LocalTransport,
        LoopbackTransport,
    )

    for kw, match in (
            ({"hosts": ["host-a"]}, "remote transport"),
            ({"hosts": ["host-a"], "transport": LocalTransport()},
             "remote transport"),
            ({"hosts": ["only-one"], "transport": LoopbackTransport(),
              "resources_per_trial": sweep.GpuResources(hosts=2)},
             "hosts")):
        with pytest.raises(sweep.SweepError, match=match):
            sweep.run(torch_jobs.constant_trainable, config={"q": 1.0},
                      total_gpus=1, storage_dir=str(tmp_path), **kw)


@pytest.mark.parametrize("executor", ["inline", "process"])
def test_run_without_a_card_needs_total_gpus(tmp_path, executor):
    """No card and no total_gpus: raise, naming total_gpus=, rather than
    size a pool of one card that is not there."""
    assert not torch.cuda.is_available()
    with pytest.raises(sweep.SweepError, match="total_gpus="):
        sweep.run(torch_jobs.constant_trainable, config={"q": 1.0},
                  metric="loss", executor=executor,
                  storage_dir=str(tmp_path))
    assert os.listdir(tmp_path) == []


def test_lambda_trainable_raises_before_any_trial(tmp_path):
    def nested(config):
        sweep.report(loss=1.0)

    for trainable in (lambda config: None, nested):
        with pytest.raises(TypeError, match="module-level"):
            sweep.run(trainable, config={"x": sweep.grid_search([1, 2])},
                      metric="loss", total_gpus=2,
                      storage_dir=str(tmp_path))
    assert os.listdir(tmp_path) == []


def test_inline_trial_error_recorded_and_raised(tmp_path):
    def boom(config):
        if config["x"] == 1:
            raise RuntimeError("kaboom")
        sweep.report(loss=1.0)

    analysis = sweep.run(
        boom, config={"x": sweep.grid_search([0, 1])}, metric="loss",
        executor="inline", total_gpus=1, storage_dir=str(tmp_path / "a"),
        raise_on_failed_trial=False)
    assert {t.config["x"]: t.status for t in analysis.trials} == \
        {0: Trial.DONE, 1: Trial.ERROR}
    assert "kaboom" in analysis.errors()["trial_00001"]
    with pytest.raises(sweep.SweepError, match="kaboom"):
        sweep.run(boom, config={"x": sweep.grid_search([0, 1])},
                  metric="loss", executor="inline", total_gpus=1,
                  storage_dir=str(tmp_path / "b"))


# ---- trials on cluster hosts (twins of tests/test_sweep.py) ----------------


def test_trials_placed_on_cluster_hosts(tmp_path, monkeypatch):
    """Each process trial borrows a host from the pool through the remote
    transport's bootstrap and returns it (3 trials over 2 hosts reuse
    one); its cards travel in its explicit environment, the driver's own
    variables do not."""
    from ray_lightning_tpu_torch.runtime import LoopbackTransport

    monkeypatch.setenv("RLT_DRIVER_ONLY", "should-not-leak")
    transport = LoopbackTransport()
    analysis = sweep.run(
        torch_jobs.hosts_aware_trainable,
        config={"q": sweep.grid_search([0.2, 0.5, 0.8])},
        metric="loss", mode="min", executor="process", total_gpus=8,
        storage_dir=str(tmp_path), trial_timeout=120.0,
        hosts=["host-a", "host-b"], transport=transport)
    assert all(t.status == Trial.DONE for t in analysis.trials)
    spawned = [h for h, _ in transport.spawned]
    assert len(spawned) == 3 and set(spawned) == {"host-a", "host-b"}
    for t in analysis.trials:
        assert t.result["hosts"] in (["host-a"], ["host-b"])
        assert t.result["visible"] in ("0", "1")
        assert t.result["driver_only"] is None
    assert analysis.best_config == {"q": 0.2}


def test_trial_sees_its_borrowed_host_set(tmp_path):
    """A trial reserving two hosts runs its own process on the first and
    finds both in `get_trial_hosts` (for a nested cross-host
    fit_distributed), its two cards in CUDA_VISIBLE_DEVICES."""
    from ray_lightning_tpu_torch.runtime import LoopbackTransport

    transport = LoopbackTransport()
    analysis = sweep.run(
        torch_jobs.hosts_aware_trainable, config={}, metric="loss",
        executor="process", total_gpus=8,
        resources_per_trial=sweep.GpuResources(gpus=2, hosts=2),
        storage_dir=str(tmp_path), trial_timeout=120.0,
        hosts=["host-a", "host-b"], transport=transport)
    [t] = analysis.trials
    assert t.status == Trial.DONE
    assert t.result["hosts"] == ["host-a", "host-b"]
    assert t.result["visible"] == "0,1"
    assert [h for h, _ in transport.spawned] == ["host-a"]


def test_tpu_resources_names_the_difference():
    """`TpuResources(chips=)` does not map onto the port's card blocks:
    the name raises and says so (it stays out of the port's surface)."""
    with pytest.raises(NotImplementedError, match="GpuResources"):
        sweep.TpuResources
    assert not hasattr(sweep, "TpuResources")
