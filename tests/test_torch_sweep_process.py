"""Trial processes of the port's sweep on the CPU, mirroring the
process-executor cases of `tests/test_sweep.py`.

Each trial runs in its own process (a runtime worker), pinned through
``CUDA_VISIBLE_DEVICES`` to the cards its block reserved; here the pool
is sized with ``total_gpus`` and the trainables run on the CPU. The
trainables live in `tests/torch_jobs.py`: trial processes import them by
name, since the trainable crosses by the standard pickle.
"""
from __future__ import annotations

import functools
import json
import os

import numpy as np
import pytest

from ray_lightning_tpu_torch import sweep
from ray_lightning_tpu_torch.checkpoint import verify_checkpoint
from ray_lightning_tpu_torch.core.trainer import Trainer
from ray_lightning_tpu_torch.models.mlp import MNISTClassifier
from ray_lightning_tpu_torch.parallel.strategy import SingleDevice
from ray_lightning_tpu_torch.resilience import RetryPolicy
from ray_lightning_tpu_torch.sweep.analysis import Trial
from tests import torch_jobs

T = 120  # seconds one trial may take before the sweep fails it


def test_concurrent_trials_get_disjoint_cards(tmp_path):
    """Two GPUs, one a trial: both trials run at once (each waits for the
    other to start) and their processes see disjoint
    CUDA_VISIBLE_DEVICES; the driver's own environment is untouched."""
    rendezvous = tmp_path / "rendezvous"
    rendezvous.mkdir()
    before = os.environ.get("CUDA_VISIBLE_DEVICES")
    analysis = sweep.run(
        functools.partial(torch_jobs.card_trainable,
                          rendezvous_dir=str(rendezvous)),
        config={"i": sweep.grid_search([0, 1]), "n": 2}, metric="loss",
        total_gpus=2, resources_per_trial=sweep.GpuResources(gpus=1),
        storage_dir=str(tmp_path / "sweep"), trial_timeout=T)
    assert [t.status for t in analysis.trials] == [Trial.DONE] * 2
    seen = [t.result["cuda_visible_devices"] for t in analysis.trials]
    assert sorted(seen) == ["0", "1"]
    assert len({t.result["pid"] for t in analysis.trials}) == 2
    assert os.environ.get("CUDA_VISIBLE_DEVICES") == before
    # per-trial process isolation leaves per-trial logs behind
    for t in analysis.trials:
        assert os.path.isdir(os.path.join(t.trial_dir, "logs"))


def test_process_trials_asha_and_concurrency(tmp_path):
    """Four trials on a pool of 4 GPUs at 2 a trial (2 at once); ASHA
    stops the worse half at their first rung, the best survives."""
    analysis = sweep.run(
        torch_jobs.constant_trainable,
        config={"q": sweep.grid_search([0.1, 0.2, 0.8, 0.9])},
        metric="loss", mode="min",
        scheduler=sweep.ASHAScheduler(grace_period=1, reduction_factor=2,
                                      max_t=12),
        total_gpus=4, resources_per_trial=sweep.GpuResources(gpus=2),
        storage_dir=str(tmp_path), trial_timeout=T)
    by_q = {t.config["q"]: t for t in analysis.trials}
    assert by_q[0.1].status == Trial.DONE and by_q[0.1].iterations == 12
    stopped = [t for t in analysis.trials if t.status == Trial.STOPPED]
    assert stopped and all(t.iterations < 12 for t in stopped)
    assert analysis.best_config == {"q": 0.1}
    assert analysis.best_trial.last_result["training_iteration"] == 12


def test_failing_trial_is_fail_fast(tmp_path):
    analysis = sweep.run(
        torch_jobs.failing_trainable, config={}, metric="loss",
        total_gpus=1, storage_dir=str(tmp_path / "a"),
        raise_on_failed_trial=False, trial_timeout=T)
    [t] = analysis.trials
    assert t.status == Trial.ERROR
    assert "process kaboom" in t.error
    with pytest.raises(sweep.SweepError, match="trial_00000") as err:
        sweep.run(torch_jobs.failing_trainable, config={}, metric="loss",
                  total_gpus=1, storage_dir=str(tmp_path / "b"),
                  trial_timeout=T)
    assert "process kaboom" in str(err.value)


def test_retry_resumes_from_the_registered_checkpoint(tmp_path):
    """The trial process dies after registering its epoch-1 checkpoint: a
    retryable failure (a process that vanished), so the runner starts it
    again from that checkpoint and it ends DONE at step 8 with four
    reports. A rerun over the same storage_dir re-executes nothing and
    keeps the recorded result."""
    runs = tmp_path / "runs.txt"
    kw = dict(config={}, metric="loss", total_gpus=1,
              storage_dir=str(tmp_path / "sweep"), trial_timeout=T,
              retry_policy=RetryPolicy(max_restarts=1, backoff_base_s=0.0,
                                       jitter=0.0))
    trainable = functools.partial(torch_jobs.resumable_trainable,
                                  runs_file=str(runs))
    analysis = sweep.run(trainable, **kw)
    [t] = analysis.trials
    assert t.status == Trial.DONE and t.restarts == 1
    starts = runs.read_text().splitlines()
    assert len(starts) == 2
    # the second start resumed from the checkpoint of epoch 1 (step 4)
    assert starts[1].split()[1] == t.checkpoints[1]
    assert starts[1].split()[1].endswith("checkpoint_00000004")
    # 2 steps an epoch x 4 epochs; a fresh restart would have reported
    # 2 + 4 times, the resumed trial reports exactly 4
    assert t.result == {"final_step": 8, "resumed": True}
    assert t.iterations == 4 and len(t.checkpoints) == 4
    assert os.path.exists(os.path.join(t.trial_dir, "trial_state.json"))

    again = sweep.run(trainable, **kw)
    [t2] = again.trials
    assert t2.status == Trial.DONE and t2.iterations == 4
    assert t2.result == {"final_step": 8, "resumed": True}
    assert len(runs.read_text().splitlines()) == 2  # nothing re-executed


#: the reloaded best checkpoint's validation loss against its trial's
#: last report, relative (two processes' means against one process's)
LOSS_RTOL = 1e-5


def _nested_sweep(tmp_path, lrs, epochs, scheduler=None):
    return sweep.run(
        functools.partial(torch_jobs.nested_mnist_trainable,
                          log_dir=str(tmp_path / "workers")),
        config={"lr": sweep.grid_search(lrs), "max_epochs": epochs},
        metric="loss", mode="min", scheduler=scheduler, total_gpus=1,
        storage_dir=str(tmp_path / "sweep"), trial_timeout=T)


def test_sweep_over_fit_distributed(tmp_path):
    """The three-level topology (reference tests/test_tune.py): sweep
    driver -> trial process -> two gloo workers of `fit_distributed`.
    Worker rank 0's checkpoint-then-report reaches the sweep through the
    trial's pump, once an epoch; the best checkpoint reloads on the CPU
    and gives the accuracy and validation loss its trial reported. At
    these rates no other report (the other trial, the first epoch) lies
    within the loss tolerance, so a wrong checkpoint fails."""
    epochs = 2
    analysis = _nested_sweep(tmp_path, [1e-3, 3e-3], epochs)
    for t in analysis.trials:
        assert t.status == Trial.DONE
        assert [h["training_iteration"] for h in t.history] == \
            list(range(1, epochs + 1))
        assert all({"loss", "acc"} <= set(h) for h in t.history)
        # one checkpoint a report, written in the trial's dir
        assert len(t.checkpoints) == epochs
        assert all(os.path.dirname(c) == t.trial_dir for c in t.checkpoints)
        assert t.result == t.last_result["acc"]
    best_trial = analysis.best_trial
    best = analysis.best_checkpoint
    assert best == best_trial.checkpoints[-1]
    ok, reason = verify_checkpoint(best)
    assert ok, reason
    loaded = MNISTClassifier.load_from_checkpoint(best, device="cpu")
    _, val = torch_jobs.mnist_data()
    evaluator = Trainer(strategy=SingleDevice(device="cpu"),
                        enable_checkpointing=False, enable_progress_bar=False)
    preds = np.concatenate(evaluator.predict(loaded, val))
    acc = float(np.mean(preds == val.data["y"]))
    reported = best_trial.last_result
    assert acc == reported["acc"]
    loss = evaluator.validate(loaded, val)["ptl/val_loss"]
    tol = LOSS_RTOL * abs(reported["loss"])
    assert abs(loss - reported["loss"]) <= tol
    others = [h for t in analysis.trials
              for h in (t.history[:-1] if t is best_trial else t.history)]
    assert min(abs(h["loss"] - reported["loss"]) for h in others) > tol
    assert all(h["acc"] != reported["acc"] for h in others)


def test_asha_stops_a_nested_fit_and_its_workers(tmp_path):
    """ASHA over nested two-process gloo fits: the lr-0 arm cannot learn
    and is stopped at its first report. The verdict raises in the trial's
    pump; the trial ends STOPPED with the checkpoint of that report, none
    of its workers runs as it returns, and the trial after it runs.
    Every status equals a replay of the histories through a fresh
    scheduler."""
    asha = dict(max_t=2, grace_period=1, reduction_factor=2)
    analysis = _nested_sweep(tmp_path, [1e-3, 0.0, 3e-3], 2,
                             sweep.ASHAScheduler(**asha))
    first, arm, after = analysis.trials
    assert (arm.status, arm.iterations, len(arm.checkpoints)) == \
        (Trial.STOPPED, 1, 1)
    assert after.status in (Trial.DONE, Trial.STOPPED)
    assert after.iterations >= 1
    replay = sweep.ASHAScheduler(metric="loss", mode="min", **asha)
    for t in analysis.trials:
        status, seen = Trial.DONE, 0
        for seen, h in enumerate(t.history, start=1):
            if replay.on_result(t.trial_id, seen, h["loss"]) == "stop":
                status = Trial.STOPPED
                break
        assert (t.status, t.iterations) == (status, seen)
        # both workers started, and neither ran on once the trial returned
        assert len(os.listdir(os.path.join(t.trial_dir, "worker_pids"))) == 2
        with open(os.path.join(t.trial_dir, torch_jobs.WORKERS_ALIVE)) as f:
            assert json.load(f) == []
