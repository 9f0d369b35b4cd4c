"""The trainguard under supervision on the CPU (gloo processes, a small
MLP classifier under DataParallel): the JAX package's slow trainguard
drills (`tests/test_trainguard.py`). A NaN batch is skipped on the device
with no restart; a NaN streak escalates and rolls back to a blessed
checkpoint; a bit flip on rank 1 of three replicas is outvoted by the
fingerprint probe and rank 1 quarantined; and the command-line gate,
``python -m ray_lightning_tpu_torch supervise --smoke --device cpu``,
passes.
"""
from __future__ import annotations

import functools
import json
import os
import subprocess
import sys

import numpy as np

from ray_lightning_tpu_torch.resilience import (
    GuardConfig,
    ResilienceConfig,
    RetryPolicy,
    fit_supervised,
)
from ray_lightning_tpu_torch.resilience.guard import (
    QUARANTINE_FILE,
    read_rollback_marker,
)
from tests import torch_jobs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(tmp_path, name, guard, faults, processes=2, rows=64):
    starts = []
    sup = fit_supervised(
        torch_jobs.sup_module, torch_jobs.sup_trainer,
        functools.partial(torch_jobs.sup_data, rows), processes,
        resilience=ResilienceConfig(
            checkpoint_dir=str(tmp_path / name),
            policy=RetryPolicy(max_restarts=2, backoff_base_s=0.2,
                               jitter=0.0),
            save_every_n_steps=1, heartbeat_interval_s=1.0,
            stall_timeout_s=0.0, guard=guard, faults=faults),
        device="cpu", timeout=120, log_dir=str(tmp_path / f"logs_{name}"),
        return_weights=False,
        on_queue_item=lambda rank, item: starts.append(item[1]))
    return sup, starts


def test_supervise_nan_skip_no_restart(tmp_path):
    """The poisoned batch (rank 0's half of step 3) is skipped on every
    rank inside the step: no process dies, the supervisor never
    restarts."""
    sup, starts = _run(tmp_path, "nan", GuardConfig(warmup_steps=2),
                       "nan_loss:rank=0,step=3")
    assert sup.total_attempts == 1 and sup.rollbacks == 0 and starts == [0]
    assert sup.result.metrics["guard_skipped_steps"] == 1
    assert sup.result.metrics["guard_last_anomaly"] == 2
    assert np.isfinite(sup.result.metrics["loss"])


def test_supervise_corruption_rollback_from_blessed(tmp_path):
    """A NaN streak escalates (CORRUPTION), the supervisor rolls back to
    the blessed checkpoint at the marker's last-good step and the
    resumed run completes."""
    sup, starts = _run(tmp_path, "streak",
                       GuardConfig(warmup_steps=1, escalate_after=3,
                                   escalate_window=8),
                       "nan_loss:rank=0,step=4,count=6")
    assert sup.rollbacks == 1 and sup.restarts == 0
    [failure] = sup.failures
    assert (failure["kind"], failure["cause"]) == ("corruption",
                                                   "anomaly-streak")
    marker = read_rollback_marker(str(tmp_path / "streak"))
    assert marker["last_good_step"] == 3 and marker["detected_step"] == 6
    assert marker["rollbacks_performed"] == 1
    assert starts == [0, 3]
    assert os.path.isdir(tmp_path / "streak" / "step=3")
    assert sup.result.metrics["guard_rollbacks"] == 1.0
    assert np.isfinite(sup.result.metrics["loss"])


def test_supervise_bitflip_quarantines_rank1(tmp_path):
    """A bit flip on rank 1 of three replicas (a process drives one
    device, so three give a majority) is outvoted 2:1 at the next probe;
    rank 1 is quarantined in the ledger and on disk and the run resumes
    from a probe-verified checkpoint."""
    sup, starts = _run(tmp_path, "sdc", GuardConfig(sdc_every_n_steps=2),
                       "bitflip_param:rank=1,step=3", processes=3, rows=96)
    assert sup.rollbacks == 1 and sup.quarantined == [1]
    [failure] = sup.failures
    assert (failure["kind"], failure["cause"]) == ("corruption", "sdc")
    with open(tmp_path / "sdc" / QUARANTINE_FILE) as f:
        assert json.load(f)["excluded"] == [1]
    marker = read_rollback_marker(str(tmp_path / "sdc"))
    assert marker["kind"] == "sdc" and marker["quarantine"] == [1]
    assert marker["last_good_step"] == 2 and starts == [0, 2]
    digests = marker["digests"]
    assert len(digests) == 3 and digests[0] == digests[2] != digests[1]
    assert np.isfinite(sup.result.metrics["loss"])


def test_supervise_smoke_cli(tmp_path):
    """The command-line gate: a kill resumes and converges, a NaN batch
    is skipped without a restart, a bit flip quarantines its rank."""
    out = subprocess.run(
        [sys.executable, "-m", "ray_lightning_tpu_torch", "supervise",
         "--smoke", "--device", "cpu", "--json",
         "--checkpoint-dir", str(tmp_path)],
        cwd=REPO, capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["ok"] and res["attempts"] == 2
    assert res["guard_legs"]["guard_nan"]["attempts"] == 1
    assert res["guard_legs"]["guard_sdc"]["quarantined"] == [1]
