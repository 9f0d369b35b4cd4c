"""Resilience: supervised training over the runtime (twin of
`ray_lightning_tpu/resilience/`).

The reference left every fault to Ray's actor restarts; the port's
runtime (runtime/group.py, runtime/fit.py) detects a dead worker and
raises. This package is the supervision layer between the driver API and
the worker group:

  * policy.py     — failure taxonomy (RETRYABLE / PREEMPTION / CORRUPTION
                    / FATAL) and RetryPolicy (capped exponential backoff,
                    restart budgets); stdlib only.
  * supervisor.py — supervise() / fit_supervised(): tear down, relaunch,
                    resume from the latest VALID checkpoint through the
                    trainer's mid-epoch resume.
  * preempt.py    — SIGTERM -> flag-only handler -> emergency checkpoint
                    and drain at the next batch boundary.
  * health.py     — per-worker heartbeats over the side channel and a
                    stall watchdog that tells a slow worker from a hung
                    one.
  * faults.py     — deterministic fault injection (kill rank R at step N,
                    preempt, hang, corrupt the latest checkpoint, poison a
                    batch, flip a parameter bit on one rank) through
                    RLT_FAULTS, so every path runs on the CPU.
  * guard.py      — trainguard: the on-device anomaly skip (a fused
                    optimizer's ``found_inf``), escalation to rollbacks
                    from the last blessed checkpoint, and a cadenced
                    parameter-fingerprint probe that catches silent data
                    corruption and quarantines the divergent rank.

Surfaces: ``fit_distributed(..., resilience=ResilienceConfig(...))``,
``Trainer(guard=...)``, ``python -m ray_lightning_tpu_torch supervise``,
and the sweep's trial retry (``sweep.run(..., retry_policy=...)``).
"""
from ray_lightning_tpu_torch.resilience.policy import (
    FailureClass,
    FailureKind,
    RetryPolicy,
    StallError,
    classify_failure,
)
from ray_lightning_tpu_torch.resilience.preempt import (
    PreemptedError,
    PreemptionGuard,
    install_preemption_handlers,
    preemption_requested,
    reset_preemption,
)
from ray_lightning_tpu_torch.resilience.health import (
    HEARTBEAT_KIND,
    HealthMonitor,
    HeartbeatCallback,
)
from ray_lightning_tpu_torch.resilience.faults import (
    Fault,
    FaultInjector,
    corrupt_checkpoint,
    parse_faults,
)
from ray_lightning_tpu_torch.resilience.guard import (
    GuardCallback,
    GuardConfig,
    GuardState,
    SDCDetectedError,
    TrainingAnomalyError,
)
from ray_lightning_tpu_torch.resilience.supervisor import (
    ResilienceConfig,
    RestartBudgetExceeded,
    SupervisedFailure,
    SupervisedResult,
    fit_supervised,
    supervise,
)

__all__ = [
    "FailureClass",
    "FailureKind",
    "RetryPolicy",
    "StallError",
    "classify_failure",
    "PreemptedError",
    "PreemptionGuard",
    "install_preemption_handlers",
    "preemption_requested",
    "reset_preemption",
    "HEARTBEAT_KIND",
    "HealthMonitor",
    "HeartbeatCallback",
    "Fault",
    "FaultInjector",
    "corrupt_checkpoint",
    "parse_faults",
    "GuardCallback",
    "GuardConfig",
    "GuardState",
    "SDCDetectedError",
    "TrainingAnomalyError",
    "ResilienceConfig",
    "RestartBudgetExceeded",
    "SupervisedFailure",
    "SupervisedResult",
    "fit_supervised",
    "supervise",
]
