"""Resilience (twin of `ray_lightning_tpu/resilience/`): so far the
failure taxonomy and retry policy that the sweep's trial-level retry
uses (``sweep.run(..., retry_policy=RetryPolicy(...))``). The
supervisor, health, preemption, fault injection and the trainguard are
ROADMAP Queue 1 item 10.
"""
from ray_lightning_tpu_torch.resilience.policy import (
    FailureClass,
    FailureKind,
    RetryPolicy,
    StallError,
    classify_failure,
)

__all__ = [
    "FailureClass",
    "FailureKind",
    "RetryPolicy",
    "StallError",
    "classify_failure",
]
