"""Failure taxonomy and retry policy (twin of
`ray_lightning_tpu/resilience/policy.py`, kept as the port's own copy).

Classification answers ONE question: is restarting the failed work and
resuming from the latest valid checkpoint going to help? Four answers:

  RETRYABLE  — infrastructure flaked (a worker process vanished with a
               nonzero rc, a stall or timeout, a collective peer or link
               that died: gloo's transport errors, NCCL's errors and its
               watchdog's collective timeout). The SAME job on the SAME
               data is expected to succeed; restart within the budget.
  PREEMPTION — the platform is reclaiming capacity (SIGTERM on a
               worker, a PreemptedError drain). Also restartable, but
               counted separately: a preemption storm is capacity
               pressure, not a bug.
  CORRUPTION — a trainguard escalation (anomaly streak or a silent-data-
               corruption verdict), matched by exception name. Restartable
               from the last *blessed* checkpoint, from its own small
               ``max_rollbacks`` budget. The port's trainguard raises
               them: `resilience.guard`'s ``TrainingAnomalyError`` and
               its subclass ``SDCDetectedError``, which
               ``_CORRUPTION_MARKERS`` matches by name.
  FATAL      — a deterministic Python exception in user/model code (a
               shape error, an assert), and the card's own verdicts on the
               program: ``CUDA error: ...`` (an illegal address, a bad
               launch) and ``CUDA out of memory``. Restarting replays the
               same failure and burns the budget; fail fast.

This module is stdlib only (no torch, no package imports), so the
runtime and the sweep import it without cycles. ``WorkerError``
(runtime/group.py) is matched structurally: class name plus the
``rank``/``cause``/``signal_name``/``exit_code`` attributes it carries.
The marker table keeps the JAX package's entries, so both packages
classify a shared message alike, and adds NCCL's.
"""
from __future__ import annotations

import dataclasses
import random
from typing import Optional


class FailureKind:
    RETRYABLE = "retryable"
    PREEMPTION = "preemption"
    CORRUPTION = "corruption"
    FATAL = "fatal"


class StallError(RuntimeError):
    """A worker's heartbeat channel went silent past the stall budget
    (health.HealthMonitor) — the process is hung, not compiling.

    ``phase``/``step`` come from the last heartbeat's telemetry payload
    (the worker's current span phase): the report upgrades from "hung"
    to "hung in <phase> at step N" — the difference between rebooting a
    pod and knowing to look at the checkpoint filesystem."""

    def __init__(self, rank: int, silent_s: float, detail: str = "",
                 phase: str = "", step: int = -1):
        self.rank = rank
        self.silent_s = silent_s
        self.phase = phase
        self.step = step
        msg = (f"worker rank {rank} sent no heartbeat for "
               f"{silent_s:.0f}s (channel silent — hung, not compiling)")
        if phase:
            msg += (f"; last reported doing {phase!r}"
                    + (f" at step {step}" if step >= 0 else ""))
        if detail:
            msg += f": {detail}"
        super().__init__(msg)


#: traceback / message markers that mean the *infrastructure* failed —
#: the job itself never got a verdict. Matched case-sensitively against
#: the worker traceback or the exception text.
_RETRYABLE_MARKERS = (
    "UNAVAILABLE",            # jaxlib XlaRuntimeError: UNAVAILABLE
    "DEADLINE_EXCEEDED",
    "coordinator",            # jax.distributed rendezvous failures
    "Connection reset",
    "Connection refused",
    "Connection closed by peer",  # a collective PEER died mid-op — the
    #                             surviving rank's view of another
    #                             rank's death (gloo surfaces it as
    #                             FAILED_PRECONDITION, not UNAVAILABLE);
    #                             which rank's failure reaches the
    #                             driver first is a race, and both views
    #                             must classify the same way (observed:
    #                             the kill-drill gate flaking FATAL when
    #                             the survivor's error won)
    "gloo/transport",         # gloo TRANSPORT-layer failures (tcp pair
    #                           resets, timeouts — the source path
    #                           appears in the message) = peer/link
    #                           loss; deliberately NOT a blanket "gloo"
    #                           marker, which would relabel a
    #                           deterministic bug raising through a
    #                           collective as infrastructure
    "Timed out waiting for clients",  # gloo rendezvous: peers never came
    "BrokenPipeError",
    "backend unavailable",
    "heartbeat",
    # NCCL's view of a peer or link that died: the error codes it raises
    # and the process-group watchdog's timeout on a collective
    "NCCL error",
    "ncclRemoteError",
    "ncclSystemError",
    "collective operation timeout",
)

#: the card's verdicts on the program itself (an illegal address, a
#: refused launch, an allocation past the card's memory): deterministic,
#: so FATAL even where a retryable marker also appears in the text
_FATAL_MARKERS = ("CUDA error:", "CUDA out of memory")

#: preemption markers: our own drain exception, plus the signals a
#: platform reclaim delivers. SIGKILL is deliberately NOT here: a
#: platform preemption announces itself with SIGTERM first; a bare
#: SIGKILL is the OOM killer or a hard host failure — restartable, but
#: drawn from the BOUNDED restart budget (a deterministic memory
#: overrun must not get max_preemptions' worth of futile replays).
_PREEMPT_MARKERS = ("PreemptedError", "preemption notice")

_PREEMPT_SIGNALS = ("SIGTERM", "SIGINT", "SIGHUP", "SIGQUIT")

#: trainguard escalation markers (resilience/guard.py): the exception
#: NAMES are the cross-process protocol — they appear verbatim in the
#: worker traceback when a rank unwinds on an anomaly-streak or SDC
#: verdict. SDCDetectedError subclasses TrainingAnomalyError, so order
#: matters: match the more specific name first for the cause slug.
_CORRUPTION_MARKERS = ("SDCDetectedError", "TrainingAnomalyError",
                       "silent data corruption",
                       "training anomaly escalation")


def _corruption_cause(text: str) -> str:
    return "sdc" if ("SDCDetectedError" in text
                     or "silent data corruption" in text) else \
        "anomaly-streak"


@dataclasses.dataclass(frozen=True)
class FailureClass:
    """One classified failure: the verdict plus what the operator reads."""

    kind: str                    # FailureKind.*
    cause: str                   # short slug, e.g. "worker-signal:SIGKILL"
    rank: Optional[int] = None   # failing rank when known
    detail: str = ""             # first line of the underlying error

    @property
    def restartable(self) -> bool:
        return self.kind != FailureKind.FATAL

    def to_dict(self) -> dict:
        return {"kind": self.kind, "cause": self.cause, "rank": self.rank,
                "detail": self.detail}


def _first_line(exc: BaseException) -> str:
    text = str(exc).strip()
    return text.splitlines()[0][:300] if text else type(exc).__name__


def _worker_detail(exc: BaseException) -> str:
    """For a WorkerError: the last non-empty traceback line — the actual
    exception repr — not the boilerplate first line."""
    tb = (getattr(exc, "traceback_str", "") or "").strip()
    lines = [ln for ln in tb.splitlines() if ln.strip()]
    return lines[-1][:300] if lines else _first_line(exc)


def _looks_like_worker_error(exc: BaseException) -> bool:
    # structural match (import-light: see module docstring)
    return (type(exc).__name__ == "WorkerError"
            and hasattr(exc, "rank") and hasattr(exc, "traceback_str"))


def classify_failure(exc: BaseException) -> FailureClass:
    """Map an exception from a supervised run to a FailureClass."""
    name = type(exc).__name__
    text = str(exc)

    if _looks_like_worker_error(exc):
        rank = getattr(exc, "rank", None)
        cause = getattr(exc, "cause", "exception")
        signame = getattr(exc, "signal_name", None)
        tb = getattr(exc, "traceback_str", "") or ""
        if signame in _PREEMPT_SIGNALS or any(
                m in tb for m in _PREEMPT_MARKERS):
            return FailureClass(
                FailureKind.PREEMPTION,
                f"worker-signal:{signame}" if signame else "worker-preempt",
                rank, _worker_detail(exc))
        if cause in ("exit", "signal"):
            # the process vanished without returning a Python verdict —
            # infra (OOM-killer, node loss, a crashed runtime)
            slug = (f"worker-signal:{signame}" if signame
                    else f"worker-exit:{getattr(exc, 'exit_code', None)}")
            return FailureClass(FailureKind.RETRYABLE, slug, rank,
                                _worker_detail(exc))
        if any(m in tb for m in _CORRUPTION_MARKERS):
            # the trainguard unwound this rank on purpose: restart is a
            # ROLLBACK (blessed checkpoint + data-order advance), not a
            # replay of the latest one
            return FailureClass(FailureKind.CORRUPTION,
                                _corruption_cause(tb), rank,
                                _worker_detail(exc))
        if any(m in tb for m in _FATAL_MARKERS):
            return FailureClass(FailureKind.FATAL, "worker-cuda", rank,
                                _worker_detail(exc))
        if any(m in tb for m in _RETRYABLE_MARKERS):
            return FailureClass(FailureKind.RETRYABLE, "worker-backend",
                                rank, _worker_detail(exc))
        # a real Python traceback out of user/model code: deterministic
        return FailureClass(FailureKind.FATAL, "worker-exception", rank,
                            _worker_detail(exc))

    if name in ("TrainingAnomalyError", "SDCDetectedError") or any(
            m in text for m in _CORRUPTION_MARKERS):
        return FailureClass(FailureKind.CORRUPTION,
                            _corruption_cause(f"{name} {text}"), None,
                            _first_line(exc))
    if any(m in text for m in _FATAL_MARKERS):
        return FailureClass(FailureKind.FATAL, f"cuda:{name}", None,
                            _first_line(exc))
    if isinstance(exc, StallError):
        return FailureClass(FailureKind.RETRYABLE, "stall",
                            getattr(exc, "rank", None), _first_line(exc))
    if isinstance(exc, TimeoutError):
        return FailureClass(FailureKind.RETRYABLE, "timeout", None,
                            _first_line(exc))
    if name == "PreemptedError" or any(m in text for m in _PREEMPT_MARKERS):
        return FailureClass(FailureKind.PREEMPTION, "preempt", None,
                            _first_line(exc))
    if name == "BackendUnavailable":
        # a bounded init-retry already spent its budget getting here;
        # the caller may still carry a restart budget of its own
        return FailureClass(FailureKind.RETRYABLE, "backend-unavailable",
                            None, _first_line(exc))
    if isinstance(exc, (ConnectionError, EOFError, OSError)):
        return FailureClass(FailureKind.RETRYABLE, "connection", None,
                            _first_line(exc))
    if any(m in text for m in _RETRYABLE_MARKERS):
        return FailureClass(FailureKind.RETRYABLE, "backend", None,
                            _first_line(exc))
    return FailureClass(FailureKind.FATAL, f"exception:{name}", None,
                        _first_line(exc))


@dataclasses.dataclass
class RetryPolicy:
    """Capped exponential backoff + a restart budget.

    ``max_restarts`` bounds TOTAL restarts across the run (attempt 0 is
    the original launch). ``preemptions_count`` controls whether
    PREEMPTION failures draw from the budget — on a preemptible pool a
    nightly run may legitimately be preempted dozens of times, so the
    default excludes them (bounded instead by ``max_preemptions``).
    """

    max_restarts: int = 3
    backoff_base_s: float = 2.0
    backoff_factor: float = 2.0
    backoff_max_s: float = 60.0
    jitter: float = 0.1          # +- fraction of the delay
    preemptions_count: bool = False
    max_preemptions: int = 100
    #: CORRUPTION rollbacks (trainguard escalations) get their own small
    #: budget: each one rewinds real progress to the last blessed
    #: checkpoint, so unlike preemptions they must stay rare — and a run
    #: that keeps corrupting is hardware begging to be drained, not
    #: restarted forever.
    max_rollbacks: int = 2

    def next_delay(self, restart_idx: int) -> float:
        """Delay before restart number ``restart_idx`` (1-based)."""
        exp = self.backoff_base_s * (
            self.backoff_factor ** max(0, restart_idx - 1))
        delay = min(self.backoff_max_s, exp)
        if self.jitter:
            delay *= 1.0 + random.uniform(-self.jitter, self.jitter)
        return max(0.0, delay)

    def allows(self, restarts: int, preemptions: int,
               failure: FailureClass, rollbacks: int = 0) -> bool:
        """True when one more restart is within budget for ``failure``.
        ``restarts``/``preemptions``/``rollbacks`` are the counts
        performed so far, tracked separately by the supervisor."""
        if not failure.restartable:
            return False
        if failure.kind == FailureKind.CORRUPTION:
            return rollbacks < self.max_rollbacks
        if failure.kind == FailureKind.PREEMPTION:
            if self.preemptions_count:
                # preemptions draw from the shared budget: count BOTH
                # tallies against it (the supervisor increments only
                # `preemptions` for this kind)
                return restarts + preemptions < self.max_restarts
            return preemptions < self.max_preemptions
        return restarts < self.max_restarts
