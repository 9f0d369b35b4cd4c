"""Trial schedulers: decide continue/stop on every report (twin of
`ray_lightning_tpu/sweep/schedulers.py`, kept as the port's own copy).

The reference delegated scheduling to Ray Tune (``ASHAScheduler`` in its
examples, reference examples/ray_ddp_example.py:101-106 passes
``num_samples``/scheduler through ``tune.run``). Here every ``report()``
from a trial is routed through the scheduler, whose verdict rides back on
the same duplex channel, so a stopped trial unwinds at once (raising
``TrialStopped`` inside the trial process) and its cards go back to the
pool.
"""
from __future__ import annotations

import math
from collections import defaultdict
from typing import Dict, List, Optional

CONTINUE = "continue"
STOP = "stop"


class TrialScheduler:
    """Base: sees (trial_id, iteration, metric value), returns a verdict."""

    #: sweep-level metric/mode are injected by the runner if the scheduler
    #: was constructed without them.
    metric: Optional[str] = None
    mode: str = "min"

    def on_result(self, trial_id: str, iteration: int,
                  value: Optional[float]) -> str:
        return CONTINUE

    def on_trial_complete(self, trial_id: str) -> None:  # noqa: B027
        pass

    def _sign(self) -> float:
        # normalize so that LOWER is always better internally
        return 1.0 if self.mode == "min" else -1.0


class FIFOScheduler(TrialScheduler):
    """No early stopping: every trial runs to its own completion."""


class ASHAScheduler(TrialScheduler):
    """Asynchronous Successive Halving (stopping variant).

    Rungs at ``grace_period * reduction_factor**k`` up to ``max_t``. When a
    trial reaches a rung it records its metric there; it continues only if
    it is in the top ``1/reduction_factor`` of everything recorded at that
    rung so far. Asynchronous: decisions never wait for stragglers, so
    cards freed by a stopped trial go straight back into the pool.
    """

    def __init__(self, metric: Optional[str] = None, mode: str = "min",
                 max_t: int = 100, grace_period: int = 1,
                 reduction_factor: int = 3):
        if reduction_factor < 2:
            raise ValueError("reduction_factor must be >= 2")
        self.metric = metric
        self.mode = mode
        self.max_t = max_t
        self.grace_period = max(1, grace_period)
        self.rf = reduction_factor
        self.milestones: List[int] = []
        t = self.grace_period
        while t < max_t:
            self.milestones.append(t)
            t *= self.rf
        # rung milestone -> recorded (sign*value) list
        self._rungs: Dict[int, List[float]] = defaultdict(list)
        self._recorded: Dict[str, set] = defaultdict(set)

    def on_result(self, trial_id: str, iteration: int,
                  value: Optional[float]) -> str:
        if value is None or math.isnan(value):
            return CONTINUE
        s = self._sign() * float(value)
        for m in self.milestones:
            if iteration >= m and m not in self._recorded[trial_id]:
                self._recorded[trial_id].add(m)
                rung = self._rungs[m]
                rung.append(s)
                if len(rung) < self.rf:
                    continue  # not enough evidence at this rung yet
                k = max(1, len(rung) // self.rf)
                cutoff = sorted(rung)[k - 1]
                if s > cutoff:
                    return STOP
        return CONTINUE


class MedianStoppingRule(TrialScheduler):
    """Stop a trial whose running average is worse than the median of the
    other trials' running averages (after ``grace_period`` iterations and
    ``min_samples`` peer trials)."""

    def __init__(self, metric: Optional[str] = None, mode: str = "min",
                 grace_period: int = 1, min_samples: int = 3):
        self.metric = metric
        self.mode = mode
        self.grace_period = max(1, grace_period)
        self.min_samples = min_samples
        self._sums: Dict[str, float] = defaultdict(float)
        self._counts: Dict[str, int] = defaultdict(int)

    def _running_avg(self, trial_id: str) -> float:
        return self._sums[trial_id] / max(1, self._counts[trial_id])

    def on_result(self, trial_id: str, iteration: int,
                  value: Optional[float]) -> str:
        if value is None or math.isnan(value):
            return CONTINUE
        self._sums[trial_id] += self._sign() * float(value)
        self._counts[trial_id] += 1
        if iteration < self.grace_period:
            return CONTINUE
        peers = [self._running_avg(t) for t in self._counts if t != trial_id]
        if len(peers) < self.min_samples:
            return CONTINUE
        median = sorted(peers)[len(peers) // 2]
        if self._running_avg(trial_id) > median:
            return STOP
        return CONTINUE
