"""Experiment results: per-trial records and best-of queries (twin of
`ray_lightning_tpu/sweep/analysis.py`).

The surface the reference's tests consume from Ray Tune's
``ExperimentAnalysis``: ``analysis.best_config`` and
``analysis.best_checkpoint`` (reference tests/test_tune.py:44-45,60-74),
trial dataframes (reference examples/ray_ddp_example.py:114).
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional


class Trial:
    PENDING = "pending"
    RUNNING = "running"
    DONE = "done"
    STOPPED = "stopped"   # early-stopped by the scheduler
    ERROR = "error"

    def __init__(self, trial_id: str, config: Dict[str, Any], trial_dir: str,
                 resources=None):
        self.trial_id = trial_id
        self.config = config
        self.trial_dir = trial_dir
        self.resources = resources
        self.status = Trial.PENDING
        self.history: List[Dict[str, Any]] = []
        self.last_result: Dict[str, Any] = {}
        self.checkpoints: List[str] = []   # registered paths, append order
        self.error: Optional[str] = None
        self.result: Any = None            # trainable's return value
        self.restarts = 0                  # trial-level retries performed
        #                                    (sweep retry_policy; resumes
        #                                    from last_checkpoint)

    @property
    def iterations(self) -> int:
        return len(self.history)

    @property
    def last_checkpoint(self) -> Optional[str]:
        return self.checkpoints[-1] if self.checkpoints else None

    def metric_value(self, metric: str, mode: str = "min",
                     scope: str = "last") -> Optional[float]:
        if scope == "last":
            v = self.last_result.get(metric)
            return float(v) if v is not None else None
        vals = [float(h[metric]) for h in self.history if metric in h]
        if not vals:
            return None
        return min(vals) if mode == "min" else max(vals)

    def __repr__(self) -> str:
        return (f"Trial({self.trial_id}, status={self.status}, "
                f"iters={self.iterations}, config={self.config})")


class ExperimentAnalysis:
    def __init__(self, trials: List[Trial], metric: Optional[str],
                 mode: str = "min"):
        self.trials = trials
        self.default_metric = metric
        self.default_mode = mode

    # ----------------------------------------------------------- queries
    def _pick(self, metric: Optional[str], mode: Optional[str],
              scope: str) -> Optional[Trial]:
        metric = metric or self.default_metric
        mode = mode or self.default_mode
        if metric is None:
            raise ValueError("no metric given and no sweep-level default")
        best: Optional[Trial] = None
        best_v = math.inf
        sign = 1.0 if mode == "min" else -1.0
        for t in self.trials:
            if t.status == Trial.ERROR:
                continue
            v = t.metric_value(metric, mode, scope)
            if v is None or math.isnan(v):
                continue
            if sign * v < best_v:
                best_v = sign * v
                best = t
        return best

    def get_best_trial(self, metric: Optional[str] = None,
                       mode: Optional[str] = None,
                       scope: str = "last") -> Optional[Trial]:
        return self._pick(metric, mode, scope)

    @property
    def best_trial(self) -> Optional[Trial]:
        return self.get_best_trial()

    @property
    def best_config(self) -> Optional[Dict[str, Any]]:
        t = self.get_best_trial()
        return t.config if t else None

    @property
    def best_checkpoint(self) -> Optional[str]:
        t = self.get_best_trial()
        return t.last_checkpoint if t else None

    @property
    def results(self) -> Dict[str, Dict[str, Any]]:
        return {t.trial_id: t.last_result for t in self.trials}

    def dataframe(self) -> List[Dict[str, Any]]:
        """One flat record per trial (a list of dicts rather than a hard
        pandas dependency; ``pandas.DataFrame(analysis.dataframe())`` works
        verbatim if pandas is available)."""
        rows = []
        for t in self.trials:
            row = {"trial_id": t.trial_id, "status": t.status,
                   "iterations": t.iterations,
                   "checkpoint": t.last_checkpoint}
            row.update({f"config/{k}": v for k, v in t.config.items()})
            row.update(t.last_result)
            rows.append(row)
        return rows

    def errors(self) -> Dict[str, str]:
        return {t.trial_id: t.error for t in self.trials
                if t.status == Trial.ERROR}
