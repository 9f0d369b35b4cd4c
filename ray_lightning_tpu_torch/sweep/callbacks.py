"""Sweep-aware trainer callbacks: report metrics, register checkpoints
(twin of `ray_lightning_tpu/sweep/callbacks.py`).

The reference's Tune callbacks (reference tune.py:26-199):

  * TuneReportCallback — maps ``trainer.callback_metrics`` to report names
    (str / list / dict forms, reference tune.py:68-95) and sends them to
    the sweep scheduler from worker rank 0.
  * TuneReportCheckpointCallback — checkpoint, then report, so the sweep
    registers the checkpoint with the metrics (reference tune.py:144-199).

Transport:
  * a trainer running in the trial process reports directly on the duplex
    channel and blocks for the verdict;
  * a trainer running in a nested `fit_distributed` worker has rank 0 put
    a report on the runtime's side channel (the reference's trampoline,
    util.py:88-93); the trial process's pump runs it, and a stop verdict
    unwinds the pump, which shuts the worker group down. The item crosses
    by the standard pickle, so it is a ``functools.partial`` of
    `session.report`, not a lambda.
  * checkpoints are written in place by the trial and only their PATH is
    reported, never the state through the channel.
"""
from __future__ import annotations

import functools
import logging
import os
from typing import Any, Dict, List, Optional, Union

from ray_lightning_tpu_torch.core.callbacks import (
    Callback,
    _remove_checkpoint,
)
from ray_lightning_tpu_torch.runtime import session as runtime_session
from ray_lightning_tpu_torch.sweep import session as trial_session

log = logging.getLogger(__name__)


def _dispatch_report(report: Dict[str, Any],
                     checkpoint: Optional[str] = None) -> None:
    """Route a report to the sweep driver from wherever we are running.

    trial process  -> direct duplex report (blocks for the verdict);
    nested worker  -> rank 0 puts the report on the side channel; the
                      trial's pump runs it and the verdict unwinds there;
    no sweep       -> no-op (the trainer works unchanged outside sweeps,
                      like the reference's is_session_enabled() fallback,
                      reference tune.py:14-22).
    """
    if trial_session.is_trial_session_enabled():
        trial_session.report(report, checkpoint=checkpoint)
    elif runtime_session.is_session_enabled():
        if runtime_session.get_actor_rank() == 0:
            runtime_session.put_queue(functools.partial(
                trial_session.report, report, checkpoint=checkpoint))
    else:
        log.debug("report outside any sweep session: %s", report)


class TuneReportCallback(Callback):
    """Report trainer metrics to the sweep on a cadence.

    ``metrics`` forms (reference tune.py:41-66):
      None         — report all of trainer.callback_metrics;
      "loss"       — report that one, under its own name;
      ["a", "b"]   — report those;
      {"out": "in"}— report trainer metric "in" under name "out".
    ``on`` — "validation_end" (default) or "train_epoch_end".
    """

    def __init__(
        self,
        metrics: Union[None, str, List[str], Dict[str, str]] = None,
        on: str = "validation_end",
    ):
        if on not in ("validation_end", "train_epoch_end"):
            raise ValueError(f"unsupported report point {on!r}")
        self.metrics = metrics
        self.on = on

    def _collect(self, trainer,
                 extra: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        source = dict(trainer.callback_metrics)
        source.update(extra or {})
        if self.metrics is None:
            items = dict(source)
        elif isinstance(self.metrics, str):
            items = {self.metrics: source.get(self.metrics)}
        elif isinstance(self.metrics, dict):
            items = {out: source.get(src) for out, src in self.metrics.items()}
        else:
            items = {m: source.get(m) for m in self.metrics}
        report = {}
        for k, v in items.items():
            if v is None:
                continue
            try:
                report[k] = float(v)
            except (TypeError, ValueError):
                pass  # non-scalar metrics don't cross the channel
        return report

    def _fire(self, trainer, extra=None) -> None:
        report = self._collect(trainer, extra)
        if report:
            _dispatch_report(report, checkpoint=self._checkpoint(trainer))

    def _checkpoint(self, trainer) -> Optional[str]:
        return None  # overridden by the checkpointing variant

    def on_validation_epoch_end(self, trainer, module, metrics) -> None:
        if self.on == "validation_end":
            self._fire(trainer, extra=metrics)

    def on_train_epoch_end(self, trainer, module) -> None:
        if self.on == "train_epoch_end" or (
            self.on == "validation_end" and not trainer.has_validation
        ):
            self._fire(trainer)


class TuneReportCheckpointCallback(TuneReportCallback):
    """Checkpoint, then report (reference tune.py:144-199 ordering, so the
    sweep registers the checkpoint alongside the metrics).

    The checkpoint lands under, in priority order: explicit ``dirpath``,
    the trial session's dir (trainer in the trial process), the
    ``RLT_TRIAL_DIR`` the trial runner exports (trainer in nested
    `fit_distributed` workers, which inherit the trial's environment),
    the trainer's root dir. Every rank writes its shards (DCP).

    ``keep_last_n`` keeps only the newest N checkpoints this callback
    wrote. The JAX callback also spares the newest trainguard-blessed one
    when every kept checkpoint is unblessed; that floor comes with the
    port's trainguard (ROADMAP Queue 1 item 10), and until then every
    checkpoint is blessed.
    """

    def __init__(
        self,
        metrics: Union[None, str, List[str], Dict[str, str]] = None,
        filename: str = "checkpoint",
        on: str = "validation_end",
        dirpath: Optional[str] = None,
        keep_last_n: Optional[int] = None,
    ):
        super().__init__(metrics=metrics, on=on)
        self.filename = filename
        self.dirpath = dirpath
        if keep_last_n is not None and keep_last_n < 1:
            raise ValueError(f"keep_last_n must be >= 1, got {keep_last_n}")
        self.keep_last_n = keep_last_n
        self._written: List[str] = []

    def _resolve_dir(self, trainer) -> str:
        if self.dirpath:
            return self.dirpath
        if trial_session.is_trial_session_enabled():
            return trial_session.get_trial_dir()
        env_dir = os.environ.get("RLT_TRIAL_DIR")
        if env_dir:
            return env_dir
        return os.path.join(trainer.default_root_dir, "sweep_checkpoints")

    def _checkpoint(self, trainer) -> Optional[str]:
        base = self._resolve_dir(trainer)
        path = os.path.join(
            base, f"{self.filename}_{trainer.global_step:08d}"
        )
        out = trainer.save_checkpoint(path)
        if self.keep_last_n is not None:
            # re-saving an existing path (a zero-step epoch writing the
            # same global_step) replaces its entry: a duplicate would let
            # the prune delete the live newest
            self._written = [p for p in self._written if p != out]
            self._written.append(out)
            self._prune(trainer)
        return out

    def _prune(self, trainer) -> None:
        """Delete this callback's oldest checkpoints beyond keep_last_n.
        Every rank keeps the same book; only rank 0 removes files, and
        only paths this callback wrote."""
        excess = len(self._written) - self.keep_last_n
        if excess <= 0:
            return
        victims, self._written = (self._written[:excess],
                                  self._written[excess:])
        if trainer.strategy.is_global_zero:
            for victim in victims:
                _remove_checkpoint(victim)
                log.info("pruned sweep checkpoint %s", victim)
