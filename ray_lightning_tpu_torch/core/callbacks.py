"""Callback bus (twin of `ray_lightning_tpu/core/callbacks.py`): the
`Callback` base, `EarlyStopping` and `ProgressLogger`. `ModelCheckpoint`
waits for checkpoint/io (ROADMAP Queue 1 item 5).
"""
from __future__ import annotations

import logging
import math
from typing import Any, Dict

import numpy as np

log = logging.getLogger(__name__)


class Callback:
    def on_fit_start(self, trainer, module) -> None: ...
    def on_fit_end(self, trainer, module) -> None: ...
    def on_train_epoch_start(self, trainer, module) -> None: ...

    def on_train_batch_start(self, trainer, module, batch,
                             batch_idx: int):
        """Before the step runs. Return a (device) batch to REPLACE the
        one about to be trained on, or None to leave it."""
        return None

    def on_train_batch_end(self, trainer, module, metrics: Dict[str, Any],
                           batch_idx: int) -> None: ...
    def on_train_epoch_end(self, trainer, module) -> None: ...
    def on_validation_epoch_end(self, trainer, module,
                                metrics: Dict[str, Any]) -> None: ...
    def on_exception(self, trainer, module, exc: BaseException) -> None: ...


class EarlyStopping(Callback):
    """Stop when `monitor` stops improving (PTL-compatible surface)."""

    def __init__(self, monitor: str = "val_loss", patience: int = 3,
                 mode: str = "min", min_delta: float = 0.0):
        assert mode in ("min", "max")
        self.monitor = monitor
        self.patience = patience
        self.mode = mode
        self.min_delta = min_delta
        self.best = math.inf if mode == "min" else -math.inf
        self.wait = 0

    def _improved(self, value: float) -> bool:
        if self.mode == "min":
            return value < self.best - self.min_delta
        return value > self.best + self.min_delta

    def _check(self, trainer, metrics: Dict[str, Any]) -> None:
        if self.monitor not in metrics:
            return
        value = float(metrics[self.monitor])
        if self._improved(value):
            self.best = value
            self.wait = 0
        else:
            self.wait += 1
            if self.wait >= self.patience:
                log.info("EarlyStopping: %s=%g (best %g), stopping",
                         self.monitor, value, self.best)
                trainer.should_stop = True

    def on_validation_epoch_end(self, trainer, module, metrics) -> None:
        self._check(trainer, metrics)

    def on_train_epoch_end(self, trainer, module) -> None:
        if not trainer.has_validation:
            self._check(trainer, trainer.callback_metrics)


class ProgressLogger(Callback):
    """Console progress: the host metrics every ``log_every_n_steps``."""

    def __init__(self, log_every_n_steps: int = 50):
        self.every = max(1, log_every_n_steps)

    def on_train_batch_end(self, trainer, module, metrics, batch_idx) -> None:
        if trainer.global_step % self.every == 0:
            pretty = {k: (f"{float(v):.4g}" if np.ndim(v) == 0 else "…")
                      for k, v in metrics.items()}
            log.info("epoch %d step %d %s", trainer.current_epoch,
                     trainer.global_step, pretty)
