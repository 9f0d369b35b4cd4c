"""Callback bus (twin of `ray_lightning_tpu/core/callbacks.py`): the
`Callback` base, `EarlyStopping`, `ModelCheckpoint` and `ProgressLogger`.

In a multi-process job every rank runs the same callbacks on the same
metrics (the trainer reduces them across ranks first), so every rank
takes the same decisions: each enters every checkpoint save, which is
collective, and stops at the same step. Rank 0 alone writes meta.json
and removes pruned checkpoints. `ThroughputMonitor` and `MemoryMonitor`
are not ported yet (ROADMAP Queue 1 item 2).
"""
from __future__ import annotations

import json
import logging
import math
import os
import shutil
from typing import Any, Dict, Optional

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
    def on_save_checkpoint(self, trainer, module, checkpoint: dict) -> None: ...
    def on_load_checkpoint(self, trainer, module, checkpoint: dict) -> None: ...
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


class ModelCheckpoint(Callback):
    """Track-and-save the best (and/or last) checkpoint.

    After fit, `best_model_path` is readable on every rank, and
    `fit_distributed` returns rank 0's to the driver (the reference
    shipped this string from worker rank 0, ray_ddp.py:186-193).
    """

    def __init__(self, dirpath: Optional[str] = None,
                 monitor: Optional[str] = None, mode: str = "min",
                 save_top_k: int = 1, save_last: bool = False,
                 every_n_epochs: int = 1,
                 every_n_train_steps: Optional[int] = None,
                 filename: str = "epoch={epoch}",
                 async_save: bool = False):
        self.dirpath = dirpath
        self.monitor = monitor
        self.mode = mode
        self.save_top_k = save_top_k
        self.save_last = save_last
        self.every_n_epochs = max(1, every_n_epochs)
        #: step-based cadence; saves are unmonitored at step boundaries
        #: (metrics lag validation)
        self.every_n_train_steps = every_n_train_steps
        self.filename = filename
        #: stream the disk write in the background (checkpoint/io.py
        #: block=False); the Trainer joins in-flight writes at fit end
        self.async_save = async_save
        self.best_model_path: str = ""
        self.best_model_score: Optional[float] = None
        self.last_model_path: str = ""
        self._saved: list[tuple[float, str]] = []  # (score, path)

    def _resolve_dir(self, trainer) -> str:
        d = self.dirpath or os.path.join(trainer.default_root_dir,
                                         "checkpoints")
        os.makedirs(d, exist_ok=True)
        return d

    def _score(self, metrics: Dict[str, Any]) -> Optional[float]:
        if self.monitor is None or self.monitor not in metrics:
            return None
        return float(metrics[self.monitor])

    def _maybe_save(self, trainer, module, metrics: Dict[str, Any],
                    step_based: bool = False) -> None:
        if (not step_based
                and trainer.current_epoch % self.every_n_epochs != 0):
            return
        d = self._resolve_dir(trainer)
        name = self.filename.format(epoch=trainer.current_epoch,
                                    step=trainer.global_step)
        if step_based and "{step" not in self.filename:
            name = f"step={trainer.global_step}"
        elif (not step_based and trainer.val_check_interval
                and "{step" not in self.filename):
            # mid-epoch validation saves several times an epoch
            name = f"{name}-step={trainer.global_step}"
        path = os.path.join(d, name)
        if step_based:
            # step cadence ignores `monitor`: recency-tracked like the
            # unmonitored path, pruned to save_top_k
            self._dedupe(path)
            trainer.save_checkpoint(path, block=not self.async_save)
            self.best_model_path = path
            if self.save_last:
                self.last_model_path = path
            self._saved.append((-float(trainer.global_step), path))
            self._prune(trainer)
            return
        score = self._score(metrics)
        if self.monitor is not None and score is None:
            return  # monitored metric absent this epoch
        self._dedupe(path)
        trainer.save_checkpoint(path, block=not self.async_save)
        if self.save_last:
            self.last_model_path = path
        if self.monitor is None:
            # unmonitored: "best" is the most recent; prune to save_top_k
            self.best_model_path = path
            self._saved.append((-float(trainer.global_step), path))
            self._prune(trainer)
            return
        sign = 1.0 if self.mode == "min" else -1.0
        self._saved.append((sign * score, path))
        if (self.best_model_score is None
                or sign * score < sign * self.best_model_score):
            self.best_model_score = score
            self.best_model_path = path
        self._prune(trainer)

    def _dedupe(self, path: str) -> None:
        # re-saving a path replaces its _saved entry
        self._saved = [(s, p) for s, p in self._saved if p != path]

    def _prune(self, trainer=None) -> None:
        """Keep the ``save_top_k`` best; the best and last paths are
        never removed. Every rank keeps the same book; rank 0 alone
        removes the directories."""
        if self.save_top_k <= 0:
            return
        self._saved.sort(key=lambda t: t[0])
        keep = self._saved[: self.save_top_k]
        if trainer is None or trainer.strategy.is_global_zero:
            for _, stale_path in self._saved[self.save_top_k:]:
                if stale_path not in (self.best_model_path,
                                      self.last_model_path):
                    _remove_checkpoint(stale_path)
        self._saved = keep

    def on_train_batch_end(self, trainer, module, metrics, batch_idx) -> None:
        if (self.every_n_train_steps
                and trainer.global_step % self.every_n_train_steps == 0):
            self._maybe_save(trainer, module, trainer.callback_metrics,
                             step_based=True)

    def on_validation_epoch_end(self, trainer, module, metrics) -> None:
        # cadences are mutually exclusive (PTL semantics): a step-based
        # checkpoint never also saves at epoch boundaries
        if not self.every_n_train_steps:
            self._maybe_save(trainer, module, metrics)

    def on_train_epoch_end(self, trainer, module) -> None:
        if not trainer.has_validation and not self.every_n_train_steps:
            self._maybe_save(trainer, module, trainer.callback_metrics)


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


def _ckpt_meta(path: str):
    """(blessed, global_step) from a checkpoint's meta.json: the blessing
    is True/False when stamped, None when absent or unreadable. An
    in-flight async save whose meta.json has not landed yet is resolved
    from this process's deferred-meta queue."""
    try:
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
    except (OSError, ValueError):
        from ray_lightning_tpu_torch.checkpoint.io import pending_meta_for

        meta = pending_meta_for(path)
        if meta is None:
            return None, None
    blessed = meta.get("blessed")
    try:
        step = int(meta.get("global_step"))
    except (TypeError, ValueError):
        step = None
    return (None if blessed is None else bool(blessed)), step


def _ckpt_blessed(path: str):
    return _ckpt_meta(path)[0]


def _remove_checkpoint(path: str) -> None:
    """Delete a pruned checkpoint dir, safely against in-flight async
    writes: if its state write is still streaming, join it first."""
    from ray_lightning_tpu_torch.checkpoint.io import (
        discard_pending_meta,
        wait_for_checkpoints,
    )

    if discard_pending_meta(path):
        try:
            wait_for_checkpoints()
        except Exception:  # noqa: BLE001 — the failure is logged; the
            # failed write's meta was already dropped
            log.exception("async checkpoint write failed during prune")
    try:
        if os.path.isdir(path):
            shutil.rmtree(path)
        elif os.path.exists(path):
            os.remove(path)
    except OSError:
        pass
