"""Callback bus (twin of `ray_lightning_tpu/core/callbacks.py`): the
`Callback` base, `EarlyStopping`, `ModelCheckpoint`, `ThroughputMonitor`,
`MemoryMonitor` and `ProgressLogger`.

In a multi-process job every rank runs the same callbacks on the same
metrics (the trainer reduces them across ranks first), so every rank
takes the same decisions: each enters every checkpoint save, which is
collective, and stops at the same step. Rank 0 alone writes meta.json
and removes pruned checkpoints.
"""
from __future__ import annotations

import json
import logging
import math
import os
import shutil
import time
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
        removes the directories.

        Retention floor (trainguard): a corruption rollback needs a
        checkpoint that is explicitly blessed (not saved inside an
        anomaly window; an absent or unreadable blessing reads as "not
        known good") and, with the SDC probe armed, at or below the last
        probe-VERIFIED step (a bit flip is silent, so newer checkpoints
        are blessed yet possibly poisoned). When no kept checkpoint
        qualifies, the best-ranked stale one that does is spared: a long
        anomaly streak must never delete the last good restore point."""
        if self.save_top_k <= 0:
            return
        self._saved.sort(key=lambda t: t[0])
        keep = self._saved[: self.save_top_k]
        stale = self._saved[self.save_top_k:]
        horizon = getattr(trainer, "_guard_probe_ok_step", None) \
            if trainer is not None else None

        def rollback_ok(path: str, max_step) -> bool:
            blessed, step = _ckpt_meta(path)
            if blessed is not True:
                return False
            return max_step is None or (step is not None
                                        and step <= max_step)

        protected: list[tuple[float, str]] = []
        if stale and keep:
            for need in ([None, horizon] if horizon is not None
                         else [None]):
                if not any(rollback_ok(p, need)
                           for _, p in keep + protected):
                    hit = next(
                        (e for e in stale
                         if e not in protected and rollback_ok(e[1], need)),
                        None)
                    if hit is not None:
                        protected.append(hit)
        protected_paths = {p for _, p in protected}
        if trainer is None or trainer.strategy.is_global_zero:
            for _, stale_path in stale:
                if stale_path not in protected_paths and stale_path not in (
                        self.best_model_path, self.last_model_path):
                    _remove_checkpoint(stale_path)
        self._saved = keep + protected

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


class ThroughputMonitor(Callback):
    """Step time and examples per second into ``callback_metrics``
    (``step_time_s``: the mean of the last ``window`` intervals between
    train-batch ends; ``examples_per_sec``).

    An interval is host time. The trainer's metrics fetch, every
    ``log_every_n_steps``, waits for the card, so at
    ``log_every_n_steps=1`` each interval is a whole step; otherwise it
    is the time to enqueue one. An interval that holds a mid-epoch
    validation counts it. The first ``skip_first`` intervals of each fit
    are dropped (the JAX monitor drops its cold compile; here the first
    step allocates the optimizer state and the kernels' first calls
    load their libraries). ``clock`` is injectable for deterministic
    tests."""

    def __init__(self, window: int = 20, skip_first: int = 1,
                 clock=None):
        self.window = window
        self.skip_first = max(0, skip_first)
        self._clock = clock or time.perf_counter
        self._times: list[float] = []
        self._t0: Optional[float] = None
        self._intervals_seen = 0

    def on_fit_start(self, trainer, module) -> None:
        # the skip window re-arms per fit, not per construction
        self._times = []
        self._t0 = None
        self._intervals_seen = 0

    def on_train_epoch_start(self, trainer, module) -> None:
        self._t0 = self._clock()

    def on_train_batch_end(self, trainer, module, metrics, batch_idx) -> None:
        t = self._clock()
        if self._t0 is not None:
            self._intervals_seen += 1
            if self._intervals_seen > self.skip_first:
                self._times.append(t - self._t0)
                self._times = self._times[-self.window:]
        self._t0 = t
        if self._times:
            step_time = float(np.mean(self._times))
            trainer.callback_metrics["step_time_s"] = step_time
            bs = trainer.last_batch_size
            if bs:
                trainer.callback_metrics["examples_per_sec"] = bs / step_time


class MemoryMonitor(Callback):
    """Per-epoch device memory (bytes allocated now and at the peak) from
    ``torch.cuda.memory_stats`` of the module's device, into
    ``hbm_bytes_in_use`` / ``hbm_peak_bytes`` (the JAX monitor's names)
    and the log. Inert on the CPU, which keeps no such stats."""

    def __init__(self, log_stats: bool = True):
        self.log_stats = log_stats

    @staticmethod
    def _stats(device) -> Optional[dict]:
        import torch

        if device is None or torch.device(device).type != "cuda":
            return None
        return torch.cuda.memory_stats(device) or None

    def on_train_epoch_end(self, trainer, module) -> None:
        stats = self._stats(module.device)
        if stats is None:
            return
        in_use = stats.get("allocated_bytes.all.current")
        peak = stats.get("allocated_bytes.all.peak")
        if in_use is not None:
            trainer.callback_metrics["hbm_bytes_in_use"] = float(in_use)
        if peak is not None:
            trainer.callback_metrics["hbm_peak_bytes"] = float(peak)
        if self.log_stats and peak is not None:
            log.info("epoch %d HBM peak %.2f GiB (in use %.2f GiB)",
                     trainer.current_epoch, peak / 2**30,
                     (in_use or 0) / 2**30)


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
