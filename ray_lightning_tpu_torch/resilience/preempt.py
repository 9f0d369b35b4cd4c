"""Preemption handling: SIGTERM -> emergency checkpoint -> graceful drain
(twin of `ray_lightning_tpu/resilience/preempt.py`).

A preempted machine gets SIGTERM and a grace window to make its state
durable. The handler does the least legal work (set a flag, ``os.write``
a notice: no allocation, no locks, no torch), and the training loop acts
on the flag at the next batch boundary, where a checkpoint that every
rank joins is possible. Checkpointing inside the handler could land in
the middle of a collective and deadlock every rank.

The port's worker runs its jobs on the process's main thread
(runtime/worker.py), so the handler can be installed there. All ranks of
a preempted host get the signal, so each sees its own flag at the same
batch boundary and the emergency save is a valid collective. The drain
raises `PreemptedError` after the save; the supervisor classifies it
PREEMPTION and resumes from the emergency checkpoint.
"""
from __future__ import annotations

import logging
import os
import signal
import time
from typing import Optional, Sequence

from ray_lightning_tpu_torch.core.callbacks import Callback

log = logging.getLogger(__name__)

#: flag state mutated ONLY by the signal handler (single item
#: assignments, atomic for the interpreter, safe in a handler)
_STATE = {"signame": None, "at": None}


class PreemptedError(RuntimeError):
    """Raised by the drain after the emergency checkpoint landed. The
    NAME is part of the protocol: it reaches the driver inside the worker
    traceback, and `policy.classify_failure` keys on it."""

    def __init__(self, signame: str, checkpoint_path: Optional[str]):
        self.signame = signame
        self.checkpoint_path = checkpoint_path
        where = (f"; emergency checkpoint at {checkpoint_path}"
                 if checkpoint_path else "; no emergency checkpoint")
        super().__init__(
            f"training drained after preemption notice ({signame}){where}")


def _handler(signum, frame):  # noqa: ARG001 (the signal handler's shape)
    try:
        name = signal.Signals(signum).name
    except ValueError:
        name = f"signal {signum}"
    _STATE["signame"] = name
    _STATE["at"] = time.monotonic()
    # os.write, not print or logging: allocation-free and re-entrant
    os.write(2, f"# preemption notice: {name}\n".encode())


def install_preemption_handlers(
    signals: Sequence[int] = (signal.SIGTERM,),
) -> None:
    """Install the flag-only handlers. Idempotent; off the main thread,
    or where the host refuses, the previous disposition stays."""
    for sig in signals:
        try:
            signal.signal(sig, _handler)
        except (ValueError, OSError):
            log.warning("could not install preemption handler for %s", sig)


def preemption_requested() -> Optional[str]:
    """The signal's name when a preemption notice arrived, else None."""
    return _STATE["signame"]


def reset_preemption() -> None:
    _STATE["signame"] = None
    _STATE["at"] = None


class PreemptionGuard(Callback):
    """Batch-boundary drain: on a pending preemption notice, write an
    emergency checkpoint (blocking: it must be durable before the grace
    window ends) and unwind with `PreemptedError`.

    ``grace_s`` is bookkeeping: the guard logs how much of the platform's
    window the save took, so an operator sees when the window is too
    short for the model."""

    def __init__(self, dirpath: str, grace_s: float = 30.0,
                 install: bool = True,
                 signals: Sequence[int] = (signal.SIGTERM,)):
        self.dirpath = dirpath
        self.grace_s = grace_s
        self._install = install
        self._signals = tuple(signals)

    def on_fit_start(self, trainer, module) -> None:
        if self._install:
            install_preemption_handlers(self._signals)

    def _drain(self, trainer) -> None:
        signame = preemption_requested()
        if signame is None:
            return
        started = _STATE["at"] or time.monotonic()
        path = os.path.join(self.dirpath,
                            f"preempt-step={trainer.global_step}")
        ckpt: Optional[str] = None
        # Finish in-flight async saves first: one of them is the resume
        # fallback if the emergency save does not finish in the window,
        # so it must be finalized (meta and digest published); a failed
        # one stays unfinalized, which resume skips.
        from ray_lightning_tpu_torch.checkpoint.io import (
            wait_for_checkpoints,
        )

        try:
            wait_for_checkpoints()
        except Exception:  # noqa: BLE001 — the torn write stays invalid
            log.exception("in-flight async checkpoint failed during the "
                          "preemption drain; resume will skip it")
        try:
            # blocking: an async write could still stream when the
            # platform pulls the plug
            ckpt = trainer.save_checkpoint(path, block=True)
        except Exception:  # noqa: BLE001 — drain anyway; resume falls
            # back to the previous periodic checkpoint
            log.exception("emergency checkpoint failed; draining without")
        log.warning(
            "preemption drain: %s at step %d, emergency save took %.1fs "
            "of the %.0fs grace window", signame, trainer.global_step,
            time.monotonic() - started, self.grace_s)
        raise PreemptedError(signame, ckpt)

    def on_train_batch_end(self, trainer, module, metrics, batch_idx) -> None:
        self._drain(trainer)

    def on_train_epoch_end(self, trainer, module) -> None:
        self._drain(trainer)
