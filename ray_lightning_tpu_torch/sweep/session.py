"""Trial-side session: the report channel from a trial back to the
sweep (twin of `ray_lightning_tpu/sweep/session.py`).

The reference's report path was one-way and trampoline-shaped: worker
rank 0 enqueued ``lambda: tune.report(...)`` (reference tune.py:97-101),
the trial driver executed it (reference util.py:88-93), and Ray Tune's
session carried it to the sweep scheduler; a scheduler decision to stop
a trial was delivered by killing the trial actor.

Here the channel is **duplex**: ``report()`` sends the metrics to the
sweep driver and *blocks for the scheduler's verdict* on the same
connection. A ``stop`` verdict raises :class:`TrialStopped` inside the
trial process, unwinding the fit loop (and any nested worker group)
cooperatively, so the trial's cards are released deterministically.
"""
from __future__ import annotations

from multiprocessing.connection import Client
from typing import Any, Callable, Dict, Optional


class TrialStopped(BaseException):
    """Raised inside a trial when the scheduler says stop. Subclasses
    BaseException (like KeyboardInterrupt) so ordinary ``except Exception``
    blocks in user training code don't swallow the stop."""


class TrialContext:
    """Bound once per trial process; ``report`` is the only required op."""

    trial_id: str
    trial_dir: str
    #: checkpoint to resume from (set when the sweep restarts an
    #: interrupted trial; read via get_checkpoint())
    last_checkpoint: Optional[str] = None

    def report(self, metrics: Dict[str, Any],
               checkpoint: Optional[str] = None) -> None:
        raise NotImplementedError

    def close(self) -> None:  # noqa: B027
        pass


class RemoteTrialContext(TrialContext):
    """Trial in its own process: reports ride a dedicated authenticated
    socket back to the sweep driver (lazy-connected on first report)."""

    def __init__(self, trial_id: str, trial_dir: str,
                 address: tuple, authkey: bytes,
                 last_checkpoint: Optional[str] = None):
        self.trial_id = trial_id
        self.trial_dir = trial_dir
        self.last_checkpoint = last_checkpoint
        self._address = address
        self._authkey = authkey
        self._conn = None

    def _connect(self):
        if self._conn is None:
            self._conn = Client(tuple(self._address), authkey=self._authkey)
            self._conn.send(("hello", self.trial_id))
        return self._conn

    def report(self, metrics, checkpoint=None) -> None:
        conn = self._connect()
        conn.send(("report", self.trial_id, dict(metrics), checkpoint))
        verdict = conn.recv()
        if verdict == "stop":
            raise TrialStopped(self.trial_id)

    def close(self) -> None:
        if self._conn is not None:
            try:
                self._conn.send(("bye", self.trial_id))
                self._conn.close()
            except OSError:
                pass
            self._conn = None


class LocalTrialContext(TrialContext):
    """Inline executor: report goes straight into the runner (same
    process); a stop verdict raises immediately."""

    def __init__(self, trial_id: str, trial_dir: str,
                 report_fn: Callable[[str, Dict[str, Any], Optional[str]], str],
                 last_checkpoint: Optional[str] = None):
        self.trial_id = trial_id
        self.trial_dir = trial_dir
        self.last_checkpoint = last_checkpoint
        self._report_fn = report_fn

    def report(self, metrics, checkpoint=None) -> None:
        verdict = self._report_fn(self.trial_id, dict(metrics), checkpoint)
        if verdict == "stop":
            raise TrialStopped(self.trial_id)


_ctx: Optional[TrialContext] = None


def init_trial_session(ctx: TrialContext) -> None:
    global _ctx
    _ctx = ctx


def reset_trial_session() -> None:
    global _ctx
    _ctx = None


def get_trial_session() -> Optional[TrialContext]:
    return _ctx


def is_trial_session_enabled() -> bool:
    """True iff this process is a sweep trial (reference analog:
    tune.is_session_enabled, reference tune.py:14-22)."""
    return _ctx is not None


def get_trial_id() -> str:
    assert _ctx is not None, "no trial session in this process"
    return _ctx.trial_id


def get_trial_dir() -> str:
    """Per-trial storage dir (the reference analog of
    ``tune.checkpoint_dir(step)``, reference tune.py:128-142, but
    checkpoints are written in place by the trial, never shipped through
    the channel)."""
    assert _ctx is not None, "no trial session in this process"
    return _ctx.trial_dir


def report(metrics: Optional[Dict[str, Any]] = None,
           checkpoint: Optional[str] = None, **kw: Any) -> None:
    """``tune.report`` analog, usable directly inside a trainable."""
    assert _ctx is not None, "report() outside a trial session"
    merged = dict(metrics or {})
    merged.update(kw)
    _ctx.report(merged, checkpoint=checkpoint)


def get_trial_hosts() -> list:
    """Cluster hosts borrowed by this trial (``RLT_TRIAL_HOSTS``, set by
    ``sweep.run(hosts=...)``); empty when the trial runs on the driver's
    machine. Pass them on as ``fit_distributed(hosts=...)``."""
    import os

    raw = os.environ.get("RLT_TRIAL_HOSTS", "")
    return [h for h in raw.split(",") if h]


def get_checkpoint() -> Optional[str]:
    """Checkpoint path to resume this trial from, or None on a fresh start.

    Set by the sweep runner when re-running an interrupted/errored trial
    (extends the reference's checkpoint registration, tune.py:128-142, with
    the restore direction Ray Tune gained later). Trainables opt in::

        def trainable(config):
            trainer.fit(module, data, ckpt_path=sweep.get_checkpoint())

    Works in the trial process (session-bound) and in nested
    `fit_distributed` workers (through ``RLT_TRIAL_RESUME``).
    """
    import os

    if _ctx is not None:
        return _ctx.last_checkpoint
    return os.environ.get("RLT_TRIAL_RESUME") or None
