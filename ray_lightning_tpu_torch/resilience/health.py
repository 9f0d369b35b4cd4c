"""Per-worker heartbeats and a stall watchdog over the side channel
(twin of `ray_lightning_tpu/resilience/health.py`).

The runtime's failure detector (`WorkerGroup._check_liveness`) sees a
worker that DIED. A worker that is alive but wedged (a deadlocked
collective, a hung device) looks like one that is slow to start: on the
card a worker's first step can wait behind the nvcc build of the
kernels. The distinction this module draws:

  live channel, step advancing     -> healthy
  live channel, step frozen        -> "slow step": logged once, not
                                      killed
  silent channel past the budget   -> hung: StallError (RETRYABLE)

Worker side: `HeartbeatCallback` runs a daemon thread that sends a small
dict over ``session.put_queue``, the side channel sweep reports ride, so
heartbeats interleave with results in the driver's pump. Driver side:
`HealthMonitor.consume` takes them from the pump's ``on_queue_item``,
and `HealthMonitor.check` runs in the pump's idle slices
(``WorkerGroup.wait(watchdog=)``).
"""
from __future__ import annotations

import logging
import threading
import time
from typing import Any, Dict, Optional

from ray_lightning_tpu_torch.core.callbacks import Callback
from ray_lightning_tpu_torch.resilience.policy import StallError
from ray_lightning_tpu_torch.telemetry.spans import NULL_RECORDER

log = logging.getLogger(__name__)

#: queue items with this "kind" are heartbeats, consumed by the monitor
#: before a user's on_queue_item sees them
HEARTBEAT_KIND = "rlt.heartbeat"


def make_heartbeat(rank: int, step: int, phase: str = "step",
                   span: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """``phase`` is what the worker's main thread is doing now (the
    telemetry recorder's current span phase); ``span`` the last finished
    span's summary."""
    hb = {"kind": HEARTBEAT_KIND, "rank": rank, "step": int(step),
          "phase": phase, "sent_at": time.time()}
    if span:
        hb["span"] = {"phase": span.get("phase"),
                      "dur": span.get("dur"), "step": span.get("step")}
    return hb


def is_heartbeat(item: Any) -> bool:
    return isinstance(item, dict) and item.get("kind") == HEARTBEAT_KIND


class HeartbeatCallback(Callback):
    """Worker-side sender: a daemon thread, not the training loop, so
    heartbeats keep flowing while the main thread sits in a long step or
    a kernel build, which is what tells "slow" from "hung"."""

    def __init__(self, interval_s: float = 5.0):
        self.interval_s = interval_s
        self._stop: Optional[threading.Event] = None
        self._muted = threading.Event()

    def mute(self) -> None:
        """Stop sending while the thread lives on: what a hung process
        looks like from the driver (the ``hang`` fault)."""
        self._muted.set()

    def on_fit_start(self, trainer, module) -> None:
        from ray_lightning_tpu_torch.runtime import session

        if not session.is_session_enabled():
            return  # not inside a runtime worker (a local Trainer.fit)
        self._stop = stop = threading.Event()
        muted = self._muted
        rank = session.get_actor_rank()

        def _send() -> bool:
            """One beat unless muted; False once the channel is gone."""
            if muted.is_set():
                return True
            try:
                step = int(trainer.global_step)
                # the recorder's live phase says what the worker is
                # doing; without telemetry, the step counter
                rec = getattr(trainer, "telemetry_recorder", NULL_RECORDER)
                phase = rec.current_phase() if rec.enabled else ""
                session.put_queue(make_heartbeat(
                    rank, step, phase or ("step" if step > 0 else "setup"),
                    span=rec.last_span()))
            except Exception:  # noqa: BLE001 — the channel closing at
                # teardown; never crash the worker over it
                return False
            return True

        def _beat():
            while not stop.wait(self.interval_s):
                if not _send():
                    return

        # the first beat from this thread, before any step: it tells the
        # monitor this rank reached the fit loop, which ends its startup
        # grace. Sent from the sender thread it could lose the race with
        # a rank that hangs in its first steps, and the hang would then
        # be judged by the startup grace, not the stall budget
        if _send():
            threading.Thread(target=_beat, daemon=True,
                             name=f"rlt-heartbeat-{rank}").start()

    def _shutdown(self) -> None:
        if self._stop is not None:
            self._stop.set()
            self._stop = None

    def on_fit_end(self, trainer, module) -> None:
        self._shutdown()

    def on_exception(self, trainer, module, exc) -> None:
        self._shutdown()


class HealthMonitor:
    """Driver-side staleness tracker.

    ``stall_timeout_s``: silent-channel budget AFTER a rank's first
    heartbeat; before it ``startup_grace_s`` applies (spawn, imports, the
    process group's rendezvous and the kernels' build happen with no
    heartbeat). ``step_stall_note_s``: live channel with no progress for
    this long gets one advisory log line."""

    def __init__(self, num_workers: int, stall_timeout_s: float = 180.0,
                 startup_grace_s: float = 600.0,
                 step_stall_note_s: float = 120.0):
        self.num_workers = num_workers
        self.stall_timeout_s = stall_timeout_s
        self.startup_grace_s = startup_grace_s
        self.step_stall_note_s = step_stall_note_s
        self._lock = threading.Lock()
        self.reset()

    def reset(self) -> None:
        with self._lock:
            self._started = time.monotonic()
            self._last_seen: Dict[int, float] = {}
            self._last_step: Dict[int, int] = {}
            self._step_since: Dict[int, float] = {}
            self._last_phase: Dict[int, str] = {}
            self._noted_stall: set = set()

    def consume(self, rank: int, item: Any) -> bool:
        """Absorb ``item`` if it is a heartbeat; True when consumed."""
        if not is_heartbeat(item):
            return False
        now = time.monotonic()
        with self._lock:
            hb_rank = int(item.get("rank", rank))
            step = int(item.get("step", -1))
            self._last_seen[hb_rank] = now
            self._last_phase[hb_rank] = str(item.get("phase", ""))
            if self._last_step.get(hb_rank) != step:
                self._last_step[hb_rank] = step
                self._step_since[hb_rank] = now
                self._noted_stall.discard(hb_rank)
        return True

    def check(self, now: Optional[float] = None) -> None:
        """Raise StallError for a hung rank; log once per episode for a
        live rank that is not stepping. Runs in the pump's idle slices,
        so it stays cheap."""
        now = time.monotonic() if now is None else now
        with self._lock:
            for rank in range(self.num_workers):
                seen = self._last_seen.get(rank)
                if seen is None:
                    if now - self._started > self.startup_grace_s:
                        raise StallError(
                            rank, now - self._started,
                            "no heartbeat ever arrived (worker never "
                            "reached the fit loop)")
                    continue
                silent = now - seen
                if silent > self.stall_timeout_s:
                    raise StallError(
                        rank, silent,
                        phase=self._last_phase.get(rank, ""),
                        step=self._last_step.get(rank, -1))
                frozen = now - self._step_since.get(rank, now)
                if (frozen > self.step_stall_note_s
                        and rank not in self._noted_stall):
                    self._noted_stall.add(rank)
                    log.warning(
                        "rank %d: heartbeats live but step %d unchanged "
                        "for %.0fs: a slow step or a wedged phase (not "
                        "killing; the silent-channel budget is %.0fs)",
                        rank, self._last_step.get(rank, -1), frozen,
                        self.stall_timeout_s)

    def snapshot(self) -> Dict[int, Dict[str, Any]]:
        """Per-rank seconds since the last heartbeat, step and phase."""
        now = time.monotonic()
        with self._lock:
            return {
                r: {"silent_s": now - self._last_seen[r],
                    "step": self._last_step.get(r, -1),
                    "phase": self._last_phase.get(r, "")}
                for r in self._last_seen
            }
