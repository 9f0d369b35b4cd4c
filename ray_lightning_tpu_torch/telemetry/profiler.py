"""On-demand ``torch.profiler`` capture, driven from the fit loop (twin
of `ray_lightning_tpu/telemetry/profiler.py`).

A production incident is never reproduced with ``profiler_dir`` set from
the start — the capture has to be armable on a RUNNING job. Three
triggers, all host-side and cadence-guarded:

    step window   ``ProfileConfig(start_step=500, num_steps=5)`` —
                  deterministic capture of a known-bad region;
    marker file   touch ``<dir>/CAPTURE`` (or a configured path) on the
                  worker's filesystem; the loop polls it on its cadence
                  and captures the next ``num_steps`` steps;
    SIGUSR1       ``signal=True`` installs a handler that sets a flag
                  (async-signal-safe: no torch work in the handler); the
                  loop picks it up at the next polled batch boundary.

Rank-scoped (``ranks=(0,)`` by default): every rank runs the same step,
so one rank's trace carries the information.

Each capture is one ``torch.profiler.profile`` session (CPU and, on a
card, CUDA activity) exported as a Chrome trace under ``config.dir``.
On a card every kernel launch the session saw on the host should have
its kernel event: a capture that holds none is counted in
``empty_captures``, one that lost some in ``incomplete_captures``, and
both are logged as errors, never as a success. On the H100 a session
now and then lost the device records of its first few kernel launches
(PERF.md §7), so a capture on a card opens in the profiler's warm-up
state, runs ``PRIMER_LAUNCHES`` small kernels there (their records are
dropped with the warm-up), and only then starts recording. A session
that cannot start
(another profiler is running, the directory is unwritable) disarms the
controller with one loud log line — profiling must never be able to
kill a fit.
"""
from __future__ import annotations

import dataclasses
import logging
import os
import re
import signal as _signal
import threading
from typing import Any, Dict, List, Optional, Tuple

log = logging.getLogger(__name__)

#: marker filename polled inside the profile dir when no explicit
#: marker_file is configured
DEFAULT_MARKER = "CAPTURE"

#: kernels a capture on a card launches in its warm-up, before it records
PRIMER_LAUNCHES = 16

#: the host calls that launch one kernel each (runtime and driver API)
_LAUNCH = re.compile(r"^cu(da)?Launch(Cooperative)?Kernel")


@dataclasses.dataclass
class ProfileConfig:
    """``Trainer(profile=ProfileConfig(...))`` — see module docstring."""

    dir: str = "rlt_profile"
    #: capture [start_step, start_step + num_steps) deterministically;
    #: None = no step-window trigger (marker/signal only)
    start_step: Optional[int] = None
    num_steps: int = 5
    #: path polled for the marker trigger; None derives <dir>/CAPTURE
    marker_file: Optional[str] = None
    #: install a SIGUSR1 handler as the third trigger
    signal: bool = False
    #: ranks that capture (every rank runs the same step)
    ranks: Tuple[int, ...] = (0,)
    #: marker/signal polling cadence in steps
    poll_every_n_steps: int = 5

    @classmethod
    def coerce(cls, value: Any) -> Optional["ProfileConfig"]:
        if value is None or value is False:
            return None
        if value is True:
            return cls()
        if isinstance(value, cls):
            return value
        if isinstance(value, str):
            return cls(dir=value)
        raise TypeError(
            f"profile= takes True, a directory string, or a "
            f"ProfileConfig; got {type(value).__name__}")


def _session(on_card: bool):
    """A new, unstarted profiler session that records from its first
    ``step()`` on: a warm-up first, then one recording phase (the seam
    tests replace)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    activities = [ProfilerActivity.CPU]
    if on_card:
        activities.append(ProfilerActivity.CUDA)
    return profile(activities=activities,
                   schedule=schedule(wait=0, warmup=1, active=1, repeat=1))


def _prime() -> None:
    """PRIMER_LAUNCHES small kernels on the current card, waited for."""
    import torch

    if not PRIMER_LAUNCHES:
        return
    x = torch.ones(PRIMER_LAUNCHES, device="cuda")
    for i in range(PRIMER_LAUNCHES - 1):
        x[i + 1:].add_(1)
    torch.cuda.synchronize()


def device_events(prof) -> Dict[str, int]:
    """{name: count} of a finished session's device events (kernels and
    copies), without the device-side copies of user annotations, whose
    time is that of the kernels inside them."""
    from torch.autograd import DeviceType

    return {e.key: e.count for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)}


def kernel_counts(prof, events: Dict[str, int]) -> Tuple[int, int]:
    """(kernel launches the session saw on the host, kernel events it
    recorded on the device); ``events`` is `device_events` of the same
    session. Every launch has its kernel when nothing was lost."""
    from torch.autograd import DeviceType

    launches = sum(e.count for e in prof.key_averages()
                   if e.device_type == DeviceType.CPU
                   and _LAUNCH.match(e.key))
    kernels = sum(n for key, n in events.items()
                  if not key.startswith(("Memcpy", "Memset")))
    return launches, kernels


class Capture:
    """One profiler session from ``start`` to ``stop``, exported as a
    Chrome trace. ``stop`` returns the capture's record: the trace's
    path and the device events it holds (``empty`` when a session on a
    card recorded none)."""

    def __init__(self, directory: str, name: str, on_card: bool):
        self.directory = directory
        self.name = name
        self.on_card = on_card
        self._prof = None

    def start(self) -> None:
        os.makedirs(self.directory, exist_ok=True)
        prof = _session(self.on_card)
        prof.start()  # the warm-up: activities on, nothing kept
        if self.on_card:
            _prime()
        prof.step()  # recording from here
        self._prof = prof

    def stop(self) -> Dict[str, Any]:
        prof, self._prof = self._prof, None
        if prof is None:
            raise RuntimeError("capture was not started")
        prof.stop()
        path = os.path.join(self.directory, f"{self.name}.trace.json")
        prof.export_chrome_trace(path)
        if not self.on_card:
            return {"trace": path, "device_events": {}, "empty": False,
                    "kernel_launches": 0, "lost_kernel_events": 0}
        events = device_events(prof)
        launches, kernels = kernel_counts(prof, events)
        return {"trace": path, "device_events": events, "empty": not events,
                "kernel_launches": launches,
                "lost_kernel_events": max(0, launches - kernels)}


class ProfilerController:
    """Owns one capture lifecycle; the trainer calls ``on_step(step)``
    once per batch (host-side, no device touch)."""

    def __init__(self, config: ProfileConfig, rank: int = 0,
                 on_card: bool = False):
        self.config = config
        self.rank = rank
        self.on_card = on_card
        self.active = rank in tuple(config.ranks)
        self.capturing = False
        #: finished captures that hold what they should (on a card: a
        #: kernel event for every kernel launch)
        self.captures = 0
        #: finished captures on a card that recorded no device event
        self.empty_captures = 0
        #: finished captures on a card that lost some kernel events
        self.incomplete_captures = 0
        #: every finished capture's record, in order
        self.records: List[Dict[str, Any]] = []
        self.disabled_reason: Optional[str] = None
        self._capture: Optional[Capture] = None
        self._start_step: Optional[int] = None
        self._stop_at: Optional[int] = None
        self._signal_flag = threading.Event()
        self._marker = config.marker_file or os.path.join(
            config.dir, DEFAULT_MARKER)
        if self.active and config.signal:
            try:
                _signal.signal(_signal.SIGUSR1,
                               lambda *_: self._signal_flag.set())
            except (ValueError, OSError):
                # not the main thread: the other triggers still work
                log.warning("profiler: could not install SIGUSR1 trigger; "
                            "step-window/marker triggers remain armed")

    # ---- trigger evaluation (host-side, cadence-guarded) -----------------

    def _should_start(self, step: int) -> bool:
        cfg = self.config
        if cfg.start_step is not None and step == cfg.start_step:
            return True
        if step % max(1, cfg.poll_every_n_steps) == 0:
            if self._signal_flag.is_set():
                self._signal_flag.clear()
                return True
            if os.path.exists(self._marker):
                try:
                    os.remove(self._marker)  # one marker = one capture
                except OSError:
                    pass
                return True
        return False

    def on_step(self, step: int) -> None:
        """Advance the capture state machine at one batch boundary."""
        if not self.active or self.disabled_reason:
            return
        if self.capturing:
            if self._stop_at is not None and step >= self._stop_at:
                self._stop(step)
            return
        if self._should_start(step):
            self._start(step)

    # ---- capture ---------------------------------------------------------

    def _start(self, step: int) -> None:
        capture = Capture(
            self.config.dir,
            f"rank{self.rank}.{os.getpid()}.step{step}", self.on_card)
        try:
            capture.start()
        except Exception as exc:  # noqa: BLE001 — never kill the fit
            self.disabled_reason = f"{type(exc).__name__}: {exc}"
            log.error(
                "profiler: torch.profiler could not start (%s) — capture "
                "DISABLED for this run; profiling is a no-op now, not an "
                "error in your job", self.disabled_reason)
            return
        self._capture = capture
        self.capturing = True
        self._start_step = step
        self._stop_at = step + max(1, self.config.num_steps)
        log.warning("profiler: capture armed at step %d for %d steps -> %s",
                    step, self.config.num_steps, self.config.dir)

    def _stop(self, step: int) -> None:
        capture, self._capture = self._capture, None
        self.capturing = False
        self._stop_at = None
        try:
            record = capture.stop()
        except Exception as exc:  # noqa: BLE001
            self.disabled_reason = f"{type(exc).__name__}: {exc}"
            log.error("profiler: stopping the capture failed (%s); capture "
                      "disabled", self.disabled_reason)
            return
        record.update(start_step=self._start_step, end_step=step)
        self.records.append(record)
        if record["empty"]:
            self.empty_captures += 1
            log.error(
                "profiler: the capture of steps %s-%d on the card holds NO "
                "device event — its events were lost; %s is a FAILED "
                "capture", self._start_step, step, record["trace"])
            return
        if record["lost_kernel_events"]:
            self.incomplete_captures += 1
            log.error(
                "profiler: the capture of steps %s-%d on the card lost %d "
                "kernel events (launched, never recorded); %s is an "
                "INCOMPLETE capture", self._start_step, step,
                record["lost_kernel_events"], record["trace"])
            return
        self.captures += 1
        log.warning("profiler: capture complete at step %d (%d device "
                    "event kinds) -> %s", step,
                    len(record["device_events"]), record["trace"])

    def close(self) -> None:
        """Fit teardown: a capture left open (fit ended mid-window) is
        closed so the trace file is written."""
        if self.capturing:
            self._stop(self._stop_at or 0)
