"""The capacity oracle (twin of `ray_lightning_tpu/autoscale/capacity.py`):
ONE answer to "how many worlds can the runtime schedule right now?",
shared by the elastic training ladder
(`elastic/budget.py` grow-back) and the serving autoscale controller
(`autoscale/controller.py` capacity clamp).

Before this module the elastic budget's default was **assume
restored**: every relaunch pretended full capacity was back, so a
shrunk run would propose a grow into hosts that were still gone and
pay a failed relaunch to learn it. The oracle replaces that with real
sources, consulted in order:

  1. ``RLT_CAPACITY`` env — an integer world count. The operator's (or
     a scheduler hook's) direct override.
  2. a **probe file** (``probe_file=`` or ``RLT_CAPACITY_FILE``) —
     either a bare integer or JSON ``{"capacity": n}``. Re-read on
     every query: an external agent (cluster scheduler webhook,
     preemption-notice watcher, a test) keeps it current.
  3. the **WorkerGroup spawn probe** (when ``spawn_probe_world`` is
     set): actually spawn that many trivial workers through
     `runtime.WorkerGroup` and count what came up — the ground truth
     the runtime itself reports. Expensive (process spawn), so the
     verdict is cached for ``cache_ttl_s``.
  4. the caller's ``assume`` fallback — the old assume-restored
     answer, now LABELED (``source="assumed"``) so a consumer can
     record the honesty gap instead of mistaking an assumption for a
     measurement (the supervisor's reshard ledger does exactly that on
     a refused grow).

Answers carry their source; ``worlds=None`` means "no source answered
and no assumption was offered" — a consumer must treat that as
no-clamp / no-grow, never as zero.
"""
from __future__ import annotations

import dataclasses
import json
import logging
import os
import tempfile
import time
from typing import Dict, Optional

log = logging.getLogger(__name__)

__all__ = ["CapacityAnswer", "CapacityOracle", "default_oracle",
           "spawn_probe", "ENV_CAPACITY", "ENV_CAPACITY_FILE"]

ENV_CAPACITY = "RLT_CAPACITY"
ENV_CAPACITY_FILE = "RLT_CAPACITY_FILE"


@dataclasses.dataclass(frozen=True)
class CapacityAnswer:
    """One oracle query's result. ``worlds`` is the schedulable world
    count (None = nothing answered); ``source`` names where it came
    from: env | file | spawn_probe | capacity_fn | assumed | none."""

    worlds: Optional[int]
    source: str
    detail: str = ""

    def to_dict(self) -> dict:
        d = {"worlds": self.worlds, "source": self.source}
        if self.detail:
            d["detail"] = self.detail
        return d


def _probe_main() -> int:
    """The spawn probe's worker body: prove the process scheduled and
    answered. Deliberately trivial — no torch import, no device touch —
    the probe measures schedulability, not device health."""
    return os.getpid()


def spawn_probe(world: int, timeout_s: float = 60.0,
                env: Optional[Dict[str, str]] = None,
                log_dir: Optional[str] = None) -> CapacityAnswer:
    """Ground-truth probe: spawn ``world`` trivial workers through
    `runtime.WorkerGroup` and report how many answered. A clean start +
    run means the runtime can schedule that world RIGHT NOW; any spawn
    failure reads as capacity 0 with the failure in ``detail`` (the
    caller's ladder then stays put rather than paying a doomed
    relaunch)."""
    from ray_lightning_tpu_torch.runtime.group import WorkerGroup

    if log_dir is None:
        log_dir = os.path.join(tempfile.gettempdir(),
                               "rlt_capacity_probe")
    group = WorkerGroup(num_workers=world, env=dict(env or {}),
                        log_dir=log_dir, start_timeout=timeout_s)
    try:
        group.start()
        results = group.run(_probe_main, timeout=timeout_s)
        return CapacityAnswer(len(results), "spawn_probe",
                              f"{len(results)}/{world} workers answered")
    except Exception as exc:  # noqa: BLE001 — a failed probe IS the answer
        return CapacityAnswer(
            0, "spawn_probe",
            f"probe of {world} worlds failed: "
            f"{type(exc).__name__}: {str(exc)[:200]}")
    finally:
        group.shutdown()


def _read_probe_file(path: str) -> Optional[int]:
    """Bare int or JSON {"capacity": n}; None when absent/garbled (a
    missing file means the external agent has nothing to say — fall
    through, don't fail)."""
    try:
        with open(path) as f:
            text = f.read().strip()
    except OSError:
        return None
    if not text:
        return None
    try:
        return int(text)
    except ValueError:
        pass
    try:
        doc = json.loads(text)
        return int(doc["capacity"])
    except (json.JSONDecodeError, KeyError, TypeError, ValueError):
        log.warning("capacity probe file %s is neither an int nor "
                    "{\"capacity\": n} — ignoring it", path)
        return None


@dataclasses.dataclass
class CapacityOracle:
    """The configured source chain. See the module docstring for the
    resolution order; every field narrows or extends it."""

    #: explicit probe file (beats ENV RLT_CAPACITY_FILE when set)
    probe_file: Optional[str] = None
    #: world size the spawn-probe fallback proves (None = probe off —
    #: spawning a worker group as a policy-query side effect is an
    #: explicit opt-in)
    spawn_probe_world: Optional[int] = None
    spawn_timeout_s: float = 60.0
    spawn_env: Optional[Dict[str, str]] = None
    #: spawn-probe verdict cache (the env/file sources are cheap and
    #: always re-read)
    cache_ttl_s: float = 30.0
    _cached: Optional[CapacityAnswer] = dataclasses.field(
        default=None, repr=False)
    _cached_until: float = dataclasses.field(default=0.0, repr=False)

    def query(self, assume: Optional[int] = None) -> CapacityAnswer:
        """Resolve the chain. ``assume`` is the caller's labeled
        fallback (e.g. the elastic budget's resolved max) — returned
        with ``source="assumed"`` only when every real source passed."""
        raw = os.environ.get(ENV_CAPACITY)
        if raw is not None:
            try:
                return CapacityAnswer(max(0, int(raw)), "env",
                                      f"{ENV_CAPACITY}={raw}")
            except ValueError:
                log.warning("%s=%r is not an integer — ignoring the "
                            "override", ENV_CAPACITY, raw)
        path = self.probe_file or os.environ.get(ENV_CAPACITY_FILE)
        if path:
            worlds = _read_probe_file(path)
            if worlds is not None:
                return CapacityAnswer(max(0, worlds), "file", path)
        if self.spawn_probe_world:
            now = time.monotonic()
            if self._cached is None or now >= self._cached_until:
                self._cached = spawn_probe(
                    self.spawn_probe_world,
                    timeout_s=self.spawn_timeout_s, env=self.spawn_env)
                self._cached_until = now + self.cache_ttl_s
            return self._cached
        if assume is not None:
            return CapacityAnswer(
                assume, "assumed",
                "no capacity source answered; assuming the resolved "
                "max — configure RLT_CAPACITY / a probe file / the "
                "spawn probe for a measured answer")
        return CapacityAnswer(None, "none", "no capacity source configured")

    def capacity(self, assume: Optional[int] = None) -> Optional[int]:
        return self.query(assume=assume).worlds

    def capacity_fn(self, assume: Optional[int] = None):
        """A `() -> int` adapter for `ElasticBudget.capacity_fn`-shaped
        consumers that cannot carry the answer metadata."""
        def fn() -> int:
            worlds = self.capacity(assume=assume)
            return worlds if worlds is not None else 0
        return fn


_DEFAULT: Optional[CapacityOracle] = None


def default_oracle() -> CapacityOracle:
    """The process-wide shared oracle (env + probe-file sources, spawn
    probe off): the one capacity truth `ElasticBudget` and the serving
    controller consult unless handed a configured instance."""
    global _DEFAULT
    if _DEFAULT is None:
        _DEFAULT = CapacityOracle()
    return _DEFAULT
