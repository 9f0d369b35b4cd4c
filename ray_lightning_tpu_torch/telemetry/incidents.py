"""Automatic incident capture: a watch-rule breach that documents
itself (twin of `ray_lightning_tpu/telemetry/incidents.py`, same
ledger format).

A production breach observed by a human at `monitor --follow` is a
lucky breach. This module makes the unlucky ones self-documenting: when
`telemetry/watch.py` fires a rule, the breach lands in
``<run_dir>/incidents.jsonl`` as one append-only JSON record carrying

  * the rule (name, metric, op, threshold, severity),
  * the firing window (the evaluations that sustained the breach),
  * metric evidence (the value and the raw surface it was read from —
    e.g. the TTFT histogram sketch, the load-signal snapshot, the
    goodput buckets),
  * a timeline excerpt — the +-N merged events surrounding the breach
    (telemetry/timeline.py), so "what else was happening" rides along,
  * the evidence-capture actions taken.

Evidence capture actuates the hooks the system already has, instead of
inventing new instrumentation: it drops the profiler's ``CAPTURE``
marker file (telemetry/profiler.py polls it on its cadence — the next
N steps get a real `torch.profiler` trace) and, when a caller passes a
serving driver, forces a flight-recorder persist through its
``force_flight_persist`` seam, so the breach window's final ticks are
on disk even if the process dies next. Both are host-side file
operations: watch/incidents never touch the device.

The ledger opens with the same clock-alignment header every other
stream carries (``t0_wall`` + monotonic origin), and each record is
wall-stamped, so the timeline merger ingests incidents as first-class
events (docs/OBSERVABILITY.md "watch rules & incidents").
"""
from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List, Optional

from ray_lightning_tpu_torch.utils.locks import san_lock

INCIDENTS_NAME = "incidents.jsonl"
INCIDENTS_VERSION = "rlt-incidents-v1"

#: serializes header-write + append: a supervisor poll and a controller
#: poll sharing one run dir must interleave whole lines
_APPEND_LOCK = san_lock("telemetry.incidents.append")


def incidents_path(run_dir: str) -> str:
    return os.path.join(run_dir, INCIDENTS_NAME)


def build_incident(rule, value: float, now_wall: float,
                   window: List[dict],
                   evidence: Optional[Dict[str, Any]] = None,
                   excerpt: Optional[List[dict]] = None) -> Dict[str, Any]:
    """One incident record (docs/OBSERVABILITY.md "incident record
    contract"). ``rule`` is a `watch.WatchRule`; ``window`` the
    evaluations that sustained the breach (newest last)."""
    ev: Dict[str, Any] = {"metric": rule.metric, "op": rule.op,
                          "threshold": rule.threshold, "value": value}
    if evidence:
        ev.update(evidence)
    return {
        "rule": rule.name,
        "severity": rule.severity,
        "wall": round(now_wall, 6),
        "window": window,
        "evidence": ev,
        "description": rule.description,
    }


def append_incident(run_dir: str, incident: Dict[str, Any]) -> str:
    """Append one record to ``<run_dir>/incidents.jsonl``; writes the
    clock-alignment header first when creating the ledger."""
    os.makedirs(run_dir, exist_ok=True)
    path = incidents_path(run_dir)
    with _APPEND_LOCK:
        header = not os.path.exists(path) or \
            os.path.getsize(path) == 0
        with open(path, "a") as f:
            if header:
                f.write(json.dumps({
                    "version": INCIDENTS_VERSION,
                    "t0_wall": time.time(),
                    "t0_perf": time.perf_counter(),
                    "pid": os.getpid(),
                }) + "\n")
            f.write(json.dumps(incident) + "\n")
    return path


def read_incidents(run_dir: str,
                   tail_bytes: Optional[int] = None) -> Dict[str, Any]:
    """Parse the incident ledger: ``{"header": {...}, "incidents":
    [...], "unparseable_lines": n}``. Missing file = no incidents;
    garbage lines are counted, never fatal. ``tail_bytes`` bounds the
    read for cadence-polled callers."""
    from ray_lightning_tpu_torch.telemetry.spans import ledger_tail_lines

    path = incidents_path(run_dir)
    header: Dict[str, Any] = {}
    incidents: List[dict] = []
    bad = 0
    try:
        first, body = ledger_tail_lines(path, tail_bytes)
    except OSError:
        return {"header": header, "incidents": incidents,
                "unparseable_lines": bad}
    for i, line in enumerate([first] + body):
        line = line.strip()
        if not line:
            continue
        try:
            obj = json.loads(line)
        except json.JSONDecodeError:
            bad += 1
            continue
        if not isinstance(obj, dict):
            bad += 1
            continue
        if i == 0 and obj.get("version") == INCIDENTS_VERSION:
            header = obj
            continue
        incidents.append(obj)
    return {"header": header, "incidents": incidents,
            "unparseable_lines": bad}


def capture_evidence(run_dir: str, profile_dir: Optional[str] = None,
                     driver: Any = None) -> Dict[str, Any]:
    """Actuate the existing evidence hooks for one breach. Returns the
    actions record the incident carries. Never raises — capture is
    best-effort garnish on the incident, not a gate on it.

    * ``CAPTURE`` marker: dropped into ``profile_dir`` (default
      ``<run_dir>/rlt_profile``) — the profiler controller
      (telemetry/profiler.py) polls exactly this file on its cadence
      and captures the next N steps; one marker = one capture.
    * flight persist: ``driver.force_flight_persist()`` when a serving
      driver is wired in — the breach window's final ticks land on
      disk NOW instead of one persist cadence later.
    """
    actions: Dict[str, Any] = {}
    marker_dir = profile_dir or os.path.join(run_dir, "rlt_profile")
    try:
        os.makedirs(marker_dir, exist_ok=True)
        from ray_lightning_tpu_torch.telemetry.profiler import DEFAULT_MARKER

        marker = os.path.join(marker_dir, DEFAULT_MARKER)
        # one marker = one capture (the profiler consumes it); an
        # unconsumed marker from an earlier incident is left alone
        if not os.path.exists(marker):
            with open(marker, "w") as f:
                f.write(json.dumps({"at": time.time(),
                                    "by": "watch"}))
            actions["profiler_marker"] = marker
        else:
            actions["profiler_marker_pending"] = marker
    except OSError as exc:
        actions["profiler_marker_error"] = str(exc)[:160]
    if driver is not None:
        try:
            persisted = driver.force_flight_persist()
            actions["flight_persisted"] = persisted
        except Exception as exc:  # noqa: BLE001 — best-effort capture
            actions["flight_persist_error"] = (
                f"{type(exc).__name__}: {str(exc)[:160]}")
    return actions
