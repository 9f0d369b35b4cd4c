"""Goodput accounting: classify supervised wall time into named buckets
(twin of `ray_lightning_tpu/telemetry/goodput.py`, same ledger format).

"Goodput" is the fraction of total wall-clock a run spent making forward
progress (TorchTitan treats this as a first-class production metric; so
does every accelerator-fleet postmortem). Everything else gets a named bucket:

    productive_s        the fit loop was free to dispatch steps
    compile_s           the warm start before the loop (the step's
                        one-time costs, kernel libraries included)
    data_wait_s         the consumer blocked on the prefetch queue
    ckpt_stall_s        the training thread blocked on checkpoint I/O
    eval_s              validation/test epochs
    metrics_fetch_s     cadenced lazy metric fetches (host syncs)
    launch_s            worker spawn -> fit start (imports, CUDA init,
                        distributed rendezvous), per attempt
    backoff_s           supervisor restart backoff sleeps (driver)
    rollback_replay_s   stepping time spent RE-training steps an earlier
                        attempt had already trained (restart/rollback
                        resume point behind the previous attempt's end)
    reshard_s           elastic world-size changes (docs/ELASTIC.md):
                        the cross-topology checkpoint restore after the
                        supervisor shrank/grew the job
    other_s             driver-side residual (classification, teardown,
                        pump overhead) — wall minus everything above

Two layers produce these:

  worker side   ``worker_ledger`` — the trainer snapshots its recorder's
                phase totals at fit end (and on the exception path) into
                ``<telemetry_dir>/ledger.rank<r>.<pid>.json``. Within a
                ledger, productive_s is wall minus the measured stall
                buckets, so a ledger's buckets sum to its wall EXACTLY.
  driver side   ``assemble_goodput`` — the supervisor stitches the rank-0
                ledgers of every attempt together with its own backoff /
                attempt wall accounting, reclassifies replayed steps'
                share of productive time into rollback_replay_s, and
                closes the books against total supervised wall with
                ``other_s``. Buckets sum to wall within float noise by
                construction; the ±5% smoke tolerance absorbs cross-
                process clock slop.

``GOODPUT_SCHEMA`` names the buckets and the headline for consumers
that must see the same shape whether or not anything was measured.
"""
from __future__ import annotations

import glob
import json
import os
import time
from typing import Any, Dict, List, Optional

#: every bucket the report carries, in display order; their sum is
#: wall_s (within tolerance — docs/OBSERVABILITY.md "goodput")
GOODPUT_BUCKETS = (
    "productive_s", "compile_s", "data_wait_s", "ckpt_stall_s", "eval_s",
    "metrics_fetch_s", "launch_s", "backoff_s", "rollback_replay_s",
    "reshard_s", "other_s",
)

#: the lost-time classes a fault-injected smoke run must show nonzero
LOST_CLASSES = ("backoff_s", "rollback_replay_s")

#: the report's shape, for consumers even when nothing was measured
GOODPUT_SCHEMA = {"buckets": list(GOODPUT_BUCKETS),
                  "headline": "goodput_fraction"}

LEDGER_VERSION = "rlt-ledger-v1"

#: recorder phases folded into each worker-side ledger bucket; phases
#: outside this map (producer-thread h2d, per-step spans) inform the
#: timeline but are overlapped with compute, so they never enter the
#: wall-exclusive budget
_PHASE_TO_BUCKET = {
    "compile": "compile_s",
    "data_wait": "data_wait_s",
    "ckpt_stall": "ckpt_stall_s",
    "eval": "eval_s",
    "metrics_fetch": "metrics_fetch_s",
    # elastic world-size changes (docs/ELASTIC.md): the worker-side
    # cross-topology checkpoint restore after a shrink/grow — named so
    # an elastic event is visible in `report`, not laundered into
    # productive time
    "reshard": "reshard_s",
}


def worker_ledger(recorder, wall_s: float, *, rank: int,
                  start_step: int, end_step: int,
                  launch_s: float = 0.0,
                  completed: bool = True,
                  extra: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """One attempt's worker-side accounting. ``wall_s`` is the fit wall
    (perf_counter), ``launch_s`` the pre-fit spawn/init time when known
    (runtime session start -> fit start). productive_s closes the books:
    wall minus the measured stalls, floored at zero."""
    totals = recorder.phase_totals()
    buckets = {b: 0.0 for b in GOODPUT_BUCKETS}
    for phase, bucket in _PHASE_TO_BUCKET.items():
        buckets[bucket] = float(totals.get(phase, 0.0))
    stalls = sum(buckets.values())
    buckets["productive_s"] = max(0.0, wall_s - stalls)
    ledger = {
        "version": LEDGER_VERSION,
        "rank": rank,
        "wall_s": float(wall_s),
        "launch_s": float(launch_s),
        "start_step": int(start_step),
        "end_step": int(end_step),
        "completed": bool(completed),
        "t0_wall": time.time() - wall_s,
        "buckets": buckets,
    }
    if extra:
        ledger["extra"] = extra
    return ledger


def write_ledger(directory: str, ledger: Dict[str, Any],
                 uid: Optional[str] = None) -> str:
    """Atomic per-attempt ledger write: rank- and uid-tagged filename
    (the recorder's pid+sequence token) so restarted attempts AND
    same-process re-fits never clobber each other, tmp+replace so a
    kill mid-write leaves no torn JSON."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(
        directory,
        f"ledger.rank{ledger['rank']}.{uid or os.getpid()}.json")
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(ledger, f)
    os.replace(tmp, path)
    return path


def read_ledgers(directory: str, rank: Optional[int] = 0) -> List[dict]:
    """All parseable attempt ledgers (``rank=None`` for every rank),
    ordered by their wall start — attempt order on one machine, and
    NTP-close enough across hosts."""
    out: List[dict] = []
    pattern = (f"ledger.rank{rank}.*.json" if rank is not None
               else "ledger.rank*.json")
    for path in glob.glob(os.path.join(directory, pattern)):
        try:
            with open(path) as f:
                ledger = json.load(f)
        except (OSError, json.JSONDecodeError):
            continue
        if ledger.get("version") == LEDGER_VERSION:
            out.append(ledger)
    out.sort(key=lambda w: w.get("t0_wall", 0.0))
    return out


def assemble_goodput(telemetry_dir: str, wall_s: float,
                     backoff_s: float = 0.0,
                     restarts: int = 0, rollbacks: int = 0,
                     preemptions: int = 0) -> Dict[str, Any]:
    """Driver-side assembly over the rank-0 attempt ledgers.

    Replay attribution: attempt k resumed at ``start_step``; any steps
    below the max ``end_step`` an earlier attempt reached were already
    trained once, so their share of attempt k's productive time is
    reclassified as ``rollback_replay_s`` (restart, preemption, and
    trainguard rollback resume all replay through the same mechanism;
    the report's ``events`` field says which classes occurred).
    """
    ledgers = read_ledgers(telemetry_dir, rank=0)
    buckets = {b: 0.0 for b in GOODPUT_BUCKETS}
    buckets["backoff_s"] = float(backoff_s)
    max_end = None
    attempts = []
    for led in ledgers:
        lb = led.get("buckets", {})
        for b in GOODPUT_BUCKETS:
            if b in ("backoff_s", "rollback_replay_s", "other_s",
                     "launch_s"):
                continue
            buckets[b] += float(lb.get(b, 0.0))
        buckets["launch_s"] += float(led.get("launch_s", 0.0))
        start = int(led.get("start_step", 0))
        end = int(led.get("end_step", start))
        steps = max(0, end - start)
        replay_steps = 0
        if max_end is not None and start < max_end:
            replay_steps = min(steps, max_end - start)
        if replay_steps and steps:
            replay_s = float(lb.get("productive_s", 0.0)) * (
                replay_steps / steps)
            buckets["rollback_replay_s"] += replay_s
            buckets["productive_s"] -= replay_s
        max_end = end if max_end is None else max(max_end, end)
        attempts.append({"start_step": start, "end_step": end,
                         "wall_s": led.get("wall_s"),
                         "replay_steps": replay_steps,
                         "completed": led.get("completed")})
    accounted = sum(buckets.values())
    buckets["other_s"] = float(wall_s) - accounted
    total = sum(buckets.values())  # == wall_s by construction
    return {
        "wall_s": float(wall_s),
        "goodput_fraction": (buckets["productive_s"] / wall_s
                             if wall_s > 0 else 0.0),
        "buckets": {b: round(v, 4) for b, v in buckets.items()},
        "buckets_sum_s": round(total, 4),
        "attempts": attempts,
        "events": {"restarts": restarts, "preemptions": preemptions,
                   "rollbacks": rollbacks},
        "ledgers": len(ledgers),
        "schema": GOODPUT_SCHEMA,
    }


def write_goodput(telemetry_dir: str, report: Dict[str, Any]) -> str:
    os.makedirs(telemetry_dir, exist_ok=True)
    path = os.path.join(telemetry_dir, "goodput.json")
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(report, f, indent=2)
    os.replace(tmp, path)
    return path


def read_goodput(telemetry_dir: str) -> Optional[Dict[str, Any]]:
    try:
        with open(os.path.join(telemetry_dir, "goodput.json")) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return None


def buckets_consistent(report: Dict[str, Any],
                       tolerance: float = 0.05) -> bool:
    """The pinned invariant: bucket sum within ``tolerance`` of wall."""
    wall = float(report.get("wall_s", 0.0))
    total = sum(float(v) for v in report.get("buckets", {}).values())
    if wall <= 0:
        return False
    return abs(total - wall) <= tolerance * wall
