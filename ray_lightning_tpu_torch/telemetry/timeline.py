"""One pane of glass: every evidence ledger a run leaves behind, merged
into a single causally-ordered event stream (twin of
`ray_lightning_tpu/telemetry/timeline.py`; it reads the JAX package's
ledgers too, the autoscale and reshard ledgers included).

The framework persists seven disjoint evidence streams — telemetry
spans, goodput attempt ledgers, per-replica serving metrics JSONL,
flight rings, the autoscale decision ledger, the reshard ledger, and
incident records — each with its own schema and reader. Diagnosing
"why did TTFT p99 spike at 14:32" used to mean hand-joining five files
by eye. This module gives them ONE vocabulary:

    Event(wall, source, kind, rank/replica, dur_s, step, payload,
          aligned)

``wall`` is epoch seconds reconstructed from each ledger's
clock-alignment header (``t0_wall`` stamped at recorder construction +
the entry's monotonic offset — the same pair spans.py has always
carried; the JAX package stamps autoscale.jsonl and reshards.jsonl
the same way). A legacy headerless ledger still ingests — its events are tagged
``aligned=False`` and sort after the aligned stream on their raw
offsets instead of crashing the merge.

Everything here is a pure function over files the hot paths already
write: assembling a timeline costs the RUN nothing (zero new host
syncs, no device work — the watch/incident layer rides the same
guarantee, test-pinned like telemetry=off).

Surfaces:

  * ``load_timeline_events(run_dir)`` — the merged, ordered stream plus
    per-source counts and a garbage-line tally;
  * ``to_chrome_trace(events)`` — Chrome trace-event JSON
    (``chrome://tracing`` / Perfetto opens a full supervised run —
    compile, steps, ckpt stalls, restarts, reshards, replica deaths,
    scale decisions, request lifecycles — as one trace);
  * ``python -m ray_lightning_tpu_torch timeline <run_dir> [--chrome out]`` —
    text rendering or the trace export (docs/OBSERVABILITY.md
    "unified timeline").
"""
from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import os
import sys
from typing import Any, Dict, List, Optional, Tuple

#: every source subsystem the merger knows; an adapter contributes at
#: most one of these (the acceptance gate wants >= 4 present in a full
#: serving-run trace)
TIMELINE_SOURCES = (
    "spans",        # telemetry/spans.py rank*.spans.jsonl
    "goodput",      # telemetry/goodput.py ledger.rank*.json attempts
    "metrics",      # telemetry/metrics.py replica*/driver*.metrics.jsonl
    "flight",       # flight rings + the run-level flight.json postmortems
    "autoscale",    # autoscale/controller.py autoscale.jsonl
    "reshard",      # resilience/supervisor.py reshards.jsonl
    "incident",     # telemetry/incidents.py incidents.jsonl
)


@dataclasses.dataclass
class Event:
    """One timeline event. ``wall`` is epoch seconds when the source
    ledger carried a clock-alignment header (``aligned=True``);
    otherwise ``wall`` is the entry's RAW monotonic offset and the
    event is tagged unaligned — present, ordered among its peers, but
    not placed on the shared wall-clock axis."""

    wall: float
    source: str
    kind: str
    aligned: bool = True
    rank: Optional[int] = None
    replica: Optional[int] = None
    dur_s: Optional[float] = None
    step: Optional[int] = None
    payload: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def to_dict(self) -> dict:
        d: Dict[str, Any] = {"wall": round(self.wall, 6),
                             "source": self.source, "kind": self.kind}
        if not self.aligned:
            d["aligned"] = False
        for k in ("rank", "replica", "dur_s", "step"):
            v = getattr(self, k)
            if v is not None:
                d[k] = v
        if self.payload:
            d["payload"] = self.payload
        return d


def _safe_float(v: Any, default: float = 0.0) -> float:
    try:
        return float(v)
    except (TypeError, ValueError):
        return default


def _jsonl_entries(path: str, tail_bytes: Optional[int] = None
                   ) -> Tuple[Dict[str, Any], List[dict], int]:
    """(header, entries, garbage_lines) for one JSONL ledger, on the
    shared `ledger_tail_lines` substrate (the first line is the
    clock-alignment header slot a tail-bounded read must never lose).
    The header is the first line when it carries a ``version`` field;
    garbage lines are counted, never fatal — a ledger torn by a kill
    mid-append must still contribute its readable prefix."""
    from ray_lightning_tpu_torch.telemetry.spans import ledger_tail_lines

    header: Dict[str, Any] = {}
    entries: List[dict] = []
    bad = 0
    try:
        first, body = ledger_tail_lines(path, tail_bytes)
    except OSError:
        return header, entries, bad
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
        if i == 0 and "version" in obj:
            header = obj
            continue
        entries.append(obj)
    return header, entries, bad


# ---- per-ledger adapters ---------------------------------------------------
# Each returns (events, garbage_line_count). Adapters never raise on a
# malformed ledger: a partial run dir is the NORMAL input here.


def _events_from_spans(tdir: str, tail_bytes: Optional[int] = None
                       ) -> Tuple[List[Event], int]:
    from ray_lightning_tpu_torch.telemetry.spans import read_spans

    events: List[Event] = []
    bad = 0
    for path in sorted(glob.glob(os.path.join(tdir,
                                              "rank*.spans.jsonl"))):
        try:
            parsed = read_spans(path, tail_bytes=tail_bytes)
        except OSError:
            continue
        bad += parsed.get("unparseable_lines", 0)
        header = parsed.get("header") or {}
        t0 = header.get("t0_wall")
        rank = header.get("rank")
        aligned = t0 is not None
        for span in parsed["spans"]:
            t = _safe_float(span.get("t"))
            payload = {}
            if span.get("thread") not in (None, "main"):
                payload["thread"] = span["thread"]
            if span.get("meta"):
                payload.update(span["meta"])
            events.append(Event(
                wall=(t0 + t) if aligned else t,
                source="spans", kind=str(span.get("phase", "?")),
                aligned=aligned,
                rank=rank if rank is not None else None,
                dur_s=span.get("dur"), step=span.get("step"),
                payload=payload))
    return events, bad


def _events_from_goodput(tdir: str) -> Tuple[List[Event], int]:
    from ray_lightning_tpu_torch.telemetry.goodput import read_ledgers

    events: List[Event] = []
    try:
        ledgers = read_ledgers(tdir, rank=None)
    except OSError:
        return events, 0
    for led in ledgers:
        t0 = led.get("t0_wall")
        events.append(Event(
            wall=_safe_float(t0), source="goodput", kind="attempt",
            aligned=t0 is not None, rank=led.get("rank"),
            dur_s=led.get("wall_s"),
            payload={"start_step": led.get("start_step"),
                     "end_step": led.get("end_step"),
                     "completed": led.get("completed"),
                     "launch_s": led.get("launch_s")}))
    return events, 0


def _events_from_metrics(tdir: str, tail_bytes: Optional[int] = None
                         ) -> Tuple[List[Event], int]:
    from ray_lightning_tpu_torch.telemetry.metrics import read_metrics

    events: List[Event] = []
    bad = 0
    paths = sorted(glob.glob(os.path.join(tdir, "*.metrics.jsonl")))
    for path in paths:
        try:
            parsed = read_metrics(path, tail_bytes=tail_bytes)
        except OSError:
            continue
        bad += parsed.get("unparseable_lines", 0)
        header = parsed.get("header") or {}
        t0 = header.get("t0_wall")
        aligned = t0 is not None
        replica = header.get("replica")
        driver = os.path.basename(path).startswith("driver")
        for sample in parsed["ticks"]:
            t = _safe_float(sample.get("t"))
            g = sample.get("g") or {}
            payload = {k: g[k] for k in
                       ("queue_depth", "decoding_slots", "free_slots",
                        "blocks_free", "slot_occupancy",
                        "replicas_live", "pending_requests")
                       if k in g}
            events.append(Event(
                wall=(t0 + t) if aligned else t, source="metrics",
                kind="driver_tick" if driver else "tick",
                aligned=aligned,
                replica=None if driver else replica,
                step=sample.get("tick"), payload=payload))
    return events, bad


def _events_from_flight(run_dir: str, tdir: str) -> Tuple[List[Event],
                                                          int]:
    from ray_lightning_tpu_torch.telemetry.metrics import read_flight

    events: List[Event] = []
    bad = 0

    def _ring_events(doc: dict, replica: Optional[int]) -> None:
        t0 = doc.get("t0_wall")
        aligned = t0 is not None
        for ev in doc.get("events") or []:
            if not isinstance(ev, dict):
                continue
            t = _safe_float(ev.get("t"))
            payload = {k: v for k, v in ev.items()
                       if k not in ("t", "kind")}
            events.append(Event(
                wall=(t0 + t) if aligned else t, source="flight",
                kind=str(ev.get("kind", "?")), aligned=aligned,
                replica=replica, payload=payload))

    for path in sorted(glob.glob(os.path.join(tdir, "*.flight.json"))):
        doc = read_flight(path)
        if doc is None:
            bad += 1
            continue
        _ring_events(doc, doc.get("replica"))
    # the run-level postmortem file: per-death dumps, each its own ring
    # plus the classified death stamp
    out_path = os.path.join(run_dir, "flight.json")
    if os.path.exists(out_path):
        try:
            with open(out_path) as f:
                doc = json.load(f)
        except (OSError, json.JSONDecodeError):
            doc = None
            bad += 1
        if isinstance(doc, dict):
            for dump in doc.get("dumps") or []:
                if not isinstance(dump, dict):
                    continue
                _ring_events(dump, dump.get("replica"))
                at = dump.get("dumped_at_wall")
                events.append(Event(
                    wall=_safe_float(at), source="flight",
                    kind="death", aligned=at is not None,
                    replica=dump.get("replica"),
                    payload=dict(dump.get("death") or {})))
    return events, bad


def _events_from_autoscale(run_dir: str,
                           tail_bytes: Optional[int] = None
                           ) -> Tuple[List[Event], int]:
    path = os.path.join(run_dir, "autoscale.jsonl")
    if not os.path.exists(path):
        return [], 0
    header, entries, bad = _jsonl_entries(path, tail_bytes)
    t0 = header.get("t0_wall")
    events: List[Event] = []
    for e in entries:
        decision = e.get("decision") or {}
        outcome = e.get("outcome") or {}
        signal = e.get("signal") or {}
        payload: Dict[str, Any] = {
            "target": decision.get("target"),
            "reason": (decision.get("reason") or "")[:160],
            "replicas": e.get("replicas"),
            "now": e.get("now"),
        }
        if not outcome.get("ok", True):
            payload["outcome_ok"] = False
        if signal.get("pressure") is not None:
            payload["pressure"] = signal["pressure"]
        cap = e.get("capacity")
        if cap:
            payload["capacity"] = cap.get("worlds")
            payload["capacity_source"] = cap.get("source")
        # "t" is the entry's monotonic offset from the header's t0_perf
        # (stamped by the JAX autoscale controller); a legacy ledger has
        # neither, so its entries ride the policy's own "now" clock —
        # internally ordered, not wall-placeable
        t = e.get("t")
        aligned = t0 is not None and t is not None
        events.append(Event(
            wall=(t0 + _safe_float(t)) if aligned
            else _safe_float(e.get("now")),
            source="autoscale",
            kind=str(decision.get("action", "?")), aligned=aligned,
            dur_s=e.get("duration_s"), payload=payload))
    return events, bad


def _events_from_reshards(run_dir: str, tdir: str,
                          tail_bytes: Optional[int] = None
                          ) -> Tuple[List[Event], int]:
    events: List[Event] = []
    bad = 0
    for base in dict.fromkeys((run_dir, tdir)):
        path = os.path.join(base, "reshards.jsonl")
        if not os.path.exists(path):
            continue
        _header, entries, b = _jsonl_entries(path, tail_bytes)
        bad += b
        for e in entries:
            # reshard entries carry an epoch "at" stamp of their own;
            # the header is the uniform-schema stamp, not a decoder key
            at = e.get("at")
            events.append(Event(
                wall=_safe_float(at), source="reshard",
                kind=str(e.get("reason", "?")), aligned=at is not None,
                payload={k: e[k] for k in
                         ("from_world", "to_world", "attempt",
                          "capacity", "capacity_source")
                         if k in e}))
    return events, bad


def _events_from_incidents(run_dir: str,
                           tail_bytes: Optional[int] = None
                           ) -> Tuple[List[Event], int]:
    from ray_lightning_tpu_torch.telemetry.incidents import read_incidents

    parsed = read_incidents(run_dir, tail_bytes=tail_bytes)
    events: List[Event] = []
    for inc in parsed["incidents"]:
        wall = inc.get("wall")
        events.append(Event(
            wall=_safe_float(wall), source="incident",
            kind=str(inc.get("rule", "?")), aligned=wall is not None,
            payload={"severity": inc.get("severity"),
                     "value": (inc.get("evidence") or {}).get("value"),
                     "threshold": (inc.get("evidence")
                                   or {}).get("threshold")}))
    return events, parsed["unparseable_lines"]


# ---- the merge -------------------------------------------------------------


def _telemetry_dir(run_dir: str) -> str:
    from ray_lightning_tpu_torch.telemetry.report import telemetry_dir

    return telemetry_dir(run_dir)


def load_timeline_events(run_dir: str,
                         tail_bytes: Optional[int] = None,
                         telemetry_dir: Optional[str] = None
                         ) -> Dict[str, Any]:
    """Assemble the unified timeline for ``run_dir``. Returns
    ``{"events": [Event...], "sources": {source: count}, "unaligned":
    n, "garbage_lines": n}``. Events are ordered by aligned wall time
    (unaligned events sort within their source on their raw offsets,
    after the aligned stream — the merge never GUESSES a headerless
    ledger's epoch). A partial run dir — only one ledger, or none —
    returns the partial stream, never raises. ``tail_bytes`` bounds
    every per-file read (cadence-polled callers like the
    watch engine's excerpt pass one; the one-shot CLI reads
    everything); ``telemetry_dir`` overrides the
    ``<run_dir>/telemetry`` convention for TelemetryConfig(dir=...)
    runs."""
    tdir = telemetry_dir or _telemetry_dir(run_dir)
    # run-level ledgers (autoscale/reshards/incidents/flight.json) sit
    # BESIDE the telemetry dir; accept either dir as the argument
    base = run_dir if tdir != run_dir else os.path.dirname(run_dir)
    collected: List[Tuple[List[Event], int]] = [
        _events_from_spans(tdir, tail_bytes),
        _events_from_goodput(tdir),
        _events_from_metrics(tdir, tail_bytes),
        _events_from_flight(base, tdir),
        _events_from_autoscale(base, tail_bytes),
        _events_from_reshards(base, tdir, tail_bytes),
        _events_from_incidents(base, tail_bytes),
    ]
    events: List[Event] = []
    garbage = 0
    for evs, bad in collected:
        events.extend(evs)
        garbage += bad
    aligned = sorted((e for e in events if e.aligned),
                     key=lambda e: e.wall)
    unaligned = sorted((e for e in events if not e.aligned),
                       key=lambda e: (e.source, e.wall))
    ordered = aligned + unaligned
    sources: Dict[str, int] = {}
    for e in ordered:
        sources[e.source] = sources.get(e.source, 0) + 1
    return {"run_dir": run_dir, "telemetry_dir": tdir,
            "events": ordered, "sources": sources,
            "unaligned": len(unaligned), "garbage_lines": garbage}


def timeline_excerpt(events: List[Event], wall: float,
                     n: int = 8) -> List[dict]:
    """The +-``n`` aligned events surrounding ``wall`` — the context an
    incident record carries so a breach self-documents
    (docs/OBSERVABILITY.md "incident capture")."""
    aligned = [e for e in events if e.aligned]
    if not aligned:
        return []
    lo = 0
    for i, e in enumerate(aligned):
        if e.wall <= wall:
            lo = i
        else:
            break
    window = aligned[max(0, lo - n):lo + n + 1]
    return [e.to_dict() for e in window]


# ---- Chrome trace export ---------------------------------------------------

#: sources whose events render as duration ("X") slices when they carry
#: a dur_s; everything else is an instant ("i")
_TRACK_OF_SOURCE = {s: i for i, s in enumerate(TIMELINE_SOURCES)}


def _lane(e: Event) -> Tuple[int, str]:
    """(tid, lane label) for one event — per-rank/replica lanes inside
    each source's process group."""
    if e.rank is not None:
        return int(e.rank) + 1000, f"rank {e.rank}"
    if e.replica is not None:
        return int(e.replica), f"replica {e.replica}"
    return -1, "driver"


def to_chrome_trace(events: List[Event]) -> Dict[str, Any]:
    """Chrome trace-event JSON (the ``traceEvents`` array format —
    chrome://tracing, Perfetto, speedscope all open it). Aligned events
    are placed on one microsecond axis anchored at the earliest aligned
    wall; unaligned events land in a dedicated ``unaligned`` process
    group on their raw offsets, flagged in ``args``."""
    aligned = [e for e in events if e.aligned]
    t0 = min((e.wall for e in aligned), default=0.0)
    trace: List[dict] = []
    seen_pids: Dict[int, str] = {}
    seen_tids: set = set()
    unaligned_pid = len(TIMELINE_SOURCES)
    for e in events:
        pid = (_TRACK_OF_SOURCE.get(e.source, unaligned_pid)
               if e.aligned else unaligned_pid)
        pname = e.source if e.aligned else "unaligned"
        if pid not in seen_pids:
            seen_pids[pid] = pname
            trace.append({"ph": "M", "name": "process_name",
                          "pid": pid, "tid": 0,
                          "args": {"name": pname}})
        tid, lane = _lane(e)
        if (pid, tid) not in seen_tids:
            seen_tids.add((pid, tid))
            trace.append({"ph": "M", "name": "thread_name",
                          "pid": pid, "tid": tid,
                          "args": {"name": lane}})
        ts = (e.wall - t0) * 1e6 if e.aligned else e.wall * 1e6
        args: Dict[str, Any] = dict(e.payload)
        if e.step is not None:
            args["step"] = e.step
        if not e.aligned:
            args["unaligned"] = True
            args["source"] = e.source
        entry: Dict[str, Any] = {
            "name": e.kind, "cat": e.source, "pid": pid, "tid": tid,
            "ts": round(max(0.0, ts), 3), "args": args,
        }
        if e.dur_s is not None and e.dur_s > 0:
            # span-shaped entries stamp their START offset, so ts is
            # already the slice's left edge
            entry["ph"] = "X"
            entry["dur"] = round(e.dur_s * 1e6, 3)
        else:
            entry["ph"] = "i"
            entry["s"] = "g"
        trace.append(entry)
    return {"traceEvents": trace, "displayTimeUnit": "ms",
            "otherData": {"tool": "ray_lightning_tpu_torch timeline",
                          "t0_wall": t0}}


def validate_chrome_trace(doc: Any) -> List[str]:
    """Structural validation against the trace-event contract the
    export promises (what the adapter tests and the smoke gate
    assert): a ``traceEvents`` list whose every entry carries
    name/ph/pid/tid and a numeric non-negative ``ts``, duration events
    a numeric ``dur``. Returns problem strings (empty = valid)."""
    problems: List[str] = []
    if not isinstance(doc, dict) or not isinstance(
            doc.get("traceEvents"), list):
        return ["no traceEvents list"]
    for i, ev in enumerate(doc["traceEvents"]):
        if not isinstance(ev, dict):
            problems.append(f"event {i} is not an object")
            continue
        for key in ("name", "ph", "pid", "tid"):
            if key not in ev:
                problems.append(f"event {i} missing {key!r}")
        if ev.get("ph") == "M":
            continue
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)) or ts < 0:
            problems.append(f"event {i} bad ts {ts!r}")
        if ev.get("ph") == "X" and not isinstance(
                ev.get("dur"), (int, float)):
            problems.append(f"event {i} duration without dur")
    return problems


# ---- rendering + CLI -------------------------------------------------------


def _fmt_wall(e: Event, t0: float) -> str:
    if not e.aligned:
        return f"   +{e.wall:10.3f}?"
    import time as _time

    frac = e.wall - int(e.wall)
    return (_time.strftime("%H:%M:%S", _time.localtime(e.wall))
            + f".{int(frac * 1000):03d} +{e.wall - t0:8.3f}")


def render_text(timeline: Dict[str, Any], limit: int = 0,
                sources: Optional[List[str]] = None) -> str:
    events: List[Event] = timeline["events"]
    if sources:
        events = [e for e in events if e.source in sources]
    total = len(events)
    if limit and total > limit:
        events = events[-limit:]
    aligned_walls = [e.wall for e in events if e.aligned]
    t0 = min(aligned_walls, default=0.0)
    lines = [f"timeline: {timeline['run_dir']} — {total} event(s) from "
             f"{len(timeline['sources'])} source(s) "
             f"({', '.join(f'{s}:{n}' for s, n in sorted(timeline['sources'].items()))})"]
    if timeline["garbage_lines"]:
        lines.append(f"  {timeline['garbage_lines']} unparseable "
                     "ledger line(s) skipped")
    if timeline["unaligned"]:
        lines.append(f"  {timeline['unaligned']} event(s) from "
                     "headerless ledgers are tagged unaligned ('?' "
                     "offsets — not on the shared wall axis)")
    if limit and total > limit:
        lines.append(f"  (showing the last {limit})")
    for e in events:
        who = (f"rank {e.rank}" if e.rank is not None
               else f"replica {e.replica}" if e.replica is not None
               else "-")
        dur = f" dur={e.dur_s * 1e3:.1f}ms" if e.dur_s else ""
        step = f" step={e.step}" if e.step is not None else ""
        extra = ""
        if e.payload:
            bits = [f"{k}={v}" for k, v in list(e.payload.items())[:4]]
            extra = "  " + " ".join(bits)
        lines.append(f"  {_fmt_wall(e, t0)}  {e.source:<9} {who:<10} "
                     f"{e.kind}{dur}{step}{extra}")
    return "\n".join(lines)


def add_timeline_parser(sub) -> None:
    p = sub.add_parser(
        "timeline",
        help="merge every evidence ledger under a run dir into one "
             "causally-ordered event stream; --chrome exports "
             "Chrome-trace/Perfetto JSON (docs/OBSERVABILITY.md "
             "'unified timeline')")
    p.add_argument("run_dir", help="run dir (or its telemetry/ subdir)")
    p.add_argument("--chrome", metavar="OUT", default=None,
                   help="write Chrome trace-event JSON here ('-' for "
                        "stdout) instead of the text rendering")
    p.add_argument("--source", action="append", default=None,
                   choices=TIMELINE_SOURCES,
                   help="restrict to these sources (repeatable)")
    p.add_argument("--limit", type=int, default=200,
                   help="text mode: show only the last N events "
                        "(0 = all)")
    p.add_argument("--json", action="store_true", dest="as_json",
                   default=argparse.SUPPRESS)


def run_timeline(args) -> int:
    if not os.path.isdir(args.run_dir):
        print(f"error: {args.run_dir} is not a directory",
              file=sys.stderr)
        return 2
    timeline = load_timeline_events(args.run_dir)
    events: List[Event] = timeline["events"]
    if args.source:
        events = [e for e in events if e.source in args.source]
    if args.chrome:
        doc = to_chrome_trace(events)
        if args.chrome == "-":
            json.dump(doc, sys.stdout)
            print()
        else:
            with open(args.chrome, "w") as f:
                json.dump(doc, f)
            print(f"wrote {len(doc['traceEvents'])} trace event(s) "
                  f"from {len(timeline['sources'])} source(s) to "
                  f"{args.chrome}")
        return 0
    if getattr(args, "as_json", False):
        print(json.dumps({
            "run_dir": timeline["run_dir"],
            "sources": timeline["sources"],
            "unaligned": timeline["unaligned"],
            "garbage_lines": timeline["garbage_lines"],
            "events": [e.to_dict() for e in events],
        }))
        return 0
    print(render_text({**timeline, "events": events},
                      limit=args.limit))
    return 0
