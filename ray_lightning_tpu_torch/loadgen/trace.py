"""The versioned, replayable workload trace format (twin of
`ray_lightning_tpu/loadgen/trace.py`: the same bytes for the same
events, and a trace written by either package replays in the other).

A trace is JSONL: one header line (kind + version + generator
metadata) followed by one event line per request, sorted by
``(tick, rid)``. Events carry everything a bitwise replay needs —
explicit prompt token ids (never "regenerate from a seed": the trace
must replay against any engine without assuming the generator's
vocab), sampling knobs, and the traffic class — so a recorded
production trace and a synthetic generated one are the same artifact
(docs/SERVING.md "traffic & SLO classes").

Serialization is canonical (sorted keys, compact separators): the
``--smoke`` determinism pin compares whole traces as BYTES, and a
re-serialized read-back must round-trip identically.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

TRACE_VERSION = 1
TRACE_KIND = "rlt-loadgen-trace"

__all__ = [
    "TRACE_KIND",
    "TRACE_VERSION",
    "TraceEvent",
    "TraceRecorder",
    "arrivals_by_tick",
    "dump_trace",
    "events_from_arrivals",
    "read_trace",
    "to_request",
    "write_trace",
]


@dataclasses.dataclass(frozen=True)
class TraceEvent:
    """One arrival: ``tick`` is the VIRTUAL tick (runner clock) the
    request enters the system."""

    tick: int
    rid: str
    prompt: Tuple[int, ...]
    max_new_tokens: int
    priority: str = "standard"
    temperature: float = 0.0
    top_k: Optional[int] = None
    seed: int = 0

    def to_dict(self) -> dict:
        return {
            "tick": self.tick, "rid": self.rid,
            "prompt": list(self.prompt),
            "max_new_tokens": self.max_new_tokens,
            "priority": self.priority,
            "temperature": self.temperature,
            "top_k": self.top_k, "seed": self.seed,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "TraceEvent":
        return cls(
            tick=int(d["tick"]), rid=str(d["rid"]),
            prompt=tuple(int(t) for t in d["prompt"]),
            max_new_tokens=int(d["max_new_tokens"]),
            # absent on traces recorded before traffic classes
            priority=str(d.get("priority", "standard")),
            temperature=float(d.get("temperature", 0.0)),
            top_k=(None if d.get("top_k") is None
                   else int(d["top_k"])),
            seed=int(d.get("seed", 0)),
        )


def _canon(obj) -> str:
    return json.dumps(obj, sort_keys=True, separators=(",", ":"))


def dump_trace(events: Sequence[TraceEvent],
               meta: Optional[dict] = None) -> str:
    """Canonical serialization — the byte-level determinism surface."""
    ordered = sorted(events, key=lambda e: (e.tick, e.rid))
    header = {"kind": TRACE_KIND, "version": TRACE_VERSION,
              "events": len(ordered), "meta": meta or {}}
    lines = [_canon(header)]
    lines.extend(_canon(e.to_dict()) for e in ordered)
    return "\n".join(lines) + "\n"


def write_trace(path: str, events: Sequence[TraceEvent],
                meta: Optional[dict] = None) -> None:
    with open(path, "w") as f:
        f.write(dump_trace(events, meta))


def read_trace(path: str) -> Tuple[dict, List[TraceEvent]]:
    """Returns ``(header, events)``; refuses unknown kinds/versions
    instead of misreading them."""
    with open(path) as f:
        lines = [ln for ln in f.read().splitlines() if ln.strip()]
    if not lines:
        raise ValueError(f"{path}: empty trace")
    header = json.loads(lines[0])
    if header.get("kind") != TRACE_KIND:
        raise ValueError(
            f"{path}: not a {TRACE_KIND} (kind={header.get('kind')!r})")
    if header.get("version") != TRACE_VERSION:
        raise ValueError(
            f"{path}: trace version {header.get('version')!r}, this "
            f"reader speaks {TRACE_VERSION}")
    events = [TraceEvent.from_dict(json.loads(ln)) for ln in lines[1:]]
    if header.get("events") not in (None, len(events)):
        raise ValueError(
            f"{path}: header claims {header['events']} events, file "
            f"holds {len(events)} — truncated trace")
    return header, events


def to_request(ev: TraceEvent):
    """Materialize the `serve.scheduler.Request` an event describes."""
    from ray_lightning_tpu_torch.serve.scheduler import Request

    return Request(
        rid=ev.rid, prompt=np.asarray(ev.prompt, np.int32),
        max_new_tokens=ev.max_new_tokens, temperature=ev.temperature,
        top_k=ev.top_k, seed=ev.seed, priority=ev.priority)


def arrivals_by_tick(events: Sequence[TraceEvent]) -> Dict[int, list]:
    """``{tick: [Request, ...]}`` — the runner/`ScriptedLoad`
    vocabulary. Within a tick, submission order is the trace's
    canonical ``(tick, rid)`` order."""
    out: Dict[int, list] = {}
    for ev in sorted(events, key=lambda e: (e.tick, e.rid)):
        out.setdefault(ev.tick, []).append(to_request(ev))
    return out


def events_from_arrivals(arrivals: Dict[int, Sequence]) \
        -> List[TraceEvent]:
    """The inverse: lift a scripted ``{tick: [Request]}`` schedule
    (e.g. `autoscale.sim.ScriptedLoad.arrivals`) into trace events."""
    events: List[TraceEvent] = []
    for tick in sorted(arrivals):
        for req in arrivals[tick]:
            events.append(TraceEvent(
                tick=int(tick), rid=req.rid,
                prompt=tuple(int(t) for t in
                             np.asarray(req.prompt).reshape(-1)),
                max_new_tokens=req.max_new_tokens,
                priority=req.priority, temperature=req.temperature,
                top_k=req.top_k, seed=req.seed))
    return events


class TraceRecorder:
    """Record-and-replay capture: hand one to `runner.run_trace` (or
    call ``record()`` wherever submissions happen) and the live run's
    arrival schedule becomes a replayable trace."""

    def __init__(self, meta: Optional[dict] = None):
        self.meta = meta or {}
        self.events: List[TraceEvent] = []

    def record(self, tick: int, req) -> None:
        self.events.extend(events_from_arrivals({tick: [req]}))

    def dump(self) -> str:
        return dump_trace(self.events, self.meta)

    def write(self, path: str) -> None:
        write_trace(path, self.events, self.meta)
