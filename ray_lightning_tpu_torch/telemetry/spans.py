"""Span recorder: where host wall-clock actually goes, per rank (twin
of `ray_lightning_tpu/telemetry/spans.py`; the files are the same
format, so either package's readers read the other's).

The fit loop already has host-resident seams for every phase that can
cost wall time — the step dispatch call, the cadenced metric fetch, the
blocking part of a checkpoint save, eval epochs — plus the driver-side
supervision phases (restart backoff, attempt launch). This module gives
those seams one cheap vocabulary:

    with recorder.span(PH_DISPATCH, step=global_step):
        metrics = self._train_step(batch)

A span is a host-side ``(phase, start, dur, step, thread)`` record in a
bounded ring (``collections.deque(maxlen=...)``) that is flushed to
JSONL per rank under the run dir on a cadence the caller controls.
Nothing here touches a tensor: no ``.item()``, no ``.cpu()``, no
``torch.cuda.synchronize()`` — a span measures how long the HOST spent
inside a region, so telemetry=off and telemetry=on launch the same
kernels in the same order and telemetry adds zero host syncs. PyTorch
returns from a CUDA call once the work is enqueued, so a dispatch span
measures the enqueue of the step, not its kernels.

``NullRecorder`` is the off switch: the same surface with a shared
reusable no-op context, so call sites never branch.

Clock alignment: each JSONL file opens with a header line carrying the
pair ``(t0_wall, t0_perf)``; span ``t`` fields are perf_counter offsets
from ``t0_perf``, so the driver-side report can place every rank's
spans on one wall-clock axis (time.time is NTP-aligned across hosts to
far better than a training step).
"""
from __future__ import annotations

import collections
import itertools
import json
import os
import time
from typing import Any, Dict, List, Optional

from ray_lightning_tpu_torch.analysis.lockwatch import san_lock

#: per-process recorder sequence: a second fit in the same process (or
#: two trainers sharing one telemetry dir — the sweep inline executor)
#: must get its OWN files, never truncate an earlier recorder's
_FILE_SEQ = itertools.count()

# ---- phase vocabulary (docs/OBSERVABILITY.md "span schema") ---------------

PH_DATA_WAIT = "data_wait"      # consumer blocked on the prefetch queue
PH_H2D = "h2d"                  # cast + shard + device_put (producer thread)
PH_DISPATCH = "dispatch"        # enqueueing the step (async CUDA launches)
PH_METRICS = "metrics_fetch"    # cadenced lazy metric fetch (host sync)
PH_CKPT = "ckpt_stall"          # training thread blocked on checkpoint I/O
PH_COMPILE = "compile"          # the warm start before the loop
PH_EVAL = "eval"                # a validation/test epoch
PH_BACKOFF = "backoff"          # supervisor restart backoff sleep (driver)
PH_ATTEMPT = "attempt"          # one supervised launch, wall (driver)
PH_ROLLBACK = "rollback"        # rollback target selection (driver)
PH_RESHARD = "reshard"          # cross-topology checkpoint restore: the
#                                 worker-side resharding load after an
#                                 elastic world-size change (plus the
#                                 driver's shrink/grow decision span)
PH_STEP = "step"                # per-step host wall (batch_end to batch_end)

#: every phase the schema knows; foreign phases are legal (the recorder
#: is a vocabulary, not a validator) but the report groups them as-is
PHASES = (
    PH_DATA_WAIT, PH_H2D, PH_DISPATCH, PH_METRICS, PH_CKPT, PH_COMPILE,
    PH_EVAL, PH_BACKOFF, PH_ATTEMPT, PH_ROLLBACK, PH_RESHARD, PH_STEP,
)

# ---- serving phases (serve/, docs/SERVING.md) -----------------------------
# Recorded per REQUEST at completion (explicit record() calls on the
# scheduler's measured host times, flushed on a cadence), never per
# engine tick: the serving loop is a hot loop and the flush cadence
# applies to it too. Kept OUT of `PHASES` on purpose — the
# training goodput buckets (telemetry/goodput.py) must not learn
# request-scoped phases whose spans overlap each other by design.

PH_QUEUE_WAIT = "queue_wait"    # request submitted -> slot admitted
PH_PREFILL = "prefill"          # admitted -> prompt fully prefilled
PH_DECODE = "decode"            # first sampled token -> retirement
PH_DETOK = "detokenize"         # token ids -> text (driver side)

SERVE_PHASES = (PH_QUEUE_WAIT, PH_PREFILL, PH_DECODE, PH_DETOK)

#: phases recorded from background threads overlap with compute and must
#: NOT be charged against the main thread's wall-time budget
THREAD_MAIN = "main"
THREAD_PRODUCER = "producer"

SPANS_VERSION = "rlt-spans-v1"


class _SpanCtx:
    """One `with recorder.span(...)` region. Slots + a single perf_counter
    pair: the per-span cost is two clock reads, a dict build, and a
    deque append — nanoseconds next to the millisecond phases it times.

    Main-thread spans nest (a lazy eval-step compile runs INSIDE the
    eval span): the span entry keeps the full duration, but the phase
    TOTALS are charged exclusively — a nested child's time is deducted
    from its parent — so the goodput buckets never double-count one
    wall-clock second."""

    __slots__ = ("_rec", "phase", "step", "thread", "meta", "_t0",
                 "child_s")

    def __init__(self, rec: "TelemetryRecorder", phase: str,
                 step: Optional[int], thread: str, meta: Optional[dict]):
        self._rec = rec
        self.phase = phase
        self.step = step
        self.thread = thread
        self.meta = meta
        self.child_s = 0.0

    def __enter__(self) -> "_SpanCtx":
        self._t0 = time.perf_counter()
        if self.thread == THREAD_MAIN:
            self._rec._stack.append(self)
            self._rec._phase = self.phase
        return self

    def __exit__(self, *exc) -> None:
        t1 = time.perf_counter()
        dur = t1 - self._t0
        totals_s = dur
        if self.thread == THREAD_MAIN:
            stack = self._rec._stack
            if stack and stack[-1] is self:
                stack.pop()
            totals_s = max(0.0, dur - self.child_s)
            self._rec._phase = stack[-1].phase if stack else PH_STEP
        # record() credits the (now-exposed) parent with this span's
        # full duration — the same path explicit record() calls take
        self._rec.record(self.phase, self._t0, dur,
                         step=self.step, thread=self.thread,
                         meta=self.meta, totals_s=totals_s)
        return None


class TelemetryRecorder:
    """Bounded-ring span recorder with cadenced JSONL flush.

    ``directory=None`` records in memory only (phase totals + ring) —
    the mode unit tests use. With a
    directory, ``flush()`` appends the ring's unflushed spans to
    ``<directory>/rank<k>.spans.jsonl``; the trainer calls it on the
    logging cadence and at fit end, never per batch.

    Thread-safe: the producer thread (H2D spans) and the heartbeat
    thread (``current_phase``/``last_span``) share it with the fit loop.
    """

    def __init__(self, directory: Optional[str] = None, rank: int = 0,
                 ring_size: int = 4096):
        self.directory = directory
        self.rank = rank
        self.enabled = True
        self._lock = san_lock("telemetry.spans.recorder")
        self._ring: collections.deque = collections.deque(maxlen=ring_size)
        self._totals: Dict[str, float] = {}
        self._counts: Dict[str, int] = {}
        self._dropped = 0        # unflushed ring overwrites
        self._dropped_total = 0  # lifetime, for the metrics surface
        self._phase: str = "setup"      # read by the heartbeat thread
        self._stack: List[_SpanCtx] = []  # main-thread open spans
        self._last: Optional[dict] = None
        self._step: Optional[int] = None
        self.t0_perf = time.perf_counter()
        self.t0_wall = time.time()
        #: unique per-recorder token: pid distinguishes restarted
        #: attempts, the sequence distinguishes recorders WITHIN one
        #: process (re-fit, inline sweep trials) — nothing ever
        #: truncates an earlier timeline or ledger
        self.uid = f"{os.getpid()}-{next(_FILE_SEQ)}"
        self._path: Optional[str] = None
        if directory is not None:
            os.makedirs(directory, exist_ok=True)
            self._path = os.path.join(
                directory, f"rank{rank}.{self.uid}.spans.jsonl")
            with open(self._path, "w") as f:
                f.write(json.dumps({
                    "version": SPANS_VERSION, "rank": rank,
                    "t0_wall": self.t0_wall, "pid": os.getpid(),
                }) + "\n")

    # ---- recording -------------------------------------------------------

    def span(self, phase: str, step: Optional[int] = None,
             thread: str = THREAD_MAIN,
             meta: Optional[dict] = None) -> _SpanCtx:
        return _SpanCtx(self, phase, step if step is not None else self._step,
                        thread, meta)

    def record(self, phase: str, start_perf: float, dur_s: float,
               step: Optional[int] = None, thread: str = THREAD_MAIN,
               meta: Optional[dict] = None,
               totals_s: Optional[float] = None) -> None:
        """Record one completed span (explicit form; ``span()`` is the
        context-manager sugar over it). ``totals_s`` overrides the
        amount charged to the phase totals — nested main-thread spans
        charge exclusively so the goodput buckets never double-count.
        A main-thread record inside an OPEN main-thread span (an eval
        epoch's data_wait, a nested compile) credits the enclosing span
        the same way, and the exclusive charge is persisted as ``excl``
        so the report's totals agree with the recorder's."""
        charged = dur_s if totals_s is None else totals_s
        entry = {"phase": phase, "t": round(start_perf - self.t0_perf, 6),
                 "dur": round(dur_s, 6), "step": step, "thread": thread}
        if charged != dur_s:
            entry["excl"] = round(charged, 6)
        if meta:
            entry["meta"] = meta
        with self._lock:
            if len(self._ring) == self._ring.maxlen:
                self._dropped += 1
                self._dropped_total += 1
            self._ring.append(entry)
            if thread == THREAD_MAIN:
                if self._stack:
                    self._stack[-1].child_s += dur_s
                self._totals[phase] = self._totals.get(phase, 0.0) + charged
                self._counts[phase] = self._counts.get(phase, 0) + 1
            self._last = entry

    def set_step(self, step: int) -> None:
        self._step = step

    # ---- heartbeat-facing state (cross-thread reads are benign) ----------

    def current_phase(self) -> str:
        return self._phase

    def last_span(self) -> Optional[dict]:
        return self._last

    # ---- accounting ------------------------------------------------------

    def phase_totals(self) -> Dict[str, float]:
        """Main-thread wall seconds per phase (producer-thread spans are
        overlapped with compute and deliberately excluded — charging
        them would double-count the wall)."""
        with self._lock:
            return dict(self._totals)

    def phase_counts(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counts)

    @property
    def dropped(self) -> int:
        return self._dropped_total

    # ---- flush -----------------------------------------------------------

    def flush(self) -> int:
        """Append the ring's spans to the per-rank JSONL and clear it.
        Call on a cadence (the trainer uses the logging cadence) or at
        teardown — NEVER per batch."""
        if self._path is None:
            return 0
        with self._lock:
            batch: List[dict] = list(self._ring)
            self._ring.clear()
            dropped, self._dropped = self._dropped, 0
        if not batch and not dropped:
            return 0
        with open(self._path, "a") as f:
            for entry in batch:
                f.write(json.dumps(entry) + "\n")
            if dropped:
                f.write(json.dumps({"phase": "_dropped",
                                    "count": dropped}) + "\n")
        return len(batch)

    def close(self) -> None:
        self.flush()


class _NullCtx:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None


_NULL_CTX = _NullCtx()


class NullRecorder:
    """telemetry=off: the same surface, every call a no-op. One shared
    context object — ``span()`` allocates nothing."""

    directory = None
    rank = 0
    enabled = False
    dropped = 0

    def span(self, phase: str, step: Optional[int] = None,
             thread: str = THREAD_MAIN, meta: Optional[dict] = None):
        return _NULL_CTX

    def record(self, *a: Any, **kw: Any) -> None: ...
    def set_step(self, step: int) -> None: ...

    def current_phase(self) -> str:
        return ""

    def last_span(self) -> Optional[dict]:
        return None

    def phase_totals(self) -> Dict[str, float]:
        return {}

    def phase_counts(self) -> Dict[str, int]:
        return {}

    def flush(self) -> int:
        return 0

    def close(self) -> None: ...


#: the shared off-switch instance call sites default to
NULL_RECORDER = NullRecorder()


def ledger_tail_lines(path: str,
                      tail_bytes: Optional[int] = None):
    """``(first_line, body_lines)`` for one JSONL ledger. The first
    line is returned separately because it is the clock-alignment
    header slot — a TAIL-bounded read (``tail_bytes``) must never lose
    it, or the timeline merge would have to guess the ledger's epoch.
    With a bound, only the last ``tail_bytes`` of the body are read
    (the partial line at the window's cut edge is dropped) — the
    discipline for cadence-polled readers (`monitor --follow`,
    watch evaluation): a week-old multi-GiB ledger costs a poll one
    seek + one bounded read, not a full parse."""
    with open(path, "rb") as f:
        first = f.readline()
        header_end = f.tell()
        if tail_bytes is None:
            body = f.read()
        else:
            f.seek(0, os.SEEK_END)
            size = f.tell()
            start = max(header_end, size - max(0, int(tail_bytes)))
            f.seek(start)
            body = f.read()
            if start > header_end:
                nl = body.find(b"\n")
                body = body[nl + 1:] if nl >= 0 else b""
    return (first.decode("utf-8", "replace"),
            body.decode("utf-8", "replace").splitlines())


def read_spans(path: str,
               tail_bytes: Optional[int] = None) -> Dict[str, Any]:
    """Parse one rank's spans JSONL: ``{"header": {...}, "spans": [...],
    "dropped": n}``. Unparseable lines are counted, not fatal — a file
    truncated by a kill mid-flush must still report what landed.
    ``tail_bytes`` bounds the read to the header + the file's last N
    bytes (cadence-polled callers)."""
    header: Dict[str, Any] = {}
    spans: List[dict] = []
    dropped = 0
    bad = 0
    first, body = ledger_tail_lines(path, tail_bytes)
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
        if i == 0 and obj.get("version") == SPANS_VERSION:
            header = obj
            continue
        if obj.get("phase") == "_dropped":
            dropped += int(obj.get("count", 0))
            continue
        spans.append(obj)
    return {"header": header, "spans": spans, "dropped": dropped,
            "unparseable_lines": bad}
