"""Live serving metrics: counters, gauges, mergeable histograms, a
bounded tick time-series, and the replica flight recorder (twin of
`ray_lightning_tpu/telemetry/metrics.py`, same file formats).

`spans.py` answers "where did host wall-clock go, per completed region";
this module answers the question serving autoscale actually asks:
**what is the load right now, and what was it over the last N ticks?**
The serving hot loop (serve/scheduler.py `tick()`) emits per-tick
gauges (queue depth, decoding/prefilling slot counts, pool pressure)
and monotonic counters (admissions, preemptions, growth stalls); the
completion path observes latency histograms (queue_wait / TTFT / TPOT).
All of it lands in one `MetricsRegistry` per replica, flushed to
uid-tagged JSONL on the engine's tick cadence — the same
discipline as the span recorder: a bounded ring in memory, file I/O
only every `flush_every_n_ticks`, never per tick.

Three properties are load-bearing and test-pinned
(tests/test_torch_serve_metrics.py):

* **zero overhead when off** — `NULL_METRICS` is the off switch; the
  engine's step never depends on the registry (metrics off or on
  launches the same kernels), every recorded value is plain host
  numpy/python (never a tensor, no new host syncs);
* **exact merge** — histograms use a FIXED log-bucket layout
  (`HIST_LO * HIST_GROWTH**i`), so merging across replicas, attempts,
  and files is integer bucket-count addition: order-independent, and
  quantiles computed from merged buckets are deterministic — the
  run-level TTFT p99 is the same number no matter which replica's file
  is read first;
* **bounded memory** — the tick ring is a `deque(maxlen=...)`;
  overwrites of unflushed samples are counted (`_dropped` lines), never
  silently lost.

The **flight recorder** is the crash-time sibling: a bounded deque of
recent ticks + scheduler events, atomically persisted to a per-replica
file on a cadence, which the DRIVER finalizes into ``flight.json``
(stamped with the resilience classification) when a replica dies — a
SIGKILLed worker cannot write a postmortem, so the last
cadence-persisted ring IS the postmortem (docs/OBSERVABILITY.md
"flight recorder").
"""
from __future__ import annotations

import collections
import itertools
import json
import math
import os
import time
from typing import Any, Dict, Iterable, List, Optional, Tuple

from ray_lightning_tpu_torch.utils.locks import san_lock

METRICS_VERSION = "rlt-metrics-v1"
FLIGHT_VERSION = "rlt-flight-v1"

# ---- the fixed histogram layout -------------------------------------------
# Every histogram in the system shares one bucket geometry so merge is
# ALWAYS legal bucket-count addition. Quarter-octave buckets: boundary
# i sits at HIST_LO * 2**(i/4) — ~19% resolution per bucket, spanning
# 0.1 ms .. ~28 min in 96 buckets. Bucket 0 is the underflow bucket
# (values < HIST_LO, including 0), bucket n_buckets+1 the overflow.

HIST_LO = 1e-4
HIST_GROWTH = 2.0 ** 0.25
HIST_BUCKETS = 96


class Histogram:
    """Fixed-log-bucket histogram with EXACT merge semantics.

    Counts are integers in a sparse dict keyed by bucket index; merge
    is integer addition, so cross-replica aggregation is associative,
    commutative, and lossless — p50/p95/p99 computed from merged
    buckets are deterministic regardless of merge order (test-pinned).
    ``min``/``max``/``sum`` merge exactly too (min of mins, max of
    maxes, sum of sums).
    """

    __slots__ = ("lo", "growth", "n_buckets", "counts", "n", "sum",
                 "min", "max", "_inv_log_g")

    def __init__(self, lo: float = HIST_LO, growth: float = HIST_GROWTH,
                 n_buckets: int = HIST_BUCKETS):
        if lo <= 0 or growth <= 1 or n_buckets < 1:
            raise ValueError(
                f"histogram layout lo={lo} growth={growth} "
                f"n_buckets={n_buckets}")
        self.lo = lo
        self.growth = growth
        self.n_buckets = n_buckets
        self.counts: Dict[int, int] = {}
        self.n = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None
        self._inv_log_g = 1.0 / math.log(growth)

    # ---- layout ----------------------------------------------------------

    def layout(self) -> dict:
        return {"lo": self.lo, "growth": self.growth,
                "n_buckets": self.n_buckets}

    def same_layout(self, other: "Histogram") -> bool:
        return (self.lo == other.lo and self.growth == other.growth
                and self.n_buckets == other.n_buckets)

    def bucket_index(self, value: float) -> int:
        """0 = underflow (< lo, incl. 0/negative); 1..n_buckets = the
        log buckets; n_buckets + 1 = overflow."""
        if value < self.lo:
            return 0
        i = int(math.floor(math.log(value / self.lo) * self._inv_log_g))
        return min(i + 1, self.n_buckets + 1)

    def bucket_upper(self, idx: int) -> float:
        """Inclusive-upper boundary of bucket ``idx`` — the value a
        quantile read from this bucket reports (conservative: the true
        sample is <= this)."""
        if idx <= 0:
            return self.lo
        if idx > self.n_buckets:
            return self.max if self.max is not None else math.inf
        return self.lo * self.growth ** idx

    # ---- recording / merging ---------------------------------------------

    def observe(self, value: float) -> None:
        value = float(value)
        idx = self.bucket_index(value)
        self.counts[idx] = self.counts.get(idx, 0) + 1
        self.n += 1
        self.sum += value
        self.min = value if self.min is None else min(self.min, value)
        self.max = value if self.max is None else max(self.max, value)

    def merge(self, other: "Histogram") -> "Histogram":
        """In-place exact merge; layouts must match."""
        if not self.same_layout(other):
            raise ValueError(
                f"histogram layout mismatch: {self.layout()} vs "
                f"{other.layout()} — merge would be lossy")
        for idx, c in other.counts.items():
            self.counts[idx] = self.counts.get(idx, 0) + c
        self.n += other.n
        self.sum += other.sum
        for attr, pick in (("min", min), ("max", max)):
            a, b = getattr(self, attr), getattr(other, attr)
            setattr(self, attr, b if a is None else
                    (a if b is None else pick(a, b)))
        return self

    # ---- reading ---------------------------------------------------------

    def quantile(self, q: float) -> Optional[float]:
        """The bucket-upper-bound quantile: the smallest bucket boundary
        B such that at least ``ceil(q * n)`` observations are <= B.
        Computed from counts only — exact under merge."""
        if self.n == 0:
            return None
        target = max(1, math.ceil(min(max(q, 0.0), 1.0) * self.n))
        cum = 0
        bound = self.bucket_upper(self.n_buckets + 1)
        for idx in sorted(self.counts):
            cum += self.counts[idx]
            if cum >= target:
                bound = self.bucket_upper(idx)
                break
        # a bucket's upper edge can exceed the true maximum; ``max``
        # merges exactly (max of maxes), so the clamp stays
        # order-independent
        return min(bound, self.max) if self.max is not None else bound

    def mean(self) -> Optional[float]:
        return self.sum / self.n if self.n else None

    def sketch(self) -> List[Tuple[float, int]]:
        """The auditable tail: nonzero ``(bucket_upper, count)`` pairs,
        ascending — what `report` prints so a p99 is checkable against
        its own buckets rather than taken on faith."""
        return [(self.bucket_upper(idx), self.counts[idx])
                for idx in sorted(self.counts)]

    def to_dict(self) -> dict:
        d = {"lo": self.lo, "growth": self.growth,
             "n_buckets": self.n_buckets, "n": self.n,
             "sum": round(self.sum, 9),
             "counts": {str(k): v for k, v in sorted(self.counts.items())}}
        if self.min is not None:
            d["min"] = self.min
            d["max"] = self.max
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "Histogram":
        h = cls(lo=d.get("lo", HIST_LO),
                growth=d.get("growth", HIST_GROWTH),
                n_buckets=d.get("n_buckets", HIST_BUCKETS))
        h.counts = {int(k): int(v)
                    for k, v in (d.get("counts") or {}).items()}
        h.n = int(d.get("n", sum(h.counts.values())))
        h.sum = float(d.get("sum", 0.0))
        h.min = d.get("min")
        h.max = d.get("max")
        return h


def merge_histograms(hists: Iterable[Histogram]) -> Optional[Histogram]:
    """Exact merge of any number of same-layout histograms (None when
    the iterable is empty). Order-independent by construction."""
    out: Optional[Histogram] = None
    for h in hists:
        if out is None:
            out = Histogram(lo=h.lo, growth=h.growth,
                            n_buckets=h.n_buckets)
        out.merge(h)
    return out


#: per-process registry/flight sequence — same discipline as the span
#: recorder's: a respawned attempt or a second registry in one process
#: gets its OWN files, never truncates an earlier stream
_FILE_SEQ = itertools.count()


class MetricsRegistry:
    """One replica's live metrics: counters + gauges sampled into a
    bounded per-tick ring, latency histograms, cadenced JSONL flush.

    ``directory=None`` records in memory only (unit tests). With a
    directory, ``flush()`` appends the ring's unflushed tick samples and
    a cumulative histogram snapshot to
    ``<directory>/replica<r>.<uid>.metrics.jsonl``; ``tick_end()`` calls
    it every ``flush_every_n_ticks`` — never per tick.

    Thread-safe for the same reason the span recorder is: the driver's
    queue-pump thread may read while the serve loop writes.
    """

    enabled = True

    def __init__(self, directory: Optional[str] = None, replica: int = 0,
                 ring_size: int = 2048, flush_every_n_ticks: int = 32,
                 prefix: str = "replica"):
        self.directory = directory
        self.replica = replica
        #: file-name prefix: "replica" streams feed the load signal /
        #: aggregation globs; other prefixes ("driver" — the autoscale
        #: session's scale/deferral counters) are read by their own
        #: consumers and deliberately stay OUT of the replica rollups
        self.prefix = prefix
        self.flush_every_n_ticks = max(1, flush_every_n_ticks)
        self._lock = san_lock("telemetry.metrics.recorder")
        self._counters: Dict[str, int] = {}
        self._gauges: Dict[str, float] = {}
        self._hists: Dict[str, Histogram] = {}
        self._ring: collections.deque = collections.deque(maxlen=ring_size)
        self._ticks = 0
        self._dropped = 0
        self._dropped_total = 0
        self.t0_perf = time.perf_counter()
        self.t0_wall = time.time()
        self.uid = f"{os.getpid()}-{next(_FILE_SEQ)}"
        self._path: Optional[str] = None
        if directory is not None:
            os.makedirs(directory, exist_ok=True)
            self._path = os.path.join(
                directory, f"{prefix}{replica}.{self.uid}.metrics.jsonl")
            with open(self._path, "w") as f:
                f.write(json.dumps({
                    "version": METRICS_VERSION, "replica": replica,
                    "t0_wall": self.t0_wall, "pid": os.getpid(),
                    "uid": self.uid,
                    "hist": {"lo": HIST_LO, "growth": HIST_GROWTH,
                             "n_buckets": HIST_BUCKETS},
                }) + "\n")

    # ---- recording (all plain python/numpy scalars — never a tensor) -----

    def count(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + int(n)

    def gauge(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[name] = float(value)

    def observe(self, name: str, value: float) -> None:
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = Histogram()
            h.observe(float(value))

    def tick_end(self) -> None:
        """Close one scheduler tick: snapshot every gauge + cumulative
        counter into the ring as one sample, flush on the cadence."""
        with self._lock:
            self._ticks += 1
            if len(self._ring) == self._ring.maxlen:
                self._dropped += 1
                self._dropped_total += 1
            self._ring.append({
                "tick": self._ticks,
                "t": round(time.perf_counter() - self.t0_perf, 6),
                "g": dict(self._gauges),
                "c": dict(self._counters),
            })
            due = self._ticks % self.flush_every_n_ticks == 0
        if due:
            self.flush()

    # ---- reading ---------------------------------------------------------

    @property
    def ticks(self) -> int:
        return self._ticks

    @property
    def dropped(self) -> int:
        return self._dropped_total

    def counters(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counters)

    def gauges(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._gauges)

    def histogram(self, name: str) -> Optional[Histogram]:
        with self._lock:
            return self._hists.get(name)

    def histograms(self) -> Dict[str, Histogram]:
        with self._lock:
            return dict(self._hists)

    def ring(self) -> List[dict]:
        """The in-memory tick window (newest last) — what `monitor
        --serve` and `load_signal()` read for the rolling view."""
        with self._lock:
            return list(self._ring)

    # ---- flush -----------------------------------------------------------

    def flush(self) -> int:
        """Append unflushed tick samples + a cumulative histogram
        snapshot line. Reader contract: the LAST ``hists`` line in the
        file is the current state (cumulative, so a torn earlier line
        costs nothing)."""
        if self._path is None:
            return 0
        with self._lock:
            batch = list(self._ring)
            self._ring.clear()
            dropped, self._dropped = self._dropped, 0
            hists = {name: h.to_dict() for name, h in self._hists.items()}
        if not batch and not dropped and not hists:
            return 0
        with open(self._path, "a") as f:
            for entry in batch:
                f.write(json.dumps(entry) + "\n")
            if dropped:
                f.write(json.dumps({"_dropped": dropped}) + "\n")
            if hists:
                f.write(json.dumps({"hists": hists}) + "\n")
        return len(batch)

    def close(self) -> None:
        self.flush()


class NullMetrics:
    """metrics=off: the same surface, every call a no-op, `enabled`
    False so hot-path call sites can skip even the cheap host-side
    value computation."""

    enabled = False
    directory = None
    replica = 0
    ticks = 0
    dropped = 0
    uid = "null"

    def count(self, name: str, n: int = 1) -> None: ...
    def gauge(self, name: str, value: float) -> None: ...
    def observe(self, name: str, value: float) -> None: ...
    def tick_end(self) -> None: ...

    def counters(self) -> Dict[str, int]:
        return {}

    def gauges(self) -> Dict[str, float]:
        return {}

    def histogram(self, name: str) -> Optional[Histogram]:
        return None

    def histograms(self) -> Dict[str, Histogram]:
        return {}

    def ring(self) -> List[dict]:
        return []

    def flush(self) -> int:
        return 0

    def close(self) -> None: ...


#: the shared off-switch instance call sites default to
NULL_METRICS = NullMetrics()


def read_metrics(path: str,
                 tail_bytes: Optional[int] = None) -> Dict[str, Any]:
    """Parse one replica's metrics JSONL: ``{"header": {...}, "ticks":
    [...], "hists": {name: Histogram}, "counters": {...}, "gauges":
    {...}, "dropped": n}``. ``counters``/``gauges`` are the newest tick
    sample's (cumulative counters — the file's final word). Unparseable
    lines are counted, not fatal: a SIGKILL mid-flush must still report
    what landed. ``tail_bytes`` bounds the read to the header + the
    file's last N bytes (the newest ticks and the LAST
    cumulative ``hists`` snapshot both live at the end, so the live
    views this serves lose nothing)."""
    from ray_lightning_tpu_torch.telemetry.spans import ledger_tail_lines

    header: Dict[str, Any] = {}
    ticks: List[dict] = []
    hists: Dict[str, Histogram] = {}
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
        if i == 0 and obj.get("version") == METRICS_VERSION:
            header = obj
            continue
        if "_dropped" in obj:
            dropped += int(obj["_dropped"])
            continue
        if "hists" in obj:
            # cumulative snapshots: the last one wins
            hists = {name: Histogram.from_dict(d)
                     for name, d in obj["hists"].items()}
            continue
        if "tick" in obj:
            ticks.append(obj)
    last = ticks[-1] if ticks else {}
    return {"header": header, "ticks": ticks, "hists": hists,
            "counters": dict(last.get("c") or {}),
            "gauges": dict(last.get("g") or {}),
            "dropped": dropped, "unparseable_lines": bad}


def metrics_paths(directory: str) -> List[str]:
    """Every replica metrics file under a telemetry dir, sorted —
    respawned attempts contribute one file each."""
    import glob as _glob

    return sorted(_glob.glob(
        os.path.join(directory, "replica*.metrics.jsonl")))


def driver_metrics_paths(directory: str) -> List[str]:
    """The autoscale session's driver-level metrics stream(s)
    (prefix="driver": scale events, submit deferrals, live-replica
    gauges) — kept out of the replica rollups above by file name."""
    import glob as _glob

    return sorted(_glob.glob(
        os.path.join(directory, "driver*.metrics.jsonl")))


# ---- cross-file aggregation (report / monitor / the load signal) ----------


def quantile_block(hist: Histogram) -> dict:
    """p50/p95/p99 + count/sum + the bucket sketch for one merged
    histogram — quantiles from BUCKETS, never samples, so the numbers
    are identical no matter which replica's file merged first."""
    return {
        "n": hist.n,
        "p50": hist.quantile(0.50),
        "p95": hist.quantile(0.95),
        "p99": hist.quantile(0.99),
        "mean": hist.mean(),
        "max": hist.max,
        "sketch": [[round(le, 6), c] for le, c in hist.sketch()],
    }


def read_all_metrics(directory: str,
                     tail_bytes: Optional[int] = None
                     ) -> List[Dict[str, Any]]:
    """Parse every replica metrics JSONL under ``directory`` once —
    the shared substrate of `aggregate_from_parsed` and
    `newest_from_parsed`, so one report/summary pass never re-reads a
    file. ``tail_bytes`` bounds each file's read (cadence-polled
    callers: the load signal, `monitor --follow`, watch evaluation —
   )."""
    out: List[Dict[str, Any]] = []
    for path in metrics_paths(directory):
        try:
            out.append(read_metrics(path, tail_bytes=tail_bytes))
        except OSError:
            continue
    return out


def _header_t0(parsed: Dict[str, Any]) -> float:
    return float(parsed["header"].get("t0_wall") or 0.0)


def aggregate_metrics_dir(directory: str) -> Optional[Dict[str, Any]]:
    """`aggregate_from_parsed` over a directory (one parse pass)."""
    return aggregate_from_parsed(read_all_metrics(directory))


def aggregate_from_parsed(
        parsed_list: List[Dict[str, Any]]) -> Optional[Dict[str, Any]]:
    """Merge parsed replica metrics files into one run-level view:
    summed counters, exactly-merged latency histograms
    (`quantile_block` each), per-replica tick/attempt counts, and
    queue-depth/occupancy series stats. None when the list is empty.
    "Last" values (``last_tick_t``, ``blocks_free_last``) come from the
    NEWEST attempt by header ``t0_wall`` — never from whichever file
    happened to sort last lexically (pids don't sort by age)."""
    if not parsed_list:
        return None
    counters: Dict[str, int] = {}
    hist_parts: Dict[str, List[Histogram]] = {}
    replicas: Dict[str, dict] = {}
    newest_t0: Dict[str, float] = {}
    qd_series: List[float] = []
    occ_series: List[float] = []
    blocks_free_last: Optional[float] = None
    blocks_free_t0 = -1.0
    dropped = 0
    for parsed in parsed_list:
        rep = str(parsed["header"].get("replica", "?"))
        t0 = _header_t0(parsed)
        info = replicas.setdefault(
            rep, {"files": 0, "ticks": 0, "last_tick_t": None})
        info["files"] += 1
        info["ticks"] += len(parsed["ticks"])
        dropped += parsed["dropped"]
        for name, v in parsed["counters"].items():
            counters[name] = counters.get(name, 0) + int(v)
        for name, h in parsed["hists"].items():
            hist_parts.setdefault(name, []).append(h)
        for sample in parsed["ticks"]:
            g = sample.get("g") or {}
            if "queue_depth" in g:
                qd_series.append(float(g["queue_depth"]))
            if "slot_occupancy" in g:
                occ_series.append(float(g["slot_occupancy"]))
        if parsed["ticks"] and t0 >= newest_t0.get(rep, -1.0):
            newest_t0[rep] = t0
            info["last_tick_t"] = parsed["ticks"][-1].get("t")
            g = parsed["gauges"]
            if "blocks_free" in g and t0 >= blocks_free_t0:
                blocks_free_t0 = t0
                blocks_free_last = float(g["blocks_free"])
    out: Dict[str, Any] = {
        "replicas": replicas,
        "counters": counters,
        "latency": {name: quantile_block(h) for name, h in
                    ((n, merge_histograms(parts)) for n, parts in
                     sorted(hist_parts.items())) if h is not None},
        "dropped_tick_samples": dropped,
    }
    if qd_series:
        s = sorted(qd_series)
        out["queue_depth"] = {
            "p50": s[len(s) // 2], "max": s[-1],
            "mean": sum(s) / len(s), "ticks": len(s)}
    if occ_series:
        out["slot_occupancy_mean"] = sum(occ_series) / len(occ_series)
    if blocks_free_last is not None:
        out["blocks_free_last"] = blocks_free_last
    return out


#: how many of each replica's NEWEST tick samples the load signal
#: averages over — live pressure, not run-lifetime means
LOAD_SIGNAL_WINDOW = 64


def newest_from_parsed(
        parsed_list: List[Dict[str, Any]]) -> Dict[str, dict]:
    """The NEWEST parsed metrics file per replica (by header t0_wall —
    respawned attempts supersede), as ``{replica: {"t0": t0_wall,
    "parsed": ...}}``."""
    newest: Dict[str, dict] = {}
    for parsed in parsed_list:
        rep = str(parsed["header"].get("replica", "?"))
        t0 = _header_t0(parsed)
        prev = newest.get(rep)
        if prev is None or t0 >= prev["t0"]:
            newest[rep] = {"t0": t0, "parsed": parsed}
    return newest


def newest_metrics_per_replica(directory: str,
                               tail_bytes: Optional[int] = None
                               ) -> Dict[str, dict]:
    """`newest_from_parsed` over a directory — the substrate of
    `load_signal_from_dir` and `monitor --serve`; callers that also
    aggregate should `read_all_metrics` once and use the
    ``_from_parsed`` forms so no file is parsed twice."""
    return newest_from_parsed(
        read_all_metrics(directory, tail_bytes=tail_bytes))


def signal_tail_bytes(window: int) -> int:
    """The per-file read bound a ``window``-tick signal needs: the
    newest ``window`` samples plus the trailing hists/gauge lines, with
    generous slack per line. The load signal only ever summarizes the
    window, so bounding the READ to it is lossless — and keeps every
    cadence-polled signal read O(window), not O(run length)."""
    return max(64 * 1024, int(window) * 1024)


def load_signal_from_dir(directory: str,
                         window: int = LOAD_SIGNAL_WINDOW,
                         tail_bytes: Optional[int] = None) -> dict:
    """The queue-depth/occupancy oracle summary over the newest metrics
    file per replica (docs/OBSERVABILITY.md "load signal"; the JAX
    package's `serve.driver.load_signal` wraps it). Reads are
    tail-bounded by default (`signal_tail_bytes(window)`): the signal is
    a rolling-window summary, so a cadence-polled read never needs the
    whole ledger."""
    if tail_bytes is None:
        tail_bytes = signal_tail_bytes(window)
    return load_signal_from_parsed(
        newest_metrics_per_replica(directory, tail_bytes=tail_bytes),
        window=window, where=directory)


def load_signal_from_parsed(newest_per_replica: Dict[str, dict],
                            window: int = LOAD_SIGNAL_WINDOW,
                            where: str = "this run") -> dict:
    """`load_signal_from_dir` over an already-parsed
    `newest_metrics_per_replica` map — callers that just read the files
    for their own view (monitor --serve) reuse the parse."""
    if not newest_per_replica:
        return {"available": False,
                "reason": "no serve metrics recorded under "
                          f"{where} (metrics off, or nothing "
                          "served)"}
    qd_window: List[float] = []
    occ_window: List[float] = []
    qd_now = 0.0
    total_slots = 0.0
    blocks_free_fraction: Optional[float] = None
    per_replica: Dict[str, dict] = {}
    retired: List[str] = []
    # per-traffic-class pooling (scheduler with SLOConfig armed emits
    # queue_depth_<class> gauges + sheds_<class> counters; absent on a
    # priority-off run, so the signal shape stays historical there)
    cls_qd_window: Dict[str, List[float]] = {}
    cls_qd_now: Dict[str, float] = {}
    cls_sheds: Dict[str, float] = {}
    for rep, entry in sorted(newest_per_replica.items()):
        parsed = entry["parsed"]
        g_last = parsed["gauges"]
        if g_last.get("retired"):
            # a scale-down stamped this replica retired at drain
            # completion (the JAX serve driver): its file stays on disk but
            # its stale window must not dilute the LIVE pressure — a
            # retired replica's trailing zeros would halve the pooled
            # p50 and talk the controller out of a needed scale-up
            retired.append(rep)
            continue
        recent = parsed["ticks"][-window:]
        qd = [float((s.get("g") or {}).get("queue_depth", 0.0))
              for s in recent]
        occ = [float((s.get("g") or {}).get("slot_occupancy", 0.0))
               for s in recent]
        qd_window.extend(qd)
        occ_window.extend(occ)
        qd_now += float(g_last.get("queue_depth", 0.0))
        for name, v in g_last.items():
            if name.startswith("queue_depth_"):
                cls = name[len("queue_depth_"):]
                cls_qd_now[cls] = cls_qd_now.get(cls, 0.0) + float(v)
                cls_qd_window.setdefault(cls, []).extend(
                    float((s.get("g") or {}).get(name, 0.0))
                    for s in recent)
        for name, v in parsed["counters"].items():
            if name.startswith("sheds_"):
                cls = name[len("sheds_"):]
                cls_sheds[cls] = cls_sheds.get(cls, 0.0) + float(v)
        total_slots += (g_last.get("decoding_slots", 0.0)
                        + g_last.get("prefilling_slots", 0.0)
                        + g_last.get("free_slots", 0.0))
        bf, biu = g_last.get("blocks_free"), g_last.get("blocks_in_use")
        if bf is not None and biu is not None and (bf + biu) > 0:
            frac = bf / (bf + biu)
            blocks_free_fraction = (frac if blocks_free_fraction is None
                                    else min(blocks_free_fraction, frac))
        per_replica[rep] = {
            "queue_depth": g_last.get("queue_depth"),
            "occupancy": (sum(occ) / len(occ)) if occ else None,
            "ticks": len(parsed["ticks"]),
        }
    if not per_replica:
        return {"available": False,
                "reason": "every replica reporting under "
                          f"{where} is retired (scaled away)",
                "replicas_retired": len(retired)}
    qd_sorted = sorted(qd_window) or [0.0]
    qd_p50 = qd_sorted[len(qd_sorted) // 2]
    signal: Dict[str, Any] = {
        "available": True,
        "replicas_reporting": len(per_replica),
        "queue_depth_now": qd_now,
        "queue_depth_p50": qd_p50,
        "queue_depth_max": qd_sorted[-1],
        "occupancy": (sum(occ_window) / len(occ_window))
        if occ_window else 0.0,
        "total_slots": total_slots,
        "pressure": qd_p50 / total_slots if total_slots else None,
        "window_ticks": len(qd_window),
        "replicas": per_replica,
    }
    if retired:
        signal["replicas_retired"] = len(retired)
    if blocks_free_fraction is not None:
        signal["blocks_free_fraction"] = blocks_free_fraction
    # flat per-class fields (watch selectors + autoscale read these by
    # name: load.pressure_latency_critical etc.) — present only when a
    # traffic-aware scheduler reported per-class gauges
    for cls in sorted(cls_qd_now):
        win = sorted(cls_qd_window.get(cls) or [0.0])
        p50 = win[len(win) // 2]
        signal[f"queue_depth_now_{cls}"] = cls_qd_now[cls]
        signal[f"pressure_{cls}"] = (p50 / total_slots
                                     if total_slots else None)
    for cls in sorted(cls_sheds):
        signal[f"sheds_{cls}"] = cls_sheds[cls]
    return signal


# ---- flight recorder -------------------------------------------------------


class FlightRecorder:
    """A bounded deque of recent ticks + scheduler events, atomically
    persisted on a cadence — the black box a dead replica leaves
    behind.

    The worker CANNOT write at death (SIGKILL gives no handler), so the
    recorder persists its ring every ``persist_every`` events via
    write-to-tmp + ``os.replace`` — the file on disk is always a
    complete, parseable JSON document at most one cadence behind the
    crash. The driver finalizes it into the run-level ``flight.json``
    with the resilience classification stamped on
    (`finalize_flight`)."""

    enabled = True

    def __init__(self, path: Optional[str] = None, replica: int = 0,
                 maxlen: int = 256, persist_every: int = 16):
        self.path = path
        self.replica = replica
        self.persist_every = max(1, persist_every)
        self.events: collections.deque = collections.deque(maxlen=maxlen)
        self._since_persist = 0
        self._lock = san_lock("telemetry.metrics.flight")
        self.t0_perf = time.perf_counter()
        self.t0_wall = time.time()
        self.uid = f"{os.getpid()}-{next(_FILE_SEQ)}"
        if path is not None:
            os.makedirs(os.path.dirname(os.path.abspath(path)),
                        exist_ok=True)
            # persist the EMPTY ring immediately: the per-replica path
            # is shared across respawned attempts, and a respawn that
            # dies before its first cadence must leave THIS attempt's
            # (empty) ring — never a stale predecessor's events for the
            # driver to stamp the new death onto
            self.persist()

    def record(self, kind: str, **fields: Any) -> None:
        with self._lock:
            entry = {"t": round(time.perf_counter() - self.t0_perf, 6),
                     "kind": kind}
            entry.update(fields)
            self.events.append(entry)
            self._since_persist += 1
            due = (self.path is not None
                   and self._since_persist >= self.persist_every)
            if due:
                self._since_persist = 0
        if due:
            self.persist()

    def persist(self) -> None:
        """Atomic rewrite: the on-disk document is always complete."""
        if self.path is None:
            return
        with self._lock:
            doc = {"version": FLIGHT_VERSION, "replica": self.replica,
                   "pid": os.getpid(), "uid": self.uid,
                   "t0_wall": self.t0_wall,
                   "events": list(self.events)}
        tmp = f"{self.path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, self.path)

    def close(self) -> None:
        self.persist()


class NullFlightRecorder:
    """flight=off: same surface, no ring, no I/O."""

    enabled = False
    path = None
    replica = 0
    events: collections.deque = collections.deque(maxlen=1)

    def record(self, kind: str, **fields: Any) -> None: ...
    def persist(self) -> None: ...
    def close(self) -> None: ...


NULL_FLIGHT = NullFlightRecorder()


def flight_path(directory: str, replica: int) -> str:
    """Where replica ``replica``'s live flight ring persists."""
    return os.path.join(directory, f"replica{replica}.flight.json")


def read_flight(path: str) -> Optional[dict]:
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, json.JSONDecodeError):
        return None
    if doc.get("version") != FLIGHT_VERSION:
        return None
    return doc


#: serializes the read-modify-write of the run-level flight.json: the
#: driver finalizes deaths from one thread PER REPLICA, and two
#: replicas dying together (node OOM kills both) must append two
#: dumps, not race each other's rewrite
_FLIGHT_OUT_LOCK = san_lock("telemetry.metrics.flight_out")


def finalize_flight(telemetry_dir: str, replica: int, death: dict,
                    out_path: str) -> Optional[dict]:
    """Driver-side postmortem assembly: read the dead replica's last
    persisted flight ring, stamp the resilience classification
    (``death`` — kind/cause/detail/restartable + restart count), and
    append the dump to the run-level ``flight.json``. Returns the dump
    (None when the replica never persisted a ring — e.g. it died before
    its first cadence; the death stamp is still appended so the
    postmortem names the gap instead of hiding it). Thread-safe: the
    append is serialized and the tmp file is uniquely named, so
    concurrent replica deaths each land their dump."""
    ring = read_flight(flight_path(telemetry_dir, replica))
    dump: Dict[str, Any] = {
        "replica": replica,
        "death": dict(death),
        "dumped_at_wall": time.time(),
    }
    if ring is not None:
        dump["uid"] = ring.get("uid")
        dump["t0_wall"] = ring.get("t0_wall")
        dump["events"] = ring.get("events", [])
    else:
        dump["events"] = []
        dump["note"] = ("no persisted flight ring — the replica died "
                        "before its first persist cadence")
    with _FLIGHT_OUT_LOCK:
        doc = {"version": FLIGHT_VERSION, "dumps": []}
        try:
            with open(out_path) as f:
                prev = json.load(f)
            if prev.get("version") == FLIGHT_VERSION and \
                    isinstance(prev.get("dumps"), list):
                doc = prev
        except (OSError, json.JSONDecodeError):
            pass
        doc["dumps"].append(dump)
        tmp = f"{out_path}.tmp.{os.getpid()}-{next(_FILE_SEQ)}"
        with open(tmp, "w") as f:
            json.dump(doc, f, indent=2)
        os.replace(tmp, out_path)
    return dump
