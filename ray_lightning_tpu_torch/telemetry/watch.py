"""Declarative SLO watch rules over the persisted evidence streams
(twin of `ray_lightning_tpu/telemetry/watch.py`: the same rules give
the same verdicts on the same files).

Production operators do not watch means — they watch TAILS and budgets
(the Gemma-on-TPU serving comparison in PAPERS.md is explicit: SLO
p99s, not averages, are the product metric). This module turns that
into a declarative layer over data the run ALREADY persists:

    WatchRule(name="ttft_p99", metric="serving.ttft_p99_s", op=">",
              threshold=2.0, sustain=2, severity="page")

A `WatchEngine` evaluates its rules on the monitor/report cadence —
every evaluation is a pure function over the on-disk ledgers
(tail-bounded reads), so watch costs the run ZERO instrumentation when
off and touches no device when on. A breach that sustains fires ONCE per episode and
lands a self-documenting record in ``<run_dir>/incidents.jsonl``
(telemetry/incidents.py): rule, firing window, metric evidence, a
timeline excerpt of the surrounding events, and the evidence-capture
actions (profiler ``CAPTURE`` marker + forced flight persist).

Metric selectors (docs/OBSERVABILITY.md "rule grammar"):

    serving.<hist>_p<q>_s    bucket-exact quantile of a merged latency
                             histogram (hist in ttft/tpot/queue_wait,
                             q in 50/95/99)
    load.<field>             the autoscale load signal (pressure,
                             queue_depth_p50, queue_depth_now,
                             occupancy)
    goodput.<bucket|fraction> the assembled goodput report
    guard.<counter>          trainguard counters from the newest
                             checkpoint meta (streak, skipped_steps)
    restarts.count           attempts observed minus one (goodput
                             ledgers) plus serving replica deaths
                             (flight.json dumps)

A selector that cannot be evaluated (stream missing, run too young)
yields None and the rule neither fires nor clears — no signal is never
treated as a good signal (the ``available: False != zero load``
discipline, applied to SLOs).
"""
from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import os
import sys
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

#: default per-ledger read bound for one watch evaluation — the watch
#: polls on a cadence, so every read is tail-bounded
WATCH_TAIL_BYTES = 256 * 1024

_OPS: Dict[str, Callable[[float, float], bool]] = {
    ">": lambda v, t: v > t,
    ">=": lambda v, t: v >= t,
    "<": lambda v, t: v < t,
    "<=": lambda v, t: v <= t,
}


@dataclasses.dataclass(frozen=True)
class WatchRule:
    """One declarative rule. ``sustain`` breaches must be observed
    before the rule fires; with ``window`` > 0 the sustain count is a
    BURN-RATE window — >= ``sustain`` breaches anywhere in the last
    ``window`` evaluations fire (K-in-window, the same shape the
    trainguard escalation uses), instead of strictly consecutive."""

    name: str
    metric: str
    op: str
    threshold: float
    sustain: int = 1
    window: int = 0
    severity: str = "page"        # "page" | "warn"
    description: str = ""

    def __post_init__(self):
        if self.op not in _OPS:
            raise ValueError(f"rule {self.name}: unknown op {self.op!r}"
                             f" (one of {sorted(_OPS)})")
        if self.sustain < 1:
            raise ValueError(f"rule {self.name}: sustain must be >= 1")
        if self.window and self.window < self.sustain:
            raise ValueError(
                f"rule {self.name}: window {self.window} < sustain "
                f"{self.sustain} could never fire")
        if self.severity not in ("page", "warn"):
            raise ValueError(
                f"rule {self.name}: severity {self.severity!r}")

    def breached(self, value: float) -> bool:
        return _OPS[self.op](value, self.threshold)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


#: the built-in rule set (docs/OBSERVABILITY.md "built-in rules") —
#: thresholds are conservative defaults; pass your own rules to tune
BUILTIN_RULES: Tuple[WatchRule, ...] = (
    WatchRule("ttft_p99", "serving.ttft_p99_s", ">", 2.0, sustain=1,
              severity="page",
              description="steady-state TTFT tail blew its SLO bound "
                          "— queueing/prefill latency grew on the "
                          "serving hot path"),
    WatchRule("goodput_fraction", "goodput.goodput_fraction", "<", 0.5,
              sustain=1, severity="warn",
              description="less than half the supervised wall made "
                          "forward progress — see the goodput buckets "
                          "for where the rest went"),
    WatchRule("queue_pressure", "load.pressure", ">", 2.0, sustain=3,
              severity="warn",
              description="sustained queue depth beyond capacity — "
                          "demand is queueing faster than replicas "
                          "drain it (autoscale clamped, or at "
                          "max_replicas)"),
    WatchRule("guard_anomaly_streak", "guard.streak", ">=", 3,
              sustain=1, severity="page",
              description="consecutive on-device anomalies — the "
                          "trainguard is skipping updates back to "
                          "back; escalation/rollback is imminent"),
    WatchRule("restart_rate", "restarts.count", ">=", 3, sustain=1,
              severity="warn",
              description="repeated attempt/replica deaths — the "
                          "retry budget is being spent; see the "
                          "classified failures"),
)


def class_slo_rules(slo, sustain: int = 1) -> Tuple[WatchRule, ...]:
    """Per-traffic-class SLO rules from a `serve.scheduler.SLOConfig`
    (duck-typed: anything with ``.classes`` / ``.shed_classes``): one
    TTFT-p95 and one TPOT-p95 rule per class against that class's own
    merged histogram (``serving.ttft_<class>_p95_s`` — class-keyed
    hists exist only when the scheduler runs with the SLOConfig
    armed), plus one shed-visibility rule per shed class
    (``load.sheds_<class>``). A breach in ONE class fires a
    class-named incident instead of being averaged into the pooled
    tail; latency_critical breaches page, the rest warn
    (docs/SERVING.md "traffic & SLO classes")."""
    rules: list = []
    for cls in sorted(slo.classes):
        spec = slo.classes[cls]
        sev = "page" if cls == "latency_critical" else "warn"
        rules.append(WatchRule(
            f"slo_ttft_{cls}", f"serving.ttft_{cls}_p95_s", ">",
            spec.ttft_p95_s, sustain=sustain, severity=sev,
            description=f"{cls} TTFT p95 above its per-class SLO "
                        f"target ({spec.ttft_p95_s:g}s) — this "
                        "class's admission latency breached, whatever "
                        "the pooled tail says"))
        rules.append(WatchRule(
            f"slo_tpot_{cls}", f"serving.tpot_{cls}_p95_s", ">",
            spec.tpot_p95_s, sustain=sustain, severity=sev,
            description=f"{cls} TPOT p95 above its per-class SLO "
                        f"target ({spec.tpot_p95_s:g}s) — decode "
                        "progress for this class is being crowded "
                        "out"))
    for cls in slo.shed_classes:
        rules.append(WatchRule(
            f"shed_{cls}", f"load.sheds_{cls}", ">=", 1, sustain=1,
            severity="warn",
            description=f"overload shed {cls} work (typed records "
                        "with retry-after hints, never silence) — "
                        "expected under a protective burst, but a "
                        "paper trail the run must carry"))
    return tuple(rules)


@dataclasses.dataclass
class WatchConfig:
    """``watch=`` coercion target (supervisor / controller / CLI)."""

    rules: Tuple[WatchRule, ...] = BUILTIN_RULES
    #: +-N merged timeline events carried in each incident record
    excerpt_events: int = 8
    #: actuate the evidence hooks on a breach (profiler CAPTURE marker
    #: + forced flight persist) — off leaves pure record-keeping
    capture: bool = True
    #: where the profiler marker drops; None derives
    #: ``<run_dir>/rlt_profile`` (the profiler's default dir)
    profile_dir: Optional[str] = None
    #: per-ledger read bound for one evaluation
    tail_bytes: int = WATCH_TAIL_BYTES

    @classmethod
    def coerce(cls, value: Any) -> Optional["WatchConfig"]:
        if value is None or value is False:
            return None
        if value is True:
            return cls()
        if isinstance(value, cls):
            return value
        if isinstance(value, (tuple, list)) and all(
                isinstance(r, WatchRule) for r in value):
            return cls(rules=tuple(value))
        raise TypeError(
            "watch= takes True, a WatchConfig, or a sequence of "
            f"WatchRule; got {type(value).__name__}")


# ---- metric surfaces -------------------------------------------------------


class MetricSurfaces:
    """One evaluation's view of the persisted metric surfaces. Each
    surface is read lazily, ONCE per evaluation, with a tail bound —
    construct a fresh instance per poll. ``value()`` returns None when
    a selector cannot be evaluated; ``evidence()`` returns the raw
    inputs behind a value so an incident is auditable against its own
    data."""

    def __init__(self, run_dir: str,
                 tail_bytes: int = WATCH_TAIL_BYTES,
                 telemetry_dir: Optional[str] = None):
        self.run_dir = run_dir
        self.tail_bytes = tail_bytes
        #: explicit telemetry dir for runs whose spans/goodput/metrics
        #: live outside <run_dir>/telemetry (TelemetryConfig(dir=...))
        self.telemetry_dir = telemetry_dir
        self._cache: Dict[str, Any] = {}

    # -- lazy surface loaders (each file parsed at most once) --------------

    def _tdir(self) -> str:
        if self.telemetry_dir is not None:
            return self.telemetry_dir
        from ray_lightning_tpu_torch.telemetry.report import telemetry_dir

        return telemetry_dir(self.run_dir)

    def _metrics(self) -> list:
        if "metrics" not in self._cache:
            from ray_lightning_tpu_torch.telemetry.metrics import (
                read_all_metrics,
            )

            self._cache["metrics"] = read_all_metrics(
                self._tdir(), tail_bytes=self.tail_bytes)
        return self._cache["metrics"]

    def _hists(self) -> dict:
        if "hists" not in self._cache:
            from ray_lightning_tpu_torch.telemetry.metrics import (
                merge_histograms,
            )

            parts: Dict[str, list] = {}
            for parsed in self._metrics():
                for name, h in parsed["hists"].items():
                    parts.setdefault(name, []).append(h)
            self._cache["hists"] = {
                name: merge_histograms(hs)
                for name, hs in parts.items()}
        return self._cache["hists"]

    def _load(self) -> dict:
        if "load" not in self._cache:
            from ray_lightning_tpu_torch.telemetry.metrics import (
                load_signal_from_parsed, newest_from_parsed,
            )

            self._cache["load"] = load_signal_from_parsed(
                newest_from_parsed(self._metrics()),
                where=self.run_dir)
        return self._cache["load"]

    def _goodput(self) -> Optional[dict]:
        if "goodput" not in self._cache:
            from ray_lightning_tpu_torch.telemetry.goodput import read_goodput

            self._cache["goodput"] = read_goodput(self._tdir())
        return self._cache["goodput"]

    def _guard(self) -> Optional[dict]:
        """Trainguard counters from the NEWEST checkpoint meta under
        the run dir (the trainer stamps them at every save — persisted
        data, no live trainer needed)."""
        if "guard" not in self._cache:
            newest: Optional[dict] = None
            newest_step = -1
            for meta_path in glob.glob(
                    os.path.join(self.run_dir, "*", "meta.json")):
                try:
                    with open(meta_path) as f:
                        meta = json.load(f)
                except (OSError, json.JSONDecodeError):
                    continue
                g = meta.get("guard")
                if not isinstance(g, dict):
                    continue
                step = int(meta.get("global_step", -1) or -1)
                if step > newest_step:
                    newest_step = step
                    newest = {**g, "global_step": step,
                              "blessed": meta.get("blessed")}
            self._cache["guard"] = newest
        return self._cache["guard"]

    def _restarts(self) -> dict:
        """Attempt/replica deaths from persisted evidence: per-rank
        goodput attempt ledgers beyond the first are restarts — the
        MAX across ranks, because a SIGKILLed rank writes no ledger
        for its dying attempt while its surviving peers do — cross-
        checked against the assembled goodput report's restart count
        when one exists; every run-level flight.json dump is a
        classified serving replica death."""
        if "restarts" not in self._cache:
            by_rank: Dict[str, int] = {}
            for path in glob.glob(os.path.join(
                    self._tdir(), "ledger.rank*.json")):
                rank = os.path.basename(path).split(".")[1]
                by_rank[rank] = by_rank.get(rank, 0) + 1
            attempts = max(by_rank.values(), default=0)
            g = self._goodput() or {}
            reported = int((g.get("events") or {}).get("restarts", 0)
                           or 0)
            if reported:
                # a SIGKILLed group can lose the dying attempt's
                # ledgers wholesale; the assembled report's restart
                # count is the floor on how many attempts there were
                attempts = max(attempts, reported + 1)
            dumps = 0
            fpath = os.path.join(self.run_dir, "flight.json")
            if os.path.exists(fpath):
                try:
                    with open(fpath) as f:
                        doc = json.load(f)
                    dumps = len(doc.get("dumps") or [])
                except (OSError, json.JSONDecodeError):
                    pass
            self._cache["restarts"] = {
                "attempts": attempts,
                "replica_deaths": dumps,
                "count": max(attempts - 1, reported, 0) + dumps,
            }
        return self._cache["restarts"]

    # -- the selector grammar ---------------------------------------------

    def value(self, selector: str) -> Optional[float]:
        group, _, field = selector.partition(".")
        if group == "serving":
            # <hist>_p<q>_s: bucket-exact quantile of the merged
            # histogram (the ONLY way a cross-replica p99 is computed
            # anywhere in the repo)
            name, _, tail = field.rpartition("_p")
            q = tail[:-2] if tail.endswith("_s") else tail
            h = self._hists().get(f"{name}_s")
            if h is None or not q.isdigit():
                return None
            return h.quantile(int(q) / 100.0)
        if group == "load":
            sig = self._load()
            if not sig.get("available"):
                return None
            v = sig.get(field)
            return float(v) if isinstance(v, (int, float)) else None
        if group == "goodput":
            g = self._goodput()
            if not g:
                return None
            if field == "goodput_fraction":
                return float(g.get("goodput_fraction", 0.0))
            v = (g.get("buckets") or {}).get(field)
            if v is None:
                v = (g.get("events") or {}).get(field)
            return float(v) if isinstance(v, (int, float)) else None
        if group == "guard":
            g = self._guard()
            if g is None:
                return None
            v = g.get(field)
            return float(v) if isinstance(v, (int, float)) else None
        if group == "restarts":
            v = self._restarts().get(field)
            return float(v) if isinstance(v, (int, float)) else None
        return None

    def evidence(self, selector: str) -> Dict[str, Any]:
        """The raw surface behind a selector, compactly — what the
        incident record carries next to the value."""
        group, _, field = selector.partition(".")
        if group == "serving":
            name = field.rpartition("_p")[0]
            h = self._hists().get(f"{name}_s")
            if h is None:
                return {}
            return {"histogram": f"{name}_s", "n": h.n,
                    "sketch": [[round(le, 6), c]
                               for le, c in h.sketch()]}
        if group == "load":
            sig = self._load()
            keys = ["available", "pressure", "queue_depth_now",
                    "queue_depth_p50", "occupancy", "total_slots",
                    "replicas_reporting"]
            if field not in keys:
                keys.append(field)  # class-scoped selectors carry
                #                     their own flat field as evidence
            return {"load_signal": {
                k: sig[k] for k in keys if k in sig}}
        if group == "goodput":
            g = self._goodput() or {}
            return {"goodput": {k: g[k] for k in
                                ("wall_s", "goodput_fraction",
                                 "buckets", "events") if k in g}}
        if group == "guard":
            g = self._guard()
            return {"guard": g} if g else {}
        if group == "restarts":
            return {"restarts": self._restarts()}
        return {}


# ---- the engine ------------------------------------------------------------


class _RuleState:
    __slots__ = ("history", "firing", "fired")

    def __init__(self):
        #: (engine poll index, breached) per evaluation that produced a
        #: value — the incident's firing window quotes these verbatim,
        #: so the record names the polls that actually sustained it
        self.history: List[Tuple[int, bool]] = []
        self.firing = False
        self.fired = 0


class WatchEngine:
    """Stateful evaluator: construct once, ``poll()`` on the monitor/
    report cadence. A rule fires once per breach EPISODE — it re-arms
    only after an evaluation observes the metric back in bounds (a
    cumulative p99 that stays high keeps the episode open: one
    incident, not one per poll)."""

    def __init__(self, run_dir: str,
                 config: Optional[WatchConfig] = None,
                 driver: Any = None,
                 clock: Callable[[], float] = time.time,
                 telemetry_dir: Optional[str] = None):
        self.run_dir = run_dir
        self.config = config or WatchConfig()
        self.driver = driver
        self._clock = clock
        #: where spans/goodput/metrics actually live when the run uses
        #: TelemetryConfig(dir=...) instead of <run_dir>/telemetry
        self.telemetry_dir = telemetry_dir
        self._state: Dict[str, _RuleState] = {
            r.name: _RuleState() for r in self.config.rules}
        self.polls = 0
        self.incidents: List[Dict[str, Any]] = []

    @property
    def fired(self) -> int:
        return len(self.incidents)

    def _should_fire(self, rule: WatchRule, st: _RuleState) -> bool:
        if rule.window:
            recent = st.history[-rule.window:]
            return sum(b for _, b in recent) >= rule.sustain
        streak = 0
        for _, b in reversed(st.history):
            if not b:
                break
            streak += 1
        return streak >= rule.sustain

    def poll(self, now: Optional[float] = None,
             driver: Any = None) -> List[Dict[str, Any]]:
        """One evaluation over the persisted surfaces. Returns the
        incidents fired by THIS poll (already appended to the
        ledger)."""
        now = self._clock() if now is None else now
        drv = driver if driver is not None else self.driver
        surfaces = MetricSurfaces(self.run_dir,
                                  tail_bytes=self.config.tail_bytes,
                                  telemetry_dir=self.telemetry_dir)
        fired: List[Dict[str, Any]] = []
        self.polls += 1
        for rule in self.config.rules:
            st = self._state[rule.name]
            value = surfaces.value(rule.metric)
            if value is None:
                # no signal is not a good signal — hold state
                continue
            breach = rule.breached(value)
            st.history.append((self.polls, breach))
            bound = max(rule.window, rule.sustain, 8)
            if len(st.history) > bound:
                del st.history[:-bound]
            if not breach:
                st.firing = False
                continue
            if st.firing or not self._should_fire(rule, st):
                continue
            st.firing = True
            st.fired += 1
            fired.append(self._fire(rule, st, value, now, surfaces,
                                    drv))
        self.incidents.extend(fired)
        return fired

    def _fire(self, rule: WatchRule, st: _RuleState, value: float,
              now: float, surfaces: MetricSurfaces,
              driver: Any) -> Dict[str, Any]:
        from ray_lightning_tpu_torch.telemetry.incidents import (
            append_incident, build_incident, capture_evidence,
        )
        from ray_lightning_tpu_torch.telemetry.timeline import (
            load_timeline_events, timeline_excerpt,
        )

        span = max(rule.window, rule.sustain, 1)
        window = [{"poll": p, "breached": b}
                  for p, b in st.history[-span:]]
        incident = build_incident(
            rule, value, now, window,
            evidence=surfaces.evidence(rule.metric))
        if self.config.capture:
            incident["actions"] = capture_evidence(
                self.run_dir, profile_dir=self.config.profile_dir,
                driver=driver)
        try:
            # tail-bounded: the excerpt wants the events AROUND the
            # breach (i.e. the newest), never a week of history —
            # the bounded-read discipline holds on the firing path too
            timeline = load_timeline_events(
                self.run_dir, tail_bytes=self.config.tail_bytes,
                telemetry_dir=self.telemetry_dir)
            incident["timeline_excerpt"] = timeline_excerpt(
                timeline["events"], now,
                n=self.config.excerpt_events)
        except Exception as exc:  # noqa: BLE001 — the record must land
            incident["timeline_excerpt"] = []
            incident["timeline_error"] = (
                f"{type(exc).__name__}: {str(exc)[:160]}")
        append_incident(self.run_dir, incident)
        return incident

    def summary(self) -> Dict[str, Any]:
        return {
            "polls": self.polls,
            "incidents": len(self.incidents),
            "rules": {r.name: {"fired": self._state[r.name].fired,
                               "firing": self._state[r.name].firing}
                      for r in self.config.rules},
        }


# ---- CLI -------------------------------------------------------------------


def add_watch_parser(sub) -> None:
    p = sub.add_parser(
        "watch",
        help="evaluate the declarative SLO watch rules over a run "
             "dir's persisted evidence; breaches land in "
             "incidents.jsonl with metric evidence + a timeline "
             "excerpt (docs/OBSERVABILITY.md 'watch rules & "
             "incidents')")
    p.add_argument("run_dir", nargs="?", default=None)
    p.add_argument("--follow", action="store_true",
                   help="re-evaluate every --interval seconds until ^C")
    p.add_argument("--interval", type=float, default=15.0)
    p.add_argument("--ttft-max", type=float, default=None,
                   help="override the built-in ttft_p99 threshold "
                        "(seconds)")
    p.add_argument("--no-capture", action="store_true",
                   help="record incidents without actuating the "
                        "evidence hooks (no CAPTURE marker, no forced "
                        "flight persist)")
    p.add_argument("--smoke", action="store_true",
                   help="gate mode: injected serving latency stall "
                        "fires the ttft rule exactly once with a "
                        "parseable incident (evidence + excerpt + one "
                        "marker capture), and the run's unified "
                        "timeline exports valid Chrome-trace JSON "
                        "with >= 4 sources")
    p.add_argument("--device", default=None,
                   help="--smoke's device: the gate runs on the CPU "
                        "(--device cpu), where its oracle is bitwise")
    p.add_argument("--json", action="store_true", dest="as_json",
                   default=argparse.SUPPRESS)


def _cli_rules(args) -> Tuple[WatchRule, ...]:
    rules = list(BUILTIN_RULES)
    if args.ttft_max is not None:
        rules = [dataclasses.replace(r, threshold=args.ttft_max)
                 if r.name == "ttft_p99" else r for r in rules]
    return tuple(rules)


def run_watch(args) -> int:
    if args.smoke:
        return _run_smoke(args)
    if not args.run_dir:
        print("error: pass a run dir or --smoke", file=sys.stderr)
        return 2
    if not os.path.isdir(args.run_dir):
        print(f"error: {args.run_dir} is not a directory",
              file=sys.stderr)
        return 2
    engine = WatchEngine(args.run_dir, WatchConfig(
        rules=_cli_rules(args), capture=not args.no_capture))
    as_json = getattr(args, "as_json", False)
    while True:
        fired = engine.poll()
        view = {"run_dir": args.run_dir, **engine.summary(),
                "fired_now": [i["rule"] for i in fired]}
        if as_json:
            print(json.dumps(view), flush=True)
        else:
            state = ", ".join(
                f"{name}{'!' if st['firing'] else ''}"
                for name, st in view["rules"].items())
            print(f"-- watch poll {view['polls']}: "
                  f"{len(fired)} new incident(s), "
                  f"{view['incidents']} total [{state}]")
            for inc in fired:
                ev = inc["evidence"]
                print(f"   {inc['severity'].upper()} {inc['rule']}: "
                      f"{ev['metric']} = {ev['value']:.4g} {ev['op']} "
                      f"{ev['threshold']:.4g}")
        if not args.follow:
            return 0
        time.sleep(max(0.2, args.interval))


# ---- the smoke gate --------------------------------------------------------


def _smoke_serving_run(run_dir: str, device, stall_s: float = 0.25):
    """A scripted serving session with one INJECTED latency stall:
    requests r0..r5 serve normally, then a late request's prefill
    window absorbs a host sleep — its measured TTFT is ~``stall_s``
    where its peers' are milliseconds, so a ttft_p99 rule with a
    threshold between the two fires deterministically. Driven under an
    autoscale controller (fabricated hold signal) so the run dir also
    carries an autoscale ledger for the timeline leg."""
    from ray_lightning_tpu_torch.autoscale import (
        AutoscaleController, ControllerConfig, PolicyConfig,
    )
    from ray_lightning_tpu_torch.serve.cli import _references, _tiny_setup
    from ray_lightning_tpu_torch.serve.driver import (
        ReplicaGroupConfig, ServeDriver,
    )
    from ray_lightning_tpu_torch.serve.engine import EngineConfig

    model, reqs = _tiny_setup(8, 8, device)
    refs = _references(model, reqs)
    ecfg = EngineConfig(capacity=4, block_size=4, blocks_per_slot=8,
                        prefill_chunk=4)
    drv = ServeDriver(model.cfg, model, ReplicaGroupConfig(
        n_replicas=1, backend="inline", engine=ecfg, run_dir=run_dir,
        device=device.type, metrics_flush_every_n_ticks=2))
    drv.start()
    ctl = AutoscaleController(drv, ControllerConfig(
        policy=PolicyConfig(min_replicas=1, max_replicas=1)),
        run_dir=run_dir)
    # healthy phase: most requests flow normally
    for req in reqs[:-1]:
        drv.submit(req)
    tick = 0
    while drv.busy():
        drv.tick()
        tick += 1
        if tick % 4 == 0:
            ctl.step(now=float(tick))
    # the stall: submit the last request, admit it (first tick), then
    # stall the host mid-prefill — its admission->first-token wall
    # (TTFT) absorbs the sleep, exactly how a wedged device tunnel or
    # an interactive-priority stall shows up in production
    drv.submit(reqs[-1])
    drv.tick()
    time.sleep(stall_s)
    while drv.busy():
        drv.tick()
        tick += 1
    ctl.step(now=float(tick))
    result = drv.stop()
    return result, refs, reqs


def _run_smoke(args) -> int:
    import tempfile

    from ray_lightning_tpu_torch.telemetry.incidents import read_incidents
    from ray_lightning_tpu_torch.telemetry.timeline import (
        load_timeline_events, to_chrome_trace, validate_chrome_trace,
    )
    from ray_lightning_tpu_torch.utils.devices import resolve_device

    device = resolve_device(getattr(args, "device", None))
    if device.type != "cpu":
        print("watch --smoke is the CPU gate (f32, where its oracle is "
              "bitwise): pass --device cpu. On the card, chip_smoke.py "
              "phase 14 drives the controller and the watch",
              file=sys.stderr)
        return 2
    out: Dict[str, Any] = {"gate": "watch --smoke"}
    failures: List[str] = []
    stall_s = 0.25
    with tempfile.TemporaryDirectory(prefix="rlt-watch-") as tmp:
        run_dir = os.path.join(tmp, "run")
        result, refs, reqs = _smoke_serving_run(run_dir, device,
                                                stall_s=stall_s)
        bad = [rid for rid, ref in refs.items()
               if list(result.outputs.get(rid, [])) != ref]
        if bad:
            failures.append(f"stalled run diverged from generate(): "
                            f"{bad}")
        # ---- leg 1: the rule must fire exactly once -------------------
        rules = tuple(
            dataclasses.replace(r, threshold=stall_s / 2)
            if r.name == "ttft_p99" else r for r in BUILTIN_RULES)
        engine = WatchEngine(run_dir, WatchConfig(rules=rules))
        first = engine.poll()
        second = engine.poll()   # episode stays open: no second fire
        third = engine.poll()
        parsed = read_incidents(run_dir)
        ttft_incidents = [i for i in parsed["incidents"]
                          if i.get("rule") == "ttft_p99"]
        out["watch"] = {
            "fired_first_poll": [i["rule"] for i in first],
            "fired_later_polls": [i["rule"] for i in second + third],
            "ledger_incidents": len(parsed["incidents"]),
            "ttft_incidents": len(ttft_incidents),
            "unparseable_lines": parsed["unparseable_lines"],
        }
        if [i["rule"] for i in first] != ["ttft_p99"]:
            failures.append(
                f"first poll fired {[i['rule'] for i in first]} — "
                "want exactly the injected ttft_p99 breach")
        if second or third:
            failures.append(
                "a sustained breach re-fired on later polls "
                f"({[i['rule'] for i in second + third]}) — one "
                "episode must be one incident")
        if len(ttft_incidents) != 1 or parsed["unparseable_lines"]:
            failures.append(
                f"incidents.jsonl holds {len(ttft_incidents)} ttft "
                f"record(s) ({parsed['unparseable_lines']} "
                "unparseable) — want exactly one, parseable")
        # ---- leg 2: the incident record contract ----------------------
        if ttft_incidents:
            inc = ttft_incidents[0]
            ev = inc.get("evidence") or {}
            if not (ev.get("value") and ev["value"] > stall_s / 2
                    and ev.get("sketch")):
                failures.append(
                    f"incident evidence is not auditable: {ev}")
            if not inc.get("timeline_excerpt"):
                failures.append(
                    "incident carries no timeline excerpt")
            actions = inc.get("actions") or {}
            marker = actions.get("profiler_marker")
            out["incident"] = {
                "value": ev.get("value"),
                "excerpt_events": len(inc.get("timeline_excerpt")
                                      or []),
                "actions": actions,
            }
            if not marker or not os.path.exists(marker):
                failures.append(
                    "evidence capture did not drop the profiler "
                    f"CAPTURE marker (actions={actions})")
        # ---- leg 3: unified timeline + Chrome export ------------------
        timeline = load_timeline_events(run_dir)
        doc = to_chrome_trace(timeline["events"])
        problems = validate_chrome_trace(doc)
        non_meta = [ev for ev in doc["traceEvents"]
                    if ev.get("ph") != "M"]
        cats = {ev["cat"] for ev in non_meta}
        ts_list = [ev["ts"] for ev in non_meta
                   if not (ev.get("args") or {}).get("unaligned")]
        out["timeline"] = {
            "events": len(non_meta),
            "sources": sorted(cats),
            "garbage_lines": timeline["garbage_lines"],
            "unaligned": timeline["unaligned"],
            "chrome_valid": not problems,
        }
        if problems:
            failures.append(
                f"chrome trace failed validation: {problems[:3]}")
        if len(cats) < 4:
            failures.append(
                f"trace carries {sorted(cats)} — want >= 4 distinct "
                "source subsystems in one pane")
        if ts_list != sorted(ts_list):
            failures.append(
                "aligned trace events are not ordered by aligned time")
    out["ok"] = not failures
    if failures:
        out["failures"] = failures
    print(json.dumps(out) if getattr(args, "as_json", False)
          else _smoke_text(out))
    if failures:
        for f in failures:
            print(f"watch --smoke FAILED: {f}", file=sys.stderr)
        return 1
    return 0


def _smoke_text(out: Dict[str, Any]) -> str:
    lines = [f"watch --smoke: {'ok' if out['ok'] else 'FAILED'}"]
    w = out.get("watch") or {}
    lines.append(
        f"  rule fire: {'ok' if w.get('ttft_incidents') == 1 else 'FAILED'} "
        f"(first poll {w.get('fired_first_poll')}, later "
        f"{w.get('fired_later_polls')}, ledger "
        f"{w.get('ledger_incidents')} incident(s))")
    inc = out.get("incident") or {}
    if inc:
        lines.append(
            f"  incident: ttft_p99 {inc.get('value'):.3f}s, "
            f"{inc.get('excerpt_events')} excerpt event(s), actions "
            f"{sorted((inc.get('actions') or {}))}")
    tl = out.get("timeline") or {}
    lines.append(
        f"  timeline: {'ok' if tl.get('chrome_valid') and len(tl.get('sources') or []) >= 4 else 'FAILED'} "
        f"({tl.get('events')} event(s) from {tl.get('sources')})")
    for f in out.get("failures", ()):
        lines.append(f"  FAILED: {f}")
    return "\n".join(lines)
