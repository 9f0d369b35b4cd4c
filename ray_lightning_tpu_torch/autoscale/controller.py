"""The autoscale actuator (twin of
`ray_lightning_tpu/autoscale/controller.py`; its ledger is the JAX
package's format, and `read_ledger` reads either package's): poll the
load signal, run the policy core,
execute the decision through the `ServeDriver` scaling seams, and
write every decision — acted or held — to an append-only ledger.

The split is deliberate (docs/AUTOSCALE.md): `policy.decide` is pure
and clockless; THIS module owns every side effect — reading
`serve.driver.load_signal`, querying the capacity oracle, calling
`driver.add_replica()` / `driver.remove_replica(graceful=True)`,
classifying a failed spawn via `resilience.policy.classify_failure`
and retrying within ``max_spawn_retries``, and appending to
``<run_dir>/autoscale.jsonl``.

Ledger contract (one JSON object per line, append-only):

    {"decision_index": k, "now": t, "signal": {...}, "capacity": {...},
     "decision": {"action", "target", "delta", "reason", "clamps"},
     "outcome": {"ok", "added"/"removed", "retries", "failures"},
     "replicas": live-after, "duration_s": actuation wall}

``signal`` is the snapshot the decision was made FROM (so a verdict is
auditable against its input), ``capacity`` the oracle's answer with
its source. Scale events additionally land as driver flight-recorder
events and driver metrics counters, and `report`/`monitor --serve`
render the ledger (docs/OBSERVABILITY.md).

A failed scale-up never drops the target: `PolicyState.applied` is
only called after the seam succeeded, so the sustained-pressure streak
survives and the next poll re-proposes the same target — the SIGKILL
drill's contract.
"""
from __future__ import annotations

import dataclasses
import json
import logging
import os
import time
from typing import Any, Callable, List, Optional

from ray_lightning_tpu_torch.autoscale.capacity import CapacityOracle
from ray_lightning_tpu_torch.autoscale.policy import (
    HOLD, SCALE_DOWN, SCALE_UP, Decision, PolicyConfig, PolicyState,
    decide,
)
log = logging.getLogger(__name__)

__all__ = ["ControllerConfig", "AutoscaleController", "LEDGER_NAME",
           "read_ledger"]

LEDGER_NAME = "autoscale.jsonl"
LEDGER_VERSION = "rlt-autoscale-v1"


@dataclasses.dataclass
class ControllerConfig:
    """The actuator's knobs — the policy's live in `PolicyConfig`."""

    policy: PolicyConfig = dataclasses.field(default_factory=PolicyConfig)
    #: capacity oracle (None = the process-wide default: env + probe
    #: file, spawn probe off). The SAME oracle type the elastic budget
    #: ladder consults — one capacity truth (docs/AUTOSCALE.md).
    oracle: Optional[CapacityOracle] = None
    #: how many recent tick samples per replica the signal summarizes
    #: — small windows react faster, large ones smooth bursts
    signal_window: int = 16
    #: failed spawns retried per scale-up attempt when
    #: `resilience.policy` classifies the death restartable
    max_spawn_retries: int = 2
    #: wall-clock poll cadence for `run_wall` (the scripted harness
    #: ignores this — it polls on virtual ticks)
    poll_every_s: float = 5.0
    #: SLO watch (telemetry/watch.py, docs/OBSERVABILITY.md): True (or
    #: a WatchConfig) evaluates the declarative rules on every poll —
    #: the controller's cadence IS the watch cadence for a serving
    #: session — with breaches landing in <run_dir>/incidents.jsonl
    #: carrying the forced-flight-persist evidence capture. None: off.
    watch: Any = None


def read_ledger(run_dir: str,
                tail_bytes: Optional[int] = None) -> List[dict]:
    """Parse ``<run_dir>/autoscale.jsonl`` (missing file = no
    decisions = []); unparseable lines are skipped, never fatal — a
    killed controller must still leave a readable ledger prefix. The
    clock-alignment header line is NOT an entry (the timeline adapter
    reads it for the wall-axis placement). ``tail_bytes`` bounds the
    read for cadence-polled callers (RLT503)."""
    from ray_lightning_tpu_torch.telemetry.spans import ledger_tail_lines

    path = os.path.join(run_dir, LEDGER_NAME)
    out: List[dict] = []
    try:
        first, body = ledger_tail_lines(path, tail_bytes)
    except OSError:
        return out
    for line in [first] + body:
        line = line.strip()
        if not line:
            continue
        try:
            obj = json.loads(line)
        except json.JSONDecodeError:
            continue
        if not isinstance(obj, dict):
            continue
        if "version" in obj and "decision" not in obj:
            continue  # the clock-alignment header
        out.append(obj)
    return out


def _signal_snapshot(signal: dict) -> dict:
    """The compact per-decision signal record — the fields the policy
    read, not the full per-replica breakdown."""
    keys = ("available", "reason", "queue_depth_now", "queue_depth_p50",
            "queue_depth_max", "occupancy", "pressure", "total_slots",
            "blocks_free_fraction", "replicas_reporting",
            "replicas_retired", "window_ticks")
    snap = {k: signal[k] for k in keys if k in signal}
    # per-traffic-class fields (pressure_<class> / queue_depth_now_<cls>
    # / sheds_<class>) are flat and policy-readable — keep them in the
    # ledger so a class-targeted decision stays auditable
    snap.update({k: v for k, v in signal.items()
                 if k.startswith(("pressure_", "queue_depth_now_",
                                  "sheds_"))})
    return snap


class AutoscaleController:
    """One closed control loop over one `ServeDriver` session.

    ``signal_fn`` defaults to `serve.driver.load_signal(run_dir,
    window)` — the scripted-load harness and unit tests may inject
    their own. ``clock`` only feeds the policy's cooldown arithmetic;
    pass ``now=`` to `step()` for a fully virtual clock (the smoke
    drives it with the driver's tick counter: deterministic, no
    wall-clock flakiness).
    """

    def __init__(self, driver, cfg: Optional[ControllerConfig] = None,
                 run_dir: Optional[str] = None,
                 signal_fn: Optional[Callable[[], dict]] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.driver = driver
        self.cfg = cfg or ControllerConfig()
        self.run_dir = run_dir if run_dir is not None \
            else driver.cfg.run_dir
        self._clock = clock
        self._signal_fn = signal_fn
        self.state = PolicyState(replicas=driver.n_live)
        self.decisions = 0
        self.scale_ups = 0
        self.scale_downs = 0
        self.spawn_retries = 0
        self.scale_up_s: List[float] = []
        self.ledger_path = (os.path.join(self.run_dir, LEDGER_NAME)
                            if self.run_dir else None)
        #: clock-alignment pair stamped into the ledger header: every
        #: entry's "t" is a perf_counter offset from t0_perf, so the
        #: timeline merger places decisions on the shared wall axis
        #: even when the POLICY clock is virtual (the scripted smoke)
        self._t0_wall = time.time()
        self._t0_perf = time.perf_counter()
        self.watch = None
        if self.cfg.watch and self.run_dir is not None:
            from ray_lightning_tpu_torch.telemetry.watch import (
                WatchConfig, WatchEngine,
            )

            self.watch = WatchEngine(
                self.run_dir, WatchConfig.coerce(self.cfg.watch),
                driver=driver)

    # ---- inputs ----------------------------------------------------------

    def _signal(self) -> dict:
        if self._signal_fn is not None:
            return self._signal_fn()
        if self.run_dir is None:
            return {"available": False,
                    "reason": "controller has no run_dir and no "
                              "signal_fn"}
        from ray_lightning_tpu_torch.serve.driver import load_signal

        return load_signal(self.run_dir, window=self.cfg.signal_window)

    def _capacity(self):
        if self.cfg.oracle is None:
            return None
        return self.cfg.oracle.query()

    # ---- the loop --------------------------------------------------------

    def step(self, now: Optional[float] = None) -> dict:
        """One control iteration: signal -> oracle -> decide -> actuate
        -> ledger. Returns the ledger entry."""
        if now is None:
            now = self._clock()
        t0 = time.perf_counter()
        signal = self._signal()
        answer = self._capacity()
        # resync to the ACTUAL replica count: a spawn that failed last
        # poll, or an operator's manual remove, must not leave the
        # policy reasoning about replicas that do not exist
        self.state.replicas = self.driver.n_live
        decision = decide(
            self.cfg.policy, self.state, signal, now,
            capacity=answer.worlds if answer is not None else None)
        outcome = self._actuate(decision, now)
        entry = {
            "decision_index": self.decisions,
            "now": now,
            # "t" is the REAL monotonic offset from the ledger header's
            # t0_perf — "now" may be a virtual policy clock, and the
            # timeline merge must never have to guess this ledger's
            # epoch from it
            "t": round(time.perf_counter() - self._t0_perf, 6),
            "signal": _signal_snapshot(signal or {}),
            "decision": decision.to_dict(),
            "outcome": outcome,
            "replicas": self.driver.n_live,
            "duration_s": round(time.perf_counter() - t0, 6),
        }
        if answer is not None:
            entry["capacity"] = answer.to_dict()
        self.decisions += 1
        self._append_ledger(entry)
        dm = self.driver.driver_metrics
        if dm is not None and dm.enabled:
            dm.count("autoscale_decisions")
            if decision.action == SCALE_UP and outcome.get("ok"):
                dm.count("autoscale_scale_ups")
            elif decision.action == SCALE_DOWN and outcome.get("ok"):
                dm.count("autoscale_scale_downs")
        fl = self.driver.driver_flight
        if fl is not None and fl.enabled and decision.action != HOLD:
            fl.record("autoscale", action=decision.action,
                      target=decision.target, ok=outcome.get("ok"),
                      reason=decision.reason[:120])
        if self.watch is not None:
            # the controller's poll cadence doubles as the watch
            # cadence: pure tail-bounded reads over already-persisted
            # ledgers, breaches land in <run_dir>/incidents.jsonl
            self.watch.poll(driver=self.driver)
        return entry

    def run_wall(self, max_duration_s: float,
                 stop_when_idle: bool = True) -> List[dict]:
        """Wall-clock mode: poll every ``cfg.poll_every_s`` while the
        driver session serves (production shape; the smoke uses the
        scripted virtual-tick harness instead)."""
        entries = []
        t_end = time.monotonic() + max_duration_s
        while time.monotonic() < t_end:
            entries.append(self.step())
            if stop_when_idle and not self.driver.busy():
                break
            time.sleep(self.cfg.poll_every_s)
        return entries

    # ---- actuation -------------------------------------------------------

    def _actuate(self, decision: Decision, now: float) -> dict:
        if decision.action == HOLD:
            return {"ok": True, "action": HOLD}
        if decision.action == SCALE_UP:
            return self._scale_up(decision, now)
        return self._scale_down(decision, now)

    def _scale_up(self, decision: Decision, now: float) -> dict:
        from ray_lightning_tpu_torch.resilience.policy import classify_failure

        added: List[int] = []
        failures: List[dict] = []
        retries = 0
        aborted = False
        t0 = time.perf_counter()
        for _ in range(decision.delta):
            if aborted:
                # a FATAL classification or an exhausted retry budget
                # ends the WHOLE scale-up: the next replica would walk
                # the same broken spawn path (e.g. a corrupt params
                # npz fails identically every time — review finding)
                break
            while True:
                try:
                    added.append(self.driver.add_replica())
                    break
                except Exception as exc:  # noqa: BLE001 — classified below
                    fc = classify_failure(exc)
                    failures.append({"kind": fc.kind, "cause": fc.cause,
                                     "detail": fc.detail[:200]})
                    log.warning(
                        "autoscale: replica spawn died (%s/%s): %s",
                        fc.kind, fc.cause, fc.detail)
                    if not fc.restartable or \
                            retries >= self.cfg.max_spawn_retries:
                        aborted = True
                        break
                    retries += 1
                    self.spawn_retries += 1
        dur = time.perf_counter() - t0
        ok = len(added) == decision.delta
        if added:
            self.scale_up_s.append(dur)
        if ok:
            self.state.applied(decision, now)
            self.scale_ups += 1
        # partial success (some replicas spawned, the last one's budget
        # ran out): commit what exists, cooldown included — capacity
        # DID arrive, and the next judgment should wait for the signal
        # to absorb it. Under still-sustained pressure the remaining
        # delta is re-proposed once the cooldown expires (only a
        # ZERO-progress scale-up skips applied() and re-proposes at
        # the very next poll).
        elif added:
            self.state.applied(
                dataclasses.replace(decision,
                                    target=self.driver.n_live,
                                    delta=len(added)), now)
            self.scale_ups += 1
        out = {"ok": ok, "action": SCALE_UP, "added": added,
               "retries": retries, "duration_s": round(dur, 4)}
        if failures:
            out["failures"] = failures
        return out

    def _scale_down(self, decision: Decision, now: float) -> dict:
        removed: List[int] = []
        errors: List[str] = []
        t0 = time.perf_counter()
        for _ in range(-decision.delta):
            try:
                removed.append(self.driver.remove_replica(graceful=True))
            except Exception as exc:  # noqa: BLE001 — surfaced in ledger
                errors.append(f"{type(exc).__name__}: {str(exc)[:200]}")
                break
        ok = len(removed) == -decision.delta
        if removed:
            self.state.applied(
                decision if ok else dataclasses.replace(
                    decision, target=self.driver.n_live,
                    delta=-len(removed)), now)
            self.scale_downs += 1
        out = {"ok": ok, "action": SCALE_DOWN, "removed": removed,
               "duration_s": round(time.perf_counter() - t0, 4)}
        if errors:
            out["errors"] = errors
        return out

    # ---- ledger ----------------------------------------------------------

    def _append_ledger(self, entry: dict) -> None:
        if self.ledger_path is None:
            return
        os.makedirs(os.path.dirname(self.ledger_path), exist_ok=True)
        with open(self.ledger_path, "a") as f:
            if f.tell() == 0:
                # clock-alignment header (docs/OBSERVABILITY.md
                # "unified timeline"): the same t0_wall/monotonic pair
                # spans/metrics files carry, so the timeline merger
                # never guesses this ledger's epoch
                f.write(json.dumps({
                    "version": LEDGER_VERSION,
                    "t0_wall": self._t0_wall,
                    "t0_perf": self._t0_perf,
                    "pid": os.getpid(),
                }) + "\n")
            f.write(json.dumps(entry) + "\n")
