"""The autoscale decision core: pure, deterministic, I/O-free (twin of
`ray_lightning_tpu/autoscale/policy.py`: the same `Decision` for the
same state, signal, clock and capacity).

One function — `decide()` — turns a load-signal snapshot
(`serve.driver.load_signal`, docs/OBSERVABILITY.md "load signal") plus
the controller's own memory (`PolicyState`) into a `Decision`. No file
reads, no clock reads, no torch: ``now`` is an argument, so the whole
decision table is unit-testable tick for tick (the scripted-load smoke
drives it with a virtual clock — tests/test_torch_autoscale.py).

The policy is a **target-pressure band with hysteresis**:

  * ``pressure`` (queue_depth_p50 / total_slots) at or above
    ``high_pressure`` for ``sustain_polls`` CONSECUTIVE polls asks for
    ``+max_step`` replicas — one blip never scales;
  * pressure at or below ``low_pressure`` with an EMPTY queue and idle
    occupancy for ``sustain_polls`` polls asks for ``-max_step``;
  * anything in between holds and RESETS both streaks (the hysteresis:
    flapping load keeps resetting the counters and never flaps the
    replica count — test-pinned).

Every proposal then passes the clamps, in order: the scale-direction
**cooldown** (a fresh scale event suppresses the next one in either
direction — the signal lags actuation by a flush cadence, so acting on
the pre-scale signal would double-apply), the ``min_replicas`` /
``max_replicas`` bounds, and the **capacity clamp** (the oracle's
schedulable-world count, `autoscale/capacity.py` — wanting a replica
the runtime cannot schedule is a ledger entry, not a spawn loop). A
clamp that nullifies the step returns a ``hold`` naming the clamp, so
the ledger always says WHY nothing happened.

Streaks survive a cooldown/clamp hold (the moment the cooldown
expires, the sustained signal acts); they reset only on an in-band
signal, a missing signal, or an applied decision
(`PolicyState.applied`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

__all__ = ["PolicyConfig", "PolicyState", "Decision", "decide",
           "HOLD", "SCALE_UP", "SCALE_DOWN"]

HOLD = "hold"
SCALE_UP = "scale_up"
SCALE_DOWN = "scale_down"


@dataclasses.dataclass(frozen=True)
class PolicyConfig:
    """The band, the hysteresis, and the clamps. All thresholds are
    dimensionless or in the controller's clock units (wall seconds in
    production, virtual ticks under the scripted-load harness)."""

    min_replicas: int = 1
    max_replicas: int = 4
    #: pressure >= this, sustained, scales up. pressure is
    #: queue_depth_p50 / total_slots: 0.5 means half a slot-set's worth
    #: of requests is queuing behind capacity at the median tick.
    high_pressure: float = 0.5
    #: pressure <= this (AND queue empty AND idle occupancy),
    #: sustained, scales down
    low_pressure: float = 0.05
    #: scale-down additionally requires mean occupancy at or below
    #: this — a deep queue can drain to zero while every slot still
    #: decodes; reclaiming a replica then would immediately re-queue
    idle_occupancy: float = 0.5
    #: consecutive polls a signal must sustain before acting
    sustain_polls: int = 2
    #: clock units a scale-UP suppresses further scaling
    up_cooldown_s: float = 30.0
    #: clock units a scale-DOWN suppresses further scaling (longer by
    #: default: spawning is cheap to undo, draining is not)
    down_cooldown_s: float = 60.0
    #: replicas added/removed per decision
    max_step: int = 1
    #: traffic class whose flat per-class signal fields
    #: (``pressure_<class>`` / ``queue_depth_now_<class>``, emitted
    #: when the scheduler runs with an `SLOConfig`) drive the band
    #: instead of the pooled signal — e.g. "latency_critical" reacts
    #: to paying-class pressure while a shed best_effort backlog
    #: queues. Falls back to the pooled fields when the signal carries
    #: no per-class data (priority-off run). None = pooled (historical)
    pressure_class: Optional[str] = None

    def __post_init__(self):
        if not 1 <= self.min_replicas <= self.max_replicas:
            raise ValueError(
                f"need 1 <= min_replicas ({self.min_replicas}) <= "
                f"max_replicas ({self.max_replicas})")
        if self.low_pressure > self.high_pressure:
            raise ValueError(
                f"low_pressure {self.low_pressure} above high_pressure "
                f"{self.high_pressure} — the band is inverted")
        if self.sustain_polls < 1:
            raise ValueError("sustain_polls must be >= 1")
        if self.max_step < 1:
            raise ValueError("max_step must be >= 1")


@dataclasses.dataclass
class PolicyState:
    """What the policy remembers between polls. The controller owns
    one; tests build them directly for the decision-table matrix."""

    replicas: int
    high_streak: int = 0
    low_streak: int = 0
    last_scale_up_t: Optional[float] = None
    last_scale_down_t: Optional[float] = None

    def applied(self, decision: "Decision", now: float) -> None:
        """Commit an ACTUATED decision: stamp the cooldown, adopt the
        target, reset the streaks. The controller calls this only after
        the driver seam succeeded — a failed spawn leaves the streaks
        high, so the sustained demand re-proposes the same target at
        the next poll instead of being forgotten (the SIGKILL drill's
        'never drops the scale target' contract)."""
        if decision.action == SCALE_UP:
            self.last_scale_up_t = now
        elif decision.action == SCALE_DOWN:
            self.last_scale_down_t = now
        if decision.action != HOLD:
            self.replicas = decision.target
            self.high_streak = 0
            self.low_streak = 0

    def last_scale_t(self) -> Optional[float]:
        stamps = [t for t in (self.last_scale_up_t,
                              self.last_scale_down_t) if t is not None]
        return max(stamps) if stamps else None


@dataclasses.dataclass(frozen=True)
class Decision:
    """One poll's verdict — exactly what lands in the ledger."""

    action: str                  # "scale_up" | "scale_down" | "hold"
    target: int                  # replica count after the action
    delta: int                   # target - current (0 for hold)
    reason: str                  # human-readable why
    clamps: Tuple[str, ...] = () # which clamps shaped/nullified it

    def to_dict(self) -> dict:
        return {"action": self.action, "target": self.target,
                "delta": self.delta, "reason": self.reason,
                "clamps": list(self.clamps)}


def _pressure(signal: dict,
              pressure_class: Optional[str] = None
              ) -> Tuple[float, float, float]:
    """(pressure, queue_depth_now, occupancy) with honest fallbacks: a
    None pressure means no slots reported — queued demand with zero
    slots is INFINITE pressure, an empty queue with zero slots is
    zero. ``pressure_class`` narrows pressure/queue-depth to that
    traffic class's flat fields when the signal carries them."""
    p_key, qd_key = "pressure", "queue_depth_now"
    if (pressure_class is not None
            and f"pressure_{pressure_class}" in signal):
        p_key = f"pressure_{pressure_class}"
        qd_key = f"queue_depth_now_{pressure_class}"
    qd_now = float(signal.get(qd_key) or 0.0)
    occ = float(signal.get("occupancy") or 0.0)
    p = signal.get(p_key)
    if p is None:
        p = math.inf if qd_now > 0 else 0.0
    return float(p), qd_now, occ


def decide(cfg: PolicyConfig, state: PolicyState, signal: Optional[dict],
           now: float, capacity: Optional[int] = None) -> Decision:
    """One poll of the decision core. Mutates ``state``'s streaks (that
    IS the hysteresis memory); cooldown stamps and the replica count
    are only committed by `PolicyState.applied` after actuation.

    ``capacity`` is the oracle's schedulable-world count (None = no
    oracle answer = no clamp). Deterministic: same (state, signal, now,
    capacity) -> same decision.
    """
    n = state.replicas
    if n < cfg.min_replicas:
        # the floor is correctness, not a demand response: a replica
        # set driven below min (operator removal, an aborted scale-up
        # after deaths) must be restored regardless of signal — with
        # 0 live replicas every metrics stream is retired, the signal
        # reads unavailable, and no demand branch could ever fire
        # (review finding, test-pinned). No cooldown either: waiting
        # out a cooldown to reach the configured minimum serves no
        # one. Only the capacity clamp still applies.
        target = cfg.min_replicas
        clamps = ["min_replicas"]
        if capacity is not None and target > capacity:
            target = max(capacity, n)
            clamps.append("capacity")
        if target <= n:
            return Decision(
                HOLD, n, 0,
                f"below the min_replicas floor ({n} < "
                f"{cfg.min_replicas}) but capacity {capacity} holds "
                "the target", tuple(clamps))
        return Decision(
            SCALE_UP, target, target - n,
            f"below the min_replicas floor ({n} < "
            f"{cfg.min_replicas}) — restoring it regardless of "
            "signal", tuple(clamps))
    if not signal or not signal.get("available"):
        # no signal is NOT zero load (load_signal's documented
        # contract) — never scale on ignorance
        state.high_streak = 0
        state.low_streak = 0
        return Decision(HOLD, n, 0,
                        "no load signal (metrics not flushed yet, or "
                        "nothing served)", ("no_signal",))
    p, qd_now, occ = _pressure(signal, cfg.pressure_class)

    if p >= cfg.high_pressure:
        state.high_streak += 1
        state.low_streak = 0
        if state.high_streak < cfg.sustain_polls:
            return Decision(
                HOLD, n, 0,
                f"pressure {p:.3f} >= {cfg.high_pressure} sustained "
                f"{state.high_streak}/{cfg.sustain_polls} polls",
                ("hysteresis",))
        up_stamp = state.last_scale_t()
        if (up_stamp is not None
                and now - up_stamp < cfg.up_cooldown_s):
            return Decision(
                HOLD, n, 0,
                f"pressure {p:.3f} sustained but scale event at "
                f"t={up_stamp:g} is within the {cfg.up_cooldown_s:g} "
                f"up-cooldown (now {now:g})", ("up_cooldown",))
        clamps = []
        target = n + cfg.max_step
        if target > cfg.max_replicas:
            target = cfg.max_replicas
            clamps.append("max_replicas")
        if capacity is not None and target > capacity:
            target = max(capacity, cfg.min_replicas)
            clamps.append("capacity")
        if target <= n:
            return Decision(
                HOLD, n, 0,
                f"pressure {p:.3f} sustained but "
                f"{' + '.join(clamps) or 'clamps'} hold the target at "
                f"{n}", tuple(clamps) or ("max_replicas",))
        return Decision(
            SCALE_UP, target, target - n,
            f"pressure {p:.3f} >= {cfg.high_pressure} for "
            f"{state.high_streak} polls (queue_now {qd_now:g}, "
            f"occupancy {occ:.2f})", tuple(clamps))

    if p <= cfg.low_pressure and qd_now <= 0 and occ <= cfg.idle_occupancy:
        state.low_streak += 1
        state.high_streak = 0
        if state.low_streak < cfg.sustain_polls:
            return Decision(
                HOLD, n, 0,
                f"idle (pressure {p:.3f}, occupancy {occ:.2f}) "
                f"sustained {state.low_streak}/{cfg.sustain_polls} "
                "polls", ("hysteresis",))
        down_stamp = state.last_scale_t()
        if (down_stamp is not None
                and now - down_stamp < cfg.down_cooldown_s):
            return Decision(
                HOLD, n, 0,
                f"idle sustained but scale event at t={down_stamp:g} "
                f"is within the {cfg.down_cooldown_s:g} down-cooldown "
                f"(now {now:g})", ("down_cooldown",))
        target = max(n - cfg.max_step, cfg.min_replicas)
        if target >= n:
            return Decision(
                HOLD, n, 0,
                f"idle sustained but already at min_replicas "
                f"{cfg.min_replicas}", ("min_replicas",))
        return Decision(
            SCALE_DOWN, target, target - n,
            f"pressure {p:.3f} <= {cfg.low_pressure}, queue empty, "
            f"occupancy {occ:.2f} <= {cfg.idle_occupancy} for "
            f"{state.low_streak} polls",
            ("min_replicas",) if target == cfg.min_replicas
            and n - cfg.max_step < cfg.min_replicas else ())

    # in-band: the hysteresis reset — flapping load lands here between
    # excursions and never accumulates a streak
    state.high_streak = 0
    state.low_streak = 0
    return Decision(
        HOLD, n, 0,
        f"pressure {p:.3f} within band ({cfg.low_pressure}, "
        f"{cfg.high_pressure}) — or busy slots hold the floor", ())
