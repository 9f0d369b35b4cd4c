"""Deterministic scripted-load harness (twin of
`ray_lightning_tpu/autoscale/sim.py`) — a thin shim over
`ray_lightning_tpu_torch.loadgen` (the trace-driven load harness that
generalized this module; docs/SERVING.md "traffic & SLO classes").

The virtual-clock drive loop now lives in `loadgen.runner.run_trace`:
the DRIVER TICK COUNTER is the clock (1 tick = 1 virtual second for
the policy's cooldown arithmetic), arrivals fire at scripted ticks,
the controller polls every ``poll_every_ticks`` ticks, and the load
signal is read from the same flushed metrics files production reads —
so the smoke/test exercises the real signal path, the real policy,
and the real `ServeDriver` seams with zero sleeps and zero wall-clock
sensitivity (tests/test_torch_autoscale.py, ``autoscale --smoke``).
`ScriptedLoad` keeps its historical API and gains ``to_events()``, so
any scripted schedule can be persisted as a versioned loadgen trace
and replayed bitwise.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

__all__ = ["ScriptedLoad", "run_scripted"]


@dataclasses.dataclass
class ScriptedLoad:
    """``arrivals[tick]`` = requests submitted at that virtual tick."""

    arrivals: Dict[int, Sequence]
    #: keep ticking (and polling) this many ticks after the last
    #: stream drains — the idle phase a scale-down needs to observe
    idle_ticks_after_drain: int = 48

    def last_arrival_tick(self) -> int:
        return max(self.arrivals) if self.arrivals else 0

    def to_events(self) -> List:
        """Lift the schedule into loadgen trace events — write them
        with `loadgen.trace.write_trace` for a replayable artifact."""
        from ray_lightning_tpu_torch.loadgen.trace import events_from_arrivals

        return events_from_arrivals(self.arrivals)


def run_scripted(driver, controller, load: ScriptedLoad,
                 poll_every_ticks: int = 2,
                 max_ticks: int = 5000) -> dict:
    """Drive one scripted serving session to completion. The driver
    session must be `start()`ed. Returns
    ``{"ticks", "drained_at", "entries"}`` where ``entries`` is every
    controller ledger entry in order."""
    from ray_lightning_tpu_torch.loadgen.runner import run_trace

    out = run_trace(
        driver, load.arrivals, controller=controller,
        poll_every_ticks=poll_every_ticks,
        idle_ticks_after_drain=load.idle_ticks_after_drain,
        max_ticks=max_ticks)
    return {"ticks": out["ticks"], "drained_at": out["drained_at"],
            "entries": out["entries"]}
