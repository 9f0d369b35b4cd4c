"""The virtual-clock drive loop (twin of
`ray_lightning_tpu/loadgen/runner.py`).

Wall-clock load tests flake by construction — queue depth depends on
when a submit landed relative to the tick. Here the DRIVER TICK
COUNTER is the clock (1 tick = 1 virtual second for the autoscale
policy's cooldown arithmetic): arrivals fire at their trace tick, the
controller (when armed) polls every ``poll_every_ticks`` ticks, and
the load signal is read from the same flushed metrics files
production reads — the real signal path, the real policy, the real
`ServeDriver` seams, zero sleeps. `autoscale.sim.run_scripted` is a
thin back-compat shim over this loop.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Union

from ray_lightning_tpu_torch.loadgen.trace import (
    TraceEvent,
    TraceRecorder,
    arrivals_by_tick,
)

__all__ = ["run_trace"]


def run_trace(driver,
              arrivals: Union[Dict[int, Sequence],
                              Sequence[TraceEvent]],
              controller=None,
              poll_every_ticks: int = 2,
              idle_ticks_after_drain: int = 48,
              max_ticks: int = 5000,
              recorder: Optional[TraceRecorder] = None) -> dict:
    """Drive one serving session to completion. ``driver`` must be
    `start()`ed; ``arrivals`` is either ``{tick: [Request, ...]}`` or
    a sequence of `TraceEvent`s. Keeps ticking (and polling)
    ``idle_ticks_after_drain`` ticks after the last stream drains —
    the idle phase a scale-down needs to observe. Returns
    ``{"ticks", "drained_at", "entries", "submitted"}`` where
    ``entries`` is every controller ledger entry in order."""
    if not isinstance(arrivals, dict):
        arrivals = arrivals_by_tick(arrivals)
    entries: List[dict] = []
    drained_at: Optional[int] = None
    submitted = 0
    last_arrival = max(arrivals) if arrivals else 0
    tick = 0
    while tick < max_ticks:
        for req in arrivals.get(tick, ()):
            if recorder is not None:
                recorder.record(tick, req)
            driver.submit(req)
            submitted += 1
        driver.tick()
        if controller is not None and tick % poll_every_ticks == 0:
            entries.append(controller.step(now=float(tick)))
        if tick >= last_arrival and not driver.busy():
            if drained_at is None:
                drained_at = tick
            if tick - drained_at >= idle_ticks_after_drain:
                break
        else:
            drained_at = None
        tick += 1
    return {"ticks": tick, "drained_at": drained_at,
            "entries": entries, "submitted": submitted}
