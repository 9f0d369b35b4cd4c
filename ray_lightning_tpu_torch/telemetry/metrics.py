"""The metrics/flight-recorder off switches the serving path defaults to.

Only the null objects of `ray_lightning_tpu/telemetry/metrics.py` are
ported so far: `serve.engine.DecodeEngine` and `serve.scheduler.Scheduler`
take a registry and a recorder and call them on every tick, and these
objects make every such call a no-op. The live registry, histograms and
the flight recorder's ring come with the telemetry port.
"""
from __future__ import annotations

from typing import Any


class NullMetrics:
    """metrics=off: the registry calls the serving path makes, each a
    no-op; ``enabled`` False so call sites can skip computing values."""

    enabled = False

    def count(self, name: str, n: int = 1) -> None: ...
    def gauge(self, name: str, value: float) -> None: ...
    def observe(self, name: str, value: float) -> None: ...
    def tick_end(self) -> None: ...


NULL_METRICS = NullMetrics()


class NullFlightRecorder:
    """flight=off: the recorder call the scheduler makes, a no-op."""

    enabled = False

    def record(self, kind: str, **fields: Any) -> None: ...


NULL_FLIGHT = NullFlightRecorder()
