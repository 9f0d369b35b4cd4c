"""Telemetry: span timeline, goodput accounting, live serving metrics,
on-demand profiling and the run report (twin of
`ray_lightning_tpu/telemetry/`; every file it writes is in the JAX
package's format, and either package's readers read the other's).

  spans.py     host-side span recorder (bounded ring -> per-rank JSONL);
               zero host syncs, the same kernels launched when off
  metrics.py   live serving metrics: counters/gauges, mergeable
               log-bucket histograms, bounded per-tick time-series,
               and the replica flight recorder
  goodput.py   productive/data-wait/ckpt-stall/backoff/replay
               wall-time classification, worker ledgers + driver assembly
  profiler.py  Trainer(profile=ProfileConfig(...)): step-window /
               marker-file / SIGUSR1 torch.profiler capture, rank-scoped
  report.py    `python -m ray_lightning_tpu_torch report|monitor` —
               timeline, goodput, serving and incident sections
  timeline.py  unified run timeline: every evidence ledger merged into
               one causally-ordered Event stream + Chrome-trace export
  watch.py     declarative SLO watch rules evaluated over the persisted
               surfaces (ttft_p99, goodput, queue pressure, guard
               streaks, restart rate)
  incidents.py automatic incident capture: a rule breach appends a
               self-documenting record (evidence + timeline excerpt)
               to <run_dir>/incidents.jsonl and drops the profiler's
               capture marker
"""
from ray_lightning_tpu_torch.telemetry.goodput import (  # noqa: F401
    GOODPUT_BUCKETS,
    GOODPUT_SCHEMA,
    assemble_goodput,
    buckets_consistent,
    read_goodput,
    worker_ledger,
    write_goodput,
    write_ledger,
)
from ray_lightning_tpu_torch.telemetry.metrics import (  # noqa: F401
    NULL_FLIGHT,
    NULL_METRICS,
    FlightRecorder,
    Histogram,
    MetricsRegistry,
    NullMetrics,
    merge_histograms,
    read_flight,
    read_metrics,
)
from ray_lightning_tpu_torch.telemetry.profiler import (  # noqa: F401
    ProfileConfig,
    ProfilerController,
)
from ray_lightning_tpu_torch.telemetry.incidents import (  # noqa: F401
    append_incident,
    capture_evidence,
    read_incidents,
)
from ray_lightning_tpu_torch.telemetry.spans import (  # noqa: F401
    NULL_RECORDER,
    PHASES,
    NullRecorder,
    TelemetryRecorder,
    ledger_tail_lines,
    read_spans,
)
from ray_lightning_tpu_torch.telemetry.timeline import (  # noqa: F401
    Event,
    load_timeline_events,
    to_chrome_trace,
)
from ray_lightning_tpu_torch.telemetry.watch import (  # noqa: F401
    BUILTIN_RULES,
    WatchConfig,
    WatchEngine,
    WatchRule,
)

__all__ = [
    "GOODPUT_BUCKETS", "GOODPUT_SCHEMA", "assemble_goodput",
    "buckets_consistent", "read_goodput", "worker_ledger",
    "write_goodput", "write_ledger", "ProfileConfig",
    "ProfilerController", "NULL_RECORDER", "PHASES", "NullRecorder",
    "TelemetryRecorder", "TelemetryConfig", "ledger_tail_lines",
    "read_spans",
    "NULL_FLIGHT", "NULL_METRICS", "FlightRecorder", "Histogram",
    "MetricsRegistry", "NullMetrics", "merge_histograms", "read_flight",
    "read_metrics",
    "Event", "load_timeline_events", "to_chrome_trace",
    "BUILTIN_RULES", "WatchConfig", "WatchEngine", "WatchRule",
    "append_incident", "capture_evidence", "read_incidents",
]


import dataclasses as _dc
import os as _os
from typing import Any as _Any, Optional as _Optional


@_dc.dataclass
class TelemetryConfig:
    """``Trainer(telemetry=...)`` — True for defaults, a directory
    string, or this. ``dir=None`` derives ``<root_dir>/telemetry``."""

    dir: _Optional[str] = None
    ring_size: int = 4096
    #: span-file + ledger flush cadence in steps (rides the trainer's
    #: logging cadence when larger)
    flush_every_n_steps: int = 50

    @classmethod
    def coerce(cls, value: _Any) -> _Optional["TelemetryConfig"]:
        if value is None or value is False:
            return None
        if value is True:
            return cls()
        if isinstance(value, cls):
            return value
        if isinstance(value, str):
            return cls(dir=value)
        raise TypeError(
            f"telemetry= takes True, a directory string, or a "
            f"TelemetryConfig; got {type(value).__name__}")

    def resolved_dir(self, root_dir: str) -> str:
        return self.dir or _os.path.join(root_dir, "telemetry")
