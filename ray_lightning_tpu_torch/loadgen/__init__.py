"""Trace-driven load harness (twin of `ray_lightning_tpu/loadgen/`): a
deterministic workload generator, the versioned replayable trace format
and the virtual-clock runner that drive the real `ServeDriver`,
`Scheduler` and autoscale stack.

* `loadgen.trace` — the versioned JSONL trace format (record a live
  run, replay it bitwise) and Request materialization; the bytes are
  the JAX package's, so a trace written by either replays in the other;
* `loadgen.generator` — seeded arrival processes (Poisson / 2-state
  bursty MMPP) with heavy-tailed lengths and a traffic-class mix, every
  draw from one `np.random.Generator(PCG64(seed))`;
* `loadgen.runner` — the virtual-clock drive loop (the driver's tick
  counter is the clock; `autoscale.sim.run_scripted` is a shim over it);
* `loadgen.cli` — ``python -m ray_lightning_tpu_torch loadgen`` and its
  ``--smoke`` gate.

Names resolve on first use.
"""
from ray_lightning_tpu_torch._lazy import lazy_exports

_NAMES = {
    "WorkloadConfig": "generator",
    "generate_events": "generator",
    "run_trace": "runner",
    **{n: "trace" for n in (
        "TRACE_VERSION", "TraceEvent", "TraceRecorder", "arrivals_by_tick",
        "dump_trace", "events_from_arrivals", "read_trace", "to_request",
        "write_trace")},
}

__all__ = sorted(_NAMES)

__getattr__, __dir__ = lazy_exports(__name__, _NAMES)
