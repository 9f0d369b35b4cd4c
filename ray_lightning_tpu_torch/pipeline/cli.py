"""``python -m ray_lightning_tpu_torch perf``: the hot loop's evidence
(twin of `ray_lightning_tpu/pipeline/cli.py`).

Runs the prefetch and warm-start comparison (pipeline/overlap.py) and
the collective-overlap leg (pipeline/collective_overlap.py) and prints
ONE JSON line with the JAX CLI's keys. ``--smoke`` is the gate: exit 1
unless the pipeline occupancy is above 0, the FSDP schedule check holds
and the throttled interleave beats serial by its floor.
"""
from __future__ import annotations

import argparse
import json
import sys


def add_perf_parser(sub) -> None:
    p = sub.add_parser(
        "perf",
        help="measure the device-prefetch overlap and the warm start with "
             "a synthetic slow loader")
    p.add_argument("--steps", type=int, default=40,
                   help="timed optimizer steps a leg")
    p.add_argument("--depth", type=int, default=2,
                   help="prefetch buffer depth of the overlapped leg")
    p.add_argument("--delay-ms", type=float, default=None,
                   help="synthetic loader delay a batch; default: "
                        "calibrated to the measured step time")
    p.add_argument("--cache-dir", default=None,
                   help="kernel build directory for the legs (default: "
                        "the one in effect)")
    p.add_argument("--device", default=None,
                   help="the legs' device (default: the CUDA card)")
    p.add_argument("--smoke", action="store_true",
                   help="gate: exit 1 unless the pipeline occupancy is "
                        "above 0 and the overlap leg proves the schedule "
                        "(prefetch lists, interleave faster than serial)")
    p.add_argument("--no-overlap-leg", action="store_true",
                   help="skip the collective-overlap leg")
    p.add_argument("--overlap-layers", type=int, default=8,
                   help="layers of the throttled interleave")
    p.add_argument("--overlap-comm-ms", type=float, default=20.0,
                   help="fake collective latency of the interleave")
    p.add_argument("--json", action="store_true", dest="as_json",
                   default=argparse.SUPPRESS)


def run_perf(args) -> int:
    from ray_lightning_tpu_torch.pipeline.overlap import (
        measure_prefetch_overlap,
    )

    result = measure_prefetch_overlap(
        steps=args.steps, depth=args.depth,
        delay_s=(args.delay_ms / 1e3 if args.delay_ms is not None
                 else None),
        cache_dir=args.cache_dir, device=args.device)
    if not args.no_overlap_leg:
        from ray_lightning_tpu_torch.pipeline.collective_overlap import (
            measure_collective_overlap,
        )

        try:
            result.update(measure_collective_overlap(
                n_layers=args.overlap_layers,
                t_comm_s=args.overlap_comm_ms / 1e3, device=args.device))
        except Exception as exc:  # noqa: BLE001 — keep the prefetch
            # evidence already measured; --smoke fails on the verdict
            result["overlap_error"] = (
                f"{type(exc).__name__}: {str(exc)[:200]}")
            result["overlap_schedule_ok"] = False
    print(json.dumps(result), flush=True)
    if args.smoke and result["pipeline_occupancy"] <= 0.0:
        print("perf smoke FAILED: prefetch pipeline occupancy is 0: the "
              "prefetcher never had a batch ready ahead of the step",
              file=sys.stderr)
        return 1
    if args.smoke and not args.no_overlap_leg:
        if not result.get("overlap_schedule_ok"):
            print("perf smoke FAILED: the FSDP overlap schedule did not "
                  "verify (see overlap_schedule / overlap_error)",
                  file=sys.stderr)
            return 1
        # the floor scales with the demo's own roofline: half the ideal
        # gain, capped at the 1.15 the 20 ms / 20 ms default clears
        floor = min(1.15, 1 + 0.5 * (result.get("ideal_speedup", 1.3) - 1))
        if result.get("overlap_speedup", 0.0) < floor:
            print(f"perf smoke FAILED: the throttled interleave hides no "
                  f"latency (speedup {result.get('overlap_speedup')} < "
                  f"floor {floor:.3f}; serial {result.get('serial_s')} s, "
                  f"overlapped {result.get('overlapped_s')} s)",
                  file=sys.stderr)
            return 1
    return 0
