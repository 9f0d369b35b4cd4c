"""``python -m ray_lightning_tpu_torch``: the port's command line.

    python -m ray_lightning_tpu_torch supervise --smoke --device cpu
    python -m ray_lightning_tpu_torch supervise my_project.jobs:make_job \\
        --processes 1 --max-restarts 3
    python -m ray_lightning_tpu_torch report   <run_dir> [--json]
    python -m ray_lightning_tpu_torch monitor  <run_dir> [--serve] [--follow]
    python -m ray_lightning_tpu_torch timeline <run_dir> [--json | --chrome OUT]
    python -m ray_lightning_tpu_torch watch    <run_dir> [--json]
    python -m ray_lightning_tpu_torch perf [--smoke] [--device cpu]
    python -m ray_lightning_tpu_torch serve example [--replicas N] \\
        [--backend process] [--device cpu]
    python -m ray_lightning_tpu_torch serve --smoke --device cpu
    python -m ray_lightning_tpu_torch plan [--preset llama3-8b] \
        [--data D --fsdp F --tensor T] [--batch B --seq S] \
        [--find-max-batch] [--json]
    python -m ray_lightning_tpu_torch --probe [--device cpu] [--json]

``supervise`` is resilience/cli.py; ``report``, ``monitor``,
``timeline`` and ``watch`` read a telemetry-enabled run's directory
(telemetry/); ``perf`` measures the hot loop's prefetch overlap, warm
start and FSDP schedule (pipeline/cli.py); ``serve`` runs the replica
driver and its smoke gate (serve/cli.py); ``plan`` is the pre-flight
memory plan on the meta device (parallel/cli.py); ``--probe`` times a chain of
bf16 matmuls on the card (utils/probe.py) beside its spec-sheet peak.
"""
import argparse
import json
import sys


def run_probe(args) -> int:
    import torch

    from ray_lightning_tpu_torch.utils.devices import resolve_device
    from ray_lightning_tpu_torch.utils.probe import (
        device_peak_tflops,
        matmul_tflops,
    )

    dev = resolve_device(args.device)
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    info = {"device": name, "matmul_tflops": matmul_tflops(device=dev),
            "peak_tflops": device_peak_tflops(name)}
    if args.as_json:
        print(json.dumps(info))
    else:
        peak = info["peak_tflops"]
        print(f"{name}: {info['matmul_tflops']:.1f} TFLOP/s bf16 matmul "
              + (f"(spec peak {peak:g})" if peak else "(no spec peak)"))
    return 0


def main(argv=None) -> int:
    from ray_lightning_tpu_torch.parallel.cli import add_plan_parser, run_plan
    from ray_lightning_tpu_torch.pipeline.cli import add_perf_parser, run_perf
    from ray_lightning_tpu_torch.resilience.cli import (
        add_supervise_parser,
        run_supervise,
    )
    from ray_lightning_tpu_torch.serve.cli import add_serve_parser, run_serve
    from ray_lightning_tpu_torch.telemetry.report import (
        add_monitor_parser,
        add_report_parser,
        run_monitor,
        run_report,
    )
    from ray_lightning_tpu_torch.telemetry.timeline import (
        add_timeline_parser,
        run_timeline,
    )
    from ray_lightning_tpu_torch.telemetry.watch import (
        add_watch_parser,
        run_watch,
    )

    ap = argparse.ArgumentParser(prog="python -m ray_lightning_tpu_torch")
    ap.add_argument("--probe", action="store_true",
                    help="time a chain of bf16 matmuls on the device and "
                         "print the rate beside its spec-sheet peak")
    ap.add_argument("--device", default=None,
                    help="the probe's device (default: the CUDA card)")
    ap.add_argument("--json", action="store_true", dest="as_json")
    sub = ap.add_subparsers(dest="command")
    add_supervise_parser(sub)
    add_report_parser(sub)
    add_monitor_parser(sub)
    add_timeline_parser(sub)
    add_watch_parser(sub)
    add_perf_parser(sub)
    add_serve_parser(sub)
    add_plan_parser(sub)
    args = ap.parse_args(argv)
    commands = {"supervise": run_supervise, "report": run_report,
                "monitor": run_monitor, "timeline": run_timeline,
                "watch": run_watch, "perf": run_perf,
                "serve": run_serve, "plan": run_plan}
    if args.command in commands:
        return commands[args.command](args)
    if args.probe:
        return run_probe(args)
    ap.print_usage(sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main())
