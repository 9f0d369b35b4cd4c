"""``python -m ray_lightning_tpu_torch``: the port's command line.

    python -m ray_lightning_tpu_torch [--json] [--probe] [--device cpu]
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
    python -m ray_lightning_tpu_torch elastic --smoke --device cpu
    python -m ray_lightning_tpu_torch autoscale [--smoke] --device cpu
    python -m ray_lightning_tpu_torch loadgen --out trace.jsonl [--seed 7]
    python -m ray_lightning_tpu_torch loadgen --trace trace.jsonl \
        --device cpu
    python -m ray_lightning_tpu_torch loadgen --smoke --device cpu
    python -m ray_lightning_tpu_torch watch --smoke --device cpu
    python -m ray_lightning_tpu_torch --probe [--device cpu] [--json]

``supervise`` is resilience/cli.py; ``report``, ``monitor``,
``timeline`` and ``watch`` read a telemetry-enabled run's directory
(telemetry/); ``perf`` measures the hot loop's prefetch overlap, warm
start and FSDP schedule (pipeline/cli.py); ``serve`` runs the replica
driver and its smoke gate (serve/cli.py); ``plan`` is the pre-flight
memory plan on the meta device (parallel/cli.py); ``elastic`` is the
elastic-training gate (elastic/cli.py), ``autoscale`` the closed-loop
serving autoscaler's demo and gate (autoscale/cli.py), ``loadgen`` the
trace-driven load harness (loadgen/cli.py). With no subcommand it is the
doctor (twin of the JAX package's): the package, torch and CUDA
versions, this process's rank, world size and local rank from the
environment, and each visible CUDA device with its index, name, memory
and compute capability (none with ``--device cpu``); ``--json`` prints
the same dict; ``--probe`` adds a timed chain of bf16 matmuls on the
card (utils/probe.py) beside its spec-sheet peak.
"""
import argparse
import json
import sys


def collect(probe: bool = False, device=None) -> dict:
    """The process's topology (the JAX doctor's `collect`, for CUDA):
    versions, rank / world size / local rank as the environment gives
    them, every visible CUDA device unless ``device`` is the CPU, and
    with ``probe`` the bf16 matmul rate on ``device`` (the card by
    default) beside its spec-sheet peak."""
    import os
    import platform

    import torch

    import ray_lightning_tpu_torch as rlt

    cpu = device is not None and torch.device(device).type == "cpu"
    n = 0 if cpu else torch.cuda.device_count()
    devices = []
    for i in range(n):
        props = torch.cuda.get_device_properties(i)
        devices.append({
            "index": i, "name": props.name,
            "total_memory_bytes": props.total_memory,
            "total_memory_gib": round(props.total_memory / 2**30, 2),
            "capability": f"{props.major}.{props.minor}"})
    env = os.environ
    info = {
        "package": f"ray_lightning_tpu_torch {rlt.__version__}",
        "torch": torch.__version__, "cuda": torch.version.cuda,
        "python": platform.python_version(),
        "rank": int(env.get("RANK", 0)),
        "world_size": int(env.get("WORLD_SIZE", 1)),
        "local_rank": int(env.get("LOCAL_RANK", 0)),
        "cuda_visible_devices": env.get("CUDA_VISIBLE_DEVICES"),
        "device_count": n, "devices": devices,
    }
    if probe:
        from ray_lightning_tpu_torch.utils.devices import resolve_device
        from ray_lightning_tpu_torch.utils.probe import (
            device_peak_tflops,
            matmul_tflops,
        )

        dev = resolve_device(device)
        name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                else "cpu")
        info.update(device=name, matmul_tflops=matmul_tflops(device=dev),
                    peak_tflops=device_peak_tflops(name))
    return info


def run_doctor(args) -> int:
    info = collect(probe=args.probe, device=args.device)
    if args.as_json:
        print(json.dumps(info))
        return 0
    print(f"{info['package']}  (torch {info['torch']}, cuda "
          f"{info['cuda']}, python {info['python']})")
    print(f"rank {info['rank']}/{info['world_size']}  local rank "
          f"{info['local_rank']}  CUDA devices {info['device_count']}"
          + (f" (CUDA_VISIBLE_DEVICES={info['cuda_visible_devices']})"
             if info["cuda_visible_devices"] is not None else ""))
    for d in info["devices"]:
        print(f"  [{d['index']}] {d['name']}  {d['total_memory_gib']} GiB  "
              f"sm_{d['capability'].replace('.', '')}")
    if not info["devices"]:
        print("  no CUDA device")
    if args.probe:
        peak = info["peak_tflops"]
        print(f"probe: {info['device']}: {info['matmul_tflops']:.1f} "
              "TFLOP/s bf16 matmul "
              + (f"(spec peak {peak:g})" if peak else "(no spec peak)"))
    return 0


def main(argv=None) -> int:
    from ray_lightning_tpu_torch.autoscale.cli import (
        add_autoscale_parser,
        run_autoscale,
    )
    from ray_lightning_tpu_torch.elastic.cli import (
        add_elastic_parser,
        run_elastic,
    )
    from ray_lightning_tpu_torch.loadgen.cli import (
        add_loadgen_parser,
        run_loadgen,
    )
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
                    help="also time a chain of bf16 matmuls on the device "
                         "and print the rate beside its spec-sheet peak")
    ap.add_argument("--device", default=None,
                    help="cpu: list no CUDA device and probe the CPU "
                         "(default: the CUDA card)")
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
    add_elastic_parser(sub)
    add_autoscale_parser(sub)
    add_loadgen_parser(sub)
    args = ap.parse_args(argv)
    commands = {"supervise": run_supervise, "report": run_report,
                "monitor": run_monitor, "timeline": run_timeline,
                "watch": run_watch, "perf": run_perf,
                "serve": run_serve, "plan": run_plan,
                "elastic": run_elastic, "autoscale": run_autoscale,
                "loadgen": run_loadgen}
    if args.command in commands:
        return commands[args.command](args)
    return run_doctor(args)


if __name__ == "__main__":
    sys.exit(main())
