"""``python -m ray_lightning_tpu_torch plan``: the pre-flight memory plan
of a Llama training job (twin of the JAX CLI's ``plan``).

    python -m ray_lightning_tpu_torch plan --preset llama3-8b --fsdp 8 \\
        --tensor 2 --batch 16 --seq 8192 [--json]
    python -m ray_lightning_tpu_torch plan --preset llama3-8b --fsdp 1 \\
        --seq 2048 --find-max-batch

The model is built on the meta device under `ShardedMesh(data, fsdp,
tensor)` over a shape-only mesh: nothing touches a card or a process
group. Exit status: 0 fits, 1 does not, 2 an invalid configuration (a
structured error). ``--serve``, ``--mu-bf16`` and ``--ce-inline-bwd``
report ``not_ported`` with their ROADMAP items and exit 2; the trace
section (the JAX CLI's jaxpr audit) reports ``not_ported`` too.
"""
from __future__ import annotations

import argparse
import json
import sys

#: what the JAX CLI's legs need, by ROADMAP item
NOT_PORTED = {
    "serve": "ROADMAP Queue 1 item 8 (serve/audit.py's HBM itemization, "
             "serve_kv_plan_bytes)",
    "mu_bf16": "ROADMAP Queue 1 item 3 (LlamaModule(mu_dtype=))",
    "ce_inline_bwd": "ROADMAP Queue 1 item 3 (the fused CE's inline "
                     "backward)",
    "trace": "ROADMAP Queue 1 item 13 (analysis/tracecheck.py as a "
             "torch.fx walk)",
}


def add_plan_parser(sub) -> None:
    from ray_lightning_tpu_torch.parallel.plan import H100_KIND

    p = sub.add_parser(
        "plan", help="pre-flight memory plan for a model x mesh x card "
                     "(no device touched)")
    p.add_argument("--preset", choices=("llama3-8b", "tiny"),
                   default="llama3-8b")
    p.add_argument("--data", type=int, default=1)
    p.add_argument("--fsdp", type=int, default=64)
    p.add_argument("--tensor", type=int, default=1)
    p.add_argument("--batch", type=int, default=64,
                   help="global batch (rows)")
    p.add_argument("--seq", type=int, default=8192)
    p.add_argument("--device-kind", default=H100_KIND,
                   help="the device's name as torch.cuda.get_device_name "
                        "spells it (or a TPU kind of the JAX table); "
                        "unknown kinds error with the known list unless "
                        "--hbm-bytes is given")
    p.add_argument("--hbm-bytes", type=int, default=None,
                   help="per-device memory override in bytes (any "
                        "--device-kind is then accepted)")
    p.add_argument("--overlap", choices=("off", "on", "serial"),
                   default="off",
                   help="charge FSDP2's prefetch buffers of this schedule")
    p.add_argument("--find-max-batch", action="store_true",
                   help="ignore --batch and report the largest per-device "
                        "batch that fits")
    p.add_argument("--ce-inline-bwd", action="store_true",
                   help="not ported (item 3)")
    p.add_argument("--mu-bf16", action="store_true",
                   help="not ported (item 3)")
    p.add_argument("--serve", action="store_true",
                   help="not ported (item 8)")
    p.add_argument("--no-trace", action="store_true",
                   help="leave out the trace section")
    p.add_argument("--json", action="store_true", dest="as_json",
                   default=argparse.SUPPRESS)


def _invalid(msg: str, as_json: bool, **extra) -> int:
    """Exit 2 with a structured error, distinguishable from the exit-1
    'does not fit' verdict."""
    if as_json:
        print(json.dumps({"error": msg, **extra}))
    else:
        print(f"error: {msg}", file=sys.stderr)
    return 2


def run_plan(args) -> int:
    from ray_lightning_tpu_torch.models.llama import LlamaConfig, LlamaModule
    from ray_lightning_tpu_torch.parallel.mesh import MeshSpec
    from ray_lightning_tpu_torch.parallel.plan import (
        dp_degree,
        find_max_local_batch,
        llama_activation_bytes,
        llama_overlap_buffer_bytes,
        plan_train_memory,
    )
    from ray_lightning_tpu_torch.parallel.strategy import ShardedMesh

    as_json = getattr(args, "as_json", False)
    for leg in ("serve", "mu_bf16", "ce_inline_bwd"):
        if getattr(args, leg):
            return _invalid(f"--{leg.replace('_', '-')} is not ported yet "
                            f"({NOT_PORTED[leg]})", as_json,
                            not_ported=NOT_PORTED[leg])
    checked = ("data", "fsdp", "tensor", "seq") if args.find_max_batch \
        else ("data", "fsdp", "tensor", "batch", "seq")
    for name in checked:
        if getattr(args, name) < 1:
            return _invalid(f"--{name} must be >= 1, got "
                            f"{getattr(args, name)}", as_json)
    presets = {"llama3-8b": LlamaConfig.llama3_8b, "tiny": LlamaConfig.tiny}
    cfg = presets[args.preset](remat=True, fused_ce=True,
                               max_seq_len=args.seq)

    def strategy():
        return ShardedMesh(data=args.data, fsdp=args.fsdp,
                           tensor=args.tensor, overlap=args.overlap)

    overlap_bytes = llama_overlap_buffer_bytes(
        cfg, fsdp=args.fsdp, tensor=args.tensor, mode=args.overlap)
    n_devices = args.data * args.fsdp * args.tensor
    dp = dp_degree(MeshSpec(data=args.data, fsdp=args.fsdp,
                            tensor=args.tensor))
    if not args.find_max_batch and args.batch % dp != 0:
        return _invalid(
            f"global batch {args.batch} is not divisible by the "
            f"data-parallel degree {dp} (data x fsdp); the job could "
            f"not shard this batch. Pick batch = k x {dp}.", as_json)
    trace = None if args.no_trace else {"not_ported": NOT_PORTED["trace"]}
    try:
        if args.find_max_batch:
            local, plan = find_max_local_batch(
                LlamaModule(cfg), strategy(), n_devices, None,
                lambda b: llama_activation_bytes(
                    cfg, b, args.seq,
                    weight_shard_degree=args.fsdp * args.tensor)
                + overlap_bytes,
                device_kind=args.device_kind,
                hbm_bytes_per_device=args.hbm_bytes)
            summary = plan.summary() if local >= 1 else (
                "no local batch fits — weights-only plan: "
                + plan.summary())
            result = {"max_local_batch": local,
                      "max_global_batch": local * dp, "dp_degree": dp,
                      "fits": local >= 1, "overlap": args.overlap,
                      "overlap_buffer_bytes": overlap_bytes,
                      "summary": summary}
            if trace is not None:
                result["trace"] = trace
            if as_json:
                print(json.dumps(result))
            else:
                print(f"max batch: {local}/device x dp {dp} = "
                      f"{local * dp} global")
                print(summary)
                _print_extra(overlap_bytes, trace)
            return 0 if local >= 1 else 1
        plan = plan_train_memory(
            LlamaModule(cfg), strategy(), n_devices, None,
            activation_bytes_per_device=llama_activation_bytes(
                cfg, args.batch // dp, args.seq,
                weight_shard_degree=args.fsdp * args.tensor)
            + overlap_bytes,
            device_kind=args.device_kind,
            hbm_bytes_per_device=args.hbm_bytes)
    except ValueError as exc:
        # a mesh the strategy rejects, a planner refusal: the same contract
        return _invalid(str(exc), as_json)
    if as_json:
        out = {"mesh": plan.mesh_axes, "n_devices": plan.n_devices,
               "per_device_bytes": plan.per_device_total,
               "budget_bytes": plan.budget, "fits": plan.fits,
               "overlap": args.overlap,
               "overlap_buffer_bytes": overlap_bytes,
               "summary": plan.summary()}
        if trace is not None:
            out["trace"] = trace
        print(json.dumps(out))
    else:
        print(plan.summary())
        _print_extra(overlap_bytes, trace)
    return 0 if plan.fits else 1


def _print_extra(overlap_bytes: int, trace) -> None:
    if overlap_bytes:
        print(f"overlap prefetch buffers: {overlap_bytes / 1024**2:.1f} "
              "MiB/device charged in the activation bound")
    if trace is not None:
        print(f"trace: not ported ({trace['not_ported']})")
