"""``python -m ray_lightning_tpu_torch plan``: the pre-flight memory plan
of a Llama training job (twin of the JAX CLI's ``plan``).

    python -m ray_lightning_tpu_torch plan --preset llama3-8b --fsdp 8 \\
        --tensor 2 --batch 16 --seq 8192 [--json]
    python -m ray_lightning_tpu_torch plan --preset llama3-8b --fsdp 1 \\
        --seq 2048 --find-max-batch

The model is built on the meta device under `ShardedMesh(data, fsdp,
tensor)` over a shape-only mesh: nothing touches a card or a process
group. Exit status: 0 fits, 1 does not, 2 an invalid configuration (a
structured error). ``--serve`` plans a SERVING replica instead
(`serve/audit.py`: weights, the paged pool, the attention lanes'
gathered view and the carried logits against the card's memory, with
the prefix-sharing and speculative pricing), one rank of it with
``--tp N``::

    python -m ray_lightning_tpu_torch plan --serve --preset llama3-8b \\
        --seq 4096 --serve-slots 4 [--serve-block-size 16] [--tp 2]

``--mu-bf16`` plans the bf16 first moment (`core.optim.MuAdamW`),
``--ce-inline-bwd`` the fused CE's inline backward and its residuals,
``--remat-policy`` the blocks' checkpoint policy (a port option: the JAX
CLI plans "nothing"). The trace section runs tracecheck on the planned
step (`analysis.tracecheck.audit_step`: rank 0 of the planned mesh on
fake tensors; ``--no-trace`` skips it): the plan's byte math says
whether the weights fit, the trace what the step will do — its
collectives' NVLink bytes and its peak. ``plan --serve`` traces the
replica's decode step (`serve.audit.audit_decode_step`). A failing
audit degrades to a ``trace_error`` field; the plan's verdict stands.
"""
from __future__ import annotations

import argparse
import json
import sys

def _trace_section(args, module_factory, strategy_factory,
                   n_devices: int, global_batch: int) -> dict:
    """tracecheck of the planned step, as the JAX CLI's section reads."""
    import numpy as np

    try:
        from ray_lightning_tpu_torch.analysis.costmodel import (
            topology_for_kind,
        )
        from ray_lightning_tpu_torch.analysis.tracecheck import audit_step

        topo = topology_for_kind(args.device_kind, n_devices,
                                 hbm_bytes=args.hbm_bytes)
        report = audit_step(
            module_factory(), strategy_factory(),
            {"tokens": np.zeros((global_batch, args.seq + 1), np.int64)},
            topology=topo, label=f"{args.preset} plan")
        return _report_section(report)
    except Exception as exc:  # noqa: BLE001 — an advisory section
        return {"trace_error": f"{type(exc).__name__}: {str(exc)[:300]}"}


def _report_section(report) -> dict:
    counts = {"error": 0, "warning": 0, "note": 0}
    for f in report.findings:
        counts[f.severity] += 1
    return {
        "ici_bytes_per_step": report.ici_bytes_per_step,
        "ici_time_us": round(report.ici_time_us, 1),
        "ici_hidden_us": round(report.ici_hidden_us, 1),
        "ici_exposed_us": round(report.ici_exposed_us, 1),
        "overlap_hidden_fraction": round(report.overlap_hidden_fraction,
                                         4),
        "overlap_scheduled": bool((report.overlap or {}).get("scheduled")),
        "kernels": dict(report.kernels),
        "peak_hbm_bytes": report.peak_hbm_bytes,
        "hbm_budget_bytes": report.hbm_budget_bytes,
        "fits": report.fits,
        "finding_counts": counts,
        "findings": [f.to_dict() for f in report.findings],
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
                   help="the fused CE's inline backward: charge its "
                        "dx and f32 dW residuals")
    p.add_argument("--mu-bf16", action="store_true",
                   help="Adam's first moment in bf16 (LlamaModule("
                        "mu_dtype=torch.bfloat16))")
    p.add_argument("--remat-policy", choices=("nothing", "dots", "attn_out"),
                   default="nothing",
                   help="the blocks' checkpoint policy ('attn_out' charges "
                        "its saved attention residuals)")
    p.add_argument("--serve", action="store_true",
                   help="plan a SERVING replica instead of a training "
                        "step: weights + paged KV pool + gathered view "
                        "vs the card's memory")
    p.add_argument("--serve-slots", type=int, default=8,
                   help="serving slot capacity (plan --serve)")
    p.add_argument("--serve-block-size", type=int, default=16,
                   help="KV pool block size in tokens (plan --serve)")
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel degree of ONE serving replica "
                        "(plan --serve): prices one rank of it")
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
    import torch

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
    if args.serve:
        return _run_serve_plan(args, as_json)
    checked = ("data", "fsdp", "tensor", "seq") if args.find_max_batch \
        else ("data", "fsdp", "tensor", "batch", "seq")
    for name in checked:
        if getattr(args, name) < 1:
            return _invalid(f"--{name} must be >= 1, got "
                            f"{getattr(args, name)}", as_json)
    presets = {"llama3-8b": LlamaConfig.llama3_8b, "tiny": LlamaConfig.tiny}
    cfg = presets[args.preset](remat=True, fused_ce=True,
                               max_seq_len=args.seq,
                               ce_inline_bwd=args.ce_inline_bwd,
                               remat_policy=args.remat_policy)
    mu_dtype = torch.bfloat16 if args.mu_bf16 else None

    def module():
        return LlamaModule(cfg, mu_dtype=mu_dtype)

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
    trace = None
    try:
        if args.find_max_batch:
            local, plan = find_max_local_batch(
                module(), strategy(), n_devices, None,
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
            if local >= 1 and not args.no_trace:
                trace = result["trace"] = _trace_section(
                    args, module, strategy, n_devices, local * dp)
            if as_json:
                print(json.dumps(result))
            else:
                print(f"max batch: {local}/device x dp {dp} = "
                      f"{local * dp} global")
                print(summary)
                _print_extra(overlap_bytes, trace)
            return 0 if local >= 1 else 1
        plan = plan_train_memory(
            module(), strategy(), n_devices, None,
            activation_bytes_per_device=llama_activation_bytes(
                cfg, args.batch // dp, args.seq,
                weight_shard_degree=args.fsdp * args.tensor)
            + overlap_bytes,
            device_kind=args.device_kind,
            hbm_bytes_per_device=args.hbm_bytes)
    except ValueError as exc:
        # a mesh the strategy rejects, a planner refusal: the same contract
        return _invalid(str(exc), as_json)
    if not args.no_trace:
        trace = _trace_section(args, module, strategy, n_devices,
                               args.batch)
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
    if trace is None:
        return
    if "trace_error" in trace:
        print(f"tracecheck: unavailable ({trace['trace_error']})")
        return
    gib = 1024**3
    if "ici_bytes_per_step" in trace:
        print(f"tracecheck: NVLink {trace['ici_bytes_per_step'] / gib:.2f} "
              f"GiB/step (~{trace['ici_time_us'] / 1e3:.1f} ms "
              "serialized), ", end="")
    else:
        print(f"tracecheck ({trace.get('attention_path')}): ", end="")
    print(f"est. peak {trace['peak_hbm_bytes'] / gib:.2f} GiB vs budget "
          f"{trace['hbm_budget_bytes'] / gib:.2f} GiB "
          f"({'fits' if trace['fits'] else 'DOES NOT FIT'})")
    if trace.get("kernels"):
        print("  kernels: " + ", ".join(
            f"{k} x{n}" for k, n in trace["kernels"].items()))
    for f in trace["findings"]:
        print(f"  {f['severity']} {f['rule']} ({f['name']}): "
              f"{f['message']}")


def _run_serve_plan(args, as_json: bool) -> int:
    """``plan --serve``: a serving replica's bytes (no optimizer) with the
    prefix-sharing and speculative pricing of the same configuration
    (every slot sharing a prefix; a quarter-depth draft at the default
    k). The exit contract is the training plan's."""
    import dataclasses

    import torch

    from ray_lightning_tpu_torch.models.llama import LlamaConfig
    from ray_lightning_tpu_torch.serve.audit import (
        format_serve_summary,
        serve_memory_summary,
        shared_prefix_plan,
        speculative_plan,
    )
    from ray_lightning_tpu_torch.serve.engine import EngineConfig

    for name in ("serve_slots", "serve_block_size", "tp", "seq"):
        if getattr(args, name) < 1:
            return _invalid(f"--{name.replace('_', '-')} must be >= 1, "
                            f"got {getattr(args, name)}", as_json)
    presets = {"llama3-8b": LlamaConfig.llama3_8b, "tiny": LlamaConfig.tiny}
    cfg = presets[args.preset](max_seq_len=args.seq, dtype=torch.bfloat16)
    try:
        ecfg = EngineConfig(
            capacity=args.serve_slots, block_size=args.serve_block_size,
            blocks_per_slot=-(-args.seq // args.serve_block_size),
            prefill_chunk=min(max(128, args.serve_block_size), args.seq))
        summary = serve_memory_summary(
            cfg, ecfg, device_kind=args.device_kind,
            hbm_bytes=args.hbm_bytes, tp=args.tp)
        draft_cfg = dataclasses.replace(
            cfg, n_layers=max(1, cfg.n_layers // 4))
        prefix = shared_prefix_plan(cfg, ecfg, n_streams=args.serve_slots)
        spec = speculative_plan(cfg, draft_cfg, ecfg)
    except ValueError as exc:
        return _invalid(str(exc), as_json)
    trace = None
    if not args.no_trace:
        try:
            from ray_lightning_tpu_torch.analysis.costmodel import (
                topology_for_kind,
            )
            from ray_lightning_tpu_torch.serve.audit import (
                audit_decode_step,
            )

            topo = topology_for_kind(args.device_kind, args.tp,
                                     hbm_bytes=args.hbm_bytes)
            fused = summary["attention_path"] == "paged-kernel"
            report = audit_decode_step(cfg, ecfg, topology=topo,
                                       label=f"{args.preset} serve",
                                       fused=fused, tp=args.tp)
            trace = {"attention_path": summary["attention_path"],
                     **_report_section(report)}
        except Exception as exc:  # noqa: BLE001 — an advisory section
            trace = {"trace_error":
                     f"{type(exc).__name__}: {str(exc)[:300]}"}
    if as_json:
        out = {"serve": summary, "fits": summary["fits"],
               "prefix_sharing": prefix, "speculative": spec}
        if trace is not None:
            out["trace"] = trace
        print(json.dumps(out))
    else:
        mib = 1024.0**2
        print(format_serve_summary(summary))
        print(f"prefix sharing ({prefix['n_streams']} streams, "
              f"{prefix['prefix_tokens']}-token prefix): pool bytes saved "
              f"{prefix['shared_pool_bytes_saved'] / mib:.1f} MiB; prefill "
              f"tokens saved {prefix['prefill_tokens_saved']}")
        print(f"speculative (k={spec['k']}, accept "
              f"{spec['accept_rate']:.2f}): verify step "
              f"{spec['verify_step_flops'] / 1e9:.2f} GFLOP vs {spec['k']} "
              f"base ticks "
              f"{spec['k'] * spec['base_decode_flops_per_token'] / 1e9:.2f}"
              f" GFLOP; expected tokens/tick "
              f"{spec['expected_tokens_per_tick']:.2f}; memory-bound "
              f"speedup {spec['memory_bound_speedup_x']:.2f}x")
        _print_extra(0, trace)
    return 0 if summary["fits"] else 1
