"""``python -m ray_lightning_tpu_torch lint`` and ``trace`` — the linter,
threadcheck and numcheck's static pass, and tracecheck, on the command
line (twin of the JAX package's `ray_lightning_tpu/analysis/cli.py`).

Zero hardware, no JAX: it runs anywhere Python runs. Targets are files,
directories (recursed), or importable dotted module names (resolved to
their source, never executed beyond the import machinery's
parent-package resolution). With no target it lints the port package,
threadcheck on.

Exit status: 0 clean (no finding at/above --fail-on), 1 findings at or
above the gate, 2 invalid invocation (missing path, unresolvable
module). With --json the report is ONE machine-readable JSON object.

``--list-rules`` prints every rule of the registry; a rule the port does
not flag carries its reason. ``--numerics`` adds numcheck's static pass
(on for the package self-lint).

``trace <target> [--topo h100-8]`` runs tracecheck (and numcheck over the
same stream) on a bundled example, the ``llama3-8b`` preset or a
``pkg.mod:factory``: the real train step on fake tensors, rank 0 of the
named deployment; exit 0 clean, 1 findings at the gate, 2 invalid.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

from ray_lightning_tpu_torch.analysis.findings import (
    RULES, SEVERITY_RANK, Finding, meets,
)
from ray_lightning_tpu_torch.analysis.linter import (
    iter_python_files, lint_paths,
)

#: the port package, the default target
PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def add_lint_parser(sub) -> None:
    """Attach the `lint` subparser (argparse) to `sub`."""
    p = sub.add_parser(
        "lint",
        help="static-analyze modules for sharding-plan, step-code and "
             "host-concurrency antipatterns (no card, no target imports)")
    p.add_argument(
        "targets", nargs="*", default=None,
        help="files, directories, or dotted module names (default: the "
             "ray_lightning_tpu_torch package)")
    p.add_argument(
        "--severity", choices=("note", "warning", "error"), default="note",
        help="minimum severity to report (default: note — everything)")
    p.add_argument(
        "--fail-on", choices=("note", "warning", "error"), default="error",
        help="exit 1 when any finding is at/above this severity "
             "(default: error)")
    p.add_argument(
        "--disable", default="",
        help="comma-separated rule ids to drop entirely (e.g. RLT204)")
    p.add_argument("--list-rules", action="store_true",
                   help="print the rule table and exit")
    p.add_argument(
        "--concurrency", action="store_true", dest="concurrency",
        default=None,
        help="also run threadcheck (RLT701-705: races, lock-order "
             "cycles, thread leaks, signal/lock hygiene). Default: on "
             "when linting the package (self-lint), off for explicit "
             "targets")
    p.add_argument(
        "--no-concurrency", action="store_false", dest="concurrency",
        help="skip threadcheck even on a package self-lint")
    p.add_argument(
        "--numerics", action="store_true", dest="numerics", default=None,
        help="also run numcheck's static pass (RLT801/805: operands cast "
             "inline to bf16 or int8 in matmul/linear/einsum calls). "
             "Default: on for the package self-lint, off for explicit "
             "targets; the full dtype audit lives in `trace`")
    p.add_argument(
        "--no-numerics", action="store_false", dest="numerics",
        help="skip the static numerics pass even on a package self-lint")
    # a plain default would clobber a `--json` given before the subcommand
    p.add_argument("--json", action="store_true", dest="as_json",
                   default=argparse.SUPPRESS)


def _resolve_target(target: str) -> Optional[str]:
    """A path stays a path; a dotted name resolves to its source file
    (or package directory)."""
    if os.path.exists(target):
        return target
    if os.sep in target or target.endswith(".py"):
        return None
    import importlib.util

    try:
        spec = importlib.util.find_spec(target)
    except (ImportError, ValueError):
        return None
    if spec is None:
        return None
    if spec.submodule_search_locations:
        return list(spec.submodule_search_locations)[0]
    return spec.origin


def list_rules(as_json: bool) -> None:
    if as_json:
        print(json.dumps({rid: {
            "name": r.name, "severity": r.severity, "summary": r.summary,
            "not_flagged": r.not_flagged}
            for rid, r in sorted(RULES.items())}))
        return
    for rid, r in sorted(RULES.items()):
        tail = f" [{r.not_flagged}]" if r.not_flagged else ""
        print(f"{rid}  {r.severity:<8} {r.name}: {r.summary}{tail}")


def run_lint(args) -> int:
    as_json = getattr(args, "as_json", False)
    if args.list_rules:
        list_rules(as_json)
        return 0

    resolved: List[str] = []
    for t in args.targets or [PACKAGE_DIR]:
        r = _resolve_target(t)
        if r is None:
            msg = (f"no such file, directory, or importable module: "
                   f"{t!r}")
            if as_json:
                print(json.dumps({"error": msg}))
            else:
                print(f"error: {msg}", file=sys.stderr)
            return 2
        resolved.append(r)

    # threadcheck rides along: default-on for the package self-lint (no
    # explicit targets), opt-in/out via --concurrency/--no-concurrency
    concurrency = getattr(args, "concurrency", None)
    if concurrency is None:
        concurrency = not args.targets
    # expand the tree ONCE: lint_paths on plain file paths does no walk,
    # so the count and the linted set cannot disagree
    files = iter_python_files(resolved)
    found: List[Finding] = list(lint_paths(files))
    if concurrency:
        from ray_lightning_tpu_torch.analysis.concurrency import (
            check_concurrency_paths,
        )

        found += check_concurrency_paths(files)
    numerics = getattr(args, "numerics", None)
    if numerics is None:
        numerics = not args.targets
    if numerics:
        from ray_lightning_tpu_torch.analysis.numcheck import (
            check_numerics_paths,
        )

        found += check_numerics_paths(files)
    disabled = {r.strip() for r in args.disable.split(",") if r.strip()}
    min_rank = SEVERITY_RANK[args.severity]
    findings = sorted(
        (f for f in found if f.rule not in disabled
         and SEVERITY_RANK[f.severity] >= min_rank),
        key=lambda f: (f.file or "", f.line or 0, f.rule))
    counts = {"error": 0, "warning": 0, "note": 0}
    for f in findings:
        counts[f.severity] += 1
    gate_hit = meets(findings, args.fail_on)
    if as_json:
        print(json.dumps({
            "ok": not gate_hit,
            "files": len(files),
            "fail_on": args.fail_on,
            "counts": counts,
            "findings": [f.to_dict() for f in findings],
        }))
    else:
        for f in findings:
            print(f.format())
        total = sum(counts.values())
        print(f"checked {len(files)} file(s): {total} finding(s) "
              f"({counts['error']} error, {counts['warning']} warning, "
              f"{counts['note']} note)"
              + ("" if not gate_hit else
                 f" — failing (gate: {args.fail_on})"))
    return 1 if gate_hit else 0


# --------------------------------------------------------------------------
# trace — the tracecheck CLI
# --------------------------------------------------------------------------
#
# Every bundled example has a builder that reconstructs its (module,
# strategy, global batch) SIZED FOR THE TOPOLOGY, so `trace
# llama_fsdp_example.py --topo h100-8` audits the step the example would
# run there, without running the example.


def _build_llama_fsdp(topo, overlap: str = "off"):
    import numpy as np

    from ray_lightning_tpu_torch.models.llama import LlamaConfig, LlamaModule
    from ray_lightning_tpu_torch.parallel.strategy import ShardedMesh

    n = topo.n_devices
    # multi-node: HSDP, the `data` axis across nodes, fsdp inside one
    data = getattr(topo, "n_slices", 1)
    fsdp = n // data
    if n >= 8:
        # the flagship: Llama-3-8B at its full 32 layers, the fused CE
        # and the flash kernels, one 8192-token row a GPU
        cfg = LlamaConfig.llama3_8b(max_seq_len=8192, fused_ce=True)
        batch, seq = n, 8192
        label = (f"llama3-8b HSDP(data={data},fsdp={fsdp})" if data > 1
                 else f"llama3-8b FSDP({n})")
    else:
        cfg = LlamaConfig.tiny()
        batch, seq = 2 * n, min(256, cfg.max_seq_len)
        label = (f"llama-tiny HSDP(data={data},fsdp={fsdp})" if data > 1
                 else f"llama-tiny FSDP({n})")
    if overlap != "off":
        label += f" overlap={overlap}"
    return (LlamaModule(cfg),
            ShardedMesh(data=data, fsdp=fsdp, overlap=overlap, device="cpu"),
            {"tokens": np.zeros((batch, seq + 1), np.int64)}, label)


def _build_llama_fsdp_across(topo, overlap: str = "off"):
    """The flagship with fsdp spanning every node (the layout RLT306
    flags on a multi-node topology)."""
    module, _, batch, label = _build_llama_fsdp(topo, overlap)
    from ray_lightning_tpu_torch.parallel.strategy import ShardedMesh

    n = topo.n_devices
    return (module, ShardedMesh(fsdp=n, overlap=overlap, device="cpu"),
            batch, label.split(" ")[0] + f" FSDP({n}) across nodes")


def _build_mlp(features, num_classes, in_dim, label):
    def build(topo):
        import numpy as np

        from ray_lightning_tpu_torch.models.mlp import MLPClassifier
        from ray_lightning_tpu_torch.parallel.strategy import DataParallel

        n = topo.n_devices
        B = 8 * n
        return (MLPClassifier(features=features, num_classes=num_classes,
                              in_features=in_dim),
                DataParallel(device="cpu"),
                {"x": np.zeros((B, in_dim), np.float32),
                 "y": np.zeros((B,), np.int64)},
                f"{label} DataParallel({n})")
    return build


def _build_cifar_resnet(topo):
    import numpy as np

    from ray_lightning_tpu_torch.models.resnet import ResNetModule
    from ray_lightning_tpu_torch.parallel.strategy import DataParallel

    n = topo.n_devices
    B = 8 * n
    return (ResNetModule(variant="resnet18", num_classes=10),
            DataParallel(device="cpu"),
            {"x": np.zeros((B, 32, 32, 3), np.float32),
             "y": np.zeros((B,), np.int64)},
            f"resnet18 DataParallel({n})")


def _build_bert_finetune(topo):
    import numpy as np

    from ray_lightning_tpu_torch.models.bert import (
        BertClassifierModule,
        BertConfig,
    )
    from ray_lightning_tpu_torch.parallel.strategy import DataParallel

    n = topo.n_devices
    B, S = 4 * n, 128
    return (BertClassifierModule(BertConfig.tiny(dropout=0.0),
                                 num_classes=2),
            DataParallel(device="cpu"),
            {"input_ids": np.zeros((B, S), np.int64),
             "labels": np.zeros((B,), np.int64)},
            f"bert-tiny DataParallel({n})")


TRACE_BUILDERS = {
    "llama_fsdp_example.py": _build_llama_fsdp,
    "llama3-8b": _build_llama_fsdp,
    "llama3-8b-fsdp-across": _build_llama_fsdp_across,
    "mnist_dp_example.py": _build_mlp((128, 256), 10, 784, "mnist-mlp"),
    "mnist_sweep_example.py": _build_mlp((128, 256), 10, 784,
                                         "mnist-sweep-mlp"),
    "pod_launch_example.py": _build_mlp((64,), 4, 16, "pod-mlp"),
    "cifar_resnet_example.py": _build_cifar_resnet,
    "bert_finetune_example.py": _build_bert_finetune,
}


def add_trace_parser(sub) -> None:
    """Attach the `trace` subparser (argparse) to `sub`."""
    p = sub.add_parser(
        "trace",
        help="audit a strategy's real train step on fake tensors: the "
             "kernels it runs, its collectives and their NVLink cost, "
             "the peak memory, the dtype rules (no card)")
    p.add_argument(
        "target",
        help="a bundled example (llama_fsdp_example.py), the 'llama3-8b' "
             "preset, or pkg.mod:factory returning (module, strategy, "
             "example_batch)")
    p.add_argument(
        "--topo", default="h100-8",
        help="the deployment: h100-<n> (one node, n <= 8), <k>xh100-8 (k "
             "nodes over InfiniBand; the trace then itemizes the "
             "inter-node bytes) or cpu-<n>")
    p.add_argument(
        "--overlap", choices=("off", "on", "serial"), default="off",
        help="trace the llama targets under the strategy's FSDP overlap "
             "schedule; tracecheck classifies each collective hidden or "
             "exposed against the prefetches it finds in the stream")
    p.add_argument("--hbm-bytes", type=int, default=None,
                   help="per-device usable memory override in bytes")
    p.add_argument("--severity", choices=("note", "warning", "error"),
                   default="note", help="minimum severity to report")
    p.add_argument(
        "--fail-on", choices=("note", "warning", "error"), default="error",
        help="exit 1 when any finding is at/above this severity")
    p.add_argument("--disable", default="",
                   help="comma-separated rule ids to drop (e.g. RLT302)")
    p.add_argument(
        "--numerics", action="store_true", dest="numerics", default=True,
        help="run numcheck over the traced stream (RLT801-805) and report "
             "the precision ledger (default: on)")
    p.add_argument("--no-numerics", action="store_false", dest="numerics",
                   help="skip the numerics pass and the precision ledger")
    p.add_argument("--json", action="store_true", dest="as_json",
                   default=argparse.SUPPRESS)


def resolve_trace_target(target: str, topo, overlap: str = "off"):
    """``(module, strategy, batch, label)`` for a trace target, or None
    when the target is not recognisable (the exit-2 path)."""
    import inspect

    builder = (TRACE_BUILDERS.get(os.path.basename(target))
               or TRACE_BUILDERS.get(target))
    if builder is not None:
        if "overlap" in inspect.signature(builder).parameters:
            return builder(topo, overlap=overlap)
        return builder(topo)
    if ":" in target and os.sep not in target:
        import importlib

        mod_name, _, fn_name = target.partition(":")
        try:
            factory = getattr(importlib.import_module(mod_name), fn_name)
        except (ImportError, AttributeError):
            return None
        built = factory()
        if isinstance(built, dict):
            return (built["module"], built["strategy"], built["batch"],
                    built.get("label", target))
        module, strategy, batch = built[:3]
        return module, strategy, batch, (built[3] if len(built) > 3
                                         else target)
    return None


def run_trace(args) -> int:
    as_json = getattr(args, "as_json", False)
    from ray_lightning_tpu_torch.analysis.costmodel import parse_topology
    from ray_lightning_tpu_torch.analysis.tracecheck import audit_step

    def invalid(msg: str) -> int:
        if as_json:
            print(json.dumps({"error": msg}))
        else:
            print(f"error: {msg}", file=sys.stderr)
        return 2

    try:
        topo = parse_topology(args.topo, hbm_bytes=args.hbm_bytes)
    except ValueError as exc:
        return invalid(str(exc))
    try:
        built = resolve_trace_target(args.target, topo,
                                     overlap=getattr(args, "overlap", "off"))
    except Exception as exc:  # noqa: BLE001 — a factory that raises is
        # an invalid invocation, not a finding
        return invalid(f"building {args.target!r} failed: "
                       f"{type(exc).__name__}: {exc}")
    if built is None:
        return invalid(
            f"unknown trace target {args.target!r}; use a bundled example "
            f"({sorted(k for k in TRACE_BUILDERS if k.endswith('.py'))}), "
            "the 'llama3-8b' preset, or pkg.mod:factory")
    module, strategy, batch, label = built
    report = audit_step(module, strategy, batch, topology=topo, label=label,
                        numerics=getattr(args, "numerics", True))
    disabled = {r.strip() for r in args.disable.split(",") if r.strip()}
    min_rank = SEVERITY_RANK[args.severity]
    report.findings = [f for f in report.findings
                       if f.rule not in disabled
                       and SEVERITY_RANK[f.severity] >= min_rank]
    gate_hit = meets(report.findings, args.fail_on)
    if as_json:
        print(json.dumps({"ok": not gate_hit, "fail_on": args.fail_on,
                          **report.to_dict()}))
    else:
        print(report.summary())
        if gate_hit:
            print(f"— failing (gate: {args.fail_on})")
    return 1 if gate_hit else 0
