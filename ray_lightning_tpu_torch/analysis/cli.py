"""``python -m ray_lightning_tpu_torch lint`` — the linter and threadcheck on
the command line (twin of the JAX package's `lint`,
`ray_lightning_tpu/analysis/cli.py`).

Zero hardware, no JAX: it runs anywhere Python runs. Targets are files,
directories (recursed), or importable dotted module names (resolved to
their source, never executed beyond the import machinery's
parent-package resolution). With no target it lints the port package,
threadcheck on.

Exit status: 0 clean (no finding at/above --fail-on), 1 findings at or
above the gate, 2 invalid invocation (missing path, unresolvable
module). With --json the report is ONE machine-readable JSON object.

``--list-rules`` prints every rule of the registry; a rule the port does
not flag carries its reason.

``trace`` (tracecheck) and ``--numerics`` (numcheck's static pass) wait
for ROADMAP Queue 1 item 13 (f).
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
