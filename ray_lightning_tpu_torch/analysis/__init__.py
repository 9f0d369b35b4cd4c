"""The analysis layer (twin of `ray_lightning_tpu/analysis/`): zero-hardware
checks that a job is well-formed before it spends card time, and the
runtime lock-order watcher.

  findings.py      the rule registry (the JAX package's, row for row) and
                   the one `Finding` type every engine reports
  linter.py        an AST pass over source files for the torch idioms
                   that cost a device sync a step, irreproducible draws,
                   NaN gradients, dropped requests (RLT1xx-6xx)
  concurrency.py   threadcheck: races, lock-order cycles, thread leaks,
                   signal and lock hygiene on the host (RLT701-705)
  lockwatch.py     `san_lock`, the named lock every long-lived lock of
                   the port is; under ``RLT_LOCKWATCH=1`` it reports a
                   lock-order cycle (RLT702) and a lock held too long
                   (RLT705) at run time
  plan_checker.py  a module's sharding plan and optimizer-state dtypes,
                   on the meta device over a shape-only mesh
                   (RLT101-105, RLT107)
  cli.py           ``python -m ray_lightning_tpu_torch lint``

The linter, threadcheck and the watcher import neither torch nor numpy,
and importing this package imports nothing of its modules: each name
resolves on first use. tracecheck, numcheck and the cost model (the
graph walks of the train step, and the ``trace`` CLI) are not ported
yet: their names raise `NotPortedError` naming ROADMAP Queue 1 item 13
(f).
"""
from ray_lightning_tpu_torch._lazy import lazy_exports

_NAMES = {
    **{n: "findings" for n in (
        "RULES", "SEVERITY_RANK", "Finding", "Rule", "max_severity",
        "meets")},
    **{n: "linter" for n in (
        "KNOWN_MESH_AXES", "TRACED_STEP_HOOKS", "lint_paths",
        "lint_source")},
    **{n: "plan_checker" for n in (
        "check_donation", "check_opt_state_dtypes", "check_param_specs",
        "check_plan", "spec_findings")},
}

_ITEM_13F = ("its engine (tracecheck, numcheck or the cost model: a graph "
             "walk of the train step) waits for ROADMAP Queue 1 item 13 (f)")

#: the JAX analysis names the port does not have yet
_MISSING = {n: _ITEM_13F for n in (
    # costmodel
    "ICI_SPECS", "CollectiveCost", "Topology", "collective_cost",
    "parse_topology", "topology_for_kind",
    # tracecheck
    "CollectiveEvent", "TraceReport", "audit_step", "check_permutation",
    "trace_step", "classify_overlap",
    # numcheck
    "LOW_PRECISION_EXTENT", "numcheck_jaxpr", "check_gradient_collectives",
    "check_numerics_sources", "check_numerics_paths")}

__all__ = list(_NAMES)

__getattr__, __dir__ = lazy_exports(__name__, _NAMES, _MISSING)
