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
  costmodel.py     the H100 deployments (NVLink, InfiniBand), the ring
                   algebra and the ``rltt`` operators' FLOPs and bytes
  tracecheck.py    the real train step on fake tensors: its kernels,
                   collectives, peak memory (RLT301-303, RLT305-306)
  numcheck.py      the dtype audit of the same stream (RLT801-805) and
                   the static pass of ``lint --numerics``
  cli.py           ``python -m ray_lightning_tpu_torch lint`` and ``trace``

The linter, threadcheck and the watcher import neither torch nor numpy,
and importing this package imports nothing of its modules: each name
resolves on first use.
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
    **{n: "costmodel" for n in (
        "ICI_SPECS", "CollectiveCost", "Topology", "collective_cost",
        "parse_topology", "topology_for_kind")},
    **{n: "tracecheck" for n in (
        "CollectiveEvent", "TraceReport", "audit_step",
        "check_permutation", "trace_step", "classify_overlap")},
    **{n: "numcheck" for n in (
        "LOW_PRECISION_EXTENT", "numcheck_jaxpr",
        "check_gradient_collectives", "check_numerics_sources",
        "check_numerics_paths")},
}


__all__ = list(_NAMES)

__getattr__, __dir__ = lazy_exports(__name__, _NAMES)
