"""elastic/ (twin of `ray_lightning_tpu/elastic/`): cross-topology
checkpoint resharding and elastic supervision budgets, on one
topology-change vocabulary.

  reshard   `reshard_restore` — restore any provenance-stamped
            checkpoint onto any target layout (mesh-to-mesh moves,
            world-size changes) through DCP; the Trainer stamps
            provenance into every checkpoint and validates cross-mesh
            resumes (`Trainer._restore`), recorded as a `reshard` span.
  budget    `ElasticBudget` — the supervisor's world-size ladder: legal
            survivor sizes (divisibility through the plan checker's own
            `MeshSpec.resolve` and `dp_degree`), shrink on lost capacity
            instead of dying, grow back when capacity returns, honest
            batch replanning.

  second tier  the network between nodes lives in the cost model
            (`analysis.costmodel.parse_topology("2xh100-8")`: two nodes
            over InfiniBand); tracecheck itemizes NVLink and InfiniBand
            bytes a step, and RLT306 flags a mesh axis other than
            ``data`` that crosses nodes.

Names resolve on first use.
"""
from ray_lightning_tpu_torch._lazy import lazy_exports

_NAMES = {
    "ElasticBudget": "budget",
    **{n: "reshard" for n in (
        "ReshardError", "checkpoint_provenance", "reshard_arrays",
        "reshard_restore", "validate_reshard")},
}

__all__ = sorted(_NAMES)

__getattr__, __dir__ = lazy_exports(__name__, _NAMES)
