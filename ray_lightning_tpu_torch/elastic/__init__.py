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

The JAX package's third leg (DCN-aware multi-slice planning) lives in
its analysis layer's graph walks, which come with ROADMAP Queue 1 item
13 (f). Names
resolve on first use.
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
