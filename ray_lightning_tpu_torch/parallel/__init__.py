"""Meshes and strategies (twin of `ray_lightning_tpu/parallel/`). Names
resolve on first use."""
from ray_lightning_tpu_torch._lazy import lazy_exports

_NAMES = {
    "MeshSpec": "mesh",
    "make_mesh": "mesh",
    "AXIS_ORDER": "mesh",
    **{n: "plan" for n in (
        "MemoryPlan", "find_max_local_batch", "hbm_bytes_for_kind",
        "llama_activation_bytes", "plan_train_memory")},
    **{n: "strategy" for n in (
        "Strategy", "DataParallel", "FSDP", "ShardedMesh", "SingleDevice",
        "RayXlaPlugin")},
}
_MISSING: dict = {}

__all__ = list(_NAMES)

__getattr__, __dir__ = lazy_exports(__name__, _NAMES, _MISSING)
