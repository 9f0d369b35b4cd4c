"""Serving (twin of `ray_lightning_tpu/serve/`): the block-paged KV pool,
the continuous-batching engine and its scheduler. Names resolve on
first use."""
from ray_lightning_tpu_torch._lazy import lazy_exports

_NAMES = {
    "BlockAllocator": "kv_cache",
    "PagedPoolSpec": "kv_cache",
    "init_pool": "kv_cache",
    "DecodeEngine": "engine",
    "EngineConfig": "engine",
    "Request": "scheduler",
    "Scheduler": "scheduler",
}
_MISSING = {"serve_kv_plan_bytes":
            "ROADMAP Queue 1 item 8 (serve/audit.py's HBM plan)"}

__all__ = list(_NAMES)

__getattr__, __dir__ = lazy_exports(__name__, _NAMES, _MISSING)
