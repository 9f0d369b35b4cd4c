"""Serving (twin of `ray_lightning_tpu/serve/`): the block-paged KV pool,
the continuous-batching engine and its scheduler, the replica driver
(inline and process replicas, the live session), the request channel and
the ``serve`` CLI. Names resolve on first use."""
from ray_lightning_tpu_torch._lazy import lazy_exports

_NAMES = {
    "BlockAllocator": "kv_cache",
    "PagedPoolSpec": "kv_cache",
    "init_pool": "kv_cache",
    "DecodeEngine": "engine",
    "EngineConfig": "engine",
    "Request": "scheduler",
    "Scheduler": "scheduler",
    "ServeDriver": "driver",
    "ReplicaGroupConfig": "driver",
    "ServeResult": "driver",
    "save_params_npz": "driver",
    "load_params_npz": "driver",
    "aggregate_serve_metrics": "driver",
    "load_signal": "driver",
    "ChannelWriter": "channel",
    "ChannelReader": "channel",
    "CursorWriter": "channel",
    "CursorReader": "channel",
    "request_to_wire": "channel",
    "request_from_wire": "channel",
}
_MISSING = {"serve_kv_plan_bytes":
            "ROADMAP Queue 1 item 8 (serve/audit.py's HBM plan)"}

__all__ = list(_NAMES)

__getattr__, __dir__ = lazy_exports(__name__, _NAMES, _MISSING)
