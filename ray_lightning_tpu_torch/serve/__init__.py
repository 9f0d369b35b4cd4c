"""Serving (twin of `ray_lightning_tpu/serve/`): the block-paged KV pool
and its byte plan, the continuous-batching engine (speculative decoding,
tensor-parallel replicas) and its scheduler, the replica driver (inline
and process replicas, the live session), the request channel, the static
serving plan (`audit`), the paged kernels' block-size autotune (`sweep`)
and the ``serve`` CLI. Names resolve on first use."""
from ray_lightning_tpu_torch._lazy import lazy_exports

_NAMES = {
    "BlockAllocator": "kv_cache",
    "PagedPoolSpec": "kv_cache",
    "init_pool": "kv_cache",
    "serve_kv_plan_bytes": "kv_cache",
    "pool_bytes": "kv_cache",
    "validate_pool_tp": "kv_cache",
    "DecodeEngine": "engine",
    "EngineConfig": "engine",
    "DraftConfig": "engine",
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
    "serve_memory_summary": "audit",
    "speculative_plan": "audit",
    "shared_prefix_plan": "audit",
    "format_serve_summary": "audit",
    "sweep_paged_kernels": "sweep",
    "apply_autotune": "sweep",
}

__all__ = list(_NAMES)

__getattr__, __dir__ = lazy_exports(__name__, _NAMES)
