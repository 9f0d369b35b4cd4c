"""The hot loop (twin of `ray_lightning_tpu/pipeline/`): keep the card's
queue of work from running dry.

  * `DevicePrefetcher` (prefetch.py) — a bounded N-buffer stage that
    places the next batches, their copies on a side CUDA stream from
    pinned memory, while the step runs;
  * `WarmStep` and the kernel cache (compile_cache.py) — the warm start
    before the loop (``compile_time_s``) and the kernel libraries' build
    directory per plan, so a restart builds nothing;
  * overlap.py, collective_overlap.py, cli.py — the evidence: a slow
    loader hidden by the prefetcher, the FSDP all-gather schedule, and
    ``python -m ray_lightning_tpu_torch perf [--smoke]``.

Importing it imports no torch.
"""
from ray_lightning_tpu_torch._lazy import lazy_exports

__all__ = [
    "DevicePrefetcher",
    "PrefetchStats",
    "CompileStats",
    "WarmStep",
    "enable_persistent_cache",
    "plan_cache_dir",
]

__getattr__, __dir__ = lazy_exports(__name__, {
    "DevicePrefetcher": "prefetch",
    "PrefetchStats": "prefetch",
    "CompileStats": "compile_cache",
    "WarmStep": "compile_cache",
    "enable_persistent_cache": "compile_cache",
    "plan_cache_dir": "compile_cache",
})
