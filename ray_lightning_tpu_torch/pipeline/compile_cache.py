"""Warm start and the persistent kernel cache (twin of
`ray_lightning_tpu/pipeline/compile_cache.py`).

Two costs hide in "the first step is slow". In the JAX package they are
the jit's trace and XLA compile, and their repeat on every restart. The
port runs eagerly and compiles no step program, but a fresh process's
first step still pays one-time costs: CUDA's lazy loading, cuBLAS setup,
building or loading the hand-written kernels' libraries, and the caching
allocator's growth to the step's working set.

`WarmStep` is the eager analog of the JAX AOT warm start: ``warm(batch)``
runs the caller's warm-up (the trainer's: one forward and backward of
the example batch through the same dispatch policy, its gradients
dropped) under a ``compile`` span, before the loop, and records
`CompileStats`. So the one-time cost is paid, timed and reported
(``compile_time_s``, split into ``compile_build_s``, the kernel
libraries' build and load, and ``compile_warm_s``, the rest) and lands
in the goodput ledger's ``compile_s`` instead of the first step's
productive time.

Differences from the JAX package, by design:

  * a warm-up that fails raises: there is no lazy path to fall back to
    that would not fail the same way;
  * a batch of another shape than the warm-up's needs nothing: no
    program was compiled for the warm-up's shapes, so the step just runs.

`enable_persistent_cache` points the kernel build directory
(`ops/build.py`, where each nvcc-built library is keyed by a digest of
its sources and flags) at a directory of the caller's: process-global,
the last caller wins, as in JAX. A restart that finds its libraries
there builds nothing (``compile_build_s`` near 0). `plan_cache_dir`
gives each plan its own directory under a base.
"""
from __future__ import annotations

import dataclasses
import hashlib
import logging
import os
import time
from typing import Any, Callable, Optional

log = logging.getLogger(__name__)


@dataclasses.dataclass
class CompileStats:
    """Wall-clock breakdown of one warm start."""

    build_s: float = 0.0    # kernel libraries built or loaded
    warm_s: float = 0.0     # the rest of the warm-up's one-time cost
    total_s: float = 0.0
    warmed: bool = False    # a warm-up ran to its end
    cache_dir: Optional[str] = None  # the kernel build directory used

    def to_metrics(self, prefix: str = "") -> dict:
        return {
            f"{prefix}compile_time_s": self.total_s,
            f"{prefix}compile_build_s": self.build_s,
            f"{prefix}compile_warm_s": self.warm_s,
        }


def enable_persistent_cache(cache_dir: str) -> str:
    """Build and load the kernel libraries in ``cache_dir`` (created if
    needed) from now on; returns the absolute directory. Process-global:
    the last caller wins."""
    from ray_lightning_tpu_torch.ops import build

    cache_dir = os.path.abspath(cache_dir)
    os.makedirs(cache_dir, exist_ok=True)
    build.set_build_dir(cache_dir)
    return cache_dir


def active_cache_dir() -> str:
    """The kernel build directory in effect."""
    from ray_lightning_tpu_torch.ops import build

    return build.BUILD


def plan_cache_key(*parts: Any) -> str:
    """Stable short hash over plan-identifying parts (the JAX function):
    the same key, the same cache directory."""
    blob = "|".join(str(p) for p in parts)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def plan_cache_dir(base_dir: str, *parts: Any) -> str:
    """``<base_dir>/<plan_cache_key(parts)>``: one cache dir per plan."""
    return os.path.join(os.path.abspath(base_dir), plan_cache_key(*parts))


class WarmStep:
    """A step with an explicit warm start.

    Calls run ``step``; ``warm(*example_args)`` runs ``warm_up`` (by
    default ``step`` itself) once under a ``compile`` span and returns
    its `CompileStats`. A warm-up that raises fails the caller.
    """

    def __init__(self, step: Callable, warm_up: Optional[Callable] = None,
                 label: str = "step", recorder: Any = None):
        from ray_lightning_tpu_torch.telemetry.spans import NULL_RECORDER

        self._step = step
        self._warm_up = warm_up or step
        self._label = label
        #: the telemetry recorder: warm() runs under a "compile" span, so
        #: the goodput ledger books it as compile_s and the heartbeat
        #: names the phase while it runs
        self._recorder = recorder or NULL_RECORDER
        self.stats = CompileStats()

    def warm(self, *example_args: Any) -> CompileStats:
        from ray_lightning_tpu_torch.ops import build
        from ray_lightning_tpu_torch.telemetry.spans import PH_COMPILE

        with self._recorder.span(PH_COMPILE, meta={"label": self._label}):
            t0 = time.perf_counter()
            built0 = build.build_seconds()
            self._warm_up(*example_args)
            total = time.perf_counter() - t0
            build_s = build.build_seconds() - built0
        self.stats = CompileStats(
            build_s=build_s, warm_s=max(0.0, total - build_s),
            total_s=total, warmed=True, cache_dir=active_cache_dir())
        log.info("%s warm start: %.3f s (kernel libraries %.3f s, %s)",
                 self._label, total, build_s, self.stats.cache_dir)
        return self.stats

    def __call__(self, *args: Any) -> Any:
        return self._step(*args)

    @property
    def warmed(self) -> bool:
        return self.stats.warmed
