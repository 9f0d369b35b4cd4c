"""GPU accounting for concurrent trials (twin of
`ray_lightning_tpu/sweep/resources.py`).

The reference reserved training-worker capacity with Ray Tune's
``extra_cpu``/``extra_gpu`` oversubscription trick (reference
examples/ray_ddp_example.py:107-112): the trial actor occupies 1 CPU and
*reserves* N more for the workers it will launch. Here the sweep does the
accounting itself: a `ResourcePool` of cards, each trial acquiring an
integral `GpuResources` block, concurrency = floor(total / per-trial).

On a TPU a count was enough. On GPUs the pool also says WHICH cards: a
trial gets the indices it reserved, and the runner pins its process to
them (``CUDA_VISIBLE_DEVICES``). Two concurrent trials that both land on
``cuda:0`` are the failure this layer exists to prevent.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from ray_lightning_tpu_torch.analysis.lockwatch import san_lock


@dataclass(frozen=True)
class GpuResources:
    """What ONE trial reserves.

    gpus   — cards the trial's processes drive (one process a card).
    hosts  — hosts the trial borrows from ``sweep.run(hosts=...)``'s
             pool (its process runs on the first; a nested
             ``fit_distributed`` may span all of them).
    cpus   — host CPUs the trial's workers consume (the reference's
             num_cpus_per_worker + extra_cpu, ray_ddp.py:89-111);
             0 = unaccounted.
    """

    gpus: int = 1
    hosts: int = 1
    cpus: int = 0

    def __post_init__(self):
        if self.gpus < 1 or self.hosts < 1:
            raise ValueError(f"resources must be >= 1, got {self}")
        if self.cpus < 0:
            raise ValueError(f"cpus must be >= 0, got {self}")


class ResourcePool:
    """Thread-safe integral-block allocator over fixed card and CPU
    budgets. Cards are handed out by index: `try_acquire` returns the
    lowest free indices, `release` takes those same indices back.
    Packing is bounded by whichever budget runs out first."""

    def __init__(self, total_gpus: int, total_cpus: Optional[int] = None):
        if total_gpus < 1:
            raise ValueError("total_gpus must be >= 1")
        if total_cpus is not None and total_cpus < 1:
            raise ValueError("total_cpus must be >= 1 when given")
        self.total_gpus = total_gpus
        self.total_cpus = total_cpus
        self._free: List[int] = list(range(total_gpus))
        #: held block (its card indices) -> the CPUs it reserved
        self._held: Dict[Tuple[int, ...], int] = {}
        self._lock = san_lock("sweep.resources.pool")

    def max_concurrent(self, per_trial: GpuResources) -> int:
        """floor(pool / per-trial block), jointly over every accounted
        dimension."""
        cap = self.total_gpus // per_trial.gpus
        if self.total_cpus is not None and per_trial.cpus > 0:
            cap = min(cap, self.total_cpus // per_trial.cpus)
        return cap

    def try_acquire(self, res: GpuResources) -> Optional[List[int]]:
        """The card indices reserved for one trial, or None when the
        pool cannot hold another block now."""
        with self._lock:
            if res.gpus > self.total_gpus:
                raise ValueError(
                    f"trial wants {res.gpus} GPUs but the pool only has "
                    f"{self.total_gpus}: a block cannot be oversubscribed")
            if self.total_cpus is not None and res.cpus > self.total_cpus:
                raise ValueError(
                    f"trial wants {res.cpus} cpus but the pool only has "
                    f"{self.total_cpus}")
            if len(self._free) < res.gpus:
                return None
            if (self.total_cpus is not None
                    and self._cpus_held() + res.cpus > self.total_cpus):
                return None
            taken, self._free = self._free[:res.gpus], self._free[res.gpus:]
            self._held[tuple(taken)] = res.cpus
            return taken

    def release(self, indices: Sequence[int]) -> None:
        """Give back a block `try_acquire` returned."""
        key = tuple(indices)
        with self._lock:
            if key not in self._held:
                raise ValueError(f"cards {list(key)} are not a held block")
            del self._held[key]
            self._free = sorted(self._free + list(key))

    def _cpus_held(self) -> int:
        # under self._lock
        return sum(self._held.values())

    @property
    def in_use(self) -> int:
        with self._lock:
            return self.total_gpus - len(self._free)

    @property
    def cpus_in_use(self) -> int:
        with self._lock:
            return self._cpus_held()
