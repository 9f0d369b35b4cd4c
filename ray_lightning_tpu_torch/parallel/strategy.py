"""Distribution strategies (twin of `ray_lightning_tpu/parallel/strategy.py`).

The JAX strategies are sharding policies over a mesh and XLA emits the
collectives. Here a strategy owns a process's place in a
`torch.distributed` process group and wraps the model so that the
collectives run:

  * `SingleDevice` — one device, no process group;
  * `DataParallel` — `DistributedDataParallel` over the ``data`` axis
    (the reference's RayPlugin: replicated weights, gradients averaged);
  * `FSDP` — FSDP2 `fully_shard`, one unit per block the model marks
    (``fsdp_unit = True``; `LlamaBlock`) plus the root, each parameter
    sharded on the dimension `fsdp_auto_spec` picks (the JAX rule);
  * `RayXlaPlugin` — `DataParallel` with the reference's constructor.

``overlap=`` is the FSDP all-gather schedule: ``"off"`` keeps FSDP2's
defaults, ``"on"`` prefetches the next unit's weights explicitly in
forward and the previous unit's in backward, ``"serial"`` (the
ablation) prefetches nothing, each unit gathered at its use. The values
computed are the same under all three. DDP's gradient buckets already
overlap with the backward, so `DataParallel` accepts the three and
behaves the same under each.

Every process drives one device, so ``num_workers`` workers are
``num_workers`` processes (`runtime.fit.fit_distributed`). Outside it,
with no process group and ``num_workers`` at most 1, `DataParallel` and
`FSDP` start a one-rank group themselves (NCCL on the card, gloo on the
CPU) and destroy it at `teardown`.

Lifecycle (driven by the Trainer):
    setup(module)      — env, init_hook, process group, device, mesh
    wrap_model(model)  — after the weights are in, before the optimizer
    shard_batch(batch) — this process's batch onto its device
    teardown()         — destroy a process group the strategy started
"""
from __future__ import annotations

import logging
import os
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from ray_lightning_tpu_torch.parallel import mesh as mesh_lib
from ray_lightning_tpu_torch.utils.devices import (
    DeviceLike,
    rank_device,
    resolve_device,
)
from ray_lightning_tpu_torch.utils.dist import global_norm

log = logging.getLogger(__name__)


class Strategy:
    """Base strategy: one device, no process group."""

    #: mesh axis of a one-dimensional mesh
    primary_axis = "data"

    def __init__(self, num_workers: Optional[int] = None,
                 init_hook: Optional[Callable[[], None]] = None,
                 env: Optional[Dict[str, str]] = None,
                 device: DeviceLike = None, overlap: str = "off"):
        if overlap not in ("off", "on", "serial"):
            raise ValueError(
                f"overlap must be 'off', 'on' or 'serial', got {overlap!r}")
        self.num_workers = num_workers
        self.init_hook = init_hook
        self.env = dict(env or {})
        self.overlap = overlap
        self._device_arg = device
        self.device: Optional[torch.device] = None
        self.mesh = None
        self._owns_group = False

    # ---- lifecycle -------------------------------------------------------

    def setup(self, module=None) -> torch.device:
        if self.env:
            os.environ.update(self.env)
        if self.init_hook is not None:
            self.init_hook()
        self._setup_device()
        if module is not None:
            self.bind_module(module)
        log.info("strategy=%s device=%s mesh=%s", type(self).__name__,
                 self.device, self.mesh_shape)
        return self.device

    def _setup_device(self) -> None:
        self.device = resolve_device(self._device_arg)

    def bind_module(self, module) -> None:
        """Bind before the module builds its model, so it is built on the
        strategy's device."""
        module.device = self.device

    def wrap_model(self, model: torch.nn.Module) -> torch.nn.Module:
        """The model the step runs (its loss goes through one ``forward``
        of what this returns)."""
        return model

    def unwrap(self, model: torch.nn.Module) -> torch.nn.Module:
        """The model whose parameter names are the state dict's."""
        return model

    def teardown(self) -> None:
        self.mesh = None

    # ---- sharding policy -------------------------------------------------

    def param_spec(self, path: str, shape) -> tuple:
        """Per-dimension mesh axes of one parameter (the JAX
        PartitionSpec as a tuple). Default: replicate."""
        return ()

    # ---- placement and reductions ----------------------------------------

    def shard_batch(self, batch: Any) -> Any:
        """This process's batch (dict/tuple of numpy arrays or tensors) on
        its device: each process holds its own shard of the global batch."""
        return _tree_map(self._to_device, batch)

    def _to_device(self, x):
        t = x if isinstance(x, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(x))
        if self.device.type == "cuda" and t.device.type == "cpu":
            # from pinned memory the copy is truly asynchronous (the
            # prefetcher's side stream); the caching host allocator keeps
            # the staging buffer until the copy has run
            t = t.pin_memory()
        return t.to(self.device, non_blocking=True)

    def reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the data-parallel ranks."""
        return t

    def reduce_mean(self, metrics: Dict[str, Any]) -> Dict[str, Any]:
        """Scalar metrics averaged over the data-parallel ranks (one
        collective for all of them); other entries are left as they are."""
        return metrics

    def global_norm(self, tensors) -> torch.Tensor:
        """The global norm of ``tensors`` (gradients), sharded or not."""
        return global_norm(tensors)

    def local_tensors(self, tensors) -> list:
        """The local parts of ``tensors`` (this rank's shards)."""
        return list(tensors)

    # ---- introspection ---------------------------------------------------

    @property
    def mesh_shape(self) -> Dict[str, int]:
        return mesh_lib.mesh_sizes(self.mesh) if self.mesh is not None \
            else {}

    @property
    def world_size(self) -> int:
        return int(np.prod(list(self.mesh_shape.values()))) if self.mesh \
            is not None else 1

    @property
    def dp_size(self) -> int:
        return mesh_lib.batch_size_divisor(self.mesh) if self.mesh \
            is not None else 1

    @property
    def is_global_zero(self) -> bool:
        return mesh_lib.process_index() == 0


class SingleDevice(Strategy):
    """One device, no sharding. ``device`` defaults to the CUDA card
    (raises without one); pass ``device="cpu"`` for the CPU."""


class _GroupStrategy(Strategy):
    """A strategy over a `torch.distributed` process group: one process
    per device, ``num_workers`` processes."""

    def build_spec(self, n_devices: int) -> mesh_lib.MeshSpec:
        raise NotImplementedError

    def _setup_device(self) -> None:
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            world = dist.get_world_size()
            if self.num_workers is not None and self.num_workers != world:
                raise ValueError(
                    f"{type(self).__name__}(num_workers={self.num_workers}) "
                    f"in a process group of {world}: launch num_workers "
                    "processes (fit_distributed(num_processes=...))")
            self.device = rank_device(self._device_arg, num_processes=1)
        else:
            n = self.num_workers or 1
            if n > 1:
                raise ValueError(
                    f"num_workers > devices: {type(self).__name__}("
                    f"num_workers={n}) in one process, which drives one "
                    "device; run the fit through fit_distributed("
                    f"num_processes={n})")
            self.device = rank_device(self._device_arg, num_processes=1)
            self._start_group()
        self.spec = self.build_spec(dist.get_world_size())
        self.mesh = self.spec.build(self.device.type, self.primary_axis)

    def _start_group(self) -> None:
        """A one-rank group of this process (NCCL on the card, gloo on
        the CPU) over an in-process store, destroyed at `teardown`."""
        import datetime

        import torch.distributed as dist

        kw = {}
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
            kw["device_id"] = self.device
        dist.init_process_group(
            "nccl" if self.device.type == "cuda" else "gloo",
            store=dist.HashStore(), rank=0, world_size=1,
            timeout=datetime.timedelta(minutes=10), **kw)
        self._owns_group = True

    def teardown(self) -> None:
        super().teardown()
        if self._owns_group:
            import torch.distributed as dist

            dist.destroy_process_group()
            self._owns_group = False

    @property
    def dp_group(self):
        return self.mesh.get_group()

    def reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        if self.dp_size == 1:
            return t
        import torch.distributed as dist

        t = t.clone()
        dist.all_reduce(t, group=self.dp_group)
        return t

    def reduce_mean(self, metrics: Dict[str, Any]) -> Dict[str, Any]:
        if self.dp_size == 1:
            return metrics
        keys = [k for k, v in metrics.items()
                if isinstance(v, torch.Tensor) and v.dim() == 0]
        if not keys:
            return metrics
        stacked = torch.stack([metrics[k].detach().float() for k in keys])
        mean = self.reduce_sum(stacked) / self.dp_size
        return {**metrics, **dict(zip(keys, mean.unbind()))}

    def local_tensors(self, tensors) -> list:
        from torch.distributed.tensor import DTensor

        return [t.to_local() if isinstance(t, DTensor) else t
                for t in tensors]

    def global_norm(self, tensors) -> torch.Tensor:
        """Each rank's norm of its shards; with shards on more than one
        rank, the square root of the sum of their squares. Replicated
        tensors (DDP) hold the whole gradient on every rank."""
        from torch.distributed.tensor import DTensor

        tensors = list(tensors)
        norm = global_norm(self.local_tensors(tensors))
        if self.dp_size > 1 and any(isinstance(t, DTensor) for t in tensors):
            norm = self.reduce_sum(norm.square()).sqrt()
        return norm


class DataParallel(_GroupStrategy):
    """Pure data parallelism: weights replicated, each process trains on
    its shard of the batch, gradients averaged by DDP's all-reduce.

    Parity target: `RayPlugin` (reference ray_ddp.py:42-307)."""

    def build_spec(self, n_devices: int) -> mesh_lib.MeshSpec:
        return mesh_lib.MeshSpec(data=n_devices)

    def wrap_model(self, model):
        from torch.nn.parallel import DistributedDataParallel as DDP

        if isinstance(model, DDP):
            return model
        return DDP(model,
                   device_ids=([self.device.index]
                               if self.device.type == "cuda" else None),
                   process_group=self.dp_group,
                   # buffers (RoPE tables) are built identically on every
                   # rank; broadcasting them would make every forward,
                   # eval and predict included, a collective
                   broadcast_buffers=False)

    def unwrap(self, model):
        from torch.nn.parallel import DistributedDataParallel as DDP

        return model.module if isinstance(model, DDP) else model


class FSDP(_GroupStrategy):
    """ZeRO-style fully-sharded data parallelism with FSDP2.

    Every module whose class sets ``fsdp_unit = True`` becomes its own
    `fully_shard` unit (its weights all-gathered for its forward and
    backward, its gradients reduce-scattered), and so does the root.
    Each parameter is sharded on the dimension the JAX rule picks
    (`fsdp_auto_spec`: the largest dimension the shard count divides).
    Where that rule replicates (a parameter under ``min_shard_size``
    elements, or one with no divisible dimension) FSDP2 has no
    replicated placement and shards dimension 0: the values are the same.
    """

    primary_axis = "fsdp"

    def __init__(self, *args, min_shard_size: int = 2**10, **kwargs):
        super().__init__(*args, **kwargs)
        self.min_shard_size = min_shard_size

    def build_spec(self, n_devices: int) -> mesh_lib.MeshSpec:
        return mesh_lib.MeshSpec(fsdp=n_devices)

    def param_spec(self, path: str, shape) -> tuple:
        return fsdp_auto_spec(tuple(shape), self.mesh_shape.get("fsdp", 1),
                              self.min_shard_size)

    def _placement(self, param):
        from torch.distributed.tensor import Shard

        spec = self.param_spec("", param.shape)
        return Shard(spec.index("fsdp")) if "fsdp" in spec else None

    def wrap_model(self, model):
        from torch.distributed.fsdp import FSDPModule, fully_shard

        if isinstance(model, FSDPModule):
            return model
        kw = dict(mesh=self.mesh, shard_placement_fn=self._placement)
        units = []
        for sub in model.modules():
            if sub is not model and getattr(sub, "fsdp_unit", False):
                units.append(fully_shard(sub, **kw))
        root = fully_shard(model, **kw)
        self._set_overlap(root, units)
        return root

    def _set_overlap(self, root, units) -> None:
        """The all-gather schedule of ``overlap``, over the units in the
        model's order (the forward's)."""
        if self.overlap == "on":
            chain = [root, *units]
            for i, unit in enumerate(chain[:-1]):
                unit.set_modules_to_forward_prefetch([chain[i + 1]])
            root.set_modules_to_backward_prefetch(units[-1:])
            for i in range(1, len(units)):
                units[i].set_modules_to_backward_prefetch([units[i - 1]])
        elif self.overlap == "serial":
            for unit in (root, *units):
                unit.set_modules_to_forward_prefetch([])
                # a unit's own state disables the default backward
                # prefetch: it is already gathered when its backward runs
                unit.set_modules_to_backward_prefetch([unit])
        self._units = units

    def overlap_schedule(self) -> Dict[str, list]:
        """Each unit's explicit prefetch targets, as unit indices (-1 is
        the root), for the forward and the backward: the structural check
        of ``overlap``."""
        from torch.distributed.fsdp import FSDPModule

        units = getattr(self, "_units", [])
        states = {id(u._get_fsdp_state()): i for i, u in enumerate(units)}

        def targets(module, attr):
            return [states.get(id(s), -1)
                    for s in getattr(module._get_fsdp_state(), attr)]

        out: Dict[str, list] = {"forward": [], "backward": []}
        for u in units:
            assert isinstance(u, FSDPModule)
            out["forward"].append(targets(u, "_states_to_forward_prefetch"))
            out["backward"].append(targets(u,
                                           "_states_to_backward_prefetch"))
        return out


class ShardedMesh(Strategy):
    """The explicit N-D mesh strategy (dp × fsdp × tensor × seq ...)."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "ShardedMesh is not ported yet (ROADMAP Queue 1 item 4: the "
            "tensor axis as DTensor with the Megatron layout of "
            "llama_param_specs); use DataParallel or FSDP")


class RayXlaPlugin(DataParallel):
    """The reference RayPlugin's constructor (ray_ddp.py:89-94) over
    `DataParallel`.

    ``num_cpus_per_worker`` is accepted and recorded, and changes
    nothing: the JAX loader sizes its prefetch pool from it, and the
    port's `DataLoader` has no prefetch pool yet (ROADMAP Queue 1 item
    13). ``use_gpu`` picks the device
    the port's way: None (the default) is the card unless
    ``device="cpu"``; True is the card; False needs ``device="cpu"``
    and raises without it, rather than choosing one."""

    def __init__(self, num_workers: Optional[int] = None,
                 num_cpus_per_worker: Optional[int] = None,
                 use_gpu: Optional[bool] = None, init_hook=None, **kwargs):
        device = kwargs.get("device")
        is_cpu = device is not None and torch.device(device).type == "cpu"
        if use_gpu is False and not is_cpu:
            raise ValueError(
                "RayXlaPlugin(use_gpu=False) without device='cpu': the "
                "port runs on the card unless the CPU is asked for")
        if use_gpu and is_cpu:
            raise ValueError("RayXlaPlugin(use_gpu=True, device='cpu') "
                             "asks for both devices")
        self.num_cpus_per_worker = max(1, num_cpus_per_worker or 1)
        self.use_gpu = use_gpu
        super().__init__(num_workers=num_workers, init_hook=init_hook,
                         **kwargs)


# ---- spec helpers --------------------------------------------------------


def _augment_with_axis(spec: tuple, shape, axis_name: str, axis_size: int,
                       min_size: int) -> tuple:
    """Add `axis_name` to the largest free, divisible dim of `spec`."""
    if not shape or int(np.prod(shape)) < min_size:
        return spec
    dims = list(spec) + [None] * (len(shape) - len(spec))
    candidates = sorted(range(len(shape)), key=lambda i: shape[i],
                        reverse=True)
    for i in candidates:
        if dims[i] is None and shape[i] % axis_size == 0:
            dims[i] = axis_name
            return tuple(dims)
    return spec


def fsdp_auto_spec(shape, fsdp_size: int, min_size: int) -> tuple:
    """Shard the largest divisible dim on `fsdp`; replicate small leaves
    (the JAX rule, as a tuple of per-dimension axes)."""
    if fsdp_size <= 1:
        return ()
    return _augment_with_axis((None,) * len(shape), tuple(shape), "fsdp",
                              fsdp_size, min_size)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)
