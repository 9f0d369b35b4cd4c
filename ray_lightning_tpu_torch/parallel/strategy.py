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
  * `ShardedMesh` — data × pipe × fsdp × expert × seq × tensor: the
    module's `param_specs` (the Megatron layout) over ``mesh["tensor"]``
    as DTensors, then `fully_shard` over the data × fsdp sub-mesh (HSDP
    when data > 1); the sequence, pipeline and expert axes as its
    docstring sets out;
  * `RayXlaPlugin` — `DataParallel` with the reference's constructor.

`FSDP` and `ShardedMesh` build the model on the meta device, wrap it,
and fill each rank's shards from the full value drawn leaf by leaf
(`place_full_value`; `core.trainer.Trainer`), so no rank ever holds the
whole model.

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
from ray_lightning_tpu_torch.parallel.comm import AxisGroup
from ray_lightning_tpu_torch.parallel.tensor import (
    TensorParallel,
    full_value,
    fused_row_permutation,
    local_piece,
)
from ray_lightning_tpu_torch.utils.devices import (
    DeviceLike,
    rank_device,
    resolve_device,
)
from ray_lightning_tpu_torch.utils.dist import global_norm

log = logging.getLogger(__name__)


#: the fused steps of the built-in modules' optimizers (`LlamaModule`'s
#: AdamW, `MNISTClassifier`'s Adam) with the schedule's device tensor lr
#: (`core.schedule.DeviceLambdaLR`): torch ships them without a Meta
#: kernel
_TENSOR_LR_STEPS = ("_fused_adamw_.tensor_lr", "_fused_adam_.tensor_lr")
_META_LIB = []


def register_fused_step_meta() -> None:
    """Give each of `_TENSOR_LR_STEPS` that lacks one a Meta kernel that
    does nothing (the ops update their inputs in place and return none).
    DTensor's sharding propagation runs an op on fake tensors; with no
    Meta kernel the fake run falls back to the real kernel on real
    zero-filled copies of every argument: every parameter, gradient and
    moment copied once more on the first step of each process (a fresh
    FSDP worker's warm start at Llama-3-8B width, 4 layers, on an H100:
    13.4 s with the fallback, 1.4 s without). The step's values do not
    change. Idempotent."""
    if _META_LIB:
        return
    lib = torch.library.Library("aten", "IMPL")
    for name in _TENSOR_LR_STEPS:
        op = "aten::" + name
        if (not torch._C._dispatch_has_kernel(op)
                or torch._C._dispatch_has_kernel_for_dispatch_key(op, "Meta")):
            continue
        lib.impl(name, _fused_step_noop, "Meta")
    _META_LIB.append(lib)


def _fused_step_noop(*args, **kwargs) -> None:
    return None


class Strategy:
    """Base strategy: one device, no process group."""

    #: mesh axis of a one-dimensional mesh
    primary_axis = "data"
    #: does the trainer build the model on the meta device and fill the
    #: wrapped shards leaf by leaf (`place_full_value`)?
    meta_init = False

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

    def build_spec(self, n_devices: int) -> mesh_lib.MeshSpec:
        return mesh_lib.MeshSpec()

    def shape_only(self, n_devices: int, module=None) -> None:
        """Lay the strategy on a shape-only mesh of ``n_devices`` (the
        planner's twin of the JAX `AbstractMesh`): axis sizes, no process
        group, no device."""
        self.spec = self.build_spec(n_devices).resolve(n_devices)
        self.mesh = None

    # ---- sharding policy -------------------------------------------------

    def param_spec(self, path: str, shape) -> tuple:
        """Per-dimension mesh axes of one parameter (the JAX
        PartitionSpec as a tuple). Default: replicate."""
        return ()

    def planned_shard(self, path: str, shape) -> tuple:
        """(storage shape, shape) of this rank's part of one parameter,
        as `wrap_model` lays it out, from shapes alone (the planner):
        the storage may be padded. Default: the whole parameter."""
        return tuple(shape), tuple(shape)

    def data_shard(self, rank: int, world: int) -> tuple:
        """(shard index, shard count) of the data a process of ``rank``
        among ``world`` reads: one shard a data-parallel rank."""
        return rank, world

    # ---- meta-device init and the state dict's layout ----------------------

    def place_full_value(self, name: str, param, full) -> None:
        """Keep this rank's part of ``full``, the whole value of the
        wrapped parameter ``name``, in ``param``."""
        from torch.distributed.tensor import DTensor

        if isinstance(param, DTensor):
            param.to_local().copy_(local_piece(
                self.layout_value(name, full), param.device_mesh,
                param.placements))
        else:
            param.copy_(full)

    def layout_value(self, name: str, full):
        """A whole parameter in the wrapped model's row order (the
        canonical one except under the tensor axis)."""
        return full

    def state_dicts(self, model, optimizer) -> tuple:
        """The wrapped model's and its optimizer's FQN-keyed state dicts
        (DCP's `get_state_dict`) in the canonical layout: what a
        checkpoint holds and what a restore reads into."""
        from torch.distributed.checkpoint.state_dict import get_state_dict

        return get_state_dict(model, optimizer)

    def restore_target(self, model, optimizer) -> tuple:
        """`state_dicts`' layout for a restore to read into: its values
        are overwritten, so a strategy may skip computing them."""
        return self.state_dicts(model, optimizer)

    def load_state_dicts(self, model, optimizer, params, osd) -> None:
        """Load `state_dicts`' canonical dicts into the wrapped model and
        its optimizer."""
        from torch.distributed.checkpoint.state_dict import set_state_dict

        set_state_dict(model, optimizer, model_state_dict=params,
                       optim_state_dict=osd)

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
    def loss_ranks(self) -> int:
        """The ranks whose losses partition the global batch's tokens (the
        data-parallel ranks; under the ``seq`` axis also each chunk of the
        sequence): `reduce_sum` and `reduce_mean` run over them."""
        return self.dp_size

    def finish_grads(self, named_grads, reduce: bool = True) -> None:
        """After the backward, before the gradients' norm: the reductions
        the wrapper does not make (none here). ``named_grads``: (name,
        gradient) pairs of the trainable parameters."""

    @property
    def is_global_zero(self) -> bool:
        return mesh_lib.process_index() == 0


class SingleDevice(Strategy):
    """One device, no sharding. ``device`` defaults to the CUDA card
    (raises without one); pass ``device="cpu"`` for the CPU."""


class _GroupStrategy(Strategy):
    """A strategy over a `torch.distributed` process group: one process
    per device, ``num_workers`` processes."""

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
        self.mesh = self.spec.build(self.device.type, self.primary_axis,
                                    keep=self._kept_axes())

    def _kept_axes(self) -> tuple:
        """Mesh axes built even at size one."""
        return ()

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
        if self.loss_ranks == 1:
            return t
        import torch.distributed as dist

        t = t.clone()
        dist.all_reduce(t, group=self.dp_group)
        return t

    def reduce_mean(self, metrics: Dict[str, Any]) -> Dict[str, Any]:
        if self.loss_ranks == 1:
            return metrics
        keys = [k for k, v in metrics.items()
                if isinstance(v, torch.Tensor) and v.dim() == 0]
        if not keys:
            return metrics
        stacked = torch.stack([metrics[k].detach().float() for k in keys])
        mean = self.reduce_sum(stacked) / self.loss_ranks
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
    meta_init = True

    def __init__(self, *args, min_shard_size: int = 2**10, **kwargs):
        super().__init__(*args, **kwargs)
        self.min_shard_size = min_shard_size

    def build_spec(self, n_devices: int) -> mesh_lib.MeshSpec:
        return mesh_lib.MeshSpec(fsdp=n_devices)

    def _sizes(self) -> Dict[str, int]:
        """{axis: size} of every axis (the built mesh's, or the planner's
        shape-only spec; all one before either)."""
        if self.mesh is not None:
            return {**mesh_lib.MeshSpec().sizes(), **self.mesh_shape}
        spec = getattr(self, "spec", None)
        return (spec or mesh_lib.MeshSpec()).sizes()

    def param_spec(self, path: str, shape) -> tuple:
        return fsdp_auto_spec(tuple(shape), self._sizes()["fsdp"],
                              self.min_shard_size)

    def _fsdp_dim(self, path: str, shape) -> int:
        """The dimension FSDP2 shards: where the JAX rule puts ``fsdp``;
        dimension 0 where it replicates (FSDP2 has no replicated
        placement)."""
        spec = self.param_spec(path, shape)
        return spec.index("fsdp") if "fsdp" in spec else 0

    def _placement(self, param):
        from torch.distributed.tensor import Shard

        spec = self.param_spec("", param.shape)
        return Shard(spec.index("fsdp")) if "fsdp" in spec else None

    def planned_shard(self, path: str, shape) -> tuple:
        return _fsdp_shard(tuple(shape), self._fsdp_dim(path, shape),
                           self._sizes()["fsdp"])

    def wrap_model(self, model):
        from torch.distributed.fsdp import FSDPModule

        register_fused_step_meta()
        if isinstance(model, FSDPModule):
            return model
        return self._shard_units(model, self.mesh, self._placement)

    def _shard_units(self, model, mesh, placement):
        """`fully_shard` over ``mesh``: each marked block its own unit,
        then the root, with ``overlap``'s prefetch between them."""
        from torch.distributed.fsdp import fully_shard

        kw = dict(mesh=mesh, shard_placement_fn=placement)
        units = [fully_shard(sub, **kw) for sub in model.modules()
                 if sub is not model and getattr(sub, "fsdp_unit", False)]
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


class ShardedMesh(FSDP):
    """The explicit N-D mesh strategy, data × fsdp × tensor (twin of the
    JAX `ShardedMesh`): ``ShardedMesh(data=2, fsdp=2, tensor=2)``.

    Each parameter's spec is the module's `param_specs` entry (the
    Megatron layout of `models.llama.llama_param_specs`), checked
    eagerly (RLT101-104, with the leaf's name), with ``fsdp`` laid on its
    largest free divisible dimension (the JAX composition). The model is
    wrapped in that order:

      1. tensor parallelism over ``mesh["tensor"]``: each parameter
         becomes a DTensor sharded on its ``tensor`` dimension or
         replicated; a fused weight's rows are first put in head-aligned
         order (the module's `fused_rows`; `parallel.tensor`), and the
         model runs its tensor-parallel forward
         (``enable_tensor_parallel``);
      2. `fully_shard` over the data × fsdp sub-mesh: FSDP2 over
         ``fsdp``, HSDP (replicated over ``data``) when data > 1, one
         unit a marked block, with ``overlap=``'s prefetch over fsdp.

    ``state_dict()``, checkpoints and `state_dicts` keep the
    canonical row order, so a checkpoint crosses layouts. The ranks of
    one tensor, seq or pipe group read the same rows (`data_shard`): the
    batch rides data × fsdp × expert.

    The sequence, pipeline and expert axes (the collectives are
    `parallel.comm`'s):

      * ``seq``: the module shards the sequence (``check_sequence_parallel``;
        the model's ``enable_sequence_parallel``: `models.llama` runs each
        rank's chunk, attention by the ring or Ulysses); the parameters
        are replicated over ``seq`` and their gradients averaged over it
        after the wrapper's own reduction; the loss and metrics are
        averaged over data × fsdp × expert × seq;
      * ``pipe``: the module has a pipeline path (``check_pipeline``):
        a model with ``enable_pipeline`` keeps its stage's layers (the
        rest are never materialised), and a parameter whose spec names
        ``pipe`` (a layer stack, `ops.pipeline.pipeline_param_spec`)
        becomes a DTensor sharded over it; the other parameters are
        replicated over ``pipe``, and their gradients are equal on every
        stage by construction (`ops.pipeline` replicates its output and
        sums its input's cotangent), so nothing is reduced over it;
      * ``expert``: a parameter whose spec names ``expert`` (`models.moe`)
        becomes a DTensor sharded over it, the rest are replicated; the
        batch is split over it too, so the replicated parameters'
        gradients are averaged over ``expert``, and an expert weight's,
        which its owner sums from every rank's tokens, divided by its
        size.

    Under ``pipe`` or ``expert`` the model is not wrapped in FSDP2: the
    gradients are averaged over ``data`` explicitly (``fsdp`` must be
    one).
    """

    primary_axis = "data"

    def __init__(self, data: int = 1, fsdp: int = 1, expert: int = 1,
                 seq: int = 1, tensor: int = 1, pipe: int = 1,
                 min_shard_size: int = 2**10, **kwargs):
        super().__init__(min_shard_size=min_shard_size, **kwargs)
        self._spec = mesh_lib.MeshSpec(data, fsdp, expert, seq, tensor,
                                       pipe)
        if fsdp not in (1, -1) and (pipe != 1 or expert != 1):
            raise NotImplementedError(
                f"ShardedMesh(fsdp={fsdp}) with pipe={pipe}, "
                f"expert={expert}: the port reduces the pipeline's and the "
                "experts' gradients over data replicas, not FSDP2 shards")
        self._module = None
        self.tp: Optional[TensorParallel] = None
        #: parameter name -> the axes it is split over (`_split_axes`),
        #: and id(gradient) -> its parameter's, recorded by `finish_grads`
        #: for `global_norm`
        self._split: Dict[str, tuple] = {}
        self._grad_split: Dict[int, tuple] = {}

    def build_spec(self, n_devices: int) -> mesh_lib.MeshSpec:
        return self._spec.resolve(n_devices)

    def _kept_axes(self) -> tuple:
        # data > 1 without fsdp is HSDP over a one-wide fsdp dimension:
        # FSDP2's replicated (all-reduced) data parallelism
        return ("fsdp",) if self.spec.data > 1 else ()

    def bind_module(self, module) -> None:
        super().bind_module(module)
        self._module = module
        # a typo'd axis needs no shapes: it raises here, at setup, by the
        # leaf's name (the shape rules run when the model is wrapped)
        for path, spec in self._module_specs().items():
            self._require_known_axes(path, spec)
        sizes = self._sizes()
        if module is None:
            return
        if sizes["pipe"] > 1 and (sizes["tensor"] > 1 or sizes["seq"] > 1):
            # the JAX Llama's exclusion, for every module
            raise ValueError(
                "the pipeline path composes with data/fsdp only; drop "
                "tensor/seq from the mesh or disable pipeline_microbatches")
        for axis, hook, what in (
                ("tensor", "check_tensor_parallel",
                 "tensor-parallel forward (check_tensor_parallel, "
                 "param_specs)"),
                ("seq", "check_sequence_parallel",
                 "sequence-parallel forward (check_sequence_parallel)"),
                ("pipe", "check_pipeline",
                 "pipeline path (check_pipeline)")):
            if sizes[axis] > 1:
                check = getattr(module, hook, None)
                if check is None:
                    raise ValueError(
                        f"ShardedMesh({axis}={sizes[axis]}): "
                        f"{type(module).__name__} has no {what}")
                check(sizes[axis])

    def shape_only(self, n_devices: int, module=None) -> None:
        super().shape_only(n_devices, module)
        self._module = module

    # ---- the composed spec ------------------------------------------------

    def _module_specs(self) -> Dict[str, tuple]:
        fn = getattr(self._module, "param_specs", None)
        return dict(fn() or {}) if fn is not None else {}

    def leaf_spec(self, path: str, shape, module_specs=None) -> tuple:
        """The composed spec of one parameter: the module's entry (its
        axes checked against the mesh), size-one axes dropped, ``fsdp``
        overlaid on the largest free divisible dimension; raises on a
        malformed result."""
        if module_specs is None:
            module_specs = self._module_specs()
        spec = module_specs.get(path)
        if spec is None:
            spec = ()
        else:
            self._require_known_axes(path, spec)
        spec = self._adapt_spec(spec)
        sizes = self._sizes()
        if sizes["fsdp"] > 1 and "fsdp" not in _spec_names(spec):
            spec = _augment_with_axis(spec, tuple(shape), "fsdp",
                                      sizes["fsdp"], self.min_shard_size)
        self._require_well_formed(path, spec, shape)
        return tuple(spec)

    def _require_known_axes(self, path: str, spec) -> None:
        """A module spec naming an axis no mesh has (a size-one axis is
        legal and dropped) raises: a typo would replicate the leaf."""
        known = set(mesh_lib.AXIS_ORDER)
        unknown = sorted(_spec_names(spec) - known)
        if unknown:
            raise ValueError(
                f"param_specs for {path!r} names unknown mesh "
                f"axis(es) {unknown} (mesh axes: {sorted(known)}) — a "
                "typo here would silently replicate the leaf "
                "[shardcheck RLT101]")

    def _require_well_formed(self, path: str, spec, shape) -> None:
        """RLT102-104 on the composed spec, at setup, by the leaf's name."""
        from ray_lightning_tpu_torch.parallel.spec_check import spec_findings

        errors = [f for f in spec_findings(spec, tuple(shape), self._sizes(),
                                           path=path)
                  if f.severity == "error"]
        if errors:
            raise ValueError("sharding plan is malformed:\n"
                             + "\n".join(f.format() for f in errors))

    def _adapt_spec(self, spec) -> tuple:
        """Drop the axes of size one."""
        sizes = self._sizes()
        out = []
        for dim in spec:
            names = () if dim is None else (
                tuple(dim) if isinstance(dim, (tuple, list)) else (dim,))
            kept = tuple(n for n in names if sizes.get(n, 1) > 1)
            out.append(kept if len(kept) > 1 else (kept[0] if kept
                                                   else None))
        while out and out[-1] is None:
            out.pop()
        return tuple(out)

    def _axis_dims(self, path: str, shape, module_specs=None) -> dict:
        """{axis: the dimension it splits} of one parameter, for the
        axes of size above one its composed spec names."""
        spec = self.leaf_spec(path, shape, module_specs)
        out = {}
        for i, dim in enumerate(spec):
            names = dim if isinstance(dim, tuple) else (dim,)
            if len([n for n in names if n is not None]) > 1:
                raise NotImplementedError(
                    f"{path}: spec {spec} shards one dimension over "
                    "several axes; the port splits a dimension over one")
            if names[0] in ("tensor", "fsdp", "expert", "pipe"):
                out[names[0]] = i
            elif names != (None,):
                raise NotImplementedError(
                    f"{path}: the port shards parameters over fsdp, "
                    f"tensor, expert and pipe, not {names}")
        if len([a for a in ("tensor", "expert", "pipe") if a in out]) > 1:
            raise NotImplementedError(
                f"{path}: spec {spec} splits the parameter over more than "
                "one of tensor, expert and pipe")
        return out

    def planned_shard(self, path: str, shape, module_specs=None):
        """As the base's; None for a layer another pipeline stage owns
        (the plan is rank 0's: stage 0's layers)."""
        sizes = self._sizes()
        stage_of = getattr(self._module, "pipeline_stage", None)
        if sizes["pipe"] > 1 and stage_of is not None and \
                stage_of(path, sizes["pipe"]) not in (None, 0):
            return None
        dims = self._axis_dims(path, shape, module_specs)
        shape = list(shape)
        for axis in ("tensor", "expert", "pipe"):
            if axis in dims:
                shape[dims[axis]] //= sizes[axis]
        if self._replicas():
            return tuple(shape), tuple(shape)
        # HSDP's data replicas hold the same shard
        return _fsdp_shard(tuple(shape), dims.get("fsdp", 0),
                           sizes["fsdp"])

    def _replicas(self) -> bool:
        """Is the model left unwrapped, its gradients averaged over the
        data replicas explicitly (under ``pipe`` or ``expert``)?"""
        sizes = self._sizes()
        return sizes["pipe"] > 1 or sizes["expert"] > 1

    def data_shard(self, rank: int, world: int) -> tuple:
        """The rank's coordinate over data × fsdp × expert (the batch
        axes), in mesh order: ranks that differ only in pipe, seq or
        tensor read the same rows."""
        sizes = self.build_spec(world).sizes()
        coords = np.unravel_index(rank, [sizes[a] for a in
                                         mesh_lib.AXIS_ORDER])
        batch = [a for a in mesh_lib.AXIS_ORDER
                 if a in ("data", "fsdp", "expert")]
        index = int(np.ravel_multi_index(
            [coords[mesh_lib.AXIS_ORDER.index(a)] for a in batch],
            [sizes[a] for a in batch]))
        return index, int(np.prod([sizes[a] for a in batch]))

    # ---- wrapping -----------------------------------------------------------

    def _fused(self) -> Dict[str, tuple]:
        fn = getattr(self._module, "fused_rows", None)
        return dict(fn()) if fn is not None else {}

    def _perm(self, name: str):
        parts = self._fused().get(name)
        if parts is None or self._sizes()["tensor"] <= 1:
            return None
        return fused_row_permutation(parts, self._sizes()["tensor"])

    def layout_value(self, name: str, full):
        perm = self._perm(name)
        return full if perm is None else full[perm.to(full.device)]

    def restore_target(self, model, optimizer) -> tuple:
        # `state_dicts`' keys and layout, built here: the model's
        # state-dict hook would gather each fused leaf's rows, which the
        # restore overwrites, so a fused leaf is an uninitialised piece
        from torch.distributed.checkpoint.state_dict import (
            get_optimizer_state_dict,
        )

        inner = self.unwrap(model)
        params = {n: self._canonical_shell(n, p.detach())
                  for n, p in inner.named_parameters()}
        for prefix, mod in inner.named_modules():
            for n, b in mod.named_buffers(prefix=prefix, recurse=False):
                if b is not None and n.rpartition(".")[2] not in \
                        mod._non_persistent_buffers_set:
                    params[n] = b
        osd = get_optimizer_state_dict(model, optimizer)
        return params, _map_optim_state(osd, self._canonical_shell)

    def _canonical_placements(self, value) -> tuple:
        from torch.distributed.tensor import Shard

        return tuple(Shard(p.dim) if type(p).__name__ == "_StridedShard"
                     else p for p in value.placements)

    def _canonical_shell(self, name: str, value):
        """`canonical_value`'s layout without its values: this rank's
        piece uninitialised (no collective)."""
        from torch.distributed.tensor import DTensor
        from torch.distributed.tensor._utils import (
            compute_local_shape_and_global_offset,
        )

        if self._perm(name) is None or not isinstance(value, DTensor):
            return value
        placements = self._canonical_placements(value)
        shape, _ = compute_local_shape_and_global_offset(
            value.shape, value.device_mesh, placements)
        return DTensor.from_local(
            value.to_local().new_empty(shape), value.device_mesh,
            placements, run_check=False, shape=value.shape,
            stride=value.stride())

    def canonical_value(self, name: str, value):
        """A wrapped parameter's value (or optimizer state) in the
        canonical row order, as a DTensor on its mesh with plain shards
        (a collective: the whole value is gathered)."""
        from torch.distributed.tensor import DTensor

        perm = self._perm(name)
        if perm is None or not isinstance(value, DTensor):
            return value
        placements = self._canonical_placements(value)
        full = full_value(value)
        canon = full[torch.argsort(perm).to(full.device)]
        piece = local_piece(canon, value.device_mesh, placements).clone()
        return DTensor.from_local(piece, value.device_mesh, placements,
                                  run_check=False, shape=canon.shape,
                                  stride=canon.stride())

    def _as_param_layout(self, name: str, value, param):
        """``value`` (canonical: a DTensor or a whole tensor) as a DTensor
        laid out like the wrapped ``param``."""
        from torch.distributed.tensor import DTensor

        if isinstance(value, DTensor):
            if (self._perm(name) is None
                    and value.device_mesh == param.device_mesh
                    and value.placements == param.placements):
                return value
            value = full_value(value)
        ploc = param.to_local()
        full = self.layout_value(name, value.to(ploc.device))
        piece = local_piece(full, param.device_mesh, param.placements)
        return DTensor.from_local(piece.to(ploc.dtype).clone(),
                                  param.device_mesh, param.placements,
                                  run_check=False, shape=param.shape,
                                  stride=param.stride())

    def wrap_model(self, model):
        from torch.distributed.fsdp import FSDPModule
        from torch.distributed.tensor import Shard

        register_fused_step_meta()
        if isinstance(model, FSDPModule) or getattr(model, "_rlt_wrapped",
                                                    False):
            self._record_splits(model)
            return model
        sizes = self._sizes()
        specs = self._module_specs()
        if sizes["pipe"] > 1 and hasattr(model, "enable_pipeline"):
            # the stage's layers alone are materialised
            model.enable_pipeline(AxisGroup.of(self.mesh, "pipe"))
        named = dict(model.named_parameters())
        dims = {n: self._axis_dims(n, p.shape, specs)
                for n, p in named.items()}
        if sizes["tensor"] > 1:
            self._shard_tensor(model, named, dims)
        for axis in ("expert", "pipe"):
            if sizes[axis] > 1:
                self._shard_axis(model, axis, dims)
        if sizes["seq"] > 1:
            model.enable_sequence_parallel(AxisGroup.of(self.mesh, "seq"))
        if sizes["expert"] > 1 and hasattr(model, "enable_expert_parallel"):
            model.enable_expert_parallel(AxisGroup.of(self.mesh, "expert"),
                                         self._batch_group())
        self._record_splits(model, dims)
        model._rlt_wrapped = True
        dp = [ax for ax in ("data", "fsdp") if ax in self.mesh_shape]
        if not dp or self._replicas():
            return model
        by_id = {id(p): n for n, p in model.named_parameters()}

        def placement(param):
            return Shard(dims[by_id[id(param)]].get("fsdp", 0))

        return self._shard_units(
            model, self.mesh[tuple(dp)] if len(dp) > 1 else self.mesh[dp[0]],
            placement)

    def _shard_tensor(self, model, named, dims) -> None:
        """Each parameter as a DTensor over ``mesh["tensor"]``: its shard
        of the (head-aligned) value, or the whole value replicated."""
        from torch import nn
        from torch.distributed.tensor import DTensor, Replicate, Shard

        tp_mesh = self.mesh["tensor"]
        self.tp = TensorParallel(tp_mesh.get_group(), tp_mesh.size(),
                                 tp_mesh.get_local_rank())
        for name, p in named.items():
            tdim = dims[name].get("tensor")
            value = self.layout_value(name, p.detach())
            if tdim is None:
                piece, placements = value, [Replicate()]
            else:
                piece = value.chunk(self.tp.size, dim=tdim)[self.tp.rank]
                placements = [Shard(tdim)]
            owner, _, attr = name.rpartition(".")
            mod = model.get_submodule(owner) if owner else model
            dt = DTensor.from_local(piece.clone(), tp_mesh, placements,
                                    run_check=False)
            setattr(mod, attr, nn.Parameter(dt,
                                            requires_grad=p.requires_grad))
        model.enable_tensor_parallel(self.tp)
        # functions, not bound methods: the hook API marks its hooks
        model.register_state_dict_post_hook(
            lambda *a: self._state_dict_hook(*a))
        model.register_load_state_dict_pre_hook(
            lambda *a: self._load_hook(*a))

    def _shard_axis(self, model, axis: str, dims) -> None:
        """Each parameter whose spec names ``axis`` as a DTensor sharded
        over ``mesh[axis]`` on that dimension (an expert bank, a layer
        stack); the model runs its local shard (`parallel.tensor.local`)."""
        from torch import nn
        from torch.distributed.tensor import DTensor, Shard

        sub = self.mesh[axis]
        for name, p in list(model.named_parameters()):
            d = dims.get(name, {}).get(axis)
            if d is None:
                continue
            piece = p.detach().chunk(sub.size(), dim=d)[sub.get_local_rank()]
            owner, _, attr = name.rpartition(".")
            mod = model.get_submodule(owner) if owner else model
            dt = DTensor.from_local(piece.clone(), sub, [Shard(d)],
                                    run_check=False)
            setattr(mod, attr, nn.Parameter(dt,
                                            requires_grad=p.requires_grad))

    def _batch_group(self) -> AxisGroup:
        """Every rank holding other rows of the batch (data × fsdp ×
        expert), ranked as `data_shard` ranks them."""
        axes = tuple(a for a in ("data", "fsdp", "expert")
                     if a in self.mesh_shape)
        sub = self.mesh[axes[0]] if len(axes) == 1 else \
            self.mesh[axes]._flatten()
        return AxisGroup(sub.get_group(), sub.size(), sub.get_local_rank())

    def _record_splits(self, model, dims=None) -> None:
        """Each parameter's split axes, for `finish_grads`; ``dims``: its
        `_axis_dims` (read from the model's global shapes when None)."""
        if dims is None:
            specs = self._module_specs()
            dims = {n: self._axis_dims(n, p.shape, specs)
                    for n, p in model.named_parameters()}
        self._split = {n: self._split_axes(model, n, d)
                       for n, d in dims.items()}

    def _split_axes(self, model, name: str, dims: dict) -> tuple:
        """The axes over which a parameter's elements differ between
        ranks (its shards): ``fsdp`` under FSDP2, and those of tensor,
        expert and pipe it is split over (a stage-owned layer's whole
        weight counts as split over ``pipe``)."""
        sizes = self._sizes()
        out = [a for a in ("tensor", "expert", "pipe")
               if a in dims and sizes[a] > 1]
        owned = getattr(model, "pipeline_owned", None)
        if sizes["pipe"] > 1 and owned is not None and owned(name):
            out.append("pipe")
        if sizes["fsdp"] > 1 and not self._replicas():
            out.append("fsdp")
        return tuple(sorted(set(out), key=mesh_lib.AXIS_ORDER.index))

    def _state_dict_hook(self, module, state_dict, prefix, local_metadata):
        for key in list(state_dict):
            name = key[len(prefix):]
            if self._perm(name) is not None:
                state_dict[key] = self.canonical_value(name,
                                                       state_dict[key])

    def _load_hook(self, module, state_dict, prefix, *args):
        from torch.distributed.tensor import DTensor

        params = dict(module.named_parameters())
        for key in list(state_dict):
            name = key[len(prefix):]
            p = params.get(name)
            if isinstance(p, DTensor):
                state_dict[key] = self._as_param_layout(name,
                                                        state_dict[key], p)

    def state_dicts(self, model, optimizer) -> tuple:
        params, osd = super().state_dicts(model, optimizer)
        return params, _map_optim_state(osd, self.canonical_value)

    def load_state_dicts(self, model, optimizer, params, osd) -> None:
        from torch.distributed.tensor import DTensor

        named = dict(self.unwrap(model).named_parameters())

        def one(name, v):
            p = named.get(name)
            if isinstance(p, DTensor) and self._perm(name) is not None:
                return self._as_param_layout(name, v, p)
            return v

        super().load_state_dicts(model, optimizer, params,
                                 _map_optim_state(osd, one))

    # ---- reductions -----------------------------------------------------------

    @property
    def dp_group(self):
        dp = tuple(ax for ax in ("data", "fsdp") if ax in self.mesh_shape)
        if not dp:
            return None
        if len(dp) == 1:
            return self.mesh[dp[0]].get_group()
        return self.mesh[dp]._flatten().get_group()

    @property
    def loss_ranks(self) -> int:
        sizes = self._sizes()
        return self.dp_size * sizes["seq"]

    def _over(self, t: torch.Tensor, axes) -> torch.Tensor:
        """``t`` summed in place over each of ``axes`` in turn (their
        product's sum)."""
        import torch.distributed as dist

        for ax in axes:
            if self._sizes()[ax] > 1:
                dist.all_reduce(t, group=self.mesh[ax].get_group())
        return t

    def reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        if self.loss_ranks == 1:
            return t
        return self._over(t.clone(), ("data", "fsdp", "expert", "seq"))

    def finish_grads(self, named_grads, reduce: bool = True) -> None:
        """Average each gradient over the axes its parameter is
        replicated on and FSDP2 does not reduce: ``seq``; ``data`` and
        ``expert`` under the replicas of ``pipe`` and ``expert`` (an
        expert weight's divided by the expert axis instead). Records each
        gradient's split axes for `global_norm`."""
        sizes = self._sizes()
        self._grad_split = {}
        for name, g in named_grads:
            split = self._split.get(name, ())
            self._grad_split[id(g)] = split
            if not reduce:
                continue
            axes = [a for a in ("data", "expert", "seq") if sizes[a] > 1
                    and a not in split
                    and (a == "seq" or self._replicas())]
            local_g = g.to_local() if hasattr(g, "to_local") else g
            self._over(local_g, axes)
            n = int(np.prod([sizes[a] for a in axes])) if axes else 1
            if "expert" in split:
                n *= sizes["expert"]
            if n > 1:
                local_g.div_(n)

    def global_norm(self, tensors) -> torch.Tensor:
        """Each element once: the squares of each gradient's local part
        summed over the axes its parameter is split on (fsdp, tensor,
        expert, pipe: `finish_grads` recorded them); those of a
        replicated gradient (HSDP's data replicas, a gain under the
        tensor axis) are counted once."""
        buckets: Dict[tuple, list] = {}
        for t in tensors:
            split = self._grad_split.get(id(t), ())
            buckets.setdefault(split, []).append(
                t.to_local() if hasattr(t, "to_local") else t)
        total = torch.zeros((), dtype=torch.float32, device=self.device)
        for split in sorted(buckets):
            sq = global_norm(buckets[split]).to(self.device).square()
            total = total + self._over(sq.reshape(1), split)[0]
        return total.sqrt()

    def teardown(self) -> None:
        super().teardown()
        self.tp = None


class RayXlaPlugin(DataParallel):
    """The reference RayPlugin's constructor (ray_ddp.py:89-94) over
    `DataParallel`.

    An explicit ``num_cpus_per_worker`` is exported to the worker as
    ``RLT_NUM_CPUS_PER_WORKER``, which sizes `DataLoader(prefetch=True)`'s
    native batcher pool, as in JAX. ``use_gpu`` picks the device
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
        env = dict(kwargs.pop("env", None) or {})
        if num_cpus_per_worker is not None:
            # only an explicit budget: a default would retune every
            # loader of the process, not this strategy's
            env.setdefault("RLT_NUM_CPUS_PER_WORKER",
                           str(max(1, num_cpus_per_worker)))
        self.num_cpus_per_worker = max(1, num_cpus_per_worker or 1)
        self.use_gpu = use_gpu
        super().__init__(num_workers=num_workers, init_hook=init_hook,
                         env=env, **kwargs)


# ---- spec helpers --------------------------------------------------------


def _fsdp_shard(shape: tuple, dim: int, n: int) -> tuple:
    """(padded storage shape, shape) of rank 0's FSDP2 shard of ``shape``
    split ``n`` ways on ``dim`` (``torch.chunk``: ceil-sized pieces, the
    storage padded to one)."""
    if n <= 1 or not shape:
        return shape, shape
    rows = -(-shape[dim] // n)
    out = shape[:dim] + (rows,) + shape[dim + 1:]
    return out, out


def _spec_names(spec) -> set:
    names = set()
    for dim in spec:
        if dim is None:
            continue
        for n in dim if isinstance(dim, (tuple, list)) else (dim,):
            names.add(n)
    return names


def _map_optim_state(osd: Dict[str, Any], fn) -> Dict[str, Any]:
    """``osd`` (FQN-keyed, `get_state_dict`'s) with each tensor state of
    a parameter passed through ``fn(name, value)``; scalars kept."""
    state = {}
    for name, entry in osd.get("state", {}).items():
        state[name] = {k: (fn(name, v) if isinstance(v, torch.Tensor)
                           and v.dim() > 0 else v)
                       for k, v in entry.items()}
    return {**osd, "state": state}


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
