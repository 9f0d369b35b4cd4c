"""Device-mesh construction and topology queries (twin of
`ray_lightning_tpu/parallel/mesh.py`).

The JAX package builds a `jax.sharding.Mesh` over the slice's devices
and lets XLA compile the collectives. Here every process drives one
device and joins a `torch.distributed` process group (NCCL on the card,
gloo on the CPU); the mesh is a `DeviceMesh` over that group's ranks,
built with `init_device_mesh`, and the strategies take their process
groups from it.

Canonical axis names (outer→inner), as in the JAX package:
    data    — pure data parallelism (batch axis)
    pipe    — pipeline-parallel stages
    fsdp    — parameter/optimizer-state sharding, also carries batch
    expert  — expert parallelism for MoE
    seq     — sequence/context parallelism
    tensor  — tensor (Megatron-style) parallelism inside a layer

Every axis is built; `parallel.comm` holds the collectives of ``seq``,
``pipe`` and ``expert``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Mapping

import torch

AXIS_ORDER = ("data", "pipe", "fsdp", "expert", "seq", "tensor")


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Declarative mesh shape. -1 on at most one axis means "all remaining"."""

    data: int = 1
    fsdp: int = 1
    expert: int = 1
    seq: int = 1
    tensor: int = 1
    pipe: int = 1

    def sizes(self) -> dict[str, int]:
        return {ax: getattr(self, ax) for ax in AXIS_ORDER}

    def resolve(self, n_devices: int) -> "MeshSpec":
        sizes = self.sizes()
        wild = [ax for ax, s in sizes.items() if s == -1]
        if len(wild) > 1:
            raise ValueError(f"At most one -1 axis allowed, got {wild}")
        fixed = math.prod(s for s in sizes.values() if s != -1)
        if wild:
            if n_devices % fixed != 0:
                raise ValueError(
                    f"{n_devices} devices not divisible by fixed axes "
                    f"product {fixed}")
            sizes[wild[0]] = n_devices // fixed
        total = math.prod(sizes.values())
        if total != n_devices:
            raise ValueError(
                f"Mesh {sizes} covers {total} devices but {n_devices} are "
                "available")
        return MeshSpec(**sizes)

    def build(self, device_type: str, primary: str = "data",
              keep: tuple = ()):
        """A `DeviceMesh` over the process group's ranks (one device a
        rank), with a dimension for each axis larger than one (and each
        axis in ``keep``, at any size), or a single ``primary`` dimension
        when there is none. The default process group must be
        initialised."""
        import torch.distributed as dist
        from torch.distributed.device_mesh import init_device_mesh

        sizes = self.resolve(dist.get_world_size()).sizes()
        names = tuple(ax for ax in AXIS_ORDER
                      if sizes[ax] > 1 or ax in keep) or (primary,)
        return init_device_mesh(device_type, tuple(sizes[n] for n in names),
                                mesh_dim_names=names)


def make_mesh(data: int = 1, fsdp: int = 1, expert: int = 1, seq: int = 1,
              tensor: int = 1, pipe: int = 1, device_type: str = "cuda"):
    return MeshSpec(data, fsdp, expert, seq, tensor, pipe).build(device_type)


# --- topology queries --------------------------------------------------------


def _dist():
    import torch.distributed as dist

    return dist if dist.is_available() and dist.is_initialized() else None


def process_index() -> int:
    """This process's rank in the default process group (0 without one)."""
    dist = _dist()
    return dist.get_rank() if dist else 0


def process_count() -> int:
    dist = _dist()
    return dist.get_world_size() if dist else 1


def local_device_count() -> int:
    """The CUDA cards this host holds (1 on a host without one: the CPU)."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 1


def global_device_count() -> int:
    """Every process drives one device."""
    return process_count()


def mesh_sizes(mesh) -> dict[str, int]:
    """{axis: size} of a `DeviceMesh` (or of a mapping, returned as is)."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def dp_axis_names(mesh) -> tuple[str, ...]:
    """Axes that carry the batch: data, fsdp and expert (ranks that differ
    only in seq, tensor or pipe read the same rows)."""
    shape = mesh_sizes(mesh)
    return tuple(
        ax for ax in ("data", "fsdp", "expert") if shape.get(ax, 1) > 1
    ) or ("data",)


def batch_size_divisor(mesh) -> int:
    shape = mesh_sizes(mesh)
    return math.prod(shape.get(ax, 1) for ax in dp_axis_names(mesh))
