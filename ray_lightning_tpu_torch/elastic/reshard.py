"""Resharding restore (twin of `ray_lightning_tpu/elastic/reshard.py`):
load any checkpoint onto any target layout.

  * checkpoints carry **topology provenance** (checkpoint/io.py
    `sharding_provenance`, stamped by the Trainer into every meta.json):
    the writing mesh's axis sizes, the process count, and each
    parameter's per-dimension shard axes;
  * `reshard_restore(path, target)` restores the checkpoint onto the
    TARGET state dict's layout — an arbitrary mesh-to-mesh move (fsdp=2
    -> world 1, data=2 -> fsdp=2, fsdp=2 -> tensor=2), validated
    against the provenance first, so an illegal or accidental move
    fails with the axis named instead of a silent mislayout.

The move itself is DCP's: a checkpoint holds GLOBAL tensors, and each
process reads the pieces its target DTensors (or plain tensors) need —
no gather to one host. The target is what the target strategy's own
`state_dicts` gives (the layout a fresh run would build), and the
restored dict goes back through its `load_state_dicts`: under the
tensor axis the fused QKV and gate-up rows sit head-aligned in the
model and canonical in every state dict and checkpoint, so a move onto
or off ``tensor`` never reads the permuted rows raw.

The JAX package reads the target mesh from the tree's
``NamedSharding``; here it is the mesh of the target's DTensors, or the
``mesh=`` the caller passes for a target of plain tensors
(`SingleDevice`, `DataParallel`).

A checkpoint WITHOUT provenance has an unknowable writing mesh, so no
cross-mesh move can be validated against it: `reshard_restore` (and the
supervisor's elastic resize) refuse it with a `ReshardError` naming the
gap; `checkpoint.restore_checkpoint` still restores it with no
cross-mesh validation, and the Trainer logs that blind spot.
"""
from __future__ import annotations

import logging
from typing import Any, Dict, Mapping, Optional

log = logging.getLogger(__name__)

__all__ = ["ReshardError", "checkpoint_provenance", "validate_reshard",
           "reshard_restore", "reshard_arrays"]


class ReshardError(RuntimeError):
    """A cross-topology restore that cannot (or must not) proceed:
    missing provenance, contradictory provenance, or a malformed
    target mesh."""


def checkpoint_provenance(path: str) -> Dict[str, Any]:
    """The topology-provenance stamps of a checkpoint's meta
    (``mesh_spec`` / ``topology`` / ``param_specs``); empty dict for a
    legacy checkpoint that carries none."""
    from ray_lightning_tpu_torch.checkpoint.io import read_meta

    meta = read_meta(path)
    return {k: meta[k] for k in ("mesh_spec", "topology", "param_specs")
            if k in meta}


def _live(sizes: Mapping[str, Any]) -> Dict[str, int]:
    return {str(k): int(v) for k, v in sizes.items() if int(v) > 1}


def validate_reshard(meta: Mapping[str, Any],
                     target_mesh: Mapping[str, int]) -> Dict[str, Any]:
    """Validate a move from the checkpoint described by ``meta`` onto a
    mesh with ``target_mesh`` axis sizes. Returns the move summary

        {"from_mesh", "to_mesh", "from_world", "to_world",
         "changed_axes", "world_change"}

    (axes of size 1 drop out on both sides). Raises ReshardError when
    the checkpoint has no provenance, when its provenance is
    self-contradictory, or when the target mesh is malformed. Every
    tensor's global shape is mesh-independent; DCP checks it during the
    restore, so a mesh-level-legal move fails there only if the model
    itself changed."""
    mesh_spec = meta.get("mesh_spec")
    if not mesh_spec:
        raise ReshardError(
            "checkpoint carries no sharding provenance (no mesh_spec in "
            "meta.json — written before elastic/ existed?): a move from "
            "an unknowable writing mesh cannot be validated. Restore it "
            "legacy-style via checkpoint.restore_checkpoint (no "
            "cross-mesh validation), or re-save it once on the current "
            "mesh to stamp provenance, then reshard")
    src = _live(mesh_spec)
    try:
        dst = _live(target_mesh)
    except (TypeError, ValueError) as exc:
        raise ReshardError(
            f"malformed target mesh {target_mesh!r}: {exc}") from exc
    if any(int(v) < 1 for v in dict(target_mesh).values()):
        raise ReshardError(
            f"malformed target mesh {target_mesh!r}: axis sizes must "
            "be >= 1")
    # provenance self-consistency (the checks verify_checkpoint runs): a
    # contradictory stamp would make this validation fiction
    from ray_lightning_tpu_torch.checkpoint.io import _verify_provenance

    ok, reason = _verify_provenance(dict(meta))
    if not ok:
        raise ReshardError(f"checkpoint provenance is invalid: {reason}")
    from_world = 1
    for v in src.values():
        from_world *= v
    to_world = 1
    for v in dst.values():
        to_world *= v
    changed = sorted(set(src) ^ set(dst)
                     | {ax for ax in set(src) & set(dst)
                        if src[ax] != dst[ax]})
    return {
        "from_mesh": src,
        "to_mesh": dst,
        "from_world": from_world,
        "to_world": to_world,
        "changed_axes": changed,
        "world_change": to_world != from_world,
    }


def _leaves(tree: Any):
    if isinstance(tree, Mapping):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _target_mesh_sizes(target: Any) -> Optional[Dict[str, int]]:
    """Axis sizes of the largest `DeviceMesh` among the target's
    DTensors (None when it holds none: a plain-tensor target needs the
    caller's ``mesh=``)."""
    from ray_lightning_tpu_torch.parallel.mesh import mesh_sizes

    best: Optional[Dict[str, int]] = None
    for leaf in _leaves(target):
        mesh = getattr(leaf, "device_mesh", None)
        if mesh is None or not getattr(mesh, "mesh_dim_names", None):
            continue
        sizes = {str(k): int(v) for k, v in mesh_sizes(mesh).items()}
        if best is None or mesh.size() > _world(best):
            best = sizes
    return best


def _world(sizes: Mapping[str, int]) -> int:
    n = 1
    for v in sizes.values():
        n *= int(v)
    return n


def reshard_restore(path: str, target: Any, *, verify: bool = True,
                    mesh: Any = None) -> Any:
    """Restore the checkpoint at ``path`` onto ``target``'s layout — an
    arbitrary mesh-to-mesh move. ``target`` is a state dict (the
    target strategy's `state_dicts`, plus ``step`` and the scheduler's
    state) whose DTensors and tensors give the layout to restore into;
    every entry present — params, optimizer moments and step — reshards
    to its target layout. ``mesh`` (a `DeviceMesh` or ``{axis: size}``)
    names the target mesh when the target holds no DTensor; ``{}`` is
    one device.

    The move is validated against the checkpoint's provenance first
    (`validate_reshard`); ``verify=True`` also runs the completeness and
    digest check, so a torn or corrupt checkpoint never becomes the
    source of a topology change. Collective across the target's group
    (every rank calls it). Returns the restored ``target``, filled in
    place; load it with the strategy's `load_state_dicts`."""
    import os

    from ray_lightning_tpu_torch.checkpoint.io import (
        read_meta,
        restore_checkpoint,
        verify_checkpoint,
    )
    from ray_lightning_tpu_torch.parallel.mesh import mesh_sizes

    path = os.path.abspath(path)
    if verify:
        ok, reason = verify_checkpoint(path)
        if not ok:
            raise ReshardError(
                f"refusing to reshard from invalid checkpoint {path}: "
                f"{reason}")
    sizes = (mesh_sizes(mesh) if mesh is not None
             else _target_mesh_sizes(target))
    if sizes is None:
        raise ReshardError(
            "target state dict holds no DTensor — reshard_restore needs "
            "the target layout: pass mesh= (the target strategy's mesh, "
            "or {} for one device), or use checkpoint.load_checkpoint "
            "for a host copy")
    move = validate_reshard(read_meta(path), sizes)
    log.info("resharding %s: %s -> %s (world %d -> %d, axes %s)",
             path, move["from_mesh"], move["to_mesh"],
             move["from_world"], move["to_world"],
             ",".join(move["changed_axes"]) or "unchanged")
    return restore_checkpoint(path, target)


def reshard_arrays(tree: Any, shardings: Any) -> Any:
    """In-memory mesh-to-mesh move: place an already-loaded tree onto
    new layouts (the checkpoint path is `reshard_restore`).
    ``shardings`` is one ``(DeviceMesh, placements)`` pair for every
    leaf, or a tree of them matching ``tree``; ``None`` makes a leaf a
    whole plain tensor. A DTensor on the same mesh moves with
    ``redistribute``, one on another mesh through its full value
    (`parallel.tensor.full_value`) and ``distribute_tensor``, a plain
    tensor with ``distribute_tensor``.
    Collective across the meshes' groups."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    from ray_lightning_tpu_torch.parallel.tensor import full_value

    def move(leaf, spec):
        if spec is None:
            return full_value(leaf)
        mesh, placements = spec
        placements = tuple(placements)
        if isinstance(leaf, DTensor):
            if leaf.device_mesh == mesh:
                return leaf.redistribute(mesh, placements)
            leaf = full_value(leaf)
        return distribute_tensor(leaf.to(mesh.device_type), mesh, placements)

    def walk(t, s):
        if isinstance(t, Mapping):
            return {k: walk(v, s[k] if _is_tree(s) else s)
                    for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v, s[i] if _is_tree(s) else s)
                           for i, v in enumerate(t))
        return move(t, s)

    return walk(tree, shardings)


def _is_tree(s: Any) -> bool:
    """A tree of specs, as against one ``(mesh, placements)`` pair."""
    if isinstance(s, Mapping):
        return True
    if isinstance(s, list):
        return True
    if isinstance(s, tuple):
        return not (len(s) == 2 and hasattr(s[0], "device_type"))
    return False
