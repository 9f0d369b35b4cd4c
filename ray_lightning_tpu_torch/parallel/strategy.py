"""Distribution strategies (twin of `ray_lightning_tpu/parallel/strategy.py`).

This slice ports the `Strategy` base and `SingleDevice`: one process,
one device. The base binds the device into the module before its model
is built and moves host batches onto it. DataParallel, FSDP, ShardedMesh
and RayXlaPlugin wait for ROADMAP Queue 1 item 4.
"""
from __future__ import annotations

import logging
from typing import Any, Optional

import numpy as np
import torch

from ray_lightning_tpu_torch.utils.devices import DeviceLike, resolve_device

log = logging.getLogger(__name__)


class Strategy:
    """Base strategy. Lifecycle (driven by the Trainer):
        setup(module)      — resolve the device and bind it into the module
        shard_batch(batch) — place a host batch on the device
    """

    def __init__(self, device: DeviceLike = None):
        self._device_arg = device
        self.device: Optional[torch.device] = None

    def setup(self, module=None) -> torch.device:
        self.device = resolve_device(self._device_arg)
        if module is not None:
            self.bind_module(module)
        log.info("strategy=%s device=%s", type(self).__name__, self.device)
        return self.device

    def bind_module(self, module) -> None:
        """Bind before the module builds its model, so it is built on the
        strategy's device."""
        module.device = self.device

    def shard_batch(self, batch: Any) -> Any:
        """A host batch (dict/tuple of numpy arrays or tensors) on the
        device."""
        return _tree_map(self._to_device, batch)

    def _to_device(self, x):
        t = x if isinstance(x, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(x))
        return t.to(self.device, non_blocking=True)


class SingleDevice(Strategy):
    """One device, no sharding. ``device`` defaults to the CUDA card
    (raises without one); pass ``device="cpu"`` for the CPU."""


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)
