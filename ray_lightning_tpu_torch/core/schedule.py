"""A learning-rate schedule whose position lives on the device.

torch's `LambdaLR` counts its updates on the host and writes a float lr
into the optimizer: the schedule advances on every update, kept or not.
`DeviceLambdaLR` keeps the count as a device tensor and writes a tensor
lr that fused optimizers read on the device, and an update the optimizer
skips through its ``found_inf`` flag (the trainguard's skip, or
`GradScaler`'s) does not advance it: the next update gets the lr the
skipped one would have had, with no host sync. It has `LambdaLR`'s
semantics otherwise: update ``k`` (0-based) runs at
``base_lr * lr_lambda(k)``, and its state dict holds ``last_epoch``.
"""
from __future__ import annotations

from typing import Callable, List

import torch


class DeviceLambdaLR:
    """``lr_lambda`` maps the count (an int64 device scalar) to the lr
    multiplier as a device tensor, in torch ops. Every param group's lr
    must be a tensor (``lr=torch.tensor(...)``, which fused optimizers
    accept); its value at construction is the group's base lr."""

    def __init__(self, optimizer: torch.optim.Optimizer,
                 lr_lambda: Callable[[torch.Tensor], torch.Tensor]):
        lrs = [g["lr"] for g in optimizer.param_groups]
        if not all(isinstance(lr, torch.Tensor) for lr in lrs):
            raise ValueError("DeviceLambdaLR needs a tensor lr in every "
                             "param group (lr=torch.tensor(...))")
        self.optimizer = optimizer
        self.lr_lambda = lr_lambda
        self.base_lrs = [float(lr) for lr in lrs]
        self._count = torch.zeros((), dtype=torch.int64,
                                  device=lrs[0].device)
        self._apply()

    def _apply(self) -> None:
        factor = self.lr_lambda(self._count)
        for group, base in zip(self.optimizer.param_groups, self.base_lrs):
            lr = group["lr"]
            lr.copy_((base * factor).to(lr.dtype))

    def step(self) -> None:
        """After ``optimizer.step()``: advance unless the optimizer
        skipped its update."""
        found_inf = getattr(self.optimizer, "found_inf", None)
        if found_inf is None:
            self._count += 1
        else:
            self._count += (1 - found_inf).to(torch.int64)
        self._apply()

    @property
    def last_epoch(self) -> int:
        """The count of updates taken (a host read)."""
        return int(self._count)

    def get_last_lr(self) -> List[float]:
        return [float(g["lr"]) for g in self.optimizer.param_groups]

    def state_dict(self) -> dict:
        return {"last_epoch": self._count}

    def load_state_dict(self, state: dict) -> None:
        self._count.copy_(torch.as_tensor(state["last_epoch"]))
        self._apply()
