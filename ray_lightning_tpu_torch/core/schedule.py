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

import math
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


def warmup_cosine_decay(step, init_value: float, peak_value: float,
                        warmup_steps: int, decay_steps: int,
                        end_value: float = 0.0):
    """optax's ``warmup_cosine_decay_schedule`` at ``step``: linear from
    ``init_value`` to ``peak_value`` over ``warmup_steps``, then a cosine
    to ``end_value`` at ``decay_steps`` (counted from step 0, warmup
    included), flat after. ``step`` an int gives a float; a device
    tensor gives an f64 device tensor, computed there (no host read)."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    span = decay_steps - warmup_steps
    if isinstance(step, torch.Tensor):
        s = step.double()
        warm = init_value + (peak_value - init_value) * s / max(
            warmup_steps, 1)
        t = torch.clamp(s - warmup_steps, max=span)
        cosine = 0.5 * (1 + torch.cos(math.pi * t / span))
        return torch.where(s < warmup_steps, warm,
                           peak_value * ((1 - alpha) * cosine + alpha))
    if step < warmup_steps:
        return init_value + (peak_value - init_value) * step / warmup_steps
    t = min(step - warmup_steps, span)
    cosine = 0.5 * (1 + math.cos(math.pi * t / span))
    return peak_value * ((1 - alpha) * cosine + alpha)


def scheduled(optimizer: torch.optim.Optimizer, schedule: Callable,
              peak_lr: float) -> DeviceLambdaLR:
    """A `DeviceLambdaLR` that runs ``optimizer`` (built with the tensor
    lr ``peak_lr``) at ``schedule(step)``, a function of the device step
    count (`warmup_cosine_decay` with its constants bound)."""

    def factor(step: torch.Tensor) -> torch.Tensor:
        if not peak_lr:
            return torch.zeros((), dtype=torch.float64, device=step.device)
        return schedule(step) / peak_lr

    return DeviceLambdaLR(optimizer, factor)
