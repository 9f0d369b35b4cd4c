"""Training state (twin of `ray_lightning_tpu/core/state.py`).

The JAX state is one donated pytree of arrays; here the parameters live
in the model and are updated in place by the optimizer, so the state
holds the objects that evolve across steps.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
from torch import nn


@dataclasses.dataclass
class TrainState:
    """``step`` counts optimizer updates; ``scheduler`` is the learning
    rate schedule stepped once per update (None when the module gives
    none)."""

    step: int
    model: nn.Module
    optimizer: Optional[torch.optim.Optimizer] = None
    scheduler: Optional[Any] = None

    @property
    def params(self) -> Dict[str, nn.Parameter]:
        return dict(self.model.named_parameters())
