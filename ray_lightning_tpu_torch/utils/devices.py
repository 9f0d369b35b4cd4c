"""Device resolution for the port's entry points.

Every entry point (`models.llama.Llama`, `models.llama.init_weights`,
`serve.engine.DecodeEngine`) runs on the CUDA card unless the caller
asks for the CPU. There is no silent fallback: asking for CUDA on a host
without a card raises.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``device`` as a `torch.device`; None means ``"cuda"``. Raises
    when CUDA is asked for and no card is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
