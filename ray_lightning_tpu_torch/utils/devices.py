"""Device resolution for the port's entry points.

Every entry point (`models.llama.Llama`, `models.llama.init_weights`,
`serve.engine.DecodeEngine`, the strategies) runs on the CUDA card unless
the caller asks for the CPU. There is no silent fallback: asking for
CUDA on a host without a card raises.
"""
from __future__ import annotations

import os
from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]

#: a process's index among the processes of its host (set by
#: `runtime.launch` in every worker)
LOCAL_RANK_ENV = "LOCAL_RANK"


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``device`` as a `torch.device`; None means ``"cuda"``. Raises
    when CUDA is asked for and no card is present. ``"meta"`` (shapes
    without storage: the planner, the sharded init) is accepted and
    touches no device."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def local_rank() -> int:
    return int(os.environ.get(LOCAL_RANK_ENV, 0))


def rank_device(device: DeviceLike = None, rank: int = None,
                num_processes: int = 1) -> torch.device:
    """The device of one process among ``num_processes`` on this host:
    ``cuda:<rank>`` (``rank`` defaults to the process's local rank), or
    the CPU when ``device="cpu"``. One process drives one card, so asking
    for more processes than cards raises."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return dev
    n_cards = torch.cuda.device_count()
    if num_processes > n_cards:
        raise ValueError(
            f"num_workers > devices: {num_processes} processes asked for "
            f"and {n_cards} CUDA device(s) present (one process drives one "
            "card)")
    if dev.index is not None:
        return dev
    return torch.device("cuda", local_rank() if rank is None else rank)
