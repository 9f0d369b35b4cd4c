"""Device throughput probe and public spec-sheet peaks (twin of
`ray_lightning_tpu/utils/probe.py`).

``python -m ray_lightning_tpu_torch --probe`` prints the measured bf16
matmul rate beside the card's spec-sheet peak: far below the peak means
the card is contended or held below its power limit, and model numbers
measured beside it are lower bounds, not capability.
"""
from __future__ import annotations

import time
from typing import Optional

import torch

from ray_lightning_tpu_torch.utils.devices import DeviceLike, resolve_device

#: dense bf16 peak TFLOP/s by `torch.cuda.get_device_name()`: NVIDIA's
#: H100 data sheet, SXM part, without sparsity, at its 700 W limit
PEAK_TFLOPS = {
    "NVIDIA H100 80GB HBM3": 989.0,
}


def device_peak_tflops(name: str) -> Optional[float]:
    """The spec-sheet bf16 peak of the card called ``name``; None for a
    card (or a CPU) the table does not hold."""
    return PEAK_TFLOPS.get(name)


def matmul_tflops(loop_iters: Optional[int] = None,
                  windows: Optional[int] = None,
                  n: Optional[int] = None,
                  device: DeviceLike = None) -> float:
    """Measured bf16 matmul TFLOP/s on ``device`` (the card unless the
    caller asks for the CPU).

    A chain of ``loop_iters`` dependent ``n x n`` products: each waits
    for the one before, so the rate is the card's, not the launch
    queue's. ``b`` holds 1/n in every entry, so the iterate stays
    exactly 1 (no overflow, nothing to fold). The best of ``windows``
    timed chains, each ended by a synchronise, shrugs off contention
    bursts. Defaults: the full probe (n 8192, 64 products, about 70
    TFLOP a window) on a card, a tiny one on the CPU.
    """
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    if loop_iters is None:
        loop_iters = 64 if on_card else 4
    if n is None:
        n = 8192 if on_card else 256
    if windows is None:
        windows = 3 if on_card else 1
    b = torch.full((n, n), 1.0 / n, dtype=torch.bfloat16, device=dev)
    a = torch.ones((n, n), dtype=torch.bfloat16, device=dev)

    def chain() -> float:
        acc = a
        for _ in range(loop_iters):
            acc = acc @ b
        return float(acc[0, 0])  # waits for the chain's end

    chain()  # warm: the library's kernel choice, allocations
    best = float("inf")
    for _ in range(windows):
        t0 = time.perf_counter()
        chain()
        best = min(best, time.perf_counter() - t0)
    return 2 * n**3 * loop_iters / best / 1e12
