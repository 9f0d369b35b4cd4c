"""Normalization ops (twin of `ray_lightning_tpu/ops/norms.py`).

`rms_norm` on a CUDA tensor always runs the hand-written Triton kernel
(`ops/kernels/rmsnorm.py`); the plain PyTorch version runs on the CPU
only. The reduction is done in float32 even for bf16 activations.
"""
from __future__ import annotations

import torch

from ray_lightning_tpu_torch.ops.kernels.rmsnorm import rms_norm_kernel


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """y = x / rms(x) * weight, reducing over the last axis in f32."""
    return rms_norm_kernel(x, weight, eps)
