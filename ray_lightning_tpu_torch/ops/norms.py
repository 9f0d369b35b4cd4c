"""Normalization ops (twin of `ray_lightning_tpu/ops/norms.py`).

`rms_norm` on a CUDA tensor runs the hand-written CUDA kernel
(`ops/kernels/rmsnorm.py`) through `RMSNormFunction`, whose backward is
the JAX package's analytic rule; on a CPU tensor the same function runs
the kernel's plain version. Under `dispatch.force_reference` it is the
plain PyTorch version, differentiated by autograd. The reduction is done
in float32 even for bf16 activations.
"""
from __future__ import annotations

import torch

from ray_lightning_tpu_torch.ops import dispatch
from ray_lightning_tpu_torch.ops.kernels.rmsnorm import (
    RMSNormFunction,
    rms_norm_plain,
)


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """y = x / rms(x) * weight, reducing over the last axis in f32."""
    if dispatch.reference_forced():
        return rms_norm_plain(x, weight, eps)
    return RMSNormFunction.apply(x, weight, eps)
