"""The Triton source of the RMSNorm kernel (see `rmsnorm.py`).

This module imports Triton at the top, so only `rmsnorm.rms_norm_kernel`
imports it, at its first launch on a CUDA tensor.
"""
from __future__ import annotations

import torch
import triton
import triton.language as tl


@triton.jit
def _rmsnorm_fwd(x_ptr, w_ptr, o_ptr, D, eps, BLOCK: tl.constexpr):
    row = tl.program_id(0).to(tl.int64)
    offs = tl.arange(0, BLOCK)
    mask = offs < D
    x = tl.load(x_ptr + row * D + offs, mask=mask, other=0.0)
    x = x.to(tl.float32)
    var = tl.sum(x * x, axis=0) / D
    rstd = tl.rsqrt(var + eps)
    w = tl.load(w_ptr + offs, mask=mask, other=0.0).to(tl.float32)
    y = x * rstd * w
    tl.store(o_ptr + row * D + offs, y.to(o_ptr.dtype.element_ty),
             mask=mask)


def launch(x2: torch.Tensor, w: torch.Tensor, out2: torch.Tensor,
           eps: float) -> None:
    """One program per row of ``x2 [N, D]`` on the current stream."""
    n, d = x2.shape
    block = triton.next_power_of_2(d)
    num_warps = 8 if block >= 2048 else 4
    _rmsnorm_fwd[(n,)](x2, w, out2, d, eps, BLOCK=block,
                       num_warps=num_warps)
