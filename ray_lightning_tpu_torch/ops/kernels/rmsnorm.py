"""Fused RMSNorm forward for Hopper (Triton).

Replaces `ray_lightning_tpu/ops/pallas/rmsnorm.py` `_kernel` (driven by
`_rmsnorm_fwd_2d`): ``x * rsqrt(mean(x^2) + eps) * w`` in f32, cast back
to x's dtype.

Bound on the H100: bytes. Per row it reads D activations and writes D
(the gain vector stays in L2), a handful of FLOPs per element, so the
least time is ``(2 * N * D * itemsize + D * 4) / 3.35 TB/s``. Design:
one program per row holds the whole row (D = 4096 at 8B) in registers,
so the activation is read from device memory exactly once and the
normalised row written once; the mean of squares is one in-register
reduction. The kernel source is `rmsnorm_triton.py`, imported only
when a CUDA tensor arrives (this host may have no Triton).

The gradient (`RMSNormFunction`) wraps this forward: its backward is the
port of the JAX package's analytic `_bwd_rule` in plain PyTorch, on the
card too, as the JAX backward is jnp and not a Pallas kernel.
"""
from __future__ import annotations

import torch


def rms_norm_plain(x: torch.Tensor, weight: torch.Tensor,
                   eps: float = 1e-5) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch (f32 reduction)."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * weight.float()).to(x.dtype)


def rms_norm_kernel(x: torch.Tensor, weight: torch.Tensor,
                    eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm over the last axis. CPU tensors run `rms_norm_plain`;
    CUDA tensors launch the Triton kernel or raise."""
    if not x.is_cuda:
        return rms_norm_plain(x, weight, eps)
    d = x.shape[-1]
    if weight.shape != (d,) or weight.device != x.device:
        raise ValueError(
            f"rms_norm: weight {tuple(weight.shape)} on {weight.device} "
            f"does not match x {tuple(x.shape)} on {x.device}")
    if not (x.is_contiguous() and weight.is_contiguous()):
        raise ValueError("rms_norm: x and weight must be contiguous")
    if x.dtype not in (torch.bfloat16, torch.float16, torch.float32):
        raise ValueError(f"rms_norm: unsupported dtype {x.dtype}")
    from ray_lightning_tpu_torch.ops.kernels.rmsnorm_triton import launch

    out = torch.empty_like(x)
    n = x.numel() // d
    if n:
        launch(x.view(n, d), weight, out.view(n, d), eps)
        rms_norm_kernel.launches += 1
    return out


#: launches of the Triton kernel since the last reset
rms_norm_kernel.launches = 0


def rms_norm_bwd(x: torch.Tensor, weight: torch.Tensor, g: torch.Tensor,
                 eps: float = 1e-5):
    """(dx, dw) of `rms_norm_plain` for the cotangent ``g`` (port of
    `ray_lightning_tpu/ops/pallas/rmsnorm.py` `_bwd_rule`): f32 math,
    dx in x's dtype, dw summed over every leading axis in w's dtype."""
    xf, gf, wf = x.float(), g.float(), weight.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    xhat = xf * rstd
    gw = gf * wf
    dx = rstd * (gw - xhat * (gw * xhat).mean(dim=-1, keepdim=True))
    dw = (gf * xhat).reshape(-1, x.shape[-1]).sum(dim=0)
    return dx.to(x.dtype), dw.to(weight.dtype)


class RMSNormFunction(torch.autograd.Function):
    """RMSNorm whose forward is `rms_norm_kernel` (the Triton kernel on a
    CUDA tensor) and whose backward is `rms_norm_bwd` (twin of the
    custom-vjp `_rmsnorm`). The kernel writes into a fresh tensor that
    autograd cannot see through; this function is what gives the norm
    gain its gradient and passes the gradient on to the residual
    stream."""

    @staticmethod
    def forward(ctx, x, weight, eps: float):
        ctx.save_for_backward(x, weight)
        ctx.eps = eps
        return rms_norm_kernel(x, weight, eps)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        dx, dw = rms_norm_bwd(x, weight, g, ctx.eps)
        return dx, dw, None
