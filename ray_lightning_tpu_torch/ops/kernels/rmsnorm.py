"""Fused RMSNorm forward for Hopper (CUDA C++).

Replaces `ray_lightning_tpu/ops/pallas/rmsnorm.py` `_kernel` (driven by
`_rmsnorm_fwd_2d`): ``x * rsqrt(mean(x^2) + eps) * w`` in f32, cast back
to x's dtype. The kernel (`ops/csrc/rmsnorm.cu`) is bound by bytes, and at
the decode shape by its fixed costs; its design (every load issued before
the reduction, 16-byte vectors with a scalar head and tail, one block a
row) is described in the source.

The gradient (`RMSNormFunction`) wraps this forward: its backward is the
port of the JAX package's analytic `_bwd_rule` in plain PyTorch, on the
card too, as the JAX backward is jnp and not a Pallas kernel.
"""
from __future__ import annotations

import ctypes

import torch

from ray_lightning_tpu_torch.ops import build

#: the kernel's dtype codes
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def rms_norm_plain(x: torch.Tensor, weight: torch.Tensor,
                   eps: float = 1e-5) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch (f32 reduction)."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * weight.float()).to(x.dtype)


def _lib():
    fn = build.load("rmsnorm").rmsnorm_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [
            ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _check_cuda(x: torch.Tensor, weight: torch.Tensor) -> None:
    """Refuse what the kernel does not take: x bf16, f16 or f32; weight
    [D] in x's dtype or f32, on x's device; both contiguous."""
    d = x.shape[-1]
    if weight.shape != (d,) or weight.device != x.device:
        raise ValueError(
            f"rms_norm: weight {tuple(weight.shape)} on {weight.device} "
            f"does not match x {tuple(x.shape)} on {x.device}")
    if not (x.is_contiguous() and weight.is_contiguous()):
        raise ValueError("rms_norm: x and weight must be contiguous")
    if x.dtype not in _DTYPES:
        raise ValueError(f"rms_norm: unsupported dtype {x.dtype}")
    if weight.dtype not in (x.dtype, torch.float32):
        raise ValueError(f"rms_norm: weight dtype {weight.dtype} is neither "
                         f"x's ({x.dtype}) nor float32")


def rms_norm_kernel(x: torch.Tensor, weight: torch.Tensor,
                    eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm over the last axis. CPU tensors run `rms_norm_plain`;
    CUDA tensors launch the CUDA kernel (one launch) or raise."""
    if not x.is_cuda:
        return rms_norm_plain(x, weight, eps)
    _check_cuda(x, weight)
    d = x.shape[-1]
    out = torch.empty_like(x)
    n = x.numel() // d if d else 0
    if n:
        rc = _lib()(x.data_ptr(), weight.data_ptr(), out.data_ptr(), n, d,
                    _DTYPES[x.dtype], _DTYPES[weight.dtype], eps,
                    torch._C._cuda_getCurrentRawStream(x.device.index))
        build.check(rc, "rmsnorm_fwd")
        rms_norm_kernel.launches += 1
    return out


#: wrapper calls that launched the kernel since the last reset
rms_norm_kernel.launches = 0

#: ``rltt::rms_norm``, defined through `torch.library.Library` for the
#: reason `ops/kernels/flash.py` gives for ``rltt::flash_fwd``
_LIB = torch.library.Library("rltt", "FRAGMENT")
_LIB.define("rms_norm(Tensor x, Tensor weight, float eps) -> Tensor")


def rms_norm_op(x: torch.Tensor, weight: torch.Tensor,
                eps: float = 1e-5) -> torch.Tensor:
    """`rms_norm_kernel` as the operator ``rltt::rms_norm``: the kernel on
    CUDA tensors, the plain version on CPU tensors, output shapes only
    on the meta device and under a fake-tensor trace."""
    return torch.ops.rltt.rms_norm.default(x, weight, float(eps))


def _rms_norm_impl(x, weight, eps):
    return rms_norm_kernel(x, weight, eps)


_LIB.impl("rms_norm", _rms_norm_impl, "CompositeExplicitAutograd")
_LIB.impl("rms_norm", lambda x, weight, eps: torch.empty_like(x), "Meta")


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
    """RMSNorm whose forward is `rms_norm_kernel` (the CUDA kernel on a
    CUDA tensor) and whose backward is `rms_norm_bwd` (twin of the
    custom-vjp `_rmsnorm`). The kernel writes into a fresh tensor that
    autograd cannot see through; this function is what gives the norm
    gain its gradient and passes the gradient on to the residual
    stream."""

    @staticmethod
    def forward(ctx, x, weight, eps: float):
        ctx.save_for_backward(x, weight)
        ctx.eps = eps
        return rms_norm_op(x, weight, eps)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        dx, dw = rms_norm_bwd(x, weight, g, ctx.eps)
        return dx, dw, None
