"""Mixed-precision linears (twin of `ray_lightning_tpu/ops/precision.py`).

The single-rounding contract: matmul operands stay narrow (bf16), the
accumulator is f32, and the result is rounded at most once, after the
full contraction. Two shapes of it:

  * `linear_f32_acc` — ``f32_acc_dot_general``: f32 accumulator, output
    rounded once back to the operand dtype.
  * `linear_f32_out` — ``f32_out_dot_general`` (the vocab projection):
    the output KEEPS the f32 accumulator, so sampling runs on unrounded
    logits.

Both stay library matmuls, as the JAX package leaves them to XLA.
Weights use the `nn.Linear` layout ``[out, in]``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


#: does this torch have the f32-out GEMM (``torch.mm(..., out_dtype=)``)?
_MM_OUT_DTYPE = hasattr(torch.ops.aten.mm, "dtype")


def pin_f32_accumulation() -> None:
    """cuBLAS may otherwise reduce a bf16 GEMM's split-K partial sums in
    bf16 (``allow_bf16_reduced_precision_reduction`` defaults to True),
    which rounds inside the contraction and breaks the contract."""
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
        False


def linear_f32_acc(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w.T`` with an f32 accumulator, rounded once to x's dtype."""
    return F.linear(x, w)


def _mm_f32_out(x2: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    if x2.is_cuda and x2.dtype != torch.float32 and _MM_OUT_DTYPE:
        return torch.mm(x2, w.t(), out_dtype=torch.float32)
    return torch.mm(x2.float(), w.float().t())


class _LinearF32Out(torch.autograd.Function):
    """The f32-out GEMM with its gradient. The f32 cotangent is rounded to
    the operands' dtype for the two backward GEMMs (bf16 in, f32
    accumulate, one rounding out), as a TPU's default-precision dot takes
    an f32 operand; in f32 every step is exact, as in the JAX backward."""

    @staticmethod
    def forward(ctx, x2, w):
        ctx.save_for_backward(x2, w)
        return _mm_f32_out(x2, w)

    @staticmethod
    def backward(ctx, g):
        x2, w = ctx.saved_tensors
        gn = g.to(x2.dtype)
        return torch.mm(gn, w.to(x2.dtype)), torch.mm(gn.t(), x2).to(w.dtype)


def linear_f32_out(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w.T`` from narrow operands, returned as the f32
    accumulator. On CUDA this is one GEMM with ``out_dtype=float32``
    (``aten::mm.dtype``, where the installed torch has it); elsewhere
    the f32 product of the operands as given, which is the same sum:
    the operands are already rounded to their dtype."""
    out = _LinearF32Out.apply(x.reshape(-1, x.shape[-1]), w)
    return out.reshape(*x.shape[:-1], w.shape[0])
