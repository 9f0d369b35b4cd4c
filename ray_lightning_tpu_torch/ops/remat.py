"""Selective activation checkpointing of the Llama blocks: the remat
policies "dots" and "attn_out" (twins of the JAX `_remat_policy`:
``dots_with_no_batch_dims_saveable`` and `_attn_residuals_saveable`).

Each block runs under `torch.utils.checkpoint` with a context from
`torch.utils.checkpoint.create_selective_checkpoint_contexts`: the
forward keeps the outputs of the operators its policy names, and the
recomputation in the backward takes those from the cache instead of
running them again. What each policy keeps:

  * "nothing": no operator output; the block input alone is kept and the
    whole block runs again;
  * "dots": the outputs of the projection GEMMs (``aten.mm``, the f32-out
    ``aten.mm.dtype`` of `ops/precision.py`, ``aten.addmm``, and the QKV
    projection inside ``rltt::qkv_rope``), so no projection runs again;
    no batched product (``bmm``) and not the flash forward, which is no
    dot in the JAX package either. The QKV projection is kept as its
    operator's q, k and v, the bytes of the GEMM's output (JAX keeps the
    GEMM's output and runs RoPE again);
  * "attn_out": the attention's residuals, q and k after RoPE, v, O and
    the f32 lse of the flash kernel, and nothing else: the outputs of
    ``rltt::qkv_rope`` and of the flash forward ``rltt::flash_fwd``
    (`ops/kernels/flash.py`), so neither the QKV GEMM, nor RoPE, nor the
    flash forward runs again in the backward, while the norms and the
    MLP do. A layer keeps ``B·S·((2·H + 2·Hkv)·hd·2 + H·4)`` bytes
    beyond its input: the planner's term
    (`parallel.plan.llama_activation_bytes`).

Every training forward of a block runs its QKV projection and RoPE as
the one operator ``rltt::qkv_rope`` (`qkv_rope` below), under any policy
or none, so a policy can keep its outputs.

Operators the hand-written kernels launch through `ctypes` (RMSNorm) are
invisible to the policy and always run again. The recomputation also
keeps the dispatch policy the forward ran under
(`dispatch.checkpoint_context_fn`).
"""
from __future__ import annotations

import contextlib
import functools
from typing import Tuple

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    create_selective_checkpoint_contexts,
)

from ray_lightning_tpu_torch.ops import dispatch
from ray_lightning_tpu_torch.ops.kernels import flash  # noqa: F401 (defines rltt::flash_fwd)
from ray_lightning_tpu_torch.ops.precision import linear_f32_acc
from ray_lightning_tpu_torch.ops.rope import apply_rope

aten = torch.ops.aten


#: ``rltt::qkv_rope``, defined through `torch.library.Library` for the
#: reason `ops/kernels/flash.py` gives for ``rltt::flash_fwd``
_LIB = torch.library.Library("rltt", "FRAGMENT")
_LIB.define("qkv_rope(Tensor h, Tensor w, Tensor cos, Tensor sin, int n_q, "
            "int n_kv, int hd) -> (Tensor, Tensor, Tensor)")


def qkv_rope_op(h: torch.Tensor, w: torch.Tensor, cos: torch.Tensor,
                sin: torch.Tensor, n_q: int, n_kv: int, hd: int
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The block's fused QKV projection ``h @ w.T`` (f32 accumulator,
    one rounding) split into q [B, S, n_q, hd], k and v [B, S, n_kv, hd],
    with RoPE on q and k: the computation of `models.llama.LlamaBlock`'s
    training path, as one operator."""
    return torch.ops.rltt.qkv_rope.default(h, w, cos, sin, n_q, n_kv, hd)


def _qkv_rope_impl(h, w, cos, sin, n_q, n_kv, hd):
    B, S = h.shape[0], h.shape[1]
    qkv = linear_f32_acc(h, w)
    q, k, v = torch.split(qkv, [n_q * hd, n_kv * hd, n_kv * hd], dim=-1)
    q = apply_rope(q.reshape(B, S, n_q, hd), cos, sin)
    k = apply_rope(k.reshape(B, S, n_kv, hd), cos, sin)
    return q.contiguous(), k.contiguous(), v.reshape(B, S, n_kv, hd).clone()


def _qkv_rope_meta(h, w, cos, sin, n_q, n_kv, hd):
    B, S = h.shape[0], h.shape[1]
    return (h.new_empty((B, S, n_q, hd)), h.new_empty((B, S, n_kv, hd)),
            h.new_empty((B, S, n_kv, hd)))


_LIB.impl("qkv_rope", _qkv_rope_impl, "CompositeExplicitAutograd")
_LIB.impl("qkv_rope", _qkv_rope_meta, "Meta")


def _rope_bwd(dy: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
              dtype: torch.dtype) -> torch.Tensor:
    """The gradient of `apply_rope` (a rotation, so its transpose) for
    the cotangent ``dy``, in the f32 arithmetic autograd does for it."""
    c = cos[:dy.shape[-3]].unsqueeze(-2)
    s = sin[:dy.shape[-3]].unsqueeze(-2)
    dy1, dy2 = dy.float().chunk(2, dim=-1)
    return torch.cat([dy1 * c + dy2 * s, dy2 * c - dy1 * s],
                     dim=-1).to(dtype)


class _QKVRope(torch.autograd.Function):
    """``rltt::qkv_rope`` with its gradient: RoPE's transpose, then the
    projection's two GEMMs. Under the tensor axis the input's gradient is
    each rank's f32 partial, summed over the group and rounded once, as
    `parallel.tensor.column_linear`'s."""

    @staticmethod
    def forward(ctx, h, w, cos, sin, n_q, n_kv, hd, tp):
        ctx.save_for_backward(h, w, cos, sin)
        ctx.tp = tp
        return qkv_rope_op(h, w, cos, sin, n_q, n_kv, hd)

    @staticmethod
    def backward(ctx, dq, dk, dv):
        from ray_lightning_tpu_torch.parallel.tensor import (
            _all_reduce,
            _mm_f32_out,
        )

        h, w, cos, sin = ctx.saved_tensors
        B, S = h.shape[0], h.shape[1]
        g = torch.cat([_rope_bwd(dq, cos, sin, h.dtype).reshape(B, S, -1),
                       _rope_bwd(dk, cos, sin, h.dtype).reshape(B, S, -1),
                       dv.reshape(B, S, -1)], dim=-1)
        g2, h2 = g.reshape(B * S, -1), h.reshape(B * S, -1)
        if ctx.tp is None:
            gh = g2.mm(w)
        else:
            gh = _all_reduce(_mm_f32_out(g2, w.t()), ctx.tp).to(h.dtype)
        return (gh.reshape(h.shape), g2.t().mm(h2), None, None, None, None,
                None, None)


def qkv_rope(h: torch.Tensor, w: torch.Tensor, cos: torch.Tensor,
             sin: torch.Tensor, n_q: int, n_kv: int, hd: int,
             tp=None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(q, k, v) of a block, differentiable, through ``rltt::qkv_rope``."""
    return _QKVRope.apply(h, w, cos, sin, n_q, n_kv, hd, tp)


# ---- the policies -----------------------------------------------------------

#: the projection GEMMs (the f32-out overload where this torch has it)
GEMMS = frozenset(op for op in (
    aten.mm.default, getattr(aten.mm, "dtype", None), aten.addmm.default)
    if op is not None)
#: what "dots" keeps: the GEMMs and the QKV projection's operator
DOTS = GEMMS | {torch.ops.rltt.qkv_rope.default}
#: the attention residuals "attn_out" keeps
ATTN_OUT = frozenset((torch.ops.rltt.qkv_rope.default,
                      torch.ops.rltt.flash_fwd.default))


def _saves(ops: frozenset):
    def policy(ctx, func, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if func in ops
                else CheckpointPolicy.PREFER_RECOMPUTE)
    return policy


#: policy name -> the SAC policy function (None: "nothing", no cache)
POLICIES = {"nothing": None, "dots": _saves(DOTS),
            "attn_out": _saves(ATTN_OUT)}


@contextlib.contextmanager
def _both(first, second):
    with first, second:
        yield


def _context_fn(policy: str):
    fwd, pinned = dispatch.checkpoint_context_fn()
    fn = POLICIES[policy]
    if fn is None:
        return fwd, pinned
    caching, cached = create_selective_checkpoint_contexts(fn)
    return caching, _both(pinned, cached)


def checkpoint_context_fn(policy: str = "nothing"):
    """``context_fn`` for `torch.utils.checkpoint` under remat policy
    ``policy``: the selective checkpoint's forward and recomputation
    contexts, the recomputation under the forward's dispatch policy."""
    if policy not in POLICIES:
        raise ValueError(f"remat policy {policy!r} is not one of "
                         f"{sorted(POLICIES)}")
    return functools.partial(_context_fn, policy)

