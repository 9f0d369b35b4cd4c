"""Fused (chunked) cross-entropy: the lm_head projection and the token
loss without the full [B, S, V] logits (twin of
`ray_lightning_tpu/ops/fused_ce.py`, default path).

At Llama-3-8B's vocabulary (V = 128256) the f32 logits of a 4096-token
step would take 2 GB; here the tokens are cut into chunks of C, each
chunk's [C, V] f32 logits tile is computed, reduced to per-token losses
and dropped, and `torch.utils.checkpoint` recomputes the tile in the
backward (the twin of `jax.checkpoint` on the scan body), so the live
logits memory is O(C·V) in both passes. The tile is one GEMM from
``compute_dtype`` operands that keeps its f32 accumulator
(`ops.precision.linear_f32_out`). The lm_head weight's gradient sums over
the chunks in ``compute_dtype``, as the JAX default path's does.

Under the mesh's ``tensor`` axis the lm_head is split by vocabulary
(`vocab_parallel_cross_entropy_sum`): each rank computes its ``[C, V/tp]``
f32 logits tile, the log-sum-exp comes from an all-reduced max and
sum of exponentials, the target logit from a masked gather summed over
the group, and the hidden states' gradient is each rank's f32 partial,
all-reduced in f32 and rounded once. The chunking and the recompute
are the same.

The inline-backward variant (``inline_backward=True``, twin of the JAX
`_ce_inline`): the loss is the root of the graph and its gradient is
linear in the upstream cotangent, so under grad the forward's chunk loop
computes, from the tile already live, each chunk's loss, ``dx`` and the
f32 ``dW`` accumulator, with the ``1 / denominator`` normalisation known
before the loop; the backward only scales both by the cotangent. No
logits tile is built twice, for a ``[V, D]`` residual in the weight's
dtype. Without grad it is the plain chunked loss. The mask takes no
gradient on this path (a mask that asks for one is refused). Under the
tensor axis each rank keeps its vocabulary slice of ``dW`` and ``dx`` is
the f32 sum over the group, rounded once.

This is XLA code in the JAX package, not a Pallas kernel, so it stays
plain torch here.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from ray_lightning_tpu_torch.ops.precision import _mm_f32_out, linear_f32_out


def _chunk_loss(x_c: torch.Tensor, t_c: torch.Tensor,
                w: torch.Tensor) -> torch.Tensor:
    """Per-token CE of one chunk, [C] f32, from its [C, V] logits tile."""
    logits = linear_f32_out(x_c, w)
    lse = torch.logsumexp(logits, dim=-1)
    tgt = logits.gather(-1, t_c[:, None]).squeeze(-1)
    return lse - tgt


def _prep_chunks(hidden, targets, mask, chunk_tokens, compute_dtype):
    """Flatten, cast and pad to whole chunks with zero-weight rows (twin
    of `_prep_chunks`; never one giant tile for an awkward token count).
    Returns (x [T + pad, D], t, m, n_chunks, C)."""
    B, S, D = hidden.shape
    T = B * S
    x = hidden.reshape(T, D).to(compute_dtype)
    t = targets.reshape(T).long()
    m = (torch.ones(T, dtype=torch.float32, device=hidden.device)
         if mask is None else mask.reshape(T).float())
    C = min(max(1, chunk_tokens), T)
    pad = (-T) % C
    if pad:
        x = torch.cat([x, x.new_zeros(pad, D)])
        t = torch.cat([t, t.new_zeros(pad)])
        m = torch.cat([m, m.new_zeros(pad)])
    return x, t, m, (T + pad) // C, C


def fused_cross_entropy(
    hidden: torch.Tensor,
    lm_head: torch.Tensor,
    targets: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    chunk_tokens: int = 1024,
    compute_dtype: torch.dtype = torch.bfloat16,
    inline_backward: bool = False,
) -> torch.Tensor:
    """Mean token CE of ``hidden @ lm_head.T`` against ``targets``.

    hidden:  [B, S, D] final-norm'd activations.
    lm_head: [V, D], the `nn.Linear` layout of the port's weights (the
             transpose of the JAX [D, V] kernel).
    targets: [B, S] int labels; mask: optional [B, S] 0/1 weights.

    Returns the scalar f32 loss, weighted by the mask. ``inline_backward``
    computes the gradients inside the forward's chunk loop
    (`inline_cross_entropy`).
    """
    if inline_backward:
        return inline_cross_entropy(hidden, lm_head, targets, mask, None,
                                    chunk_tokens, compute_dtype)
    loss_sum, count = fused_cross_entropy_sum(
        hidden, lm_head, targets, mask, chunk_tokens, compute_dtype)
    return loss_sum / torch.clamp_min(count, 1.0)


def fused_cross_entropy_sum(
    hidden: torch.Tensor,
    lm_head: torch.Tensor,
    targets: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    chunk_tokens: int = 1024,
    compute_dtype: torch.dtype = torch.bfloat16,
):
    """(sum of the mask-weighted token losses, sum of the mask), both f32
    scalars: `fused_cross_entropy` before its division, for a caller whose
    denominator spans more than this batch (data-parallel ranks)."""
    x, t, m, n_chunks, C = _prep_chunks(hidden, targets, mask, chunk_tokens,
                                        compute_dtype)
    w = lm_head.to(compute_dtype)
    grad = torch.is_grad_enabled()
    loss_sum = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(n_chunks):
        x_c, t_c = x[i * C:(i + 1) * C], t[i * C:(i + 1) * C]
        losses = (checkpoint(_chunk_loss, x_c, t_c, w, use_reentrant=False)
                  if grad else _chunk_loss(x_c, t_c, w))
        loss_sum = loss_sum + (losses * m[i * C:(i + 1) * C]).sum()
    return loss_sum, m.sum()


# ---- the inline backward -----------------------------------------------------


def _inline_tile(x_c, t_c, m_c, w, inv, tp):
    """One chunk's (loss sum, dlogits in w's dtype) from its logits tile:
    ``(softmax - onehot) * m / denominator``, the onehot subtracted at
    each row's target (this rank's vocabulary slice under ``tp``)."""
    logits = _mm_f32_out(x_c, w)
    rows = torch.arange(x_c.shape[0], device=x_c.device)
    if tp is None:
        lse = torch.logsumexp(logits, dim=-1)
        tgt = logits[rows, t_c]
        idx, inside = t_c, None
    else:
        import torch.distributed as dist

        from ray_lightning_tpu_torch.parallel.tensor import _all_reduce

        mx = logits.amax(dim=-1)
        _all_reduce(mx, tp, dist.ReduceOp.MAX)
        sumexp = _all_reduce(torch.exp(logits - mx[:, None]).sum(dim=-1), tp)
        lse = torch.log(sumexp) + mx
        n = w.shape[0]
        idx = t_c - tp.rank * n
        inside = (idx >= 0) & (idx < n)
        idx = idx.clamp(0, n - 1)
        tgt = _all_reduce(logits[rows, idx] * inside.to(logits.dtype), tp)
    loss = ((lse - tgt) * m_c).sum()
    p = torch.exp(logits - lse[:, None])
    hit = (torch.ones_like(lse) if inside is None
           else inside.to(p.dtype))
    p.index_put_((rows, idx), -hit, accumulate=True)
    return loss, (p * (m_c * inv)[:, None]).to(w.dtype)


class _InlineCE(torch.autograd.Function):
    """The chunked CE whose forward also computes the gradients for a
    cotangent of 1 (twin of `_ce_inline_fwd`); the backward scales them."""

    @staticmethod
    def forward(ctx, hidden, lm_head, targets, m, denominator, chunk_tokens,
                compute_dtype, tp):
        B, S, D = hidden.shape
        T = B * S
        x, t, mm, n_chunks, C = _prep_chunks(hidden, targets, m,
                                             chunk_tokens, compute_dtype)
        w = lm_head.to(compute_dtype)
        inv = 1.0 / denominator
        dw = torch.zeros(w.shape, dtype=torch.float32, device=w.device)
        loss = torch.zeros((), dtype=torch.float32, device=hidden.device)
        dx = []
        for i in range(n_chunks):
            sl = slice(i * C, (i + 1) * C)
            loss_c, dlogits = _inline_tile(x[sl], t[sl], mm[sl], w, inv, tp)
            loss = loss + loss_c
            dx_c = _mm_f32_out(dlogits, w.t())
            if tp is not None:
                from ray_lightning_tpu_torch.parallel.tensor import (
                    _all_reduce,
                )

                _all_reduce(dx_c, tp)
            dx.append(dx_c.to(hidden.dtype))
            dw += _mm_f32_out(dlogits.t(), x[sl].t())
        dx = torch.cat(dx)[:T].reshape(B, S, D)
        ctx.save_for_backward(dx, dw.to(lm_head.dtype))
        return loss * inv

    @staticmethod
    def backward(ctx, g):
        dx, dw = ctx.saved_tensors
        return (dx * g.to(dx.dtype), dw * g.to(dw.dtype), None, None, None,
                None, None, None)


def inline_cross_entropy(hidden, lm_head, targets, mask, denominator=None,
                         chunk_tokens: int = 1024,
                         compute_dtype: torch.dtype = torch.bfloat16,
                         tp=None) -> torch.Tensor:
    """The mask-weighted sum of the token losses over ``denominator`` (an
    f32 device scalar; default the mask's sum, at least 1), its gradients
    computed inside the forward's chunk loop when gradients are on
    (``_InlineCE``), else the plain chunked loss. ``lm_head`` [V, D], or
    this rank's vocabulary rows under the tensor group ``tp``."""
    if denominator is None:
        count = (torch.tensor(float(targets.numel()), device=hidden.device)
                 if mask is None else mask.float().sum())
        denominator = torch.clamp_min(count, 1.0)
    if mask is not None and mask.requires_grad:
        raise ValueError("inline_backward gives the mask no gradient; "
                         "detach it or use the default path")
    if not (torch.is_grad_enabled()
            and (hidden.requires_grad or lm_head.requires_grad)):
        if tp is None:
            loss_sum, _ = fused_cross_entropy_sum(
                hidden, lm_head, targets, mask, chunk_tokens, compute_dtype)
        else:
            loss_sum, _ = vocab_parallel_cross_entropy_sum(
                hidden, lm_head, targets, tp, mask, chunk_tokens,
                compute_dtype)
        return loss_sum / denominator
    m = (torch.ones(targets.shape, dtype=torch.float32,
                    device=hidden.device)
         if mask is None else mask.float())
    return _InlineCE.apply(hidden, lm_head, targets, m,
                           denominator.detach().float(), chunk_tokens,
                           compute_dtype, tp)


# ---- the vocab-parallel loss (the mesh's tensor axis) ------------------------


class _VocabTile(torch.autograd.Function):
    """One chunk's local logits tile ``x @ w.T`` [C, V/tp] in f32 (the
    twin of `ops.precision.linear_f32_out`); the backward sums the
    hidden rows' f32 partials over the tensor group and rounds once."""

    @staticmethod
    def forward(ctx, x, w, tp):
        ctx.save_for_backward(x, w)
        ctx.tp = tp
        return _mm_f32_out(x, w)

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist

        x, w = ctx.saved_tensors
        gn = g.to(x.dtype)
        gx = _mm_f32_out(gn, w.t())
        dist.all_reduce(gx, group=ctx.tp.group)
        return gx.to(x.dtype), torch.mm(gn.t(), x).to(w.dtype), None


def _vocab_parallel_chunk_loss(x_c, t_c, w, tp):
    """Per-token CE of one chunk, [C] f32, from its local logits tile."""
    import torch.distributed as dist

    from ray_lightning_tpu_torch.parallel.tensor import reduce_from

    logits = _VocabTile.apply(x_c, w, tp)
    m = logits.detach().amax(dim=-1)
    dist.all_reduce(m, op=dist.ReduceOp.MAX, group=tp.group)
    sumexp = reduce_from(torch.exp(logits - m[:, None]).sum(dim=-1), tp)
    lse = torch.log(sumexp) + m
    n = w.shape[0]
    idx = t_c - tp.rank * n
    inside = (idx >= 0) & (idx < n)
    tgt = logits.gather(-1, idx.clamp(0, n - 1)[:, None]).squeeze(-1)
    tgt = reduce_from(tgt * inside.to(tgt.dtype), tp)
    return lse - tgt


def vocab_parallel_cross_entropy_sum(
    hidden: torch.Tensor,
    lm_head: torch.Tensor,
    targets: torch.Tensor,
    tp,
    mask: Optional[torch.Tensor] = None,
    chunk_tokens: int = 1024,
    compute_dtype: torch.dtype = torch.bfloat16,
    checkpointed: bool = True,
):
    """`fused_cross_entropy_sum` with ``lm_head`` this rank's vocabulary
    rows [V/tp, D] (rank r holds ids ``[r * V/tp, (r + 1) * V/tp)``) and
    ``hidden`` the same on every rank of the tensor group ``tp``
    (`parallel.tensor.TensorParallel`). ``checkpointed=False`` with
    ``chunk_tokens`` at least the token count is the materialized
    logits' loss (`models.llama.token_loss_sum`), split by vocabulary."""
    x, t, m, n_chunks, C = _prep_chunks(hidden, targets, mask, chunk_tokens,
                                        compute_dtype)
    w = lm_head.to(compute_dtype)
    remat = checkpointed and torch.is_grad_enabled()
    loss_sum = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(n_chunks):
        x_c, t_c = x[i * C:(i + 1) * C], t[i * C:(i + 1) * C]
        losses = (checkpoint(_vocab_parallel_chunk_loss, x_c, t_c, w, tp,
                             use_reentrant=False)
                  if remat else _vocab_parallel_chunk_loss(x_c, t_c, w, tp))
        loss_sum = loss_sum + (losses * m[i * C:(i + 1) * C]).sum()
    return loss_sum, m.sum()
