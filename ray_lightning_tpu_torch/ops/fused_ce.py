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

This is XLA code in the JAX package, not a Pallas kernel, so it stays
plain torch here. The inline-backward variant (`_ce_inline`) is not
ported yet (ROADMAP Queue 1 item 3).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from ray_lightning_tpu_torch.ops.precision import linear_f32_out


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

    Returns the scalar f32 loss, weighted by the mask.
    """
    if inline_backward:
        raise NotImplementedError(
            "fused_cross_entropy(inline_backward=True) is not ported yet "
            "(ROADMAP Queue 1 item 3: the _ce_inline custom backward)")
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
    return loss_sum / torch.clamp_min(m.sum(), 1.0)
