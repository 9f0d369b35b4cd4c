"""Tensor (Megatron) parallelism over the mesh's ``tensor`` axis.

The JAX package states the tensor split as PartitionSpecs and GSPMD
inserts the collectives. Here each rank runs its own shards of the
weights and the collectives are explicit autograd functions over the
tensor group, so autograd sees every one of them:

  * `column_linear` — a column-parallel projection (its output features
    split over the ranks) of a replicated input: identity forward; the
    input's gradient is each rank's f32 partial, all-reduced in f32 and
    rounded once (Megatron's "f");
  * `row_linear` — a row-parallel projection (its input features split):
    the f32 partial products all-reduced in f32 and rounded once, so the
    output keeps the single rounding of the one-card
    `ops.precision.linear_f32_acc` (Megatron's "g");
  * `reduce_from` — an all-reduce forward, identity backward (the
    vocab-split embedding and cross-entropy sums);
  * `vocab_parallel_embedding` — a masked local lookup, then a sum;
  * `vocab_parallel_logits` — the vocab-split head's f32 logits gathered
    over the ranks; the backward takes this rank's slice of their
    gradient, and sums the input's f32 partials before one rounding.

Each takes ``tp=None`` off the tensor axis and is then the one-card
operation (`ops.precision.linear_f32_acc`, a plain lookup,
`ops.precision.linear_f32_out`), so the model has one forward for both.

The fused weights are not head-aligned (``wqkv`` is q|k|v along its
rows, ``w_gate_up`` gate|up), so a plain row split would hand one rank
only q heads. `fused_row_permutation` orders such a weight's rows
rank-major ([q_0 k_0 v_0 | q_1 k_1 v_1 | ...]) before the split: each
rank's contiguous block holds its own q heads, its KV groups and its own
gate and up columns. The strategy applies it once at wrap and undoes it
in the state dict (`parallel.strategy.ShardedMesh`), so checkpoints and
``state_dict()`` keep the canonical layout.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence

import torch

from ray_lightning_tpu_torch.ops.precision import (
    _mm_f32_out,
    linear_f32_acc,
    linear_f32_out,
)


@dataclasses.dataclass(frozen=True)
class TensorParallel:
    """A rank's place in its tensor group."""

    group: Any
    size: int
    rank: int


def _all_reduce(t: torch.Tensor, tp: TensorParallel, op=None) -> torch.Tensor:
    import torch.distributed as dist

    dist.all_reduce(t, op=op or dist.ReduceOp.SUM, group=tp.group)
    return t


def local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard (differentiable), or ``t`` itself."""
    return t.to_local() if hasattr(t, "to_local") else t


class _ColumnLinear(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, tp):
        ctx.save_for_backward(x, w)
        ctx.tp = tp
        return linear_f32_acc(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g2 = g.reshape(-1, g.shape[-1])
        x2 = x.reshape(-1, x.shape[-1])
        gx = _all_reduce(_mm_f32_out(g2, w.t()), ctx.tp).to(x.dtype)
        gw = torch.mm(g2.t(), x2)
        return gx.reshape(x.shape), gw, None


class _RowLinear(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, tp):
        ctx.save_for_backward(x, w)
        x2 = x.reshape(-1, x.shape[-1])
        out = _all_reduce(_mm_f32_out(x2, w), tp).to(x.dtype)
        return out.reshape(*x.shape[:-1], w.shape[0])

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g2 = g.reshape(-1, g.shape[-1])
        x2 = x.reshape(-1, x.shape[-1])
        return (torch.mm(g2, w).reshape(x.shape), torch.mm(g2.t(), x2),
                None)


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        return _all_reduce(x.clone(), tp)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherLogits(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, tp):
        import torch.distributed as dist

        ctx.save_for_backward(x, w)
        ctx.tp = tp
        part = _mm_f32_out(x.reshape(-1, x.shape[-1]), w)
        parts = [torch.empty_like(part) for _ in range(tp.size)]
        dist.all_gather(parts, part, group=tp.group)
        return torch.cat(parts, dim=-1).reshape(*x.shape[:-1], -1)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        n = w.shape[0]
        g2 = g.reshape(-1, g.shape[-1])[:, ctx.tp.rank * n:
                                        (ctx.tp.rank + 1) * n]
        # the f32 cotangent rounded to the operands' dtype, as the
        # one-card `linear_f32_out` backward does
        gn = g2.to(x.dtype)
        x2 = x.reshape(-1, x.shape[-1])
        gx = _all_reduce(_mm_f32_out(gn, w.t()), ctx.tp).to(x.dtype)
        return gx.reshape(x.shape), torch.mm(gn.t(), x2).to(w.dtype), None


def column_linear(x: torch.Tensor, w: torch.Tensor,
                  tp: Optional[TensorParallel] = None) -> torch.Tensor:
    """``x @ w.T`` for a replicated ``x`` and this rank's output rows
    ``w`` [out/tp, in]; the input's gradient is summed over the group in
    f32 and rounded once."""
    if tp is None:
        return linear_f32_acc(x, w)
    return _ColumnLinear.apply(x, w, tp)


def row_linear(x: torch.Tensor, w: torch.Tensor,
               tp: Optional[TensorParallel] = None) -> torch.Tensor:
    """``x @ w.T`` summed over the group, for this rank's input columns
    ``x`` [..., in/tp] and ``w`` [out, in/tp]: the f32 partials are
    all-reduced in f32 and rounded once to ``x.dtype``."""
    if tp is None:
        return linear_f32_acc(x, w)
    return _RowLinear.apply(x, w, tp)


def reduce_from(x: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    """The sum of ``x`` over the group (identity backward: what follows is
    computed alike on every rank)."""
    return _ReduceFrom.apply(x, tp)


def vocab_parallel_embedding(tokens: torch.Tensor, table: torch.Tensor,
                             tp: Optional[TensorParallel] = None
                             ) -> torch.Tensor:
    """Rows of a vocab-split table (this rank holds ids ``[rank * V/tp,
    (rank + 1) * V/tp)``): a masked local lookup summed over the group.
    Exactly one rank contributes each row, so the sum is the row."""
    if tp is None:
        return table[tokens.long()]
    n = table.shape[0]
    idx = tokens.long() - tp.rank * n
    inside = (idx >= 0) & (idx < n)
    rows = table[idx.clamp(0, n - 1)] * inside[..., None].to(table.dtype)
    return reduce_from(rows, tp)


def vocab_parallel_logits(x: torch.Tensor, w: torch.Tensor,
                          tp: Optional[TensorParallel] = None
                          ) -> torch.Tensor:
    """The f32 logits ``x @ w.T`` [..., V] of a replicated ``x`` and this
    rank's vocabulary rows ``w`` [V/tp, in], every rank's slice gathered.
    Differentiable: each rank's head gets its slice's gradient, and the
    input's gradient is the f32 sum over the group, rounded once."""
    if tp is None:
        return linear_f32_out(x, w)
    return _GatherLogits.apply(x.contiguous(), w, tp)


def fused_row_permutation(parts: Sequence[int], tp: int) -> torch.Tensor:
    """The row order that makes a weight fused from ``parts`` (row counts,
    each divisible by ``tp``) split head-aligned: rank-major, each rank's
    share of every part in turn. ``full[perm]`` is the wrapped layout,
    ``layout[argsort(perm)]`` the canonical one."""
    starts = [sum(parts[:i]) for i in range(len(parts))]
    order = []
    for r in range(tp):
        for start, n in zip(starts, parts):
            k = n // tp
            order.append(torch.arange(start + r * k, start + (r + 1) * k))
    return torch.cat(order)


def local_piece(full: torch.Tensor, mesh, placements) -> torch.Tensor:
    """This rank's part of ``full`` under a DTensor's ``placements`` on
    ``mesh``, with ``torch.chunk``'s uneven split (DTensor's and FSDP2's):
    the plain shards in mesh order, then FSDP2's strided shards (a
    ``_StridedShard`` splits what the later shard on its dimension left,
    as FSDP2 builds it). A view; clone to own it."""
    from torch.distributed.tensor import Shard

    coords = mesh.get_coordinate()
    strided = [i for i, p in enumerate(placements)
               if type(p).__name__ == "_StridedShard"]
    order = [i for i in range(len(placements)) if i not in strided] + strided
    out = full
    for i in order:
        p = placements[i]
        if isinstance(p, Shard) or i in strided:
            n = mesh.size(i)
            chunks = torch.chunk(out, n, dim=p.dim)
            c = coords[i]
            out = chunks[c] if c < len(chunks) else out.narrow(p.dim, 0, 0)
    return out
