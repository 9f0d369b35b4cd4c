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
    `ops.precision.linear_f32_acc` (Megatron's "g"). Both take an f32
    bias, added before the one rounding (`ops.precision.dense_f32_acc`'s
    contract): a column-parallel layer's shard to its local product, a
    row-parallel layer's replicated bias once, after the all-reduce;
  * `copy_to` — Megatron's "f" alone, for a column-parallel contraction
    that is not a linear (the MoE expert bank's einsums);
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
gate and up columns. The same order applies along whichever dimension
the weight is fused on (a bias's only one; the MoE bank's ``w_gate_up``
its last). The strategy applies it once at wrap and undoes it in the
state dict (`parallel.strategy.ShardedMesh`), so checkpoints and
``state_dict()`` keep the canonical layout.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence

import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

from ray_lightning_tpu_torch.ops.precision import (
    _mm_f32_out,
    dense_f32_acc,
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


def _add_bias_once(part: torch.Tensor, b, dtype) -> torch.Tensor:
    """The f32 product ``part`` plus the f32 bias ``b`` (or none), rounded
    once to ``dtype``: `ops.precision.dense_f32_acc`'s one rounding."""
    return (part if b is None else part + b.float()).to(dtype)


def _bias_grad(g2: torch.Tensor, b):
    """A bias's gradient: the f32 sum of its output's cotangents (the
    one-card ``dense_f32_acc``'s), or None without a bias."""
    return None if b is None else g2.float().sum(0).to(b.dtype)


class _ColumnLinear(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b, tp):
        ctx.save_for_backward(x, w, b)
        ctx.tp = tp
        if b is None:
            return linear_f32_acc(x, w)
        part = _mm_f32_out(x.reshape(-1, x.shape[-1]), w)
        return _add_bias_once(part, b, x.dtype).reshape(*x.shape[:-1],
                                                        w.shape[0])

    @staticmethod
    def backward(ctx, g):
        x, w, b = ctx.saved_tensors
        g2 = g.reshape(-1, g.shape[-1])
        x2 = x.reshape(-1, x.shape[-1])
        gx = _all_reduce(_mm_f32_out(g2, w.t()), ctx.tp).to(x.dtype)
        gw = torch.mm(g2.t(), x2)
        # the bias shard's output columns are this rank's alone: its
        # gradient is complete here, with no collective
        return gx.reshape(x.shape), gw, _bias_grad(g2, b), None


class _RowLinear(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b, tp):
        ctx.save_for_backward(x, w, b)
        x2 = x.reshape(-1, x.shape[-1])
        part = _mm_f32_out(x2, w)
        if _get_current_dispatch_mode_stack():
            # a selective checkpoint's cache (remat policy "dots",
            # ops/remat.py) may keep the GEMM's own output for the
            # recomputation, which must find it unreduced: the all-reduce
            # works on a copy
            part = part.clone()
        # the replicated bias is added once, after the f32 sum and before
        # its one rounding
        out = _add_bias_once(_all_reduce(part, tp), b, x.dtype)
        return out.reshape(*x.shape[:-1], w.shape[0])

    @staticmethod
    def backward(ctx, g):
        x, w, b = ctx.saved_tensors
        g2 = g.reshape(-1, g.shape[-1])
        x2 = x.reshape(-1, x.shape[-1])
        # the output (so its cotangent) is replicated over the group: the
        # replicated bias's gradient is the same on every rank, with no
        # collective
        return (torch.mm(g2, w).reshape(x.shape), torch.mm(g2.t(), x2),
                _bias_grad(g2, b), None)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.clone(), ctx.tp), None


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
                  tp: Optional[TensorParallel] = None,
                  bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x @ w.T (+ bias)`` for a replicated ``x`` and this rank's output
    rows ``w`` [out/tp, in] (and ``bias`` [out/tp], f32): the bias added
    to the f32 product before its one rounding; the input's gradient is
    summed over the group in f32 and rounded once. Off the tensor axis
    with a bias it is `ops.precision.dense_f32_acc`."""
    if tp is None:
        return linear_f32_acc(x, w) if bias is None else \
            dense_f32_acc(x, w, bias)
    return _ColumnLinear.apply(x, w, bias, tp)


def row_linear(x: torch.Tensor, w: torch.Tensor,
               tp: Optional[TensorParallel] = None,
               bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x @ w.T (+ bias)`` summed over the group, for this rank's input
    columns ``x`` [..., in/tp] and ``w`` [out, in/tp]: the f32 partials
    are all-reduced in f32, the replicated f32 ``bias`` [out] added once,
    and the sum rounded once to ``x.dtype``. Off the tensor axis with a
    bias it is `ops.precision.dense_f32_acc`."""
    if tp is None:
        return linear_f32_acc(x, w) if bias is None else \
            dense_f32_acc(x, w, bias)
    return _RowLinear.apply(x, w, bias, tp)


def copy_to(x: torch.Tensor, tp: Optional[TensorParallel]) -> torch.Tensor:
    """``x`` as it is, its gradient summed over the group (Megatron's "f"
    in front of a column-parallel contraction that is not a linear, such
    as an expert bank's einsum); ``x`` itself off the tensor axis."""
    return x if tp is None else _CopyTo.apply(x, tp)


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


def exchange_rows(local: torch.Tensor, rows: torch.Tensor, dim: int,
                  group, rank: int, size: int) -> torch.Tensor:
    """Re-deal the rows (along ``dim``) of a tensor that the group holds
    in equal contiguous chunks (rank ``r`` rows ``[r * c, (r + 1) * c)``,
    ``local`` this rank's): ``rows[r]`` ([size, c], long) lists the rows
    rank ``r``'s new block holds, in order. Returns this rank's new
    block. Each rank keeps the rows it already holds and sends each other
    rank the rows that rank's block needs, in one ``all_to_all_single``
    (which gloo carries for CUDA tensors): only the rows that change rank
    move, where `full_value` would gather every row to every rank."""
    import torch.distributed as dist

    x = local.movedim(dim, 0)
    c = x.shape[0]
    rows = rows.to(x.device)
    owner = rows // c
    src = owner[rank]
    out = torch.empty_like(x)
    keep = src == rank
    out[keep] = x[rows[rank][keep] - rank * c]
    sends = [x[rows[r][owner[r] == rank] - rank * c] if r != rank
             else x[:0] for r in range(size)]
    in_splits = [len(t) for t in sends]
    out_splits = [0 if s == rank else int((src == s).sum())
                  for s in range(size)]
    recv = x.new_empty((sum(out_splits), *x.shape[1:]))
    dist.all_to_all_single(recv, torch.cat(sends).contiguous(), out_splits,
                           in_splits, group=group)
    # the received rows come source by source, each in this block's order
    out[torch.cat([torch.nonzero(src == s).flatten() for s in range(size)
                   if s != rank])] = recv
    return out.movedim(0, dim)


def _chunk_sizes(length: int, n: int) -> list:
    """The sizes of ``torch.chunk(x, n)`` along a dimension of
    ``length``, padded with zeros to ``n`` entries."""
    each = -(-length // n) if length else 0
    sizes = [min(each, max(0, length - k * each)) for k in range(n)]
    return sizes


def full_value(value) -> torch.Tensor:
    """A DTensor's whole value on its device (anything else as it is),
    gathered with c10d's ``all_gather_into_tensor`` over each sharded mesh
    dimension, innermost first (the inverse of `local_piece`).
    ``DTensor.full_tensor`` goes through the functional collectives, which
    crash under gloo with CUDA tensors (torch 2.11 on the H100: a
    segfault in ``wait_tensor``), where c10d's own collective carries
    them; the tensor ranks that share one card run on gloo. Placements
    other than plain ``Shard``/``Replicate`` (FSDP2's strided shards, a
    partial sum) take ``full_tensor``."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not isinstance(value, DTensor):
        return value
    placements = value.placements
    if any(type(p) not in (Shard, Replicate) for p in placements):
        return value.full_tensor()
    mesh = value.device_mesh
    coords = mesh.get_coordinate()
    out = value.to_local()
    for i in reversed(range(len(placements))):
        p = placements[i]
        if not isinstance(p, Shard):
            continue
        # the length mesh dimension i split: the dimension after the
        # splits of the mesh dimensions before it
        length = value.shape[p.dim]
        for j in range(i):
            q = placements[j]
            if isinstance(q, Shard) and q.dim == p.dim:
                length = _chunk_sizes(length, mesh.size(j))[coords[j]]
        n = mesh.size(i)
        sizes = _chunk_sizes(length, n)
        moved = out.movedim(p.dim, 0)
        pad = sizes[0] - moved.shape[0]
        if pad:
            moved = torch.cat([moved, moved.new_zeros(
                (pad, *moved.shape[1:]))])
        gathered = moved.new_empty((n * sizes[0], *moved.shape[1:]))
        dist.all_gather_into_tensor(gathered, moved.contiguous(),
                                    group=mesh.get_group(i))
        parts = [g[:s] for g, s in zip(gathered.chunk(n), sizes)] \
            if sizes[0] else [gathered]
        out = torch.cat(parts).movedim(0, p.dim)
    return out.contiguous()


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
