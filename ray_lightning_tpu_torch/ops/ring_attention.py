"""Ring attention: sequence parallelism over the mesh's ``seq`` axis (twin
of `ray_lightning_tpu/ops/ring_attention.py`).

Each rank holds [B, S/n, H, D] of q, k and v. Attention runs in n ring
steps: a rank attends its q to the KV block it holds, then passes the
block to its neighbour ``rank + 1`` (`parallel.comm`, the twin of
`lax.ppermute` over `ring_perm`). Causality follows from the global
offsets: the rank's own block is causal at ``q_offset`` 0, a block from
an earlier rank is seen whole, and a block from a later rank is in every
query's future: JAX computes it and gets zeros, the port skips it.

On CUDA tensors each block is one launch of the hand-written flash
forward (`ops.kernels.flash.flash_fwd_kernel`), which returns the block's
``(o, lse)``; the pairs merge in f32 by their lse. The next block's send
is posted before this block's kernel runs, so the copy runs under it.
There are n - 1 rotations forward, as in JAX.

The backward is written by hand (JAX differentiates through its
ppermutes): `RingAttentionFunction` saves q, the rank's own k and v, the
merged O and the merged lse, computes ``delta = rowsum(dO * O)`` once and
walks the ring again; each visible block takes the dK/dV and the dQ
kernels under the global lse and delta, whose probabilities are then the
block's share of the whole softmax. The dK/dV accumulators (f32) travel
with their block, and one last hop brings them home.

Precision: each block's O leaves the kernel rounded to the inputs' dtype,
where JAX keeps one f32 accumulator across the blocks. The plain lane
(under `ops.dispatch.force_reference`, and what the wrappers run on CPU
tensors) is the same ring through the kernels' plain versions, which
round at the same points: on the card the kernel lane and the plain lane
compare like with like, and on the CPU in f32 the ring equals the JAX
one to f32 tolerance. `_accum_block` is the JAX per-block update itself
(an f32 online softmax), kept as the twin the tests hold against JAX's;
in bf16 it differs from both lanes by the per-block rounding of O.

Entry points, as in JAX: `ring_attention_local(q, k, v, ring=...)` is the
per-rank body (a rank's shards, and the `AxisGroup` of its ring or any
shift with the `parallel.comm` contract); `ring_attention(q, k, v, mesh)`
reads the ring from the mesh's ``seq`` axis. `ring_attention_ranks` runs
the body for every rank of a ring in one process, rank after rank
(`parallel.comm.LocalShift`): the rotation seam the CPU tests and the
card's one-process lane use.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from ray_lightning_tpu_torch.ops import dispatch
from ray_lightning_tpu_torch.ops.attention import repeat_kv
from ray_lightning_tpu_torch.ops.kernels import flash as fk
from ray_lightning_tpu_torch.parallel.comm import (
    AxisGroup,
    GroupShift,
    LocalShift,
)

_NEG_INF = float("-inf")


def ring_perm(axis_size: int) -> list:
    """The ring's schedule: one cycle, every rank sends to ``rank + 1``."""
    return [(j, (j + 1) % axis_size) for j in range(axis_size)]


def _accum_block(q, k, v, o, m, l, *, q_off, kv_off, causal, scale):
    """One online-softmax update of (o, m, l) with a KV block (the JAX
    `_accum_block`): q [B, Sq, H, D]; k, v [B, Skv, Hkv, D]; o [B, H, Sq,
    D] f32; m, l [B, H, Sq] f32 running max and denominator."""
    if k.shape[2] != q.shape[2]:
        rep = q.shape[2] // k.shape[2]
        k, v = repeat_kv(k, rep), repeat_kv(v, rep)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        q_pos = torch.arange(q.shape[1], device=q.device)[:, None] + q_off
        kv_pos = torch.arange(k.shape[1], device=q.device)[None, :] + kv_off
        s = s.masked_fill(~(q_pos >= kv_pos), _NEG_INF)
    m_new = torch.maximum(m, s.amax(dim=-1))
    # rows with nothing visible yet keep m = -inf; exp against a 0
    # stand-in still gives exact zeros
    safe_m = torch.where(torch.isfinite(m_new), m_new,
                         torch.zeros_like(m_new))
    p = torch.exp(s - safe_m[..., None])
    alpha = torch.where(torch.isfinite(m), torch.exp(m - safe_m),
                        torch.zeros_like(m))
    l_new = l * alpha + p.sum(dim=-1)
    o_new = o * alpha[..., None] + torch.einsum("bhqk,bkhd->bhqd", p,
                                                v.float())
    return o_new, m_new, l_new


def _visible(causal: bool, src: int, rank: int) -> bool:
    return not causal or src <= rank


def _block_fns(reference: bool) -> tuple:
    """(forward, dK/dV, dQ) of one lane: the kernels' wrappers (which run
    their plain versions on CPU tensors), or the plain versions."""
    kind = "plain" if reference else "kernel"
    return tuple(getattr(fk, f"flash_{step}_{kind}")
                 for step in ("fwd", "bwd_dkv", "bwd_dq"))


def _merge(parts):
    """The (o, lse) pairs of one rank's blocks merged in f32: (o f32 [B,
    Sq, H, D], lse [B, H, Sq])."""
    lses = torch.stack([lse for _, lse in parts])
    lse = torch.logsumexp(lses, dim=0)
    o = None
    for (o_j, _), lse_j in zip(parts, lses):
        w = torch.exp(lse_j - lse).transpose(1, 2)[..., None]
        term = o_j.float() * w
        o = term if o is None else o + term
    return o, lse


def _ring_forward(seam, qs, ks, vs, causal, scale, reference):
    n = seam.size
    fwd = _block_fns(reference)[0]
    held = [[k, v] for k, v in zip(ks, vs)]
    parts: List[list] = [[] for _ in qs]
    for t in range(n):
        # post the next block's send before this block's work
        pending = (seam.start(held, held) if t < n - 1 else None)
        for i, r in enumerate(seam.ranks):
            src = (r - t) % n
            if _visible(causal, src, r):
                k, v = held[i]
                parts[i].append(fwd(qs[i], k, v, causal and src == r, 0,
                                    scale))
        if pending is not None:
            held = pending.wait()
    outs, lses = [], []
    for i, q in enumerate(qs):
        o, lse = _merge(parts[i])
        outs.append(o.to(q.dtype).contiguous())
        lses.append(lse.contiguous())
    return outs, lses


def _ring_backward(seam, qs, ks, vs, os_, lses, dos, causal, scale,
                   reference):
    n = seam.size
    _, dkv, dq_fn = _block_fns(reference)
    dos = [d.contiguous() for d in dos]
    deltas = [fk.flash_delta(o, d) for o, d in zip(os_, dos)]
    dqs = [torch.zeros(q.shape, dtype=torch.float32, device=q.device)
           for q in qs]
    held = [[k, v] for k, v in zip(ks, vs)]
    accs = [[torch.zeros(k.shape, dtype=torch.float32, device=k.device),
             torch.zeros(v.shape, dtype=torch.float32, device=v.device)]
            for k, v in zip(ks, vs)]
    for t in range(n):
        pending = seam.start(held, held) if t < n - 1 else None
        for i, r in enumerate(seam.ranks):
            src = (r - t) % n
            if not _visible(causal, src, r):
                continue
            k, v = held[i]
            args = (qs[i], k, v, dos[i], lses[i], deltas[i],
                    causal and src == r, 0, scale)
            dk, dv = dkv(*args)
            dq = dq_fn(*args)
            dqs[i] += dq.float()
            accs[i][0] += dk.float()
            accs[i][1] += dv.float()
        # the accumulators travel with their block; after the last step
        # this hop brings each home
        if n > 1:
            accs = seam.start(accs, accs).wait()
        if pending is not None:
            held = pending.wait()
    return ([dq.to(q.dtype) for dq, q in zip(dqs, qs)],
            [a[0].to(k.dtype) for a, k in zip(accs, ks)],
            [a[1].to(v.dtype) for a, v in zip(accs, vs)])


class RingAttentionFunction(torch.autograd.Function):
    """Ring attention for the ranks ``seam.ranks`` drives (one over a
    process group; every rank of the ring under `LocalShift`), with the
    hand-written backward. Inputs: the shift, ``causal``, ``scale``,
    ``reference`` (the lane), then every driven rank's q, then their k,
    then their v. Outputs: each driven rank's O."""

    @staticmethod
    def forward(ctx, seam, causal, scale, reference, *qkv):
        m = len(seam.ranks)
        qkv = [t.contiguous() for t in qkv]
        qs, ks, vs = qkv[:m], qkv[m:2 * m], qkv[2 * m:]
        outs, lses = _ring_forward(seam, qs, ks, vs, causal, scale,
                                   reference)
        ctx.save_for_backward(*qs, *ks, *vs, *outs, *lses)
        ctx.args = (seam, causal, scale, reference, m)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *dos):
        seam, causal, scale, reference, m = ctx.args
        saved = ctx.saved_tensors
        qs, ks, vs = saved[:m], saved[m:2 * m], saved[2 * m:3 * m]
        outs, lses = saved[3 * m:4 * m], saved[4 * m:]
        dqs, dks, dvs = _ring_backward(seam, qs, ks, vs, outs, lses, dos,
                                       causal, scale, reference)
        return (None, None, None, None, *dqs, *dks, *dvs)


def _shift_of(ring):
    if isinstance(ring, AxisGroup):
        return GroupShift(ring)
    return ring


def ring_attention_ranks(qs: Sequence[torch.Tensor],
                         ks: Sequence[torch.Tensor],
                         vs: Sequence[torch.Tensor], seam=None, *,
                         causal: bool = True,
                         scale: Optional[float] = None) -> list:
    """The ring body for the ranks ``seam`` drives (default: a
    `LocalShift` over ``len(qs)`` ranks, every rank in this process):
    per-rank lists of shards in, per-rank outputs out."""
    seam = seam if seam is not None else LocalShift(len(qs))
    scale = scale if scale is not None else qs[0].shape[-1] ** -0.5
    if len(qs) != len(seam.ranks):
        raise ValueError(f"{len(qs)} ranks' shards for a seam driving "
                         f"{len(seam.ranks)}")
    reference = dispatch.reference_forced()
    return list(RingAttentionFunction.apply(
        seam, bool(causal), float(scale), reference, *qs, *ks, *vs))


def ring_attention_local(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, ring, causal: bool = True,
                         scale: Optional[float] = None) -> torch.Tensor:
    """The per-rank ring body: q, k, v [B, S/n, H(kv), D], this rank's
    sequence shard; ``ring`` its `AxisGroup` on the ring's axis (or a
    shift of the `parallel.comm` contract driving this rank alone).
    Returns [B, S/n, H, D] in q's dtype. Axis size 1 is plain attention
    over the one block."""
    return ring_attention_ranks([q], [k], [v], _shift_of(ring),
                                causal=causal, scale=scale)[0]


def seq_group(mesh, axis_name: str = "seq") -> AxisGroup:
    """The rank's `AxisGroup` on ``axis_name`` of ``mesh`` (size one where
    the mesh lacks it)."""
    axis = AxisGroup.of(mesh, axis_name)
    return axis if axis is not None else AxisGroup(None, 1, 0)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mesh, *, axis_name: str = "seq", causal: bool = True,
                   scale: Optional[float] = None) -> torch.Tensor:
    """Sequence-parallel attention over ``mesh``'s ``axis_name``: each
    rank passes its sequence shard [B, S/n, H, D] (the JAX function takes
    the global array; here every process holds its own shard) and gets
    its rows of the output. With axis size 1, plain blockwise attention."""
    return ring_attention_local(q, k, v, ring=seq_group(mesh, axis_name),
                                causal=causal, scale=scale)
