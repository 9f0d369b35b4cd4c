"""Pipeline parallelism: a GPipe microbatch pipeline over the mesh's
``pipe`` axis (twin of `ray_lightning_tpu/ops/pipeline.py`).

Each ``pipe`` rank holds a contiguous block of L/P layers. With P stages
and M microbatches the schedule runs T = M + P - 1 steps in lockstep, as
the JAX scan does: at step t stage p computes microbatch t - p when it
is in range; stage 0 feeds from the microbatch queue, a later stage from
the activation it received at the step before; then every stage hands
its output to stage p + 1 over the open chain `pipeline_perm`
(`parallel.comm.GroupShift`, the twin of the JAX ppermute). The last
stage's outputs are replicated over ``pipe`` (a sum over the axis of the
last stage's outputs and everyone else's zeros, the JAX psum).

The backward is the reverse chain, written by hand (JAX transposes the
ppermute): `_GPipeFunction` keeps each microbatch's stage graph from the
forward (GPipe's O(M) activation stash; ``remat=True`` checkpoints each
layer, `torch.utils.checkpoint` under the port's remat policies), runs
the steps backwards, takes the cotangent of the stage's output from the
next stage (the last stage from its own share of the output's
cotangent), runs the stage's backward, which accumulates the gradients
of the stage's layers, and sends the input's cotangent back to stage
p - 1. The input's cotangent, which stage 0 alone computes, is summed
over the axis, so every rank holds the gradient of its replicated input.

``pipe`` 1 is the plain layer loop.
"""
from __future__ import annotations

from typing import Any, Callable, Optional, Sequence

import torch
from torch.utils.checkpoint import checkpoint

from ray_lightning_tpu_torch.parallel.comm import AxisGroup, GroupShift


def pipeline_perm(pipe: int) -> list:
    """The stage-to-stage schedule: an open chain, stage i to i + 1."""
    return [(i, i + 1) for i in range(pipe - 1)]


def pipeline_param_spec(inner: Optional[tuple] = None,
                        axis_name: str = "pipe") -> tuple:
    """The spec of a layer-stacked parameter under pipeline parallelism:
    the leading (layer) dimension on ``pipe``, then the per-layer spec."""
    return (axis_name, *(inner or ()))


def _pipe_axis(mesh, axis_name: str) -> Optional[AxisGroup]:
    if isinstance(mesh, AxisGroup) or mesh is None:
        return mesh
    return AxisGroup.of(mesh, axis_name)


def _n_layers(stacked) -> int:
    """L of a layer stack: a dict of [L, ...] leaves (plain, or DTensors
    whose global leading dimension is L) or a sequence of L layers."""
    if isinstance(stacked, dict):
        return next(iter(stacked.values())).shape[0]
    return len(stacked)


def _stage_block(stacked, stage: int, pipe: int):
    """This stage's contiguous block of the stack: a DTensor leaf sharded
    over the axis is its local shard already; a plain leaf or a sequence
    is sliced."""
    n = _n_layers(stacked)
    lo, hi = stage * n // pipe, (stage + 1) * n // pipe
    if isinstance(stacked, dict):
        return {k: (v.to_local() if hasattr(v, "to_local") else v[lo:hi])
                for k, v in stacked.items()}
    return list(stacked[lo:hi])


def _layers(block) -> list:
    """The per-layer parameters of a block."""
    if isinstance(block, dict):
        n = next(iter(block.values())).shape[0]
        return [{k: v[i] for k, v in block.items()} for i in range(n)]
    return list(block)


def _leaves(block) -> list:
    if isinstance(block, dict):
        return [v for v in block.values() if isinstance(v, torch.Tensor)
                and v.requires_grad]
    return [p for layer in block if isinstance(layer, torch.nn.Module)
            for p in layer.parameters() if p.requires_grad]


class _GPipeFunction(torch.autograd.Function):
    """The GPipe schedule of one rank, with the hand-written reverse
    chain. Inputs: the stage function (applying the stage's layers to a
    microbatch), the shift, M, whether to keep each microbatch's graph
    for a backward, the rank's global batch ``x``, then the stage's
    parameter leaves (inputs only so that autograd calls the backward;
    their gradients accumulate inside it)."""

    @staticmethod
    def forward(ctx, stage, shift, m, grad, x, *leaves):
        axis = shift.axis
        p, n = axis.rank, axis.size
        mbs = list(x.chunk(m))
        template = [mbs[0]]
        saved, outs, recv = [None] * m, [None] * m, None
        for t in range(m + n - 1):
            mb = t - p
            y = None
            if 0 <= mb < m:
                h_in = mbs[mb] if p == 0 else recv[0]
                with torch.set_grad_enabled(grad):
                    h = h_in.detach().requires_grad_(
                        grad and (x.requires_grad or p > 0))
                    y = stage(h)
                if grad:
                    saved[mb] = (h, y)
                if p == n - 1:
                    outs[mb] = y.detach()
            # stage p takes, from p - 1, the microbatch it computes at
            # step t + 1
            want = p > 0 and 0 <= t + 1 - p < m
            recv = shift.start([[y.detach()] if y is not None else None],
                               [template if want else None],
                               step=1, closed=False).wait()[0]
        out = (torch.cat(outs) if p == n - 1 else torch.zeros_like(x))
        out = _sum_over(out, axis)
        ctx.saved = saved
        ctx.args = (shift, m, x.shape, x.dtype, x.device)
        return out

    @staticmethod
    def backward(ctx, g):
        shift, m, shape, dtype, device = ctx.args
        axis = shift.axis
        p, n = axis.rank, axis.size
        saved = ctx.saved
        ctx.saved = None
        gs = list(g.contiguous().chunk(m))
        template = [gs[0]]
        dxs = [None] * m
        recv = None
        for t in reversed(range(m + n - 1)):
            mb = t - p
            dh = None
            if 0 <= mb < m:
                dy = gs[mb] if p == n - 1 else recv[0]
                h, y = saved[mb]
                saved[mb] = None
                torch.autograd.backward(y, dy)
                dh = h.grad
                if p == 0:
                    dxs[mb] = dh
            # stage p - 1 takes the cotangent of microbatch t - 1 - (p - 1)
            want = p < n - 1 and 0 <= t - 1 - p < m
            recv = shift.start([[dh] if dh is not None else None],
                               [template if want else None],
                               step=-1, closed=False).wait()[0]
        dx = (torch.cat([d if d is not None else torch.zeros_like(gs[0])
                         for d in dxs])
              if p == 0 else torch.zeros(shape, dtype=dtype, device=device))
        return (None, None, None, None, _sum_over(dx.to(dtype), axis),
                *([None] * len(ctx.needs_input_grad[5:])))


def _sum_over(t: torch.Tensor, axis: AxisGroup) -> torch.Tensor:
    import torch.distributed as dist

    t = t.contiguous().clone()
    dist.all_reduce(t, group=axis.group)
    return t


def gpipe_apply(stage_fn: Callable[..., torch.Tensor], stacked_params: Any,
                x: torch.Tensor, mesh, *, microbatches: int,
                axis_name: str = "pipe", remat: bool = False,
                remat_policy: Optional[str] = None,
                extra: Sequence = ()) -> torch.Tensor:
    """Apply L stacked layers to ``x``, stage-split over ``axis_name``.

    ``stage_fn(layer_params, h, *extra) -> h``: ONE layer's forward.
    ``stacked_params``: a dict of [L, ...] leaves (plain tensors on every
    rank, sliced to the stage's block here, or DTensors sharded over the
    axis, whose local shard is the block) or a sequence of L layers (a
    `ModuleList`, whose entries outside the stage's block may be
    placeholders). ``x``: the rank's [B, ...] activations, replicated
    over the axis, B divisible by ``microbatches``; ``mesh``: a
    `DeviceMesh` or the axis's `AxisGroup`. ``remat`` checkpoints each
    layer under the port's ``remat_policy`` ("nothing", "dots",
    "attn_out"). Returns the output after all L layers on every rank of
    the axis. With axis size 1, the plain layer loop."""
    from ray_lightning_tpu_torch.ops.remat import checkpoint_context_fn

    axis = _pipe_axis(mesh, axis_name)
    pipe = axis.size if axis is not None else 1

    def body(lp, h):
        if remat and torch.is_grad_enabled():
            return checkpoint(stage_fn, lp, h, *extra, use_reentrant=False,
                              context_fn=checkpoint_context_fn(
                                  remat_policy or "nothing"))
        return stage_fn(lp, h, *extra)

    if pipe <= 1:
        for lp in _layers(_stage_block(stacked_params, 0, 1)):
            x = body(lp, x)
        return x
    n = _n_layers(stacked_params)
    if n % pipe:
        raise ValueError(f"{n} layers not divisible by pipe={pipe}")
    if x.shape[0] % microbatches:
        raise ValueError(f"per-shard batch {x.shape[0]} not divisible by "
                         f"microbatches={microbatches}")

    def stage(h):
        # the block's views taken afresh for each microbatch: each
        # microbatch's backward runs and frees its own graph
        for lp in _layers(_stage_block(stacked_params, axis.rank, pipe)):
            h = body(lp, h)
        return h

    owned = (stacked_params if isinstance(stacked_params, dict)
             else _stage_block(stacked_params, axis.rank, pipe))
    return _GPipeFunction.apply(stage, GroupShift(axis, x.device),
                                microbatches, torch.is_grad_enabled(), x,
                                *_leaves(owned))
