"""The collectives of the sequence, pipeline and expert axes.

The JAX package writes them as `lax.ppermute` (the ring's rotation, the
pipeline's stage hop) and `lax.all_to_all` (Ulysses, and the all-to-alls
XLA inserts for MoE's dispatch), and XLA schedules them. Here each is an
explicit call of c10d over the axis's process group:

  * `AxisGroup` — a rank's place on one mesh axis (its group, size and
    coordinate);
  * `GroupShift` — every rank sends to its neighbour ``rank + step``
    along the axis and receives from ``rank - step``: a closed ring (the
    rotation of ring attention) or an open chain (the GPipe stage hop:
    the last stage sends nothing, the first receives nothing);
  * `LocalShift` — the same contract for every rank of an axis driven by
    one process, rank after rank (the rotation seam: the CPU tests and
    the card's one-process ring lane run the ring's per-rank body for n
    ranks without a process group);
  * `all_to_all` — a differentiable tiled all-to-all (the JAX
    ``all_to_all(..., tiled=True)``), whose backward is the inverse
    exchange.

The shift's route is chosen by the group's backend and the tensors'
device, never by catching a failure: NCCL, and gloo with CPU tensors,
take ``batch_isend_irecv``; gloo with CUDA tensors takes
``all_to_all_single`` with a non-zero split toward the neighbour only,
because gloo's point-to-point hands the raw device pointer to its TCP
transport, while its all-to-all stages CUDA tensors through the host
(`GLOO_CUDA_ROUTE`; the two-rank probe of `chip_smoke.py` phase 17 (a)
prints which of the two carries CUDA tensors). The all-to-all is c10d's
``all_to_all_single`` on every backend, under an explicit
`torch.autograd.Function` (DTensor's functional collectives die under
gloo with CUDA tensors).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, List, Optional, Sequence

import torch

#: the shift's route under gloo with CUDA tensors
GLOO_CUDA_ROUTE = "all_to_all"

#: every `GroupShift` of this process: shifts posted, bytes sent, and the
#: host seconds spent waiting for them to finish (what a rotation adds to
#: the ranks' critical path when the work under it is shorter)
SHIFT_STATS = {"calls": 0, "bytes": 0, "wait_s": 0.0}


@dataclasses.dataclass(frozen=True)
class AxisGroup:
    """A rank's place on one mesh axis."""

    group: Any
    size: int
    rank: int

    @classmethod
    def of(cls, mesh, axis: str) -> Optional["AxisGroup"]:
        """``axis`` of a `DeviceMesh` (None where the mesh lacks it)."""
        if mesh is None or axis not in (mesh.mesh_dim_names or ()):
            return None
        sub = mesh[axis]
        return cls(sub.get_group(), sub.size(), sub.get_local_rank())


def shift_route(group, device) -> str:
    """"p2p" (``batch_isend_irecv``) or "all_to_all" for a shift of
    tensors on ``device`` over ``group``, by the group's backend."""
    import torch.distributed as dist

    if (dist.get_backend(group) == "gloo"
            and torch.device(device).type == "cuda"):
        return GLOO_CUDA_ROUTE
    return "p2p"


def _pack(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """One flat byte buffer of ``tensors``."""
    return torch.cat([t.contiguous().reshape(-1).view(torch.uint8)
                      for t in tensors])


def _unpack(buf: torch.Tensor, like: Sequence[torch.Tensor]) -> list:
    out, at = [], 0
    for t in like:
        n = t.numel() * t.element_size()
        seg = buf[at:at + n]
        if at % 16:
            # the kernels take 16-byte aligned tensors
            seg = seg.clone()
        out.append(seg.view(t.dtype).reshape(t.shape))
        at += n
    return out


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


class _Pending:
    """A posted shift; `wait` returns what each driven rank received."""

    def __init__(self, finish):
        self._finish = finish

    def wait(self) -> list:
        return self._finish()


class GroupShift:
    """The shift over a process group, for this process's rank alone
    (``ranks`` is ``[rank]``): `start` posts it and returns at once, so
    work can run under it; `wait` on the result finishes it (each shift
    counted in `SHIFT_STATS`)."""

    def __init__(self, axis: AxisGroup, device=None):
        self.axis = axis
        #: where a shift that sends and receives nothing still takes part
        #: in the exchange (the all-to-all route)
        self.device = device
        self.size = axis.size
        self.ranks = [axis.rank]

    def start(self, send: List[Optional[list]], like: List[Optional[list]],
              step: int = 1, closed: bool = True) -> _Pending:
        """``send[0]``: the tensors this rank sends to ``rank + step``
        (None: none, the end of an open chain); ``like[0]``: templates
        of what it receives from ``rank - step`` (None: nothing)."""
        import torch.distributed as dist

        tensors, templates = send[0], like[0]
        n, r = self.size, self.axis.rank
        dst, src = r + step, r - step
        if closed:
            dst, src = dst % n, src % n
        ref = (tensors or templates or [None])[0]
        # the ends of an open chain send or receive nothing
        if not 0 <= dst < n:
            tensors = None
        if not 0 <= src < n:
            templates = None
        dev = ref.device if ref is not None else self.device
        route = shift_route(self.axis.group, dev) if dev is not None \
            else "p2p"
        if tensors is None and templates is None and route == "p2p":
            return _Pending(lambda: [None])
        SHIFT_STATS["calls"] += 1
        empty = torch.empty(0, dtype=torch.uint8, device=dev)
        out_buf = (torch.empty(_nbytes(templates), dtype=torch.uint8,
                               device=dev)
                   if templates is not None else None)
        in_buf = _pack(tensors) if tensors is not None else None
        if tensors is not None:
            SHIFT_STATS["bytes"] += in_buf.numel()
        group = self.axis.group
        ranks = dist.get_process_group_ranks(group)
        if route == "p2p":
            ops = []
            if in_buf is not None:
                ops.append(dist.P2POp(dist.isend, in_buf, ranks[dst], group))
            if out_buf is not None:
                ops.append(dist.P2POp(dist.irecv, out_buf, ranks[src],
                                      group))
            works = dist.batch_isend_irecv(ops)
        else:
            in_splits = [0] * n
            out_splits = [0] * n
            if in_buf is not None:
                in_splits[dst] = in_buf.numel()
            if out_buf is not None:
                out_splits[src] = out_buf.numel()
            works = [dist.all_to_all_single(
                out_buf if out_buf is not None else empty,
                in_buf if in_buf is not None else empty,
                out_splits, in_splits, group=group, async_op=True)]

        def finish():
            t0 = time.perf_counter()
            for w in works:
                w.wait()
            SHIFT_STATS["wait_s"] += time.perf_counter() - t0
            return [None if out_buf is None else _unpack(out_buf, templates)]

        return _Pending(finish)


class LocalShift:
    """The rotation seam: every rank of an axis of ``size`` driven by one
    process, rank after rank; ``start`` moves each rank's tensors to its
    neighbour's slot (no copy, no collective)."""

    def __init__(self, size: int):
        self.size = size
        self.ranks = list(range(size))

    def start(self, send: List[Optional[list]], like: List[Optional[list]],
              step: int = 1, closed: bool = True) -> _Pending:
        n = self.size
        out: list = [None] * n
        for r, tensors in enumerate(send):
            dst = (r + step) % n if closed else r + step
            if tensors is None or not 0 <= dst < n or like[dst] is None:
                continue
            out[dst] = list(tensors)
        return _Pending(lambda: out)


# ---- the all-to-all -------------------------------------------------------


def _exchange(x: torch.Tensor, axis: AxisGroup, split_dim: int,
              concat_dim: int) -> torch.Tensor:
    import torch.distributed as dist

    n = axis.size
    parts = torch.stack(x.chunk(n, dim=split_dim)).contiguous()
    out = torch.empty_like(parts)
    dist.all_to_all_single(out, parts, group=axis.group)
    return torch.cat(out.unbind(0), dim=concat_dim)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, split_dim, concat_dim):
        ctx.args = (axis, split_dim, concat_dim)
        return _exchange(x, axis, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        axis, split_dim, concat_dim = ctx.args
        return (_exchange(g.contiguous(), axis, concat_dim, split_dim),
                None, None, None)


def all_to_all(x: torch.Tensor, axis: AxisGroup, split_dim: int,
               concat_dim: int) -> torch.Tensor:
    """The tiled all-to-all over ``axis`` (JAX ``lax.all_to_all(x, axis,
    split_axis, concat_axis, tiled=True)``): ``x`` split into ``size``
    equal chunks along ``split_dim``, chunk j sent to rank j, the chunks
    received concatenated along ``concat_dim`` in the senders' order.
    Differentiable: the backward is the inverse exchange."""
    if axis.size == 1:
        return x
    if x.shape[split_dim] % axis.size:
        raise ValueError(f"all_to_all: dimension {split_dim} of "
                         f"{tuple(x.shape)} does not divide by "
                         f"{axis.size}")
    return _AllToAll.apply(x, axis, split_dim, concat_dim)


class _MeanOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        import torch.distributed as dist

        ctx.axis = axis
        out = x.clone()
        dist.all_reduce(out, group=axis.group)
        return out / axis.size

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist

        g = g.clone()
        dist.all_reduce(g, group=ctx.axis.group)
        return g / ctx.axis.size, None


def mean_over(x: torch.Tensor, axis: Optional[AxisGroup]) -> torch.Tensor:
    """The mean of ``x`` over the ranks of ``axis`` (JAX: a mean over a
    global batch axis), differentiable: its gradient is the mean of the
    ranks' cotangents."""
    if axis is None or axis.size == 1:
        return x
    return _MeanOver.apply(x, axis)
