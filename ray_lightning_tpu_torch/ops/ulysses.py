"""Ulysses sequence parallelism: the head/sequence all-to-all (twin of
`ray_lightning_tpu/ops/ulysses.py`).

One all-to-all turns a rank's sequence shard [B, S/n, H, D] into a head
shard over the whole sequence [B, S, H/n, D]; each rank runs
`ops.attention.flash_attention` (the hand-written flash kernels on the
card) over the full sequence for its head group; a second all-to-all
restores the sequence shard. Two collectives whatever n, against the
ring's n - 1 rotations; it needs the heads, and the KV heads, to divide
by the axis size. The all-to-alls are `parallel.comm.all_to_all`, whose
backward is the inverse exchange.
"""
from __future__ import annotations

import torch

from ray_lightning_tpu_torch.ops.attention import flash_attention
from ray_lightning_tpu_torch.parallel.comm import AxisGroup, all_to_all


def check_heads(h_local: int, hkv_local: int, n: int) -> None:
    """The JAX ulysses error: the per-shard heads must divide by the seq
    axis size."""
    if h_local % n != 0 or hkv_local % n != 0:
        raise ValueError(
            f"ulysses needs per-shard heads divisible by the seq axis: "
            f"H/tensor={h_local}, Hkv/tensor={hkv_local}, seq={n} — use "
            "ring attention for this shape")


def ulysses_attention_local(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, *, axis: AxisGroup,
                            causal: bool = True) -> torch.Tensor:
    """The per-rank body: q, k, v [B, S/n, H(kv), D] (this rank's local
    heads, its sequence shard) -> [B, S/n, H, D]. Axis size 1 is plain
    flash attention."""
    if axis.size == 1:
        return flash_attention(q, k, v, causal=causal)
    check_heads(q.shape[2], k.shape[2], axis.size)

    def to_heads(x):
        # [B, S/n, H, D] -> [B, S, H/n, D]
        return all_to_all(x, axis, split_dim=2, concat_dim=1).contiguous()

    out = flash_attention(to_heads(q), to_heads(k), to_heads(v),
                          causal=causal)
    # [B, S, H/n, D] -> [B, S/n, H, D]
    return all_to_all(out.contiguous(), axis, split_dim=1, concat_dim=2)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      mesh, *, axis_name: str = "seq",
                      causal: bool = True) -> torch.Tensor:
    """Sequence-parallel attention over ``mesh``'s ``axis_name`` by the
    head/sequence all-to-all: each rank passes its sequence shard (its
    local heads under the tensor axis) and gets its rows back. Raises the
    JAX ValueError when the per-shard heads do not divide by the axis
    size."""
    from ray_lightning_tpu_torch.ops.ring_attention import seq_group

    axis = seq_group(mesh, axis_name)
    check_heads(q.shape[2], k.shape[2], axis.size)
    return ulysses_attention_local(q, k, v, axis=axis, causal=causal)
