"""Attention ops (twin of `ray_lightning_tpu/ops/attention.py`).

  1. `dot_product_attention` — the masked SDPA reference (materializes
     the score matrix); the dense-cache lanes and the reference lanes use
     it.
  2. `flash_attention` — tiled causal/full attention for training and
     prefill-from-zero: the hand-written forward and backward kernels
     (`ops/kernels/flash.py`) through an autograd function; only a
     ``mask`` or `dispatch.force_reference` sends it to (1).
  3. `paged_attention` — single-token decode attention over the serving
     engine's block-paged KV pool through per-slot block tables. The
     kernel path is the hand-written CUDA kernel
     (`ops/kernels/paged_attention.py`); the reference path gathers a
     dense per-slot view first (identical semantics — that copy is what
     the kernel retires).
  4. `paged_prefill` — the chunked causal twin for the prefill lane
     (`ops/kernels/paged_prefill.py`).

(1) and (2) take [B, S, H, D] and support GQA (by repeating KV heads in
(1), in place in the kernels of (2)); (3) takes one query token per slot,
[C, H, D]; (4) the group's chunk, [B, CH, H, D].
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ray_lightning_tpu_torch.ops import dispatch
from ray_lightning_tpu_torch.ops.kernels.flash import (
    flash_attention_kernel,
    flash_shapes_supported,
)
from ray_lightning_tpu_torch.ops.kernels.paged_attention import (
    paged_attention_op,
    paged_shapes_supported,
)
from ray_lightning_tpu_torch.ops.kernels.paged_prefill import (
    paged_prefill_op,
    paged_prefill_shapes_supported,
)


def make_causal_mask(q_len: int, kv_len: int, q_offset: int = 0,
                     device=None) -> torch.Tensor:
    """Boolean [q_len, kv_len] mask, True = attend; ``q_offset`` shifts
    the query positions (the JAX function)."""
    q_pos = torch.arange(q_len, device=device)[:, None] + q_offset
    kv_pos = torch.arange(kv_len, device=device)[None, :]
    return q_pos >= kv_pos


def repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """[B, S, H_kv, D] -> [B, S, H_kv * n_rep, D] for GQA."""
    if n_rep == 1:
        return x
    b, s, h, d = x.shape
    return x[:, :, :, None, :].expand(b, s, h, n_rep, d).reshape(
        b, s, h * n_rep, d)


def dot_product_attention(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, causal: bool = True,
                          mask: Optional[torch.Tensor] = None,
                          q_offset: int = 0,
                          scale: Optional[float] = None) -> torch.Tensor:
    """Reference SDPA: [B, S, H, D] in, [B, S, H, D] out; f32 softmax,
    probabilities rounded to q's dtype before the f32-accumulated PV
    product (exactly the JAX reference's rounding points)."""
    if k.shape[2] != q.shape[2]:
        n_rep = q.shape[2] // k.shape[2]
        k = repeat_kv(k, n_rep)
        v = repeat_kv(v, n_rep)
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        q_pos = torch.arange(q.shape[1], device=q.device)[:, None] + q_offset
        kv_pos = torch.arange(k.shape[1], device=q.device)[None, :]
        scores = scores.masked_fill(~(q_pos >= kv_pos), float("-inf"))
    if mask is not None:
        # mask: [B, S_kv] padding mask or [B, 1, S_q, S_kv]
        if mask.dim() == 2:
            mask = mask[:, None, None, :]
        scores = scores.masked_fill(~mask, float("-inf"))
    # rows with no visible key would softmax to NaN; emit zeros there
    any_visible = torch.isfinite(scores).any(dim=-1, keepdim=True)
    probs = torch.softmax(
        torch.where(any_visible, scores, torch.zeros_like(scores)),
        dim=-1).to(q.dtype)
    probs = torch.where(any_visible, probs, torch.zeros_like(probs))
    out = torch.einsum("bhqk,bkhd->bqhd", probs.float(), v.float())
    return out.to(q.dtype)


def flash_uses_kernel(q_shape, k_shape, device=None,
                      masked: bool = False) -> bool:
    """Would `flash_attention` take the kernels for these shapes and
    arguments (twin of `flash_uses_pallas`)? False for a masked call or
    under `dispatch.force_reference`; otherwise True: on the CPU the
    kernel wrappers run their plain versions, and on CUDA a shape the
    Hopper gate refuses raises (the card takes the reference only when
    asked for)."""
    if masked or dispatch.reference_forced():
        return False
    if (device is not None and torch.device(device).type == "cuda"
            and not flash_shapes_supported(q_shape, k_shape)):
        raise ValueError(
            f"flash_attention: the Hopper kernels do not take shapes "
            f"{tuple(q_shape)}, {tuple(k_shape)}; ask for the reference "
            "path (dispatch.force_reference())")
    return True


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True,
                    mask: Optional[torch.Tensor] = None, q_offset: int = 0,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Tiled attention on [B, S, H, D] (twin of the JAX `flash_attention`):
    the flash kernels, forward and backward, unless a ``mask`` is given or
    the reference is forced, which take `dot_product_attention`."""
    if flash_uses_kernel(q.shape, k.shape, q.device,
                         masked=mask is not None):
        return flash_attention_kernel(q, k, v, causal=causal,
                                      q_offset=q_offset, scale=scale)
    return dot_product_attention(q, k, v, causal=causal, mask=mask,
                                 q_offset=q_offset, scale=scale)


# ---- paged decode attention (the serving engine's fused hot op) -----------


@dataclasses.dataclass
class PagedDecodeView:
    """The decode lane's view of the block-paged KV pool (one entry per
    slot, all int32 tensors on the pool's device):

    ``tables [C, M]`` slot -> pool block ids (0 = reserved scratch);
    ``lengths [C]`` valid cache positions incl. the current token;
    ``write_block/write_offset [C]`` where this tick's K/V token lands
    (already scratch-redirected for slots not in the decode phase).

    ``use_kernel`` carries the engine's build-time dispatch decision
    into `paged_attention`'s call site, so what runs is what
    `DecodeEngine.attention_path` reports; None defers to the ambient
    policy."""

    tables: torch.Tensor
    lengths: torch.Tensor
    write_block: torch.Tensor
    write_offset: torch.Tensor
    use_kernel: Optional[bool] = None


@dataclasses.dataclass
class PagedPrefillView:
    """The prefill lane's view of the pool (one entry per group row):

    ``tables [B, M]`` row -> pool block ids (vacant rows all-scratch);
    ``write_block/write_offset [B, CH]`` where each chunk token's K/V
    lands — scattered into owned blocks BEFORE attention runs
    (write-then-attend). ``use_kernel`` as in `PagedDecodeView`."""

    tables: torch.Tensor
    write_block: torch.Tensor
    write_offset: torch.Tensor
    use_kernel: Optional[bool] = None


def gather_pages(pool: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    """The dense view the kernels retire: [n_blocks, P, Hkv, hd] pool +
    [B, M] tables -> [B, M*P, Hkv, hd]."""
    b, m = tables.shape
    _, p, hkv, hd = pool.shape
    return pool[tables.long()].reshape(b, m * p, hkv, hd)


def paged_attention_reference(q, pool_k, pool_v, tables, lengths,
                              pad=None, scale=None):
    """Reference with the kernel's semantics: gather each slot's blocks
    into a dense [C, M*P, Hkv, hd] view, mask ``pad <= kv_pos < length``
    and run the masked-SDPA reference."""
    k = gather_pages(pool_k, tables)
    v = gather_pages(pool_v, tables)
    kv_pos = torch.arange(k.shape[1], device=q.device)[None, :]
    mask = kv_pos < lengths[:, None]
    if pad is not None:
        mask = mask & (kv_pos >= pad[:, None])
    return dot_product_attention(q[:, None], k, v, causal=False,
                                 mask=mask, scale=scale)[:, 0]


def paged_prefill_reference(q, pool_k, pool_v, tables, pos, pad=None,
                            scale=None):
    """Reference with the prefill kernel's semantics: gather each row's
    blocks, mask ``pad[b] <= kv_pos <= pos + j``, masked SDPA. A fully
    masked query row (a pad column) emits zeros."""
    b, ch = q.shape[:2]
    k = gather_pages(pool_k, tables)
    v = gather_pages(pool_v, tables)
    kv_pos = torch.arange(k.shape[1], device=q.device)[None, None, :]
    q_pos = (pos + torch.arange(ch, device=q.device))[None, :, None]
    mask = (kv_pos <= q_pos).expand(b, ch, k.shape[1])
    if pad is not None:
        mask = mask & (kv_pos >= pad[:, None, None])
    return dot_product_attention(q, k, v, causal=False,
                                 mask=mask[:, None], scale=scale)


def _takes_kernel(use_kernel: Optional[bool], device, supported: bool,
                  what: str, shapes) -> bool:
    """An explicit decision (the engine's baked one) wins; None defers
    to the ambient policy for ``device``. The reference runs where the
    kernel is not wanted, or on the CPU where the shape gate refuses;
    a kernel wanted on a CUDA device for shapes the gate refuses
    raises: on the card the plain path is taken only when asked for."""
    if use_kernel is None:
        use_kernel = device is not None and dispatch.use_kernel(device)
    if use_kernel and not supported and device is not None \
            and torch.device(device).type == "cuda":
        raise ValueError(
            f"{what}: the Hopper kernel does not take shapes {shapes}; "
            "ask for the reference path (use_kernel=False, "
            "use_kernels=False or dispatch.force_reference())")
    return bool(use_kernel) and supported


def paged_attention_uses_kernel(q_shape, pool_shape,
                                use_kernel: Optional[bool] = None,
                                device=None) -> bool:
    """Would `paged_attention` take the kernel for these shapes? ONE
    predicate shared with the dispatch itself: the engine keys its
    decode lane on it at build time. Raises where the kernel is wanted
    on CUDA and the shape gate refuses."""
    return _takes_kernel(use_kernel, device,
                         paged_shapes_supported(q_shape, pool_shape),
                         "paged_attention", (tuple(q_shape),
                                             tuple(pool_shape)))


def paged_prefill_uses_kernel(q_shape, pool_shape,
                              use_kernel: Optional[bool] = None,
                              device=None) -> bool:
    """The prefill twin of `paged_attention_uses_kernel`."""
    return _takes_kernel(use_kernel, device,
                         paged_prefill_shapes_supported(q_shape, pool_shape),
                         "paged_prefill", (tuple(q_shape),
                                           tuple(pool_shape)))


def paged_attention(q, pool_k, pool_v, tables, lengths, pad=None,
                    scale=None, use_kernel: Optional[bool] = None):
    """Decode attention over the block-paged pool: q [C, H, hd], pool
    [n_blocks, P, Hkv, hd], tables [C, M], lengths [C] -> [C, H, hd].
    The kernel path when the dispatch says so and the shapes pass the
    Hopper gate; the gathering reference when it does not, except that
    CUDA tensors whose shapes the gate refuses raise unless the
    reference was asked for."""
    if paged_attention_uses_kernel(q.shape, pool_k.shape, use_kernel,
                                   q.device):
        return paged_attention_op(q, pool_k, pool_v, tables, lengths,
                                  pad=pad, scale=scale)
    return paged_attention_reference(q, pool_k, pool_v, tables, lengths,
                                     pad=pad, scale=scale)


def paged_prefill(q, pool_k, pool_v, tables, pos: int, pad=None,
                  scale=None, use_kernel: Optional[bool] = None):
    """Chunked causal prefill attention over the pool: q [B, CH, H, hd],
    chunk token j at cache position ``pos + j`` -> [B, CH, H, hd]."""
    if paged_prefill_uses_kernel(q.shape, pool_k.shape, use_kernel,
                                 q.device):
        return paged_prefill_op(q, pool_k, pool_v, tables, pos, pad=pad,
                                scale=scale)
    return paged_prefill_reference(q, pool_k, pool_v, tables, pos,
                                   pad=pad, scale=scale)
