"""Paged chunked-prefill attention: the CUDA kernel's wrapper, its plain
PyTorch version, its split plan and its Hopper shape gate.

The kernel (`ops/csrc/paged_prefill.cu`) replaces
`ray_lightning_tpu/ops/pallas/paged_prefill.py` `_prefill_kernel`: both
products on wgmma, tiles copied by cp.async into swizzled shared memory.
One thread block (one warpgroup) holds 64 query rows, ``64 // n_rep``
chunk tokens times the n_rep query heads of one KV head (the TPU kernel's
128-token tile follows the TPU's matrix unit, not this card), and walks
one of ``n_split`` ranges of 64-position cache tiles; a merge kernel
combines the ranges' partials, as the decode does.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ray_lightning_tpu_torch.ops import build
from ray_lightning_tpu_torch.ops.kernels.paged_attention import sm_count

#: cache positions per kernel tile
TILE = 64
#: tiles each split covers at least, so a split's fixed cost (its Q load
#: and partial write) stays small against its K/V reads
_MIN_TILES_PER_SPLIT = 2


def q_tile(ch: int, n_rep: int) -> int:
    """Query tokens per thread block: at most 64 query rows in all."""
    return max(1, min(ch, 64 // n_rep))


def split_plan(b: int, hkv: int, n_q_tiles: int, n_tiles: int, sms: int):
    """(n_split, tiles per split) for B group rows x Hkv heads x
    ``n_q_tiles`` query tiles over a walk of ``n_tiles`` 64-position
    tiles: about four blocks per SM in all (two fit an SM at once), each
    range at least two tiles long. One range needs no merge."""
    want = max(1, -(-4 * sms // (b * hkv * n_q_tiles)))
    n_split = max(1, min(want, n_tiles // _MIN_TILES_PER_SPLIT))
    tps = -(-n_tiles // n_split)
    return -(-n_tiles // tps), tps


def launch_plan(b: int, ch: int, h: int, hkv: int, cache: int, pos: int,
                sms: int):
    """(query tokens per block, n_split, tiles per split) of one chunk:
    the walk covers the 64-position tiles up to the chunk's last position
    or the table's end (``cache`` = M * P positions), whichever is
    first."""
    bq = q_tile(ch, h // hkv)
    n_tiles = max(1, -(-min(cache, pos + ch) // TILE))
    return (bq, *split_plan(b, hkv, -(-ch // bq), n_tiles, sms))


def paged_prefill_shapes_supported(q_shape, pool_shape) -> bool:
    """Would the prefill kernel accept these shapes? q [B, CH, H, hd],
    pool [n_blocks, P, Hkv, hd]: hd 64 or 128 (whole k-steps of 16),
    any block size (the kernel copies each cache position on its own,
    looked up in the row's table), whole GQA ratio with at most 64
    query heads per KV head (one block's 64 rows)."""
    if len(q_shape) != 4 or len(pool_shape) != 4:
        return False
    _, ch, h, hd = q_shape
    _, p, hkv, hd2 = pool_shape
    return (ch >= 1 and hd == hd2 and hd in (64, 128) and p >= 1
            and hkv >= 1 and h % hkv == 0 and h // hkv <= 64)


def paged_prefill_plain(q, pool_k, pool_v, tables, pos: int, pad=None,
                        scale=None):
    """The kernel's arithmetic in plain PyTorch: f32 scores, mask
    ``pad[b] <= kv_pos <= pos + j``, f32 softmax statistics, the
    unnormalised probabilities rounded to q's dtype for the PV product
    (as the kernel's tensor cores take them; a no-op in f32), zeros for
    a query that sees nothing, one rounding to q's dtype at the end."""
    b, ch, h, hd = q.shape
    _, p, hkv, _ = pool_k.shape
    m = tables.shape[1]
    n_rep = h // hkv
    scale = scale if scale is not None else hd ** -0.5
    idx = tables.long()
    k = pool_k[idx].reshape(b, m * p, hkv, hd).float()
    v = pool_v[idx].reshape(b, m * p, hkv, hd).float()
    qg = q.float().reshape(b, ch, hkv, n_rep, hd)
    s = torch.einsum("bjgrd,bkgd->bgrjk", qg, k) * scale
    kv_pos = torch.arange(m * p, device=q.device)[None, None, :]
    q_pos = (pos + torch.arange(ch, device=q.device))[None, :, None]
    visible = (kv_pos <= q_pos).expand(b, ch, m * p)
    if pad is not None:
        visible = visible & (kv_pos >= pad[:, None, None])
    visible = visible[:, None, None]
    s = s.masked_fill(~visible, float("-inf"))
    mx = s.amax(dim=-1, keepdim=True)
    mx = torch.where(torch.isfinite(mx), mx, torch.zeros_like(mx))
    pr = torch.exp(s - mx)
    l = pr.sum(dim=-1, keepdim=True)
    o = torch.einsum("bgrjk,bkgd->bgrjd", pr.to(q.dtype).float(), v)
    o = o / torch.where(l == 0, torch.ones_like(l), l)
    return o.permute(0, 3, 1, 2, 4).reshape(b, ch, h, hd).to(q.dtype)


def _lib():
    lib = build.load("paged_prefill")
    fn = lib.paged_prefill_bf16
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 11 + [
            ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _check_cuda(q, pool_k, pool_v, tables, pad):
    dev = q.device
    named = dict(q=q, pool_k=pool_k, pool_v=pool_v, tables=tables, pad=pad)
    for name, t in named.items():
        if t.device != dev:
            raise ValueError(f"paged_prefill: {name} on {t.device}, "
                             f"q on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"paged_prefill: {name} is not contiguous")
    for name in ("q", "pool_k", "pool_v"):
        if named[name].dtype != torch.bfloat16:
            raise ValueError(f"paged_prefill: {name} must be bfloat16, "
                             f"got {named[name].dtype}")
        if named[name].data_ptr() % 16:
            raise ValueError(f"paged_prefill: {name} not 16-byte aligned")
    for name in ("tables", "pad"):
        if named[name].dtype != torch.int32:
            raise ValueError(f"paged_prefill: {name} must be int32")
    b = q.shape[0]
    if not paged_prefill_shapes_supported(q.shape, pool_k.shape) or \
            pool_v.shape != pool_k.shape or tables.shape[0] != b or \
            pad.shape != (b,):
        raise ValueError(
            f"paged_prefill: unsupported shapes q {tuple(q.shape)}, pool "
            f"{tuple(pool_k.shape)}, tables {tuple(tables.shape)}")


def paged_prefill_kernel(q: torch.Tensor, pool_k: torch.Tensor,
                         pool_v: torch.Tensor, tables: torch.Tensor,
                         pos: int, pad: Optional[torch.Tensor] = None,
                         scale: Optional[float] = None) -> torch.Tensor:
    """Chunked causal prefill attention over the paged pool,
    [B, CH, H, hd] out; ``pos`` is the host int write offset. CPU
    tensors run `paged_prefill_plain`; CUDA tensors launch the kernel
    (with a split walk two CUDA launches, partials and merge, counted as
    one) or raise."""
    if not q.is_cuda:
        return paged_prefill_plain(q, pool_k, pool_v, tables, pos,
                                   pad=pad, scale=scale)
    if pad is None:
        pad = torch.zeros(q.shape[0], dtype=torch.int32, device=q.device)
    _check_cuda(q, pool_k, pool_v, tables, pad)
    b, ch, h, hd = q.shape
    _, p, hkv, _ = pool_k.shape
    m = tables.shape[1]
    scale = scale if scale is not None else hd ** -0.5
    bq, n_split, tps = launch_plan(b, ch, h, hkv, m * p, int(pos),
                                   sm_count(q.device.index))
    part_acc = part_ml = None
    if n_split > 1:
        part_acc = torch.empty((b, ch, h, n_split, hd), dtype=torch.float32,
                               device=q.device)
        part_ml = torch.empty((b, ch, h, n_split, 2), dtype=torch.float32,
                              device=q.device)
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _lib()(q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(),
                tables.data_ptr(), pad.data_ptr(),
                None if part_acc is None else part_acc.data_ptr(),
                None if part_ml is None else part_ml.data_ptr(),
                out.data_ptr(), b, ch, h, hkv, hd, p, m, int(pos), bq,
                n_split, tps, float(scale), stream)
    build.check(rc, "paged_prefill_bf16")
    paged_prefill_kernel.launches += 1
    return out


#: wrapper calls that launched the kernel since the last reset
paged_prefill_kernel.launches = 0

#: ``rltt::paged_prefill``, defined through `torch.library.Library` for the
#: reason `ops/kernels/flash.py` gives for ``rltt::flash_fwd``
_LIB = torch.library.Library("rltt", "FRAGMENT")
_LIB.define("paged_prefill(Tensor q, Tensor pool_k, Tensor pool_v, "
            "Tensor tables, int pos, Tensor? pad, float? scale) -> Tensor")


def paged_prefill_op(q: torch.Tensor, pool_k: torch.Tensor,
                     pool_v: torch.Tensor, tables: torch.Tensor, pos: int,
                     pad: Optional[torch.Tensor] = None,
                     scale: Optional[float] = None) -> torch.Tensor:
    """`paged_prefill_kernel` as the operator ``rltt::paged_prefill``."""
    return torch.ops.rltt.paged_prefill.default(q, pool_k, pool_v, tables,
                                                int(pos), pad, scale)


def _paged_prefill_impl(q, pool_k, pool_v, tables, pos, pad, scale):
    return paged_prefill_kernel(q, pool_k, pool_v, tables, pos, pad=pad,
                                scale=scale)


_LIB.impl("paged_prefill", _paged_prefill_impl, "CompositeExplicitAutograd")
_LIB.impl("paged_prefill", lambda q, *_: torch.empty_like(q), "Meta")
