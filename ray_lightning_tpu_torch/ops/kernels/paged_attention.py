"""Paged decode attention: the CUDA kernel's wrapper, its plain PyTorch
version and its Hopper shape gate.

The kernel (`ops/csrc/paged_attention.cu`) replaces
`ray_lightning_tpu/ops/pallas/paged_attention.py` `_decode_kernel`. It is
bound by the bytes of the visible K/V it must read; its design (the cache
split into ranges of 16-position tiles so a 4-slot decode still fills
the card, one warp per range and KV head holding all of that head's
query heads in one tensor-core row tile, a small merge kernel) is
described in the source.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from ray_lightning_tpu_torch.ops import build

#: cache positions per kernel tile
TILE = 16
#: tiles each split covers at least, so a split's fixed cost (its q load
#: and partial write) stays small against its K/V reads
_MIN_TILES_PER_SPLIT = 2


def paged_shapes_supported(q_shape, pool_shape) -> bool:
    """Would the decode kernel accept these shapes? q [C, H, hd], pool
    [n_blocks, P, Hkv, hd]: hd 64 or 128 (whole k-steps of 16), any
    block size (the kernel looks each position's block up), whole GQA
    ratio with at most 16 query heads per KV head (one m16 row tile).
    Dispatch callers use `ops.attention.paged_attention_uses_kernel`."""
    if len(q_shape) != 3 or len(pool_shape) != 4:
        return False
    _, h, hd = q_shape
    _, p, hkv, hd2 = pool_shape
    return (hd == hd2 and hd in (64, 128) and p >= 1
            and hkv >= 1 and h % hkv == 0 and h // hkv <= 16)


def paged_attention_plain(q, pool_k, pool_v, tables, lengths, pad=None,
                          scale=None):
    """The kernel's arithmetic in plain PyTorch: f32 scores, mask
    ``pad <= kv_pos < length``, f32 softmax statistics, the unnormalised
    probabilities rounded to q's dtype for the PV product (as the
    kernel's tensor cores take them; a no-op in f32), zeros for a slot
    that sees nothing, one rounding to q's dtype at the end."""
    c, h, hd = q.shape
    _, p, hkv, _ = pool_k.shape
    m = tables.shape[1]
    n_rep = h // hkv
    scale = scale if scale is not None else hd ** -0.5
    idx = tables.long()
    k = pool_k[idx].reshape(c, m * p, hkv, hd).float()
    v = pool_v[idx].reshape(c, m * p, hkv, hd).float()
    qg = q.float().reshape(c, hkv, n_rep, hd)
    s = torch.einsum("cgrd,ckgd->cgrk", qg, k) * scale
    kv_pos = torch.arange(m * p, device=q.device)[None, :]
    visible = kv_pos < lengths[:, None]
    if pad is not None:
        visible = visible & (kv_pos >= pad[:, None])
    visible = visible[:, None, None, :]
    s = s.masked_fill(~visible, float("-inf"))
    mx = s.amax(dim=-1, keepdim=True)
    mx = torch.where(torch.isfinite(mx), mx, torch.zeros_like(mx))
    pr = torch.exp(s - mx)
    l = pr.sum(dim=-1, keepdim=True)
    o = torch.einsum("cgrk,ckgd->cgrd", pr.to(q.dtype).float(), v)
    o = o / torch.where(l == 0, torch.ones_like(l), l)
    return o.reshape(c, h, hd).to(q.dtype)


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """The card's streaming multiprocessors (the split plans' input)."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def split_plan(c: int, hkv: int, n_tiles: int, sms: int):
    """(n_split, tiles per split) for C slots x Hkv heads over a cache of
    ``n_tiles`` 16-position tiles: about sixteen single-warp blocks per
    SM in all, so an SM has enough loads in flight to cover their
    latency."""
    want = max(1, -(-16 * sms // (c * hkv)))
    n_split = max(1, min(want, n_tiles // _MIN_TILES_PER_SPLIT))
    tps = -(-n_tiles // n_split)
    return -(-n_tiles // tps), tps


def _lib():
    lib = build.load("paged_attention")
    fn = lib.paged_decode_bf16
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 + [
            ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _check_cuda(q, pool_k, pool_v, tables, lengths, pad):
    dev = q.device
    named = dict(q=q, pool_k=pool_k, pool_v=pool_v, tables=tables,
                 lengths=lengths, pad=pad)
    for name, t in named.items():
        if t.device != dev:
            raise ValueError(f"paged_attention: {name} on {t.device}, "
                             f"q on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"paged_attention: {name} is not contiguous")
    for name in ("q", "pool_k", "pool_v"):
        if named[name].dtype != torch.bfloat16:
            raise ValueError(f"paged_attention: {name} must be bfloat16, "
                             f"got {named[name].dtype}")
        if named[name].data_ptr() % 16:
            raise ValueError(f"paged_attention: {name} not 16-byte aligned")
    for name in ("tables", "lengths", "pad"):
        if named[name].dtype != torch.int32:
            raise ValueError(f"paged_attention: {name} must be int32")
    c, h, hd = q.shape
    if not paged_shapes_supported(q.shape, pool_k.shape) or \
            pool_v.shape != pool_k.shape or tables.shape[0] != c or \
            lengths.shape != (c,) or pad.shape != (c,):
        raise ValueError(
            f"paged_attention: unsupported shapes q {tuple(q.shape)}, pool "
            f"{tuple(pool_k.shape)}, tables {tuple(tables.shape)}")


def paged_attention_kernel(q: torch.Tensor, pool_k: torch.Tensor,
                           pool_v: torch.Tensor, tables: torch.Tensor,
                           lengths: torch.Tensor,
                           pad: Optional[torch.Tensor] = None,
                           scale: Optional[float] = None) -> torch.Tensor:
    """Decode attention over the paged pool, [C, H, hd] out. CPU tensors
    run `paged_attention_plain`; CUDA tensors launch the kernel (two
    CUDA launches: partials and merge, counted as one) or raise."""
    if not q.is_cuda:
        return paged_attention_plain(q, pool_k, pool_v, tables, lengths,
                                     pad=pad, scale=scale)
    if pad is None:
        pad = torch.zeros_like(lengths)
    _check_cuda(q, pool_k, pool_v, tables, lengths, pad)
    c, h, hd = q.shape
    _, p, hkv, _ = pool_k.shape
    m = tables.shape[1]
    scale = scale if scale is not None else hd ** -0.5
    n_split, tps = split_plan(c, hkv, -(-m * p // TILE),
                              sm_count(q.device.index))
    part_acc = torch.empty((c, h, n_split, hd), dtype=torch.float32,
                           device=q.device)
    part_ml = torch.empty((c, h, n_split, 2), dtype=torch.float32,
                          device=q.device)
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _lib()(q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(),
                tables.data_ptr(), lengths.data_ptr(), pad.data_ptr(),
                part_acc.data_ptr(), part_ml.data_ptr(), out.data_ptr(),
                c, h, hkv, hd, p, m, n_split, tps, float(scale), stream)
    build.check(rc, "paged_decode_bf16")
    paged_attention_kernel.launches += 1
    return out


#: wrapper calls that launched the kernel since the last reset
paged_attention_kernel.launches = 0
