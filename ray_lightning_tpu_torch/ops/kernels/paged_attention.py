"""Paged decode attention: the CUDA kernel's wrapper, its plain PyTorch
version, its launch plan (with a Python twin of the kernel's range
arithmetic) and its Hopper shape gate.

The kernel (`ops/csrc/paged_attention.cu`) replaces
`ray_lightning_tpu/ops/pallas/paged_attention.py` `_decode_kernel`. It is
bound by the bytes of the visible K/V it must read. One launch: each
(slot, KV head) is a thread-block cluster of R blocks; each block cuts the
slot's visible span into R runs of 64-position tiles from the lengths on
the device, walks its own run with two tiles in flight, and the cluster
merges its partials in shared memory (described in the source).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from ray_lightning_tpu_torch.ops import build

#: cache positions per kernel tile (16 for each of a block's four warps)
TILE = 64
#: blocks (ranges) per (slot, KV head) cluster at most; 8 is the portable
#: cluster size, 16 the largest the card allows
MAX_RANGES = 8


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
    """The card's streaming multiprocessors (the launch plans' input)."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def decode_plan(c: int, hkv: int, cache: int, sms: int) -> int:
    """R, the ranges (blocks of one cluster) of each (slot, KV head) for C
    slots x Hkv heads over a table of ``cache`` positions: about two
    blocks per SM in all (three fit an SM at once), at most `MAX_RANGES`,
    and no more than the table has tiles. The lengths are on the device;
    each block cuts its own run from them (`decode_ranges`)."""
    want = -(-2 * sms // (c * hkv))
    return max(1, min(MAX_RANGES, want, -(-cache // TILE)))


def decode_ranges(length: int, pad: int, cache: int, ranges: int,
                  tile: int = TILE):
    """[(first tile, end tile)] that each of the ``ranges`` blocks of one
    (slot, KV head) walks: the visible span [pad, length), cut to the
    table's ``cache`` positions, in whole tiles, split into near-equal
    runs in range order (twin of paged_attention.cu `run_of`)."""
    lo, hi = max(pad, 0), max(0, min(length, cache))
    t0 = lo // tile
    n = -(-hi // tile) - t0 if hi > lo else 0
    return [(t0 + r * n // ranges, t0 + (r + 1) * n // ranges)
            for r in range(ranges)]


def _lib():
    lib = build.load("paged_attention")
    fn = lib.paged_decode_bf16
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [
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
            tables.dim() != 2 or tables.shape[1] < 1 or \
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
    run `paged_attention_plain`; CUDA tensors launch the kernel (one
    CUDA launch) or raise."""
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
    out = torch.empty_like(q)
    rc = _lib()(q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(),
                tables.data_ptr(), lengths.data_ptr(), pad.data_ptr(),
                out.data_ptr(), c, h, hkv, hd, p, m,
                decode_plan(c, hkv, m * p, sm_count(q.device.index)),
                float(scale), torch._C._cuda_getCurrentRawStream(q.device.index))
    build.check(rc, "paged_decode_bf16")
    paged_attention_kernel.launches += 1
    return out


#: wrapper calls that launched the kernel since the last reset
paged_attention_kernel.launches = 0

#: ``rltt::paged_decode``, defined through `torch.library.Library` for the
#: reason `ops/kernels/flash.py` gives for ``rltt::flash_fwd``
_LIB = torch.library.Library("rltt", "FRAGMENT")
_LIB.define("paged_decode(Tensor q, Tensor pool_k, Tensor pool_v, "
            "Tensor tables, Tensor lengths, Tensor? pad, float? scale) "
            "-> Tensor")


def paged_attention_op(q: torch.Tensor, pool_k: torch.Tensor,
                       pool_v: torch.Tensor, tables: torch.Tensor,
                       lengths: torch.Tensor,
                       pad: Optional[torch.Tensor] = None,
                       scale: Optional[float] = None) -> torch.Tensor:
    """`paged_attention_kernel` as the operator ``rltt::paged_decode``."""
    return torch.ops.rltt.paged_decode.default(q, pool_k, pool_v, tables,
                                               lengths, pad, scale)


def _paged_decode_impl(q, pool_k, pool_v, tables, lengths, pad, scale):
    return paged_attention_kernel(q, pool_k, pool_v, tables, lengths,
                                  pad=pad, scale=scale)


_LIB.impl("paged_decode", _paged_decode_impl, "CompositeExplicitAutograd")
_LIB.impl("paged_decode", lambda q, *_: torch.empty_like(q), "Meta")
