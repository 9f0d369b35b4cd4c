"""Flash attention, forward and backward: the three CUDA kernels' wrappers,
their plain PyTorch versions, the Hopper shape gate and the autograd
function that ties them together.

The kernels (`ops/csrc/flash_fwd.cu`, `ops/csrc/flash_bwd.cu`) replace
`ray_lightning_tpu/ops/pallas/flash.py` `_fwd_kernel`, `_bwd_dkv_kernel`
and `_bwd_dq_kernel`. All three are bound by operations on the H100 at
the training shape (about 1000 FLOPs per byte read, against the card's
~295), so every product runs on the tensor cores, bf16 in, f32
accumulate. All three use Hopper's own machinery: a producer warpgroup
fills a two-stage ring of tiles by TMA, tracked by mbarriers, and two
consumer warpgroups multiply them with wgmma from swizzled shared memory,
the probabilities (and dS) passed on in registers. The TPU kernels carry
their accumulators across a sequential grid axis; here one block owns an
output tile and walks the other axis itself. dK/dV are summed over the
GQA group inside the block, and dQ is a second pass with no atomics, as
on the TPU.

Layout at every function here: q, o [B, Sq, H, hd]; k, v [B, Sk, Hkv, hd];
lse and delta f32 [B, H, Sq] (the TPU kernels' [B, H, Sq, 1] without its
unit axis). The JAX block sizes (512 / 1024) are TPU facts; the Hopper
kernels take any Sq, Sk >= 1 and hd 64 or 128.

On CPU tensors each wrapper runs its plain version; on CUDA tensors it
launches its kernel or raises. The plain versions repeat the kernels'
arithmetic in f32 with the kernels' rounding points: the probabilities
and dS are rounded to the inputs' dtype before the products they feed (a
no-op in f32; the JAX kernels upcast q, k and v to f32 inside the kernel,
so on the CPU the comparison with JAX is in f32 and on the card against
the plain version in bf16).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ray_lightning_tpu_torch.ops import build

#: masked-score sentinel: exp(-1e30 - -1e30) = 1, never nan, and every
#: masked probability is zeroed explicitly
NEG_INF = -1e30


def flash_shapes_supported(q_shape, k_shape) -> bool:
    """Would the Hopper kernels take these shapes? q [B, Sq, H, hd],
    k [B, Sk, Hkv, hd]: hd 64 or 128 (whole k-steps of 16), a whole GQA
    ratio, Sq and Sk of any length from 1 (the kernels mask the ragged
    tile themselves)."""
    if len(q_shape) != 4 or len(k_shape) != 4:
        return False
    b, sq, h, hd = q_shape
    b2, sk, hkv, hd2 = k_shape
    return (b == b2 and b >= 1 and sq >= 1 and sk >= 1 and hd == hd2
            and hd in (64, 128) and hkv >= 1 and h % hkv == 0)


# ---- plain versions ----------------------------------------------------------


def _scores(q, k, causal: bool, q_offset: int, scale: float):
    """f32 scaled scores grouped by KV head, [B, Hkv, n_rep, Sq, Sk], and
    the [Sq, Sk] visibility mask."""
    b, sq, h, hd = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    qg = q.float().reshape(b, sq, hkv, h // hkv, hd)
    s = torch.einsum("bigrd,bjgd->bgrij", qg, k.float()) * scale
    kv_pos = torch.arange(sk, device=q.device)[None, :]
    q_pos = q_offset + torch.arange(sq, device=q.device)[:, None]
    visible = (q_pos >= kv_pos) if causal else torch.ones(
        sq, sk, dtype=torch.bool, device=q.device)
    return s, visible


def flash_fwd_plain(q, k, v, causal: bool = True, q_offset: int = 0,
                    scale: Optional[float] = None):
    """The forward kernel's arithmetic: (o [B, Sq, H, hd] in q's dtype,
    lse f32 [B, H, Sq]). Masked scores take the sentinel, masked
    probabilities are zero, a query that sees nothing gives zeros and
    lse = -1e30; the unnormalised probabilities are rounded to q's dtype
    for the PV product."""
    b, sq, h, hd = q.shape
    scale = scale if scale is not None else hd ** -0.5
    s, visible = _scores(q, k, causal, q_offset, scale)
    s = s.masked_fill(~visible, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m) * visible
    l = p.sum(dim=-1, keepdim=True)
    safe = torch.where(l == 0, torch.ones_like(l), l)
    o = torch.einsum("bgrij,bjgd->bgrid", p.to(q.dtype).float(), v.float())
    o = (o / safe).permute(0, 3, 1, 2, 4).reshape(b, sq, h, hd)
    lse = (m + torch.log(safe)).reshape(b, h, sq)
    return o.to(q.dtype), lse


def flash_delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(dO * O) in f32, [B, H, Sq]: the one reduction the
    backward computes outside its kernels (as `_bwd` does on the TPU)."""
    return (do.float() * o.float()).sum(dim=-1).transpose(1, 2).contiguous()


def _bwd_probs(q, k, v, do, lse, delta, causal, q_offset, scale):
    """Recomputed P = exp(S * scale - lse) (zero where masked) and
    dS = P * (dP - delta) * scale, f32 [B, Hkv, n_rep, Sq, Sk]."""
    b, sq, h, hd = q.shape
    hkv = k.shape[2]
    s, visible = _scores(q, k, causal, q_offset, scale)
    grouped = (b, hkv, h // hkv, sq, 1)
    p = torch.where(visible, torch.exp(s - lse.reshape(grouped)),
                    torch.zeros_like(s))
    dog = do.float().reshape(b, sq, hkv, h // hkv, hd)
    dp = torch.einsum("bigrd,bjgd->bgrij", dog, v.float())
    return p, p * (dp - delta.reshape(grouped)) * scale


def flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal: bool = True,
                        q_offset: int = 0, scale: Optional[float] = None):
    """Pass 1: (dk, dv) [B, Sk, Hkv, hd] in k's dtype, summed over the
    query heads of each KV head; P and dS rounded to q's dtype first."""
    b, sq, h, hd = q.shape
    hkv = k.shape[2]
    scale = scale if scale is not None else hd ** -0.5
    p, ds = _bwd_probs(q, k, v, do, lse, delta, causal, q_offset, scale)
    grouped = (b, sq, hkv, h // hkv, hd)
    dv = torch.einsum("bgrij,bigrd->bjgd", p.to(q.dtype).float(),
                      do.float().reshape(grouped))
    dk = torch.einsum("bgrij,bigrd->bjgd", ds.to(q.dtype).float(),
                      q.float().reshape(grouped))
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_bwd_dq_plain(q, k, v, do, lse, delta, causal: bool = True,
                       q_offset: int = 0, scale: Optional[float] = None):
    """Pass 2: dq [B, Sq, H, hd] in q's dtype; dS rounded first."""
    b, sq, h, hd = q.shape
    scale = scale if scale is not None else hd ** -0.5
    _, ds = _bwd_probs(q, k, v, do, lse, delta, causal, q_offset, scale)
    dq = torch.einsum("bgrij,bjgd->bigrd", ds.to(q.dtype).float(), k.float())
    return dq.reshape(b, sq, h, hd).to(q.dtype)


def flash_bwd_plain(q, k, v, o, lse, do, causal: bool = True,
                    q_offset: int = 0, scale: Optional[float] = None):
    """The whole backward from the saved (q, k, v, o, lse) and dO:
    (dq, dk, dv), by the same two passes as the kernels."""
    delta = flash_delta(o, do)
    dk, dv = flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal, q_offset,
                                 scale)
    dq = flash_bwd_dq_plain(q, k, v, do, lse, delta, causal, q_offset,
                            scale)
    return dq, dk, dv


# ---- the CUDA kernels --------------------------------------------------------


def _fn(lib_name: str, sym: str, n_ptrs: int, n_ints: int):
    fn = getattr(build.load(lib_name), sym)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints + [
            ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _check_cuda(what: str, q, k, v, **extra) -> None:
    dev = q.device
    named = dict(q=q, k=k, v=v, **extra)
    for name, t in named.items():
        if t.device != dev:
            raise ValueError(f"{what}: {name} on {t.device}, q on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} is not contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} not 16-byte aligned")
        want = torch.float32 if name in ("lse", "delta") else torch.bfloat16
        if t.dtype != want:
            raise ValueError(f"{what}: {name} must be {want}, got {t.dtype}")
    if not flash_shapes_supported(q.shape, k.shape) or v.shape != k.shape:
        raise ValueError(f"{what}: unsupported shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    b, sq, h, _ = q.shape
    for name in ("lse", "delta"):
        if name in named and named[name].shape != (b, h, sq):
            raise ValueError(f"{what}: {name} must be {(b, h, sq)}, got "
                             f"{tuple(named[name].shape)}")
    if "do" in named and named["do"].shape != q.shape:
        raise ValueError(f"{what}: do must match q {tuple(q.shape)}")


def _dims(q, k):
    b, sq, h, hd = q.shape
    return b, sq, k.shape[1], h, k.shape[2], hd


def flash_fwd_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     causal: bool = True, q_offset: int = 0,
                     scale: Optional[float] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o, lse). CPU tensors run `flash_fwd_plain`; CUDA tensors launch
    the forward kernel or raise."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    if not q.is_cuda:
        return flash_fwd_plain(q, k, v, causal, q_offset, scale)
    _check_cuda("flash_fwd", q, k, v)
    b, sq, sk, h, hkv, hd = _dims(q, k)
    o = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _fn("flash_fwd", "flash_fwd_bf16", 5, 8)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), b, sq, sk, h, hkv, hd, int(causal), int(q_offset),
        float(scale), stream)
    build.check(rc, "flash_fwd_bf16")
    flash_fwd_kernel.launches += 1
    return o, lse


def flash_bwd_dkv_kernel(q, k, v, do, lse, delta, causal: bool = True,
                         q_offset: int = 0, scale: Optional[float] = None):
    """Pass 1, (dk, dv) [B, Sk, Hkv, hd]. CPU tensors run
    `flash_bwd_dkv_plain`; CUDA tensors launch the kernel or raise."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    if not q.is_cuda:
        return flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal,
                                   q_offset, scale)
    _check_cuda("flash_bwd_dkv", q, k, v, do=do, lse=lse, delta=delta)
    b, sq, sk, h, hkv, hd = _dims(q, k)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _fn("flash_bwd", "flash_bwd_dkv_bf16", 8, 8)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        b, sq, sk, h, hkv, hd, int(causal), int(q_offset), float(scale),
        stream)
    build.check(rc, "flash_bwd_dkv_bf16")
    flash_bwd_dkv_kernel.launches += 1
    return dk, dv


def flash_bwd_dq_kernel(q, k, v, do, lse, delta, causal: bool = True,
                        q_offset: int = 0, scale: Optional[float] = None):
    """Pass 2, dq [B, Sq, H, hd]. CPU tensors run `flash_bwd_dq_plain`;
    CUDA tensors launch the kernel or raise."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    if not q.is_cuda:
        return flash_bwd_dq_plain(q, k, v, do, lse, delta, causal, q_offset,
                                  scale)
    _check_cuda("flash_bwd_dq", q, k, v, do=do, lse=lse, delta=delta)
    b, sq, sk, h, hkv, hd = _dims(q, k)
    dq = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _fn("flash_bwd", "flash_bwd_dq_bf16", 7, 8)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), b, sq, sk, h, hkv,
        hd, int(causal), int(q_offset), float(scale), stream)
    build.check(rc, "flash_bwd_dq_bf16")
    flash_bwd_dq_kernel.launches += 1
    return dq


#: wrapper calls that launched each kernel since the last reset
flash_fwd_kernel.launches = 0
flash_bwd_dkv_kernel.launches = 0
flash_bwd_dq_kernel.launches = 0


class FlashAttentionFunction(torch.autograd.Function):
    """Flash attention with the kernels' backward (twin of the custom-vjp
    `_flash_bhsd`): the forward saves ``(q, k, v, o, lse)``, as
    `_flash_fwd_rule` does, and the backward computes delta, then runs
    pass 1 (dK, dV) and pass 2 (dQ). Under `torch.utils.checkpoint` the
    forward runs again in the backward, launching its kernel again."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, q_offset: int, scale: float):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        o, lse = flash_fwd_kernel(q, k, v, causal, q_offset, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (causal, q_offset, scale)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.contiguous()
        delta = flash_delta(o, do)
        dk, dv = flash_bwd_dkv_kernel(q, k, v, do, lse, delta, *ctx.args)
        dq = flash_bwd_dq_kernel(q, k, v, do, lse, delta, *ctx.args)
        return dq, dk, dv, None, None, None


def flash_attention_kernel(q, k, v, causal: bool = True, q_offset: int = 0,
                           scale: Optional[float] = None) -> torch.Tensor:
    """Differentiable flash attention on [B, S, H, hd] through the
    kernels (their plain versions on CPU tensors)."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    return FlashAttentionFunction.apply(q, k, v, bool(causal), int(q_offset),
                                        float(scale))
