"""The AdamW step over many tensors: the CUDA kernel's wrapper and its
plain PyTorch version.

The kernel (`ops/csrc/adamw.cu`) replaces no Pallas kernel: in the JAX
package the update is optax's ``adamw(mu_dtype=...)``, fused by XLA. It
exists because no PyTorch optimizer has optax's semantics with a narrow
first moment: optax computes the update from the f32 new moment and only
then rounds the moment to ``mu_dtype`` for storage (torch's fused AdamW
keeps its moments in the parameters' dtype). The kernel takes a bf16
first moment only (an f32 one is torch's fused AdamW's state); the plain
version takes either. It is bound by bytes (24 bytes an element: p, g,
m, v read, p, m, v written) and streams every tensor in one launch; its
design is in the source.

The arithmetic, in optax's order (``scale_by_adam``, then
``add_decayed_weights``, then the negated learning rate), each operation
rounded on its own::

    m' = (1 - b1) * g + [b1 * m]     # [.]: a product in m's dtype
    v' = (1 - b2) * g * g + b2 * v
    u  = (m' / (1 - b1^t)) / (sqrt(v' / (1 - b2^t)) + eps) + wd * p
    p' = p + (-lr) * u               # t = the tensor's step count + 1

and ``m'`` is stored rounded to m's dtype. ``[b1 * m]`` is what JAX
computes for ``decay * mu`` with a bf16 ``mu``: a weak-typed scalar keeps
the product in bf16, so b1 itself rounds to bf16 (0.8984375 for 0.9) and
so does the product; with an f32 moment it is the plain f32 product.

The learning rate and the skip flag are device scalars: with
``found_inf`` nonzero the step leaves parameters, moments and step counts
as they were, with no host read (the trainguard's skip, as torch's fused
optimizers take it). Each tensor's step count is an f32 device scalar,
as torch's fused AdamW keeps it.
"""
from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence

import torch

from ray_lightning_tpu_torch.ops import build

#: tensors one launch carries (the kernel's parameter table)
MAX_TENSORS = 128


def _decay_in(beta1: float, mu_dtype: torch.dtype) -> float:
    """b1 as a product with a moment of ``mu_dtype`` sees it."""
    return float(torch.tensor(beta1, dtype=mu_dtype).float())


def adamw_step_plain(params: Sequence[torch.Tensor],
                     grads: Sequence[torch.Tensor],
                     exp_avgs: Sequence[torch.Tensor],
                     exp_avg_sqs: Sequence[torch.Tensor],
                     steps: Sequence[torch.Tensor], lr: torch.Tensor,
                     found_inf: Optional[torch.Tensor], beta1: float,
                     beta2: float, eps: float, weight_decay: float) -> None:
    """The kernel's arithmetic in plain PyTorch, tensor by tensor, in
    place: parameters and ``exp_avg_sqs`` f32, ``exp_avgs`` f32 or bf16,
    ``steps`` f32 scalars, ``lr`` and ``found_inf`` device scalars."""
    keep = None if found_inf is None else found_inf != 0
    for p, g, m, v, s in zip(params, grads, exp_avgs, exp_avg_sqs, steps):
        t = s + 1
        # filled on the device: a tensor copied from a host scalar costs a
        # synchronising copy
        b1 = torch.full((), beta1, dtype=torch.float32, device=p.device)
        b2 = torch.full((), beta2, dtype=torch.float32, device=p.device)
        # [b1 * m] in m's dtype: torch would multiply a bf16 tensor by
        # the f32 scalar, so round b1 first, multiply in f32 (exact) and
        # round the product
        decay = (_decay_in(beta1, m.dtype) * m.float()).to(m.dtype)
        mn = (1 - beta1) * g + decay.float()
        vn = (1 - beta2) * (g * g) + beta2 * v
        u = (mn / (1 - b1 ** t)) / (torch.sqrt(vn / (1 - b2 ** t)) + eps)
        u = u + weight_decay * p
        pn = p + (-lr) * u
        mn = mn.to(m.dtype)
        if keep is not None:
            pn, mn, vn = (torch.where(keep, a, b)
                          for a, b in ((p, pn), (m, mn), (v, vn)))
            t = torch.where(keep, s, t)
        p.copy_(pn)
        m.copy_(mn)
        v.copy_(vn)
        s.copy_(t)


def _lib():
    fn = build.load("adamw").adamw_step
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p, ctypes.c_int]
                       + [ctypes.c_void_p] * 3 + [ctypes.c_float] * 7
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _check_cuda(params, grads, exp_avgs, exp_avg_sqs, steps, lr,
                found_inf) -> None:
    dev = params[0].device
    for p, g, m, v, s in zip(params, grads, exp_avgs, exp_avg_sqs, steps):
        for name, x, dt in (("param", p, torch.float32),
                            ("grad", g, torch.float32),
                            ("exp_avg", m, torch.bfloat16),
                            ("exp_avg_sq", v, torch.float32),
                            ("step", s, torch.float32)):
            if x.device != dev or x.dtype != dt or not x.is_contiguous():
                raise ValueError(
                    f"adamw_step: {name} {tuple(x.shape)} {x.dtype} on "
                    f"{x.device} (want contiguous {dt} on {dev})")
        if not (g.shape == m.shape == v.shape == p.shape
                and s.numel() == 1):
            raise ValueError(f"adamw_step: shapes differ for a parameter "
                             f"{tuple(p.shape)}")
    for name, x in (("lr", lr), ("found_inf", found_inf)):
        if x is not None and (x.device != dev or x.dtype != torch.float32
                              or x.numel() != 1):
            raise ValueError(f"adamw_step: {name} must be an f32 scalar on "
                             f"{dev}, got {x.dtype} {tuple(x.shape)} on "
                             f"{x.device}")


def adamw_step_kernel(params: List[torch.Tensor], grads, exp_avgs,
                      exp_avg_sqs, steps, lr: torch.Tensor,
                      found_inf: Optional[torch.Tensor], beta1: float,
                      beta2: float, eps: float, weight_decay: float,
                      done: Optional[torch.Tensor] = None) -> None:
    """One AdamW step over every tensor, in place. CPU tensors run
    `adamw_step_plain`; CUDA tensors (``exp_avgs`` bf16, the rest f32)
    launch the kernel (one launch per `MAX_TENSORS` tensors) or raise.
    ``done`` is the kernel's int32 scratch of one counter a tensor, zero
    between launches (made here when None; an optimizer keeps its
    own)."""
    if not params:
        return
    if not params[0].is_cuda:
        adamw_step_plain(params, grads, exp_avgs, exp_avg_sqs, steps, lr,
                         found_inf, beta1, beta2, eps, weight_decay)
        return
    _check_cuda(params, grads, exp_avgs, exp_avg_sqs, steps, lr, found_inf)
    dev = params[0].device
    n = len(params)
    if done is None or done.numel() < n:
        done = torch.zeros(n, dtype=torch.int32, device=dev)
    fn = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        for lo in range(0, n, MAX_TENSORS):
            hi = min(n, lo + MAX_TENSORS)
            table = (ctypes.c_uint64 * (6 * MAX_TENSORS))()
            for j, i in enumerate(range(lo, hi)):
                for col, x in enumerate((params[i], grads[i], exp_avgs[i],
                                         exp_avg_sqs[i], steps[i])):
                    table[col * MAX_TENSORS + j] = x.data_ptr()
                table[5 * MAX_TENSORS + j] = params[i].numel()
            rc = fn(ctypes.addressof(table), hi - lo, done[lo:].data_ptr(),
                    lr.data_ptr(),
                    None if found_inf is None else found_inf.data_ptr(),
                    beta1, _decay_in(beta1, torch.bfloat16), 1 - beta1, beta2,
                    1 - beta2, eps, weight_decay, stream)
            build.check(rc, "adamw_step")
            adamw_step_kernel.launches += 1


#: wrapper calls' kernel launches since the last reset
adamw_step_kernel.launches = 0


def adamw_bytes(params: Sequence[torch.Tensor],
                exp_avgs: Sequence[torch.Tensor]) -> int:
    """The bytes a step must move: p, g, m, v read and p, m, v written
    once each."""
    return sum(p.numel() * (4 * 5 + 2 * m.element_size())
               for p, m in zip(params, exp_avgs))
