"""Single home for the kernel-dispatch policy (twin of
`ray_lightning_tpu/ops/dispatch.py`).

An op takes its hand-written CUDA kernel exactly when its input
lies on a CUDA device and nothing in the current context forces the
plain reference path. There is no backend probe and no fallback: a
kernel that cannot build or launch raises.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Optional, Union

import torch

#: context-scoped override: None = device decides, False = reference
#: forced, True = kernel allowed even inside an outer force_reference
_forced: contextvars.ContextVar[Optional[bool]] = contextvars.ContextVar(
    "rltt_kernel_forced", default=None)


@contextlib.contextmanager
def _pinned(value: Optional[bool]):
    token = _forced.set(value)
    try:
        yield
    finally:
        _forced.reset(token)


def force_reference():
    """Pin dispatch to the plain reference path for the current context
    (twin of `force_xla`)."""
    return _pinned(False)


def force_kernel():
    """Undo an enclosing `force_reference` for the current context (twin
    of `force_pallas`). The kernel still runs only on CUDA tensors."""
    return _pinned(True)


def checkpoint_context_fn():
    """``context_fn`` for `torch.utils.checkpoint`: the recomputation runs
    under the policy the forward ran under. The backward (and with it the
    recomputation) of CUDA tensors runs on autograd's device thread,
    which does not see this thread's context, so without it a forward
    under `force_reference` would be recomputed through the kernels."""
    return contextlib.nullcontext(), _pinned(_forced.get())


def reference_forced() -> bool:
    """Does the current context pin the plain reference path?"""
    return _forced.get() is False


def use_kernel(x: Union[torch.Tensor, torch.device, str]) -> bool:
    """True exactly when ``x`` (a tensor, or the device it would live
    on) is on CUDA and nothing forces the reference path."""
    dev = x.device if isinstance(x, torch.Tensor) else torch.device(x)
    return dev.type == "cuda" and not reference_forced()
