"""Helpers that the trainer, the strategies and the runtime share: the
global norm of the gradients and its clip, and a free TCP port for a
process group's rendezvous.

Importing this module imports no torch, so `runtime/` stays light in the
driver and in workers whose jobs need no torch.
"""
from __future__ import annotations

import socket


def find_free_port(host: str = "127.0.0.1") -> int:
    """A free TCP port on ``host`` (reference ray_ddp.py:152-156's
    MASTER_PORT discovery): the driver's listener and the process
    group's rendezvous."""
    s = socket.socket()
    s.bind((host, 0))
    port = s.getsockname()[1]
    s.close()
    return port


def global_norm(tensors):
    """sqrt of the sum of squares of every element, in f32
    (`optax.global_norm`)."""
    import torch

    if not tensors:
        return torch.zeros(())
    norms = torch._foreach_norm([t.float() if t.dtype != torch.float32
                                 else t for t in tensors])
    return torch.linalg.vector_norm(torch.stack(norms))


def clip_by_global_norm_(grads, norm, max_norm: float) -> None:
    """`optax.clip_by_global_norm` in place: unchanged when the norm is
    below ``max_norm``, else scaled by max_norm / norm."""
    import torch

    factor = torch.where(norm < max_norm, torch.ones_like(norm),
                         max_norm / norm)
    torch._foreach_mul_(grads, factor)
