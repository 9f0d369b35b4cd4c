"""Rotary position embeddings, Llama-3 style (twin of
`ray_lightning_tpu/ops/rope.py`).

Half-split convention (``x1, x2 = split(x, 2)``, not interleaved), f32
tables, rotation done in f32 and cast back to the input dtype.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def rope_frequencies(head_dim: int, max_seq_len: int,
                     theta: float = 500000.0,
                     device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) tables of shape [max_seq_len, head_dim // 2], f32."""
    inv_freq = 1.0 / (theta ** (
        torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
        / head_dim))
    t = torch.arange(max_seq_len, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv_freq)
    return torch.cos(freqs), torch.sin(freqs)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Rotate x [..., S, H, D] with tables [S_max, D/2]; ``positions``
    ([..., S] int) selects table rows (default arange(S))."""
    if positions is None:
        seq_len = x.shape[-3]
        c, s = cos[:seq_len], sin[:seq_len]
    else:
        c, s = cos[positions], sin[positions]
    c = c.unsqueeze(-2)  # broadcast over heads: [..., S, 1, D/2]
    s = s.unsqueeze(-2)
    x1, x2 = x.float().chunk(2, dim=-1)
    rotated = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return rotated.to(x.dtype)
