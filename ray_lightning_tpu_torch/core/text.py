"""Text/LM data preparation: chunking and sequence packing (twin of
`ray_lightning_tpu/core/text.py`, the same numpy code).

Both helpers emit fixed-[N, seq_len+1] token matrices ready for the
Llama family's {"tokens", "mask"} batch format (models/llama.py
`LlamaModule._split`), where column i is the input and column i+1 its
target; one shape a step. All hot paths are numpy-vectorized (stride
tricks + concatenate), with no per-token Python loops, so corpus-scale
inputs stay 4 bytes a token.
"""
from __future__ import annotations

from typing import Dict, Iterable, Optional, Sequence

import numpy as np


def _rows_from_stream(t: np.ndarray, seq_len: int, pad_id: int,
                      drop_last: bool) -> Dict[str, np.ndarray]:
    """Shared chunker: [len] stream -> {"tokens": [N, S+1], "mask"?}.

    Rows stride by S (one-token overlap carries the boundary target).
    A padded tail row (drop_last=False) comes with a target mask; full
    rows need none, so "mask" is only emitted when padding exists.
    """
    stride = seq_len
    n = max(0, (len(t) - 1) // stride)  # empty stream must not underflow
    rows = []
    if n >= 1:
        windows = np.lib.stride_tricks.sliding_window_view(t, seq_len + 1)
        rows.append(np.ascontiguousarray(windows[::stride][:n]))
    tail_len = len(t) - n * stride  # includes the overlap token
    has_tail = not drop_last and tail_len > 1
    if has_tail:
        tail = t[n * stride:]
        pad = np.full(seq_len + 1 - len(tail), pad_id, np.int32)
        rows.append(np.concatenate([tail, pad])[None])
    if not rows:
        raise ValueError(
            f"stream of {len(t)} tokens cannot fill a row of "
            f"seq_len+1={seq_len + 1}"
            + ("" if drop_last else " (need at least 2 tokens)")
        )
    tokens = np.concatenate(rows) if len(rows) > 1 else rows[0]
    out = {"tokens": tokens}
    if has_tail:
        mask = np.ones((len(tokens), seq_len), np.float32)
        mask[-1] = 0.0
        mask[-1, : tail_len - 1] = 1.0
        out["mask"] = mask
    return out


def chunk_tokens(flat_tokens, seq_len: int, drop_last: bool = True,
                 pad_id: int = 0) -> Dict[str, np.ndarray]:
    """Split one long token stream into [N, seq_len+1] training rows.

    With ``drop_last=False`` the padded tail row is kept and a target
    ``mask`` is emitted so padding never contributes loss.
    """
    t = np.asarray(flat_tokens, dtype=np.int32).reshape(-1)
    return _rows_from_stream(t, seq_len, pad_id, drop_last)


def pack_sequences(
    docs: Iterable[Sequence[int]],
    seq_len: int,
    pad_id: int = 0,
    eos_id: Optional[int] = None,
    drop_last: bool = True,
) -> Dict[str, np.ndarray]:
    """Greedily pack variable-length documents into fixed rows.

    Documents are laid end-to-end (an ``eos_id`` separator appended to
    each when given). A document longer than a row simply continues into
    the next row (stream semantics) — nothing is truncated. Output
    follows `_rows_from_stream` ({"tokens"} + "mask" iff a padded tail
    row exists).
    """
    parts = []
    eos = (np.asarray([eos_id], np.int32) if eos_id is not None else None)
    for doc in docs:
        parts.append(np.asarray(doc, dtype=np.int32).reshape(-1))
        if eos is not None:
            parts.append(eos)
    t = np.concatenate(parts) if parts else np.zeros(0, np.int32)
    return _rows_from_stream(t, seq_len, pad_id, drop_last)


def tokenize_and_pack(
    texts: Iterable[str],
    tokenizer,
    seq_len: int,
    add_eos: bool = True,
    drop_last: bool = True,
) -> Dict[str, np.ndarray]:
    """Convenience over any HF-style tokenizer (``tokenizer.encode`` +
    ``eos_token_id``/``pad_token_id`` attributes)."""
    eos = getattr(tokenizer, "eos_token_id", None) if add_eos else None
    pad = getattr(tokenizer, "pad_token_id", None)
    docs = (tokenizer.encode(t) for t in texts)
    return pack_sequences(docs, seq_len, pad_id=pad if pad is not None else 0,
                          eos_id=eos, drop_last=drop_last)
