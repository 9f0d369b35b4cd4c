"""The port's `core/text.py` against the JAX package's, on the CPU: the
six cases of tests/test_text.py, each output equal to JAX's element for
element (same dtypes, same keys), and the packed rows training the
port's tiny Llama."""
from __future__ import annotations

import numpy as np
import pytest

from ray_lightning_tpu.core import text as jax_text
from ray_lightning_tpu_torch.core import text


def _same(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_chunk_tokens_layout():
    t = np.arange(33)
    out = text.chunk_tokens(t, seq_len=8)
    assert out["tokens"].shape == (4, 9)
    np.testing.assert_array_equal(out["tokens"][0], np.arange(9))
    np.testing.assert_array_equal(out["tokens"][1], np.arange(8, 17))
    _same(out, jax_text.chunk_tokens(t, seq_len=8))


def test_chunk_too_short_raises():
    for mod in (text, jax_text):
        with pytest.raises(ValueError, match="cannot fill"):
            mod.chunk_tokens(np.arange(4), seq_len=8)


def test_pack_sequences_with_eos_and_mask():
    docs = [[1, 2, 3], [4, 5], [6, 7, 8, 9, 10, 11]]
    out = text.pack_sequences(docs, seq_len=6, eos_id=99, drop_last=False)
    toks, mask = out["tokens"], out["mask"]
    assert toks.shape[1] == 7 and mask.shape[1] == 6
    np.testing.assert_array_equal(toks[0], [1, 2, 3, 99, 4, 5, 99])
    assert mask[0].sum() == 6
    assert mask[-1].sum() < 6
    assert (toks[-1][int(mask[-1].sum()) + 1:] == 0).all()
    _same(out, jax_text.pack_sequences(docs, seq_len=6, eos_id=99,
                                       drop_last=False))


def test_pack_feeds_llama():
    """Packed rows, equal to JAX's, train the port's tiny Llama."""
    import torch

    from ray_lightning_tpu_torch.core.data import DataLoader
    from ray_lightning_tpu_torch.core.trainer import Trainer
    from ray_lightning_tpu_torch.models.llama import LlamaConfig, LlamaModule
    from ray_lightning_tpu_torch.parallel.strategy import SingleDevice

    cfg = LlamaConfig.tiny(dtype=torch.float32)
    rng = np.random.default_rng(0)
    docs = [rng.integers(1, cfg.vocab_size, rng.integers(5, 40)).tolist()
            for _ in range(64)]
    data = text.pack_sequences(docs, seq_len=32, eos_id=0)
    _same(data, jax_text.pack_sequences(docs, seq_len=32, eos_id=0))
    module = LlamaModule(cfg, lr=1e-3, warmup_steps=1, total_steps=4)
    trainer = Trainer(strategy=SingleDevice(device="cpu"), max_epochs=1,
                      limit_train_batches=2, enable_checkpointing=False,
                      enable_progress_bar=False)
    trainer.fit(module, DataLoader(data, batch_size=8))
    assert np.isfinite(float(trainer.callback_metrics["loss"]))
    assert trainer.global_step == 2


def test_chunk_short_stream_keep_tail():
    out = text.chunk_tokens(np.arange(5), seq_len=8, drop_last=False)
    assert out["tokens"].shape == (1, 9)
    np.testing.assert_array_equal(out["tokens"][0][:5], np.arange(5))
    assert out["mask"][0].sum() == 4
    _same(out, jax_text.chunk_tokens(np.arange(5), seq_len=8,
                                     drop_last=False))
    with pytest.raises(ValueError):
        text.chunk_tokens(np.arange(4), seq_len=8)


def test_empty_stream_raises_not_fabricates():
    for mod in (text, jax_text):
        with pytest.raises(ValueError, match="cannot fill"):
            mod.pack_sequences([], seq_len=8, drop_last=False)
        with pytest.raises(ValueError, match="cannot fill"):
            mod.chunk_tokens(np.zeros(0, np.int32), seq_len=8,
                             drop_last=False)


class _Tok:
    """An HF-style tokenizer: ``encode`` and the special ids."""

    eos_token_id, pad_token_id = 2, 1

    def encode(self, s):
        return [3 + ord(c) % 50 for c in s]


@pytest.mark.parametrize("add_eos,drop_last", [(True, True), (False, False)])
def test_tokenize_and_pack_matches_jax(add_eos, drop_last):
    texts = ["the quick brown fox", "jumps", "over the lazy dog " * 3]
    kw = dict(seq_len=8, add_eos=add_eos, drop_last=drop_last)
    _same(text.tokenize_and_pack(texts, _Tok(), **kw),
          jax_text.tokenize_and_pack(texts, _Tok(), **kw))
