"""The port's `llama_params_from_hf` against a `transformers` Llama built
offline from a config with random weights (tests/test_hf_interop.py's
setup) and against the JAX converter, on the CPU.

  * the port's model on the converted weights gives HF's logits, 5e-4
    (the JAX test's tolerance), untied and tied;
  * the state dict equals JAX `llama_params_from_hf` -> `params_from_jax`
    bitwise, with and without HF's ``model.`` prefix, numpy or torch;
  * a tied config takes the embedding as the head and refuses a distinct
    ``lm_head.weight``; an untied config given a tied checkpoint reuses
    the embedding; a missing key names itself.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import transformers

from ray_lightning_tpu.models.hf_interop import (
    llama_params_from_hf as jax_from_hf,
)
from ray_lightning_tpu.models.llama import LlamaConfig as JaxConfig
from ray_lightning_tpu_torch.models import llama_params_from_hf
from ray_lightning_tpu_torch.models.llama import (
    Llama,
    LlamaConfig,
    params_from_jax,
)

DIMS = dict(vocab_size=256, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
            hidden_dim=128, max_seq_len=256)


def _hf(tie: bool, seed: int = 0):
    hf_cfg = transformers.LlamaConfig(
        vocab_size=DIMS["vocab_size"], hidden_size=DIMS["dim"],
        num_hidden_layers=DIMS["n_layers"],
        num_attention_heads=DIMS["n_heads"],
        num_key_value_heads=DIMS["n_kv_heads"],
        intermediate_size=DIMS["hidden_dim"],
        max_position_embeddings=DIMS["max_seq_len"], rope_theta=500000.0,
        rms_norm_eps=1e-5, attention_bias=False, tie_word_embeddings=tie)
    torch.manual_seed(seed)
    hf = transformers.LlamaForCausalLM(hf_cfg)
    hf.eval()
    return hf


def _cfg(tie: bool) -> LlamaConfig:
    return LlamaConfig(**DIMS, dtype=torch.float32, remat=False,
                       tie_embeddings=tie)


@pytest.mark.parametrize("tie", [False, True])
def test_llama_matches_hf_logits(tie):
    hf = _hf(tie)
    ids = np.random.default_rng(2).integers(0, DIMS["vocab_size"], (2, 16))
    with torch.no_grad():
        ref = hf(torch.tensor(ids, dtype=torch.long)).logits.numpy()
    cfg = _cfg(tie)
    model = Llama(cfg, device="cpu")
    model.load_state_dict(llama_params_from_hf(hf.state_dict(), cfg))
    with torch.no_grad():
        ours = model(torch.tensor(ids)).numpy()
    np.testing.assert_allclose(ours, ref, atol=5e-4, rtol=5e-4)


@pytest.mark.parametrize("tie", [False, True])
@pytest.mark.parametrize("form", ["torch", "numpy", "no_prefix"])
def test_state_dict_equals_jax_converter(tie, form):
    hf = _hf(tie, seed=1)
    sd = hf.state_dict()
    np_sd = {k: v.numpy() for k, v in sd.items()}
    given = {"torch": sd, "numpy": np_sd,
             "no_prefix": {k.removeprefix("model."): v
                           for k, v in sd.items()}}[form]
    cfg = _cfg(tie)
    got = llama_params_from_hf(given, cfg, dtype=torch.float32)
    jcfg = JaxConfig(**DIMS, dtype=jnp.float32, tie_embeddings=tie)
    want = params_from_jax(jax.tree.map(np.asarray, jax_from_hf(np_sd, jcfg)),
                           cfg, dtype=torch.float32)
    assert set(got) == set(want)
    assert ("lm_head" in got) == (not tie)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
    # the serving default stores the matmul weights in cfg.dtype
    bf = llama_params_from_hf(given, LlamaConfig(**DIMS, tie_embeddings=tie))
    assert bf["layers.0.wqkv"].dtype == torch.bfloat16
    assert bf["layers.0.attn_norm"].dtype == torch.float32


def test_tied_and_untied_checkpoints_and_missing_keys():
    untied = _hf(False, seed=2).state_dict()
    with pytest.raises(ValueError, match="distinct lm_head"):
        llama_params_from_hf(untied, _cfg(True))
    # a tied checkpoint without its head: an untied config reuses the
    # embedding
    tied = {k: v for k, v in _hf(True, seed=3).state_dict().items()
            if k != "lm_head.weight"}
    got = llama_params_from_hf(tied, _cfg(False), dtype=torch.float32)
    assert torch.equal(got["lm_head"], got["tok_embed"])
    with pytest.raises(KeyError, match="missing"):
        llama_params_from_hf({"bogus": np.zeros(3)}, _cfg(False))
