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

BERT (`bert_params_from_hf`, `bert_classifier_params_from_hf`) against
`transformers` `BertModel` / `BertForSequenceClassification` built from
configs (tests/test_hf_interop.py's setup): the encoder's hidden states
within 2e-4 of HF's on the unmasked positions, the pooler within 1e-3
(the JAX tests' tolerances), HF's classifier logits, and the state dict
equal to the JAX converters' through `bert.params_from_jax` bitwise.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import transformers

from ray_lightning_tpu.models.bert import BertConfig as JaxBertConfig
from ray_lightning_tpu.models.hf_interop import (
    bert_classifier_params_from_hf as jax_bert_classifier_from_hf,
)
from ray_lightning_tpu.models.hf_interop import (
    bert_params_from_hf as jax_bert_from_hf,
)
from ray_lightning_tpu.models.hf_interop import (
    llama_params_from_hf as jax_from_hf,
)
from ray_lightning_tpu.models.llama import LlamaConfig as JaxConfig
from ray_lightning_tpu_torch.models import (
    bert_classifier_params_from_hf,
    bert_params_from_hf,
    llama_params_from_hf,
)
from ray_lightning_tpu_torch.models import bert
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


# ---- BERT --------------------------------------------------------------------

BERT_DIMS = dict(vocab_size=256, dim=64, n_layers=2, n_heads=4,
                 hidden_dim=128, max_seq_len=128)


def _hf_bert_config():
    return transformers.BertConfig(
        vocab_size=BERT_DIMS["vocab_size"], hidden_size=BERT_DIMS["dim"],
        num_hidden_layers=BERT_DIMS["n_layers"],
        num_attention_heads=BERT_DIMS["n_heads"],
        intermediate_size=BERT_DIMS["hidden_dim"],
        max_position_embeddings=BERT_DIMS["max_seq_len"], type_vocab_size=2,
        hidden_act="gelu", hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0, layer_norm_eps=1e-12,
        num_labels=3)


def _hf_bert(classifier: bool = False, seed: int = 0):
    torch.manual_seed(seed)
    cls = (transformers.BertForSequenceClassification if classifier
           else transformers.BertModel)
    model = cls(_hf_bert_config())
    model.eval()
    return model


def _bert_cfg(**kw):
    return bert.BertConfig(**BERT_DIMS, dtype=torch.float32, dropout=0.0,
                           **kw)


@pytest.mark.parametrize("use_flash", [True, False])
def test_bert_encoder_matches_hf(use_flash):
    """Hidden states on the unmasked positions within 2e-4 of HF's
    (a padded row takes the dense path; the other call the flash path)."""
    hf = _hf_bert()
    cfg = _bert_cfg(use_flash=use_flash)
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 256, (2, 16))
    mask = np.ones_like(ids)
    mask[1, 10:] = 0
    enc = bert.BertEncoder(cfg)
    enc.load_state_dict(bert_params_from_hf(hf.state_dict(), cfg))
    with torch.no_grad():
        ref = hf(input_ids=torch.tensor(ids),
                 attention_mask=torch.tensor(mask)).last_hidden_state
        ours = enc(torch.tensor(ids), torch.tensor(mask))
        ref_full = hf(input_ids=torch.tensor(ids)).last_hidden_state
        ours_full = enc(torch.tensor(ids))
    np.testing.assert_allclose(ours[0], ref[0], atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(ours[1, :10], ref[1, :10], atol=2e-4,
                               rtol=2e-4)
    np.testing.assert_allclose(ours_full, ref_full, atol=2e-4, rtol=2e-4)


def test_bert_classifier_pooler_and_head_match_hf():
    """The pooler's tanh over [CLS] within 1e-3 of HF's ``pooler_output``;
    from a `BertForSequenceClassification` checkpoint the logits are HF's
    (its head carried over); without one, a fresh head from the
    generator."""
    cfg = _bert_cfg()
    ids = torch.tensor(np.random.default_rng(1).integers(0, 256, (2, 12)))
    hf = _hf_bert()
    sd = bert_classifier_params_from_hf(hf.state_dict(), cfg, num_classes=2)
    model = bert.BertForSequenceClassification(cfg, 2)
    model.load_state_dict(sd)
    with torch.no_grad():
        ref_pooled = hf(ids).pooler_output
        pooled = torch.tanh(model.pooler(model.encoder(ids)[:, 0]))
        assert model(ids).shape == (2, 2)
    np.testing.assert_allclose(pooled, ref_pooled, atol=1e-3, rtol=1e-3)
    again = bert_classifier_params_from_hf(hf.state_dict(), cfg, 2)
    assert torch.equal(again["classifier.weight"], sd["classifier.weight"])
    assert float(sd["classifier.weight"].std()) < 0.05
    assert not sd["classifier.bias"].any()

    hfc = _hf_bert(classifier=True, seed=2)
    model = bert.BertForSequenceClassification(cfg, 3)
    model.load_state_dict(bert_classifier_params_from_hf(
        hfc.state_dict(), cfg, num_classes=3))
    with torch.no_grad():
        np.testing.assert_allclose(model(ids), hfc(ids).logits, atol=2e-4,
                                   rtol=2e-4)


@pytest.mark.parametrize("classifier", [False, True])
@pytest.mark.parametrize("scan_layers", [True, False])
def test_bert_state_dict_equals_jax_converter(classifier, scan_layers):
    """The port's converters equal the JAX ones followed by
    `bert.params_from_jax`, bitwise, for either JAX layer layout (a bare
    `BertModel` gives the encoder; a classifier checkpoint, under its
    ``bert.`` prefix, the whole model with HF's head)."""
    hf = _hf_bert(classifier=classifier, seed=3)
    sd = hf.state_dict()
    np_sd = {k: v.numpy() for k, v in sd.items()}
    cfg = _bert_cfg()
    jcfg = JaxBertConfig(**BERT_DIMS, dtype=jnp.float32,
                         scan_layers=scan_layers)
    if classifier:
        got = bert_classifier_params_from_hf(sd, cfg, num_classes=3)
        want = bert.params_from_jax(jax.tree.map(
            np.asarray, jax_bert_classifier_from_hf(np_sd, jcfg, 3)))
    else:
        got = bert_params_from_hf(np_sd, cfg)
        want = bert.params_from_jax(jax.tree.map(
            np.asarray, jax_bert_from_hf(np_sd, jcfg)))
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == torch.float32 and torch.equal(got[k], v), k


def test_bert_short_position_table_and_missing_keys():
    sd = _hf_bert().state_dict()
    with pytest.raises(ValueError, match="position embeddings"):
        bert_params_from_hf(sd, bert.BertConfig(
            **{**BERT_DIMS, "max_seq_len": 256}))
    short = bert_params_from_hf(sd, bert.BertConfig(
        **{**BERT_DIMS, "max_seq_len": 32}))
    assert short["pos_embed"].shape == (32, 64)
    with pytest.raises(KeyError, match="missing"):
        bert_params_from_hf({"bogus": np.zeros(3)}, _bert_cfg())
