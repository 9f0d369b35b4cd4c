"""HuggingFace weight interop: `transformers` Llama and BERT state dicts
as the port's state dicts (twin of `ray_lightning_tpu/models/hf_interop.py`).

Pure name and layout mapping, with no `transformers` import: the caller
passes ``model.state_dict()`` (torch tensors) or numpy arrays. The rules
are the JAX converters':

  * HF's ``model.`` (Llama) or ``bert.`` (BERT) prefix is optional;
  * q/k/v are fused into ``wqkv`` (rows q|k|v) and Llama's gate/up into
    ``w_gate_up`` (rows gate|up); HF's linears are already the port's
    ``[out, in]`` layout, so nothing is transposed;
  * an untied Llama config takes ``lm_head.weight``, or reuses the
    embedding when the checkpoint is tied (has no head of its own); a
    tied config (``tie_embeddings=True``) refuses a checkpoint whose
    ``lm_head.weight`` differs from its embedding, whose head would be
    dropped;
  * a BERT checkpoint's position table must hold ``cfg.max_seq_len``
    rows (it is cut to them); a classifier head comes from the
    checkpoint when it has one, else it is drawn fresh.

HF rotates the same half-split RoPE pairs as the port, so HF Llama
checkpoints load with no permutation.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch

from ray_lightning_tpu_torch.models.bert import BertConfig
from ray_lightning_tpu_torch.models.llama import LlamaConfig


def _get(sd: Mapping, key: str) -> torch.Tensor:
    if key not in sd:
        raise KeyError(
            f"HF state dict is missing {key!r} — wrong architecture or an "
            f"unexpected transformers version (have e.g. {list(sd)[:3]}...)")
    v = sd[key]
    if isinstance(v, torch.Tensor):
        return v.detach().cpu()
    return torch.from_numpy(np.ascontiguousarray(np.asarray(v)))


def llama_params_from_hf(hf_state_dict: Mapping, cfg: LlamaConfig,
                         dtype: Optional[torch.dtype] = None
                         ) -> Dict[str, torch.Tensor]:
    """The port's `Llama` state dict from a `transformers.LlamaForCausalLM`
    (or `LlamaModel`) state dict. Matmul weights and the embedding are
    stored in ``dtype`` (default ``cfg.dtype``, the serving model; the
    trainer's masters take float32), norm gains in f32, as
    `params_from_jax` stores them."""
    sd = hf_state_dict
    p = "model." if any(k.startswith("model.") for k in sd) else ""
    wd = dtype or cfg.dtype

    def w(t: torch.Tensor) -> torch.Tensor:
        return t.to(wd).contiguous()

    embed = _get(sd, f"{p}embed_tokens.weight")
    out = {"tok_embed": w(embed),
           "final_norm": _get(sd, f"{p}norm.weight").float()}
    if cfg.tie_embeddings:
        if "lm_head.weight" in sd and not torch.equal(
                _get(sd, "lm_head.weight"), embed):
            raise ValueError(
                "checkpoint has a distinct lm_head.weight but "
                "cfg.tie_embeddings=True — its output head would be "
                "discarded; set tie_embeddings=False")
    else:
        out["lm_head"] = w(_get(sd, "lm_head.weight")
                           if "lm_head.weight" in sd else embed)
    for i in range(cfg.n_layers):
        lp = f"{p}layers.{i}."
        out[f"layers.{i}.wqkv"] = w(torch.cat(
            [_get(sd, lp + f"self_attn.{n}_proj.weight")
             for n in ("q", "k", "v")]))
        out[f"layers.{i}.wo"] = w(_get(sd, lp + "self_attn.o_proj.weight"))
        out[f"layers.{i}.w_gate_up"] = w(torch.cat(
            [_get(sd, lp + f"mlp.{n}_proj.weight") for n in ("gate", "up")]))
        out[f"layers.{i}.w_down"] = w(_get(sd, lp + "mlp.down_proj.weight"))
        out[f"layers.{i}.attn_norm"] = _get(
            sd, lp + "input_layernorm.weight").float()
        out[f"layers.{i}.mlp_norm"] = _get(
            sd, lp + "post_attention_layernorm.weight").float()
    return out


def bert_params_from_hf(hf_state_dict: Mapping, cfg: BertConfig,
                        prefix: str = "") -> Dict[str, torch.Tensor]:
    """The port's `BertEncoder` state dict (f32) from a
    `transformers.BertModel` state dict; ``prefix`` is ``"bert."`` for a
    `BertForSequenceClassification`'s."""
    sd, p = hf_state_dict, prefix

    def emb(name):
        return _get(sd, f"{p}embeddings.{name}").float()

    pos = emb("position_embeddings.weight")
    if pos.shape[0] < cfg.max_seq_len:
        raise ValueError(
            f"cfg.max_seq_len={cfg.max_seq_len} but the checkpoint has "
            f"only {pos.shape[0]} position embeddings — positions past "
            "the table would silently clamp; lower max_seq_len or extend "
            "the table explicitly")
    out = {"tok_embed": emb("word_embeddings.weight").contiguous(),
           "pos_embed": pos[:cfg.max_seq_len].contiguous(),
           "type_embed": emb("token_type_embeddings.weight").contiguous(),
           "embed_ln.weight": emb("LayerNorm.weight"),
           "embed_ln.bias": emb("LayerNorm.bias")}
    names = {"wo": "attention.output.dense", "w_up": "intermediate.dense",
             "w_down": "output.dense",
             "attn_ln": "attention.output.LayerNorm",
             "mlp_ln": "output.LayerNorm"}
    for i in range(cfg.n_layers):
        lp, dst = f"{p}encoder.layer.{i}.", f"layers.{i}."
        for kind in ("weight", "bias"):
            out[f"{dst}wqkv.{kind}"] = torch.cat(
                [_get(sd, f"{lp}attention.self.{n}.{kind}")
                 for n in ("query", "key", "value")]).float().contiguous()
            for name, hf in names.items():
                out[f"{dst}{name}.{kind}"] = _get(
                    sd, f"{lp}{hf}.{kind}").float().contiguous()
    return out


def bert_classifier_params_from_hf(
        hf_state_dict: Mapping, cfg: BertConfig, num_classes: int,
        generator: Optional[torch.Generator] = None
        ) -> Dict[str, torch.Tensor]:
    """The port's `BertForSequenceClassification` state dict: the
    checkpoint's encoder and pooler; its classifier head when it has one
    (a `BertForSequenceClassification` checkpoint), else a fresh head,
    normal(0, 0.02) from ``generator`` (default seed 0) and a zero bias."""
    sd = hf_state_dict
    prefix = "bert." if any(k.startswith("bert.") for k in sd) else ""
    out = {f"encoder.{k}": v
           for k, v in bert_params_from_hf(sd, cfg, prefix).items()}
    out["pooler.weight"] = _get(sd, f"{prefix}pooler.dense.weight").float()
    out["pooler.bias"] = _get(sd, f"{prefix}pooler.dense.bias").float()
    if "classifier.weight" in sd:
        out["classifier.weight"] = _get(sd, "classifier.weight").float()
        out["classifier.bias"] = _get(sd, "classifier.bias").float()
    else:
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        out["classifier.weight"] = 0.02 * torch.randn(
            num_classes, cfg.dim, generator=generator)
        out["classifier.bias"] = torch.zeros(num_classes)
    return {k: v.contiguous() for k, v in out.items()}
