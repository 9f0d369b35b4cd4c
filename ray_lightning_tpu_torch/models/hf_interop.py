"""HuggingFace weight interop: a `transformers` Llama state dict as the
port's `Llama` state dict (twin of `ray_lightning_tpu/models/hf_interop.py`
`llama_params_from_hf`).

Pure name and layout mapping, with no `transformers` import: the caller
passes ``model.state_dict()`` (torch tensors) or numpy arrays. The rules
are the JAX converter's:

  * HF's ``model.`` prefix is optional (a `LlamaForCausalLM` has it, a
    bare `LlamaModel` does not);
  * q/k/v are fused into ``wqkv`` (rows q|k|v) and gate/up into
    ``w_gate_up`` (rows gate|up); HF's linears are already the port's
    ``[out, in]`` layout, so nothing is transposed;
  * an untied config takes ``lm_head.weight``, or reuses the embedding
    when the checkpoint is tied (has no head of its own);
  * a tied config (``tie_embeddings=True``) refuses a checkpoint whose
    ``lm_head.weight`` differs from its embedding, whose head would be
    dropped.

HF rotates the same half-split RoPE pairs as the port, so HF checkpoints
load with no permutation. The BERT half of the JAX module waits for the
port's BERT (ROADMAP Queue 1 item 13 (d)).
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch

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
