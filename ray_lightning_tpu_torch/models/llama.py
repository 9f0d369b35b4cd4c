"""Llama-3-style decoder for serving (twin of
`ray_lightning_tpu/models/llama.py`, inference paths).

Numerics follow the JAX model: activations in ``cfg.dtype`` (bf16),
f32 RMSNorm reductions, f32-accumulated linears rounded once, RoPE in
f32, and an lm_head whose logits keep the f32 accumulator.

Three cache paths, as in `LlamaBlock.__call__`:

  * paged PREFILL (`PagedPrefillView`): a CH-token chunk per group row
    against one layer's shared block pool; the chunk's K/V is written
    into the pool before attention (`ops.attention.paged_prefill`);
  * paged DECODE (`PagedDecodeView`): one token per slot against the
    pool (`ops.attention.paged_attention`);
  * DENSE cache ``[B, S_max, Hkv, hd]`` (the engine's reference lanes):
    the masked reference attention over the gathered view.

The pool is updated IN PLACE (`index_put_`), where the JAX model returns
a new pool that its jit donates; the same holds for the dense cache.
The training path (no cache, flash attention) waits for the training
slice.

Weights live in one state dict whose keys mirror the flax tree:
``tok_embed``, ``layers.{i}.{attn_norm,wqkv,wo,mlp_norm,w_gate_up,
w_down}``, ``final_norm``, ``lm_head``; linears in the `nn.Linear`
layout ``[out, in]``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ray_lightning_tpu_torch.ops.attention import (
    PagedDecodeView,
    PagedPrefillView,
    dot_product_attention,
    paged_attention,
    paged_prefill,
)
from ray_lightning_tpu_torch.ops.norms import rms_norm
from ray_lightning_tpu_torch.ops.precision import (
    linear_f32_acc,
    linear_f32_out,
    pin_f32_accumulation,
)
from ray_lightning_tpu_torch.ops.rope import apply_rope, rope_frequencies
from ray_lightning_tpu_torch.utils.devices import resolve_device


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 128256
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    hidden_dim: int = 14336
    max_seq_len: int = 8192
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    dtype: Any = torch.bfloat16

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    @classmethod
    def llama3_8b(cls, **kw) -> "LlamaConfig":
        return cls(**{**dict(
            vocab_size=128256, dim=4096, n_layers=32, n_heads=32,
            n_kv_heads=8, hidden_dim=14336), **kw})

    @classmethod
    def tiny(cls, **kw) -> "LlamaConfig":
        """Test/debug config: same code path, laptop-sized."""
        return cls(**{**dict(
            vocab_size=256, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
            hidden_dim=128, max_seq_len=256), **kw})


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


class LlamaBlock(nn.Module):
    def __init__(self, cfg: LlamaConfig, device: torch.device):
        super().__init__()
        self.cfg = cfg
        d, hd, f = cfg.dim, cfg.head_dim, cfg.hidden_dim
        n_qkv = (cfg.n_heads + 2 * cfg.n_kv_heads) * hd
        self.attn_norm = _param((d,), torch.float32, device)
        self.wqkv = _param((n_qkv, d), cfg.dtype, device)
        self.wo = _param((d, cfg.n_heads * hd), cfg.dtype, device)
        self.mlp_norm = _param((d,), torch.float32, device)
        self.w_gate_up = _param((2 * f, d), cfg.dtype, device)
        self.w_down = _param((d, f), cfg.dtype, device)

    def forward(self, x, cos, sin, cache, pos, pad=None, paged=None):
        """``cache`` is one layer's ``(k, v)``: the shared pool
        ``[n_blocks, P, Hkv, hd]`` when ``paged`` is set, else a dense
        ``[B, S_max, Hkv, hd]`` cache. ``pos``: the decode view's per-slot
        [B] tensor; otherwise the chunk's write offset (host int) or, on
        the dense path, a per-row [B] tensor for single-token decode.
        ``pad`` ([B] int32) is the per-row left pad of a ragged batch."""
        cfg = self.cfg
        hd, n_q, n_kv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
        B, S = x.shape[0], x.shape[1]
        h = rms_norm(x, self.attn_norm, cfg.norm_eps)
        qkv = linear_f32_acc(h, self.wqkv)
        q, k, v = torch.split(qkv, [n_q * hd, n_kv * hd, n_kv * hd], dim=-1)
        q = q.reshape(B, S, n_q, hd)
        k = k.reshape(B, S, n_kv, hd)
        v = v.reshape(B, S, n_kv, hd)
        ck, cv = cache
        ar = torch.arange(S, device=x.device)
        if isinstance(paged, PagedPrefillView):
            positions = (pos + ar)[None, :].expand(B, S)
            if pad is not None:
                positions = (positions - pad[:, None]).clamp_min(0)
            q = apply_rope(q, cos, sin, positions=positions)
            k = apply_rope(k, cos, sin, positions=positions)
            # write-then-attend: the chunk's K/V lands in owned pool
            # blocks (vacant rows scratch-redirected to block 0, masked
            # garbage by contract) before attention, so each query's
            # causal window covers the in-chunk prefix
            wb, wo = paged.write_block.long(), paged.write_offset.long()
            ck.index_put_((wb, wo), k.to(ck.dtype))
            cv.index_put_((wb, wo), v.to(cv.dtype))
            attn = paged_prefill(q, ck, cv, paged.tables, pos, pad=pad,
                                 use_kernel=paged.use_kernel)
        elif isinstance(paged, PagedDecodeView):
            if S != 1:
                raise ValueError("the paged decode path takes one token "
                                 "per slot")
            positions = pos[:, None] + ar[None, :]
            if pad is not None:
                positions = (positions - pad[:, None]).clamp_min(0)
            q = apply_rope(q, cos, sin, positions=positions)
            k = apply_rope(k, cos, sin, positions=positions)
            # write-then-attend: the token's own K/V is visible to its
            # query. Idle slots arrive scratch-redirected; their
            # duplicate block-0 writes race, harmlessly (masked garbage)
            wb, wo = paged.write_block.long(), paged.write_offset.long()
            ck.index_put_((wb, wo), k[:, 0].to(ck.dtype))
            cv.index_put_((wb, wo), v[:, 0].to(cv.dtype))
            attn = paged_attention(q[:, 0], ck, cv, paged.tables,
                                   paged.lengths, pad=pad,
                                   use_kernel=paged.use_kernel)[:, None]
        else:
            if isinstance(pos, torch.Tensor):  # per-row single token
                positions = pos[:, None] + ar[None, :]
            else:
                positions = (pos + ar)[None, :].expand(B, S)
            rope_pos = positions
            if pad is not None:
                rope_pos = (positions - pad[:, None]).clamp_min(0)
            q = apply_rope(q, cos, sin, positions=rope_pos)
            k = apply_rope(k, cos, sin, positions=rope_pos)
            rows = torch.arange(B, device=x.device)[:, None]
            ck[rows, positions] = k.to(ck.dtype)
            cv[rows, positions] = v.to(cv.dtype)
            kv_pos = torch.arange(ck.shape[1], device=x.device)
            mask = kv_pos[None, None, None, :] <= positions[:, None, :, None]
            if pad is not None:
                # pad columns are not context for anyone
                mask = mask & (kv_pos[None, None, None, :]
                               >= pad[:, None, None, None])
            attn = dot_product_attention(q, ck, cv, causal=False, mask=mask)
        x = x + linear_f32_acc(attn.reshape(B, S, n_q * hd), self.wo)
        h = rms_norm(x, self.mlp_norm, cfg.norm_eps)
        gate, up = linear_f32_acc(h, self.w_gate_up).chunk(2, dim=-1)
        return x + linear_f32_acc(F.silu(gate) * up, self.w_down)


class Llama(nn.Module):
    """Token ids [B, S] -> f32 logits [B, S, V], over a KV cache.

    Built with empty weights on ``device`` (default the CUDA card; raises
    without one unless ``device="cpu"``): fill them with `init_weights`
    or `load_state_dict(params_from_jax(...))`."""

    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        dev = resolve_device(device)
        pin_f32_accumulation()
        self.cfg = cfg
        self.tok_embed = _param((cfg.vocab_size, cfg.dim), cfg.dtype, dev)
        self.layers = nn.ModuleList(
            [LlamaBlock(cfg, dev) for _ in range(cfg.n_layers)])
        self.final_norm = _param((cfg.dim,), torch.float32, dev)
        self.lm_head = _param((cfg.vocab_size, cfg.dim), cfg.dtype, dev)
        cos, sin = rope_frequencies(cfg.head_dim, cfg.max_seq_len,
                                    cfg.rope_theta, device=dev)
        self.register_buffer("cos", cos, persistent=False)
        self.register_buffer("sin", sin, persistent=False)

    @property
    def device(self) -> torch.device:
        return self.tok_embed.device

    def hidden(self, tokens: torch.Tensor, cache, pos, pad=None,
               paged=None) -> torch.Tensor:
        """Final-norm'd states [B, S, D]. ``cache`` is ``(k, v)`` with
        leaves stacked over layers ([L, ...]); each layer's slice is
        updated in place."""
        x = self.tok_embed[tokens.long()]
        ck, cv = cache
        for i, layer in enumerate(self.layers):
            x = layer(x, self.cos, self.sin, (ck[i], cv[i]), pos, pad=pad,
                      paged=paged)
        return rms_norm(x, self.final_norm, self.cfg.norm_eps)

    def logits(self, h: torch.Tensor) -> torch.Tensor:
        """lm_head projection keeping the f32 accumulator."""
        return linear_f32_out(h.contiguous(), self.lm_head)

    def forward(self, tokens: torch.Tensor, cache, pos, pad=None,
                paged=None) -> torch.Tensor:
        return self.logits(self.hidden(tokens, cache, pos, pad=pad,
                                       paged=paged))


def init_weights(cfg: LlamaConfig, generator: torch.Generator,
                 device=None) -> Llama:
    """A `Llama` on ``device`` (default the CUDA card) with random
    weights drawn from ``generator`` (which lives on that device),
    scaled like flax's initialisers: linears normal(0, 1/sqrt(fan_in))
    (lecun_normal, without its truncation), the embedding normal(0,
    1/sqrt(dim)), norm gains one."""
    model = Llama(cfg, device=device)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.dim() == 1:
                p.fill_(1.0)
                continue
            fan_in = cfg.dim if name == "tok_embed" else p.shape[1]
            p.normal_(0.0, 1.0 / math.sqrt(fan_in), generator=generator)
    return model


_LAYER_KERNELS = ("wqkv", "wo", "w_gate_up", "w_down")
_LAYER_NORMS = ("attn_norm", "mlp_norm")


def params_from_jax(params_np: Dict[str, Any], cfg: LlamaConfig
                    ) -> Dict[str, torch.Tensor]:
    """The JAX `Llama`'s flax param tree (numpy leaves) as this model's
    state dict. Both layer layouts are read: ``layers/<name>`` stacked
    ``[L, ...]`` (``scan_layers=True``) and ``layer_{i}/<name>``. Dense
    kernels ``[in, out]`` are transposed to ``[out, in]``; the fused
    column orders (``wqkv`` = q|k|v, ``w_gate_up`` = gate|up) carry over
    as they are. Matmul weights and the embedding are stored in
    ``cfg.dtype``: the JAX model keeps f32 params and casts them at each
    use, which rounds the same way. Norm gains stay f32."""
    def t(a, dtype):
        return torch.tensor(np.ascontiguousarray(a), dtype=dtype)

    def layer(i):
        if "layers" in params_np:
            return {k: (v if isinstance(v, np.ndarray) else v["kernel"])[i]
                    for k, v in params_np["layers"].items()}
        return {k: (v if isinstance(v, np.ndarray) else v["kernel"])
                for k, v in params_np[f"layer_{i}"].items()}

    sd = {"tok_embed": t(params_np["tok_embed"]["embedding"], cfg.dtype),
          "final_norm": t(params_np["final_norm"], torch.float32),
          "lm_head": t(np.asarray(params_np["lm_head"]["kernel"]).T,
                       cfg.dtype)}
    for i in range(cfg.n_layers):
        lp = layer(i)
        for name in _LAYER_KERNELS:
            sd[f"layers.{i}.{name}"] = t(np.asarray(lp[name]).T, cfg.dtype)
        for name in _LAYER_NORMS:
            sd[f"layers.{i}.{name}"] = t(lp[name], torch.float32)
    return sd
