"""Llama-3-style decoder (twin of `ray_lightning_tpu/models/llama.py`):
the training path, the serving paths and `LlamaModule`.

Numerics follow the JAX model: activations in ``cfg.dtype`` (bf16),
f32 RMSNorm reductions, f32-accumulated linears rounded once, RoPE in
f32, and an lm_head whose logits keep the f32 accumulator. Matmul weights
and the embedding are stored in ``param_dtype`` and cast to ``cfg.dtype``
at each use: the trainer keeps f32 master weights (the twin of flax's
``param_dtype=float32``), the serving engine stores them in bf16, where
the cast is a no-op. The embedding row is taken from the table and
rounded afterwards, so its gradient scatters into the table in f32.

Four attention paths, as in `LlamaBlock.__call__`:

  * TRAINING (``cache is None``): RoPE on the first S positions, then
    causal `flash_attention` (the hand-written forward and backward
    kernels), each block under `torch.utils.checkpoint` when
    ``cfg.remat`` (policy "nothing": the block's input is kept, the rest
    recomputed in the backward);
  * paged PREFILL (`PagedPrefillView`): a CH-token chunk per group row
    against one layer's shared block pool; the chunk's K/V is written
    into the pool before attention (`ops.attention.paged_prefill`);
  * paged DECODE (`PagedDecodeView`): one token per slot against the
    pool (`ops.attention.paged_attention`);
  * DENSE cache ``[B, S_max, Hkv, hd]`` (the engine's reference lanes):
    a prefill from an empty cache (S > 1, pos 0, no pad) is causal
    `flash_attention` over the chunk, anything else the masked reference
    attention over the gathered view.

The pool is updated IN PLACE (`index_put_`), where the JAX model returns
a new pool that its jit donates; the same holds for the dense cache.

Weights live in one state dict whose keys mirror the flax tree:
``tok_embed``, ``layers.{i}.{attn_norm,wqkv,wo,mlp_norm,w_gate_up,
w_down}``, ``final_norm``, ``lm_head``; linears in the `nn.Linear`
layout ``[out, in]``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ray_lightning_tpu_torch.core.module import TpuModule
from ray_lightning_tpu_torch.ops import dispatch
from ray_lightning_tpu_torch.ops.attention import (
    PagedDecodeView,
    PagedPrefillView,
    dot_product_attention,
    flash_attention,
    paged_attention,
    paged_prefill,
)
from ray_lightning_tpu_torch.ops.fused_ce import fused_cross_entropy
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
    #: checkpoint each block in training (the backward recomputes it)
    remat: bool = True
    #: what the checkpoint saves; only "nothing" (the block input) is
    #: ported, "dots" and "attn_out" raise when a model is built
    remat_policy: str = "nothing"
    #: chunked fused cross-entropy for the loss (ops/fused_ce.py); None =
    #: auto, on for vocabularies of 2**16 or more
    fused_ce: Optional[bool] = None
    #: logits tile height of the fused CE
    ce_chunk_tokens: int = 1024
    #: the fused CE's inline-backward variant (raises: not ported yet)
    ce_inline_bwd: bool = False

    def __post_init__(self):
        if self.remat_policy not in ("nothing", "dots", "attn_out"):
            raise ValueError(
                f"remat_policy must be 'nothing', 'dots' or 'attn_out', "
                f"got {self.remat_policy!r}")
        if self.ce_inline_bwd and not (
                self.fused_ce is True
                or (self.fused_ce is None and self.vocab_size >= 2**16)):
            raise ValueError(
                "ce_inline_bwd requires the fused CE path: set "
                "fused_ce=True (or leave it auto with vocab >= 64k)")

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
            hidden_dim=128, max_seq_len=256, remat=False), **kw})


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


class LlamaBlock(nn.Module):
    def __init__(self, cfg: LlamaConfig, device: torch.device,
                 param_dtype=None):
        super().__init__()
        self.cfg = cfg
        d, hd, f = cfg.dim, cfg.head_dim, cfg.hidden_dim
        n_qkv = (cfg.n_heads + 2 * cfg.n_kv_heads) * hd
        wd = param_dtype or cfg.dtype
        self.attn_norm = _param((d,), torch.float32, device)
        self.wqkv = _param((n_qkv, d), wd, device)
        self.wo = _param((d, cfg.n_heads * hd), wd, device)
        self.mlp_norm = _param((d,), torch.float32, device)
        self.w_gate_up = _param((2 * f, d), wd, device)
        self.w_down = _param((d, f), wd, device)

    def forward(self, x, cos, sin, cache=None, pos=None, pad=None,
                paged=None):
        """Training when ``cache`` is None. Otherwise ``cache`` is one
        layer's ``(k, v)``: the shared pool ``[n_blocks, P, Hkv, hd]``
        when ``paged`` is set, else a dense ``[B, S_max, Hkv, hd]`` cache.
        ``pos``: the decode view's per-slot [B] tensor; otherwise the
        chunk's write offset (host int) or, on the dense path, a per-row
        [B] tensor for single-token decode. ``pad`` ([B] int32) is the
        per-row left pad of a ragged batch."""
        cfg = self.cfg
        hd, n_q, n_kv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
        B, S = x.shape[0], x.shape[1]
        h = rms_norm(x, self.attn_norm, cfg.norm_eps)
        qkv = linear_f32_acc(h, self.wqkv.to(cfg.dtype))
        q, k, v = torch.split(qkv, [n_q * hd, n_kv * hd, n_kv * hd], dim=-1)
        q = q.reshape(B, S, n_q, hd)
        k = k.reshape(B, S, n_kv, hd)
        v = v.reshape(B, S, n_kv, hd)
        ar = torch.arange(S, device=x.device)
        if cache is None:
            q = apply_rope(q, cos, sin)
            k = apply_rope(k, cos, sin)
            attn = flash_attention(q, k, v, causal=True)
            return self._finish(x, attn)
        ck, cv = cache
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
            if (S > 1 and isinstance(pos, int) and pos == 0
                    and pad is None):
                # prefill from an empty cache: causal attention over the
                # chunk itself, never the [S, S_max] masked scores
                attn = flash_attention(q, k, v, causal=True)
            else:
                kv_pos = torch.arange(ck.shape[1], device=x.device)
                mask = (kv_pos[None, None, None, :]
                        <= positions[:, None, :, None])
                if pad is not None:
                    # pad columns are not context for anyone
                    mask = mask & (kv_pos[None, None, None, :]
                                   >= pad[:, None, None, None])
                attn = dot_product_attention(q, ck, cv, causal=False,
                                             mask=mask)
        return self._finish(x, attn)

    def _finish(self, x, attn):
        """The output projection, the residual and the SwiGLU MLP."""
        cfg = self.cfg
        B, S = x.shape[0], x.shape[1]
        x = x + linear_f32_acc(attn.reshape(B, S, -1), self.wo.to(cfg.dtype))
        h = rms_norm(x, self.mlp_norm, cfg.norm_eps)
        gate, up = linear_f32_acc(h, self.w_gate_up.to(cfg.dtype)).chunk(
            2, dim=-1)
        return x + linear_f32_acc(F.silu(gate) * up,
                                  self.w_down.to(cfg.dtype))


class Llama(nn.Module):
    """Token ids [B, S] -> f32 logits [B, S, V]: training without a cache,
    serving over one.

    Built with empty weights on ``device`` (default the CUDA card; raises
    without one unless ``device="cpu"``): fill them with `init_weights`,
    `init_params_` or `load_state_dict(params_from_jax(...))`. Matmul
    weights and the embedding are stored in ``param_dtype`` (default
    ``cfg.dtype``; the trainer passes float32), norm gains in f32. The
    weights are built without gradients; training turns them on."""

    def __init__(self, cfg: LlamaConfig, device=None, param_dtype=None):
        super().__init__()
        if cfg.remat and cfg.remat_policy != "nothing":
            raise NotImplementedError(
                f"remat_policy={cfg.remat_policy!r} is not ported yet "
                "(ROADMAP Queue 1 item 3); use 'nothing'")
        dev = resolve_device(device)
        pin_f32_accumulation()
        self.cfg = cfg
        wd = param_dtype or cfg.dtype
        self.tok_embed = _param((cfg.vocab_size, cfg.dim), wd, dev)
        self.layers = nn.ModuleList(
            [LlamaBlock(cfg, dev, wd) for _ in range(cfg.n_layers)])
        self.final_norm = _param((cfg.dim,), torch.float32, dev)
        self.lm_head = _param((cfg.vocab_size, cfg.dim), wd, dev)
        cos, sin = rope_frequencies(cfg.head_dim, cfg.max_seq_len,
                                    cfg.rope_theta, device=dev)
        self.register_buffer("cos", cos, persistent=False)
        self.register_buffer("sin", sin, persistent=False)

    @property
    def device(self) -> torch.device:
        return self.tok_embed.device

    def hidden(self, tokens: torch.Tensor, cache=None, pos=None, pad=None,
               paged=None) -> torch.Tensor:
        """Final-norm'd states [B, S, D]. Without a cache, the training
        path over the first S positions (each block checkpointed when
        ``cfg.remat`` and gradients are on). ``cache`` is ``(k, v)`` with
        leaves stacked over layers ([L, ...]); each layer's slice is
        updated in place."""
        cfg = self.cfg
        x = self.tok_embed[tokens.long()].to(cfg.dtype)
        if cache is None:
            remat = cfg.remat and torch.is_grad_enabled()
            for layer in self.layers:
                x = (checkpoint(layer, x, self.cos, self.sin,
                                use_reentrant=False,
                                context_fn=dispatch.checkpoint_context_fn)
                     if remat else layer(x, self.cos, self.sin))
        else:
            ck, cv = cache
            for i, layer in enumerate(self.layers):
                x = layer(x, self.cos, self.sin, (ck[i], cv[i]), pos,
                          pad=pad, paged=paged)
        return rms_norm(x, self.final_norm, cfg.norm_eps)

    def logits(self, h: torch.Tensor) -> torch.Tensor:
        """lm_head projection keeping the f32 accumulator."""
        return linear_f32_out(h.contiguous(), self.lm_head.to(self.cfg.dtype))

    def forward(self, tokens: torch.Tensor, cache=None, pos=None, pad=None,
                paged=None) -> torch.Tensor:
        return self.logits(self.hidden(tokens, cache, pos, pad=pad,
                                       paged=paged))


def init_params_(model: Llama, generator: torch.Generator) -> Llama:
    """Fill ``model``'s weights in place from ``generator`` (which lives
    on the model's device), scaled like flax's initialisers: linears
    normal(0, 1/sqrt(fan_in)) (lecun_normal, without its truncation), the
    embedding normal(0, 1/sqrt(dim)), norm gains one."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.dim() == 1:
                p.fill_(1.0)
                continue
            fan_in = model.cfg.dim if name == "tok_embed" else p.shape[1]
            p.normal_(0.0, 1.0 / math.sqrt(fan_in), generator=generator)
    return model


def init_weights(cfg: LlamaConfig, generator: torch.Generator,
                 device=None) -> Llama:
    """A serving `Llama` on ``device`` (default the CUDA card) with
    random weights drawn from ``generator`` (`init_params_`)."""
    return init_params_(Llama(cfg, device=device), generator)


_LAYER_KERNELS = ("wqkv", "wo", "w_gate_up", "w_down")
_LAYER_NORMS = ("attn_norm", "mlp_norm")


def params_from_jax(params_np: Dict[str, Any], cfg: LlamaConfig,
                    dtype=None) -> Dict[str, torch.Tensor]:
    """The JAX `Llama`'s flax param tree (numpy leaves) as this model's
    state dict. Both layer layouts are read: ``layers/<name>`` stacked
    ``[L, ...]`` (``scan_layers=True``) and ``layer_{i}/<name>``. Dense
    kernels ``[in, out]`` are transposed to ``[out, in]``; the fused
    column orders (``wqkv`` = q|k|v, ``w_gate_up`` = gate|up) carry over
    as they are. Matmul weights and the embedding are stored in ``dtype``
    (default ``cfg.dtype``: the serving model, where rounding once at
    load rounds as the JAX model's cast at each use does; the trainer
    passes float32 for its master weights). Norm gains stay f32."""
    wd = dtype or cfg.dtype

    def t(a, dtype):
        return torch.tensor(np.ascontiguousarray(a), dtype=dtype)

    def layer(i):
        if "layers" in params_np:
            return {k: (v if isinstance(v, np.ndarray) else v["kernel"])[i]
                    for k, v in params_np["layers"].items()}
        return {k: (v if isinstance(v, np.ndarray) else v["kernel"])
                for k, v in params_np[f"layer_{i}"].items()}

    sd = {"tok_embed": t(params_np["tok_embed"]["embedding"], wd),
          "final_norm": t(params_np["final_norm"], torch.float32),
          "lm_head": t(np.asarray(params_np["lm_head"]["kernel"]).T, wd)}
    for i in range(cfg.n_layers):
        lp = layer(i)
        for name in _LAYER_KERNELS:
            sd[f"layers.{i}.{name}"] = t(np.asarray(lp[name]).T, wd)
        for name in _LAYER_NORMS:
            sd[f"layers.{i}.{name}"] = t(lp[name], torch.float32)
    return sd


def cross_entropy_loss(logits: torch.Tensor, targets: torch.Tensor,
                       mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token-level CE in f32; ``mask`` (0/1) excludes padding (twin of
    `cross_entropy_loss`, optax's integer-label softmax CE)."""
    logits = logits.float()
    losses = (torch.logsumexp(logits, dim=-1)
              - logits.gather(-1, targets.long()[..., None]).squeeze(-1))
    if mask is not None:
        mask = mask.float()
        return (losses * mask).sum() / torch.clamp_min(mask.sum(), 1.0)
    return losses.mean()


def warmup_cosine_decay(step: int, init_value: float, peak_value: float,
                        warmup_steps: int, decay_steps: int,
                        end_value: float = 0.0) -> float:
    """optax's ``warmup_cosine_decay_schedule`` at ``step``: linear from
    ``init_value`` to ``peak_value`` over ``warmup_steps``, then a cosine
    to ``end_value`` at ``decay_steps`` (counted from step 0, warmup
    included), flat after."""
    if step < warmup_steps:
        return init_value + (peak_value - init_value) * step / warmup_steps
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    span = decay_steps - warmup_steps
    t = min(step - warmup_steps, span)
    cosine = 0.5 * (1 + math.cos(math.pi * t / span))
    return peak_value * ((1 - alpha) * cosine + alpha)


class LlamaModule(TpuModule):
    """TpuModule wrapper: next-token prediction on {"tokens": [B, S+1]}
    (or {"inputs", "targets"} pairs), twin of the JAX `LlamaModule`. The
    model keeps f32 master weights with gradients on and computes in
    ``cfg.dtype``; the optimizer is AdamW (betas 0.9 / 0.95) on every
    parameter under optax's warmup-cosine schedule."""

    def __init__(self, cfg: Optional[LlamaConfig] = None,
                 lr: float = 3e-4, weight_decay: float = 0.1,
                 warmup_steps: int = 100, total_steps: int = 10000,
                 mu_dtype: Optional[Any] = None, **cfg_overrides):
        super().__init__()
        if mu_dtype is not None:
            raise NotImplementedError(
                "LlamaModule(mu_dtype=...) is not ported yet (ROADMAP "
                "Queue 1 item 3): torch's AdamW keeps its moments in the "
                "parameters' dtype")
        if cfg is None:
            cfg = LlamaConfig(**cfg_overrides)
        elif cfg_overrides:
            cfg = dataclasses.replace(cfg, **cfg_overrides)
        self.cfg = cfg
        self.lr = lr
        self.weight_decay = weight_decay
        self.warmup_steps = warmup_steps
        self.total_steps = total_steps
        self.save_hyperparameters(
            cfg=cfg, lr=lr, weight_decay=weight_decay,
            warmup_steps=warmup_steps, total_steps=total_steps,
            mu_dtype=mu_dtype)

    def configure_model(self) -> Llama:
        return Llama(self.cfg, device=self.device,
                     param_dtype=torch.float32).requires_grad_(True)

    def init_params(self, generator: torch.Generator, batch=None):
        init_params_(self.model, generator)
        return dict(self.model.named_parameters())

    def schedule(self, step: int) -> float:
        """The learning rate of update ``step`` (0-based)."""
        return warmup_cosine_decay(step, 0.0, self.lr, self.warmup_steps,
                                   max(self.total_steps, 2),
                                   end_value=self.lr * 0.1)

    def configure_optimizers(self):
        opt = torch.optim.AdamW(self.model.parameters(), lr=self.lr,
                                betas=(0.9, 0.95), eps=1e-8,
                                weight_decay=self.weight_decay)
        lr = self.lr
        sched = torch.optim.lr_scheduler.LambdaLR(
            opt, lambda step: self.schedule(step) / lr if lr else 0.0)
        return opt, sched

    def _split(self, batch):
        if "tokens" in batch:
            toks = batch["tokens"]
            return toks[:, :-1], toks[:, 1:], batch.get("mask")
        return batch["inputs"], batch["targets"], batch.get("mask")

    def _use_fused_ce(self) -> bool:
        if self.cfg.fused_ce is not None:
            return self.cfg.fused_ce
        return self.cfg.vocab_size >= 2**16

    def _loss(self, params, inputs, targets, mask):
        cfg = self.cfg
        if not self._use_fused_ce():
            return cross_entropy_loss(self.apply(params, inputs), targets,
                                      mask)
        if params is not None and params is not self.params:
            raise ValueError("the fused-CE loss runs the module's own "
                             "parameters")
        hidden = self.model.hidden(inputs)
        return fused_cross_entropy(
            hidden, self.model.lm_head, targets, mask,
            chunk_tokens=cfg.ce_chunk_tokens, compute_dtype=cfg.dtype,
            inline_backward=cfg.ce_inline_bwd)

    def training_step(self, params, batch, rng):
        inputs, targets, mask = self._split(batch)
        loss = self._loss(params, inputs, targets, mask)
        self.log("train_loss", loss)
        return loss

    def validation_step(self, params, batch):
        inputs, targets, mask = self._split(batch)
        return {"val_loss": self._loss(params, inputs, targets, mask)}

    def predict_step(self, params, batch):
        inputs, _, _ = self._split(batch)
        return self.apply(params, inputs).argmax(-1)
