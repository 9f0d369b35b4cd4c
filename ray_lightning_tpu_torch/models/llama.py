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

The training loss is one call of the model, ``Llama(tokens,
targets=..., mask=...)`` (the chunked fused CE, or the materialized
logits' CE), so a strategy's wrapper (DDP, FSDP2) sees every weight the
loss reads; `LlamaModule` makes it the token mean over the global batch
of all data-parallel ranks.

Four attention paths, as in `LlamaBlock.__call__`:

  * TRAINING (``cache is None``): the QKV projection and RoPE on the
    first S positions as one operator (`ops.remat.qkv_rope`), then
    causal `flash_attention` (the hand-written forward and backward
    kernels), each block under `torch.utils.checkpoint` when
    ``cfg.remat`` (policy "nothing": the block's input is kept, the rest
    recomputed in the backward; "dots" and "attn_out" keep more,
    `ops/remat.py`);
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

Under the mesh's ``tensor`` axis (`parallel.strategy.ShardedMesh`,
`enable_tensor_parallel`) the training path runs each rank's shards with
the Megatron layout of `llama_param_specs`: ``wqkv`` and ``w_gate_up``
column-parallel (each rank its own q heads, KV groups and gate/up
columns; `parallel.tensor`), ``wo`` and ``w_down`` row-parallel with
their f32 partials summed before the one rounding, the embedding and
the lm_head split by vocabulary (a masked lookup; the vocab-parallel
chunked CE), the norm gains replicated. Attention runs on the local
heads, ``H/tp`` q heads over ``Hkv/tp`` KV heads. The serving paths run
the same way on a tensor-parallel replica's rank
(`serve.engine.DecodeEngine(mesh=)`), whose pool holds its ``Hkv/tp``
KV heads and whose logits are gathered whole on every rank.

Weights live in one state dict whose keys mirror the flax tree:
``tok_embed``, ``layers.{i}.{attn_norm,wqkv,wo,mlp_norm,w_gate_up,
w_down}``, ``final_norm``, ``lm_head`` (absent under ``tie_embeddings``,
where the embedding is the head); linears in the `nn.Linear` layout
``[out, in]``.
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
from ray_lightning_tpu_torch.core.schedule import (
    warmup_cosine_decay,
)
from ray_lightning_tpu_torch.ops.attention import (
    PagedDecodeView,
    PagedPrefillView,
    dot_product_attention,
    flash_attention,
    paged_attention,
    paged_prefill,
)
from ray_lightning_tpu_torch.ops.fused_ce import (
    fused_cross_entropy_sum,
    inline_cross_entropy,
    vocab_parallel_cross_entropy_sum,
)
from ray_lightning_tpu_torch.ops.norms import rms_norm
from ray_lightning_tpu_torch.ops.precision import pin_f32_accumulation
from ray_lightning_tpu_torch.ops.remat import checkpoint_context_fn, qkv_rope
from ray_lightning_tpu_torch.ops.rope import apply_rope, rope_frequencies
from ray_lightning_tpu_torch.parallel.tensor import (
    column_linear,
    local,
    row_linear,
    vocab_parallel_embedding,
    vocab_parallel_logits,
)
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
    #: the embedding is the head too: no ``lm_head`` weight; the logits
    #: are the f32 product of the hidden states and the table (the JAX
    #: ``embed.attend`` over its f32 table)
    tie_embeddings: bool = False
    dtype: Any = torch.bfloat16
    #: checkpoint each block in training (the backward recomputes it)
    remat: bool = True
    #: what the checkpoint saves beyond the block input (`ops/remat.py`):
    #: "nothing", "dots" (the projection GEMMs' outputs) or "attn_out" (q
    #: and k after RoPE, v, and the flash kernel's O and lse)
    remat_policy: str = "nothing"
    #: chunked fused cross-entropy for the loss (ops/fused_ce.py); None =
    #: auto, on for vocabularies of 2**16 or more
    fused_ce: Optional[bool] = None
    #: logits tile height of the fused CE
    ce_chunk_tokens: int = 1024
    #: the fused CE computes its gradients inside the forward's chunk loop
    #: (no logits tile built twice) for a [V, D] f32 residual
    ce_inline_bwd: bool = False
    #: shard the sequence over the mesh's ``seq`` axis when the strategy's
    #: mesh has seq > 1 (`parallel.strategy.ShardedMesh(seq=)`)
    seq_parallel: bool = False
    #: "ring" (`ops.ring_attention`, any head count) or "ulysses"
    #: (`ops.ulysses`, heads divisible by the axis)
    seq_parallel_mode: str = "ring"
    #: > 0: the GPipe decoder path (`ops.pipeline`) with this many
    #: microbatches when the mesh has pipe > 1; the layers are owned by
    #: their stage
    pipeline_microbatches: int = 0

    def __post_init__(self):
        if self.seq_parallel_mode not in ("ring", "ulysses"):
            raise ValueError(
                f"seq_parallel_mode must be 'ring' or 'ulysses', got "
                f"{self.seq_parallel_mode!r}")
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
        if self.pipeline_microbatches > 0 and self.seq_parallel:
            raise ValueError(
                "pipeline_microbatches and seq_parallel are mutually "
                "exclusive (the pipeline path runs attention per stage)")

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    @property
    def use_fused_ce(self) -> bool:
        if self.fused_ce is not None:
            return self.fused_ce
        return self.vocab_size >= 2**16

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
    #: `parallel.strategy.FSDP` shards each block as its own unit
    fsdp_unit = True
    #: the rank's tensor group (`parallel.tensor.TensorParallel`), or
    #: None off the tensor axis
    tp = None
    #: the rank's `parallel.comm.AxisGroup` on the ``seq`` axis, or None
    sp = None

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
        tp = self.tp
        if tp is not None:
            # this rank's heads; a cache (a serving rank's pool) holds
            # its Hkv/tp KV heads
            n_q, n_kv = n_q // tp.size, n_kv // tp.size
        h = rms_norm(x, local(self.attn_norm), cfg.norm_eps)
        if cache is None:
            # the QKV GEMM and RoPE as one operator, which the remat
            # policies "dots" and "attn_out" keep (ops/remat.py)
            q, k, v = qkv_rope(h, local(self.wqkv).to(cfg.dtype), cos, sin,
                               n_q, n_kv, hd, tp)
            return self._finish(x, self._attention(q, k, v))
        qkv = column_linear(h, local(self.wqkv).to(cfg.dtype), tp)
        q, k, v = torch.split(qkv, [n_q * hd, n_kv * hd, n_kv * hd], dim=-1)
        q = q.reshape(B, S, n_q, hd)
        k = k.reshape(B, S, n_kv, hd)
        v = v.reshape(B, S, n_kv, hd)
        ar = torch.arange(S, device=x.device)
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

    def _attention(self, q, k, v):
        """The training path's causal attention: over the ``seq`` axis
        when the sequence is sharded (ring or Ulysses), else the flash
        kernels."""
        cfg = self.cfg
        if self.sp is not None:
            if cfg.seq_parallel_mode == "ulysses":
                from ray_lightning_tpu_torch.ops.ulysses import (
                    ulysses_attention_local,
                )

                return ulysses_attention_local(q, k, v, axis=self.sp,
                                               causal=True)
            from ray_lightning_tpu_torch.ops.ring_attention import (
                ring_attention_local,
            )

            return ring_attention_local(q, k, v, ring=self.sp, causal=True)
        return flash_attention(q, k, v, causal=True)

    def _finish(self, x, attn):
        """The output projection, the residual and the SwiGLU MLP."""
        cfg = self.cfg
        B, S, tp = x.shape[0], x.shape[1], self.tp
        x = x + row_linear(attn.reshape(B, S, -1),
                           local(self.wo).to(cfg.dtype), tp)
        h = rms_norm(x, local(self.mlp_norm), cfg.norm_eps)
        gate, up = column_linear(
            h, local(self.w_gate_up).to(cfg.dtype), tp).chunk(2, dim=-1)
        return x + row_linear(F.silu(gate) * up,
                              local(self.w_down).to(cfg.dtype), tp)


class AbsentLayer(nn.Module):
    """A layer that another pipeline stage owns: no weights; their names,
    shapes and dtypes kept, so the init draws them (and discards them) in
    the order of the whole model."""

    def __init__(self, layer: nn.Module):
        super().__init__()
        self.shapes = [(n, tuple(p.shape), p.dtype)
                       for n, p in layer.named_parameters()]


class Llama(nn.Module):
    """Token ids [B, S] -> f32 logits [B, S, V]: training without a cache,
    serving over one.

    Built with empty weights on ``device`` (default the CUDA card; raises
    without one unless ``device="cpu"``; ``"meta"`` builds shapes only,
    for the planner and the sharded init): fill them with `init_weights`,
    `init_params_` or `load_state_dict(params_from_jax(...))`. Matmul
    weights and the embedding are stored in ``param_dtype`` (default
    ``cfg.dtype``; the trainer passes float32), norm gains in f32. The
    weights are built without gradients; training turns them on."""

    def __init__(self, cfg: LlamaConfig, device=None, param_dtype=None):
        super().__init__()
        dev = resolve_device(device)
        pin_f32_accumulation()
        self.cfg = cfg
        wd = param_dtype or cfg.dtype
        self.tok_embed = _param((cfg.vocab_size, cfg.dim), wd, dev)
        self.layers = nn.ModuleList(
            [LlamaBlock(cfg, dev, wd) for _ in range(cfg.n_layers)])
        self.final_norm = _param((cfg.dim,), torch.float32, dev)
        if not cfg.tie_embeddings:
            self.lm_head = _param((cfg.vocab_size, cfg.dim), wd, dev)
        self.tp = None
        #: the ``seq`` and ``pipe`` axes' `parallel.comm.AxisGroup`s
        self.sp = None
        self.pp = None
        self.register_buffer("cos", None, persistent=False)
        self.register_buffer("sin", None, persistent=False)
        self.reset_rope_(dev)

    def reset_rope_(self, device=None) -> None:
        """(Re)compute the RoPE tables on ``device`` (default the
        weights'): after `to_empty`, a meta-built model's are garbage."""
        dev = self.device if device is None else device
        self.cos, self.sin = rope_frequencies(
            self.cfg.head_dim, self.cfg.max_seq_len, self.cfg.rope_theta,
            device=dev)

    def enable_tensor_parallel(self, tp) -> None:
        """Run the training path on this rank's shards of the tensor group
        ``tp`` (`parallel.tensor.TensorParallel`); the strategy has made
        the weights those shards (`parallel.strategy.ShardedMesh`)."""
        check_tensor_parallel(self.cfg, tp.size)
        self.tp = tp
        for layer in self.layers:
            layer.tp = tp

    def enable_sequence_parallel(self, axis) -> None:
        """Run the training path on this rank's chunk of the sequence
        (`seq_chunk`) over the ``seq`` axis ``axis`` (an `AxisGroup`):
        every op but attention is per token, attention is the ring or
        Ulysses (``cfg.seq_parallel_mode``), RoPE at the chunk's global
        positions."""
        if self.cfg.seq_parallel_mode == "ulysses":
            from ray_lightning_tpu_torch.ops.ulysses import check_heads

            tp = self.tp.size if self.tp is not None else 1
            check_heads(self.cfg.n_heads // tp, self.cfg.n_kv_heads // tp,
                        axis.size)
        self.sp = axis
        for layer in self.layers:
            layer.sp = axis

    def seq_chunk(self, t: Optional[torch.Tensor]):
        """This rank's chunk of ``t`` [B, S, ...] along the sequence (``t``
        itself off the ``seq`` axis)."""
        if t is None or self.sp is None:
            return t
        if t.shape[1] % self.sp.size:
            raise ValueError(f"sequence {t.shape[1]} does not divide by "
                             f"seq={self.sp.size}")
        return t.chunk(self.sp.size, dim=1)[self.sp.rank]

    def enable_pipeline(self, axis) -> None:
        """Keep only this stage's contiguous block of layers (the rest
        become `AbsentLayer`s) and run the training path's layers as the
        GPipe pipeline over the ``pipe`` axis ``axis``; the embedding, the
        final norm and the head stay on every stage."""
        n, p = self.cfg.n_layers, axis.size
        if n % p:
            raise ValueError(f"{n} layers not divisible by pipe={p}")
        lo, hi = axis.rank * n // p, (axis.rank + 1) * n // p
        for i in range(n):
            if not lo <= i < hi and not isinstance(self.layers[i],
                                                   AbsentLayer):
                self.layers[i] = AbsentLayer(self.layers[i])
        self.pp = axis

    @staticmethod
    def pipeline_owned(name: str) -> bool:
        """Is the parameter ``name`` owned by one pipeline stage?"""
        return name.startswith("layers.")

    @property
    def head(self) -> torch.Tensor:
        """The output projection [V, D]: ``lm_head``, or the embedding
        table of a tied model."""
        return (self.tok_embed if self.cfg.tie_embeddings
                else self.lm_head)

    @property
    def device(self) -> torch.device:
        t = self.tok_embed
        return t.to_local().device if hasattr(t, "to_local") else t.device

    def hidden(self, tokens: torch.Tensor, cache=None, pos=None, pad=None,
               paged=None) -> torch.Tensor:
        """Final-norm'd states [B, S, D]. Without a cache, the training
        path over the first S positions (each block checkpointed when
        ``cfg.remat`` and gradients are on). ``cache`` is ``(k, v)`` with
        leaves stacked over layers ([L, ...]); each layer's slice is
        updated in place."""
        cfg = self.cfg
        x = vocab_parallel_embedding(tokens, local(self.tok_embed),
                                     self.tp).to(cfg.dtype)
        if cache is None:
            remat = cfg.remat and torch.is_grad_enabled()
            cos, sin = self.cos, self.sin
            if self.sp is not None:
                # the chunk's global positions
                off = self.sp.rank * tokens.shape[1]
                cos, sin = cos[off:], sin[off:]
            if self.pp is not None:
                from ray_lightning_tpu_torch.ops.pipeline import gpipe_apply

                x = gpipe_apply(_layer_step, self.layers, x, self.pp,
                                microbatches=cfg.pipeline_microbatches,
                                remat=remat, remat_policy=cfg.remat_policy,
                                extra=(cos, sin))
                return rms_norm(x, local(self.final_norm), cfg.norm_eps)
            context_fn = checkpoint_context_fn(cfg.remat_policy)
            for layer in self.layers:
                x = (checkpoint(layer, x, cos, sin,
                                use_reentrant=False, context_fn=context_fn)
                     if remat else layer(x, cos, sin))
        else:
            ck, cv = cache
            for i, layer in enumerate(self.layers):
                x = layer(x, self.cos, self.sin, (ck[i], cv[i]), pos,
                          pad=pad, paged=paged)
        return rms_norm(x, local(self.final_norm), cfg.norm_eps)

    def logits(self, h: torch.Tensor) -> torch.Tensor:
        """lm_head projection keeping the f32 accumulator (under the
        tensor axis, every rank's vocabulary slice gathered); a tied
        model's is the f32 product with the embedding table."""
        if self.cfg.tie_embeddings:
            return vocab_parallel_logits(h.float().contiguous(),
                                         local(self.tok_embed).float(),
                                         self.tp)
        return vocab_parallel_logits(h.contiguous(),
                                     local(self.lm_head).to(self.cfg.dtype),
                                     self.tp)

    def forward(self, tokens: torch.Tensor, cache=None, pos=None, pad=None,
                paged=None, *, targets: Optional[torch.Tensor] = None,
                mask: Optional[torch.Tensor] = None,
                denominator: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Logits, or with ``targets`` the training loss: the
        mask-weighted sum of the token losses over ``denominator``
        (default: the mask's sum, at least 1), through the chunked fused
        CE when ``cfg.use_fused_ce``. The loss is one call of the model,
        so a wrapper (DDP, FSDP) sees every weight it reads."""
        h = self.hidden(tokens, cache, pos, pad=pad, paged=paged)
        if targets is None:
            return self.logits(h)
        cfg = self.cfg
        head = local(self.head)
        if cfg.use_fused_ce and cfg.ce_inline_bwd:
            # the gradients come from the forward's chunk loop, which
            # takes the denominator first
            return inline_cross_entropy(
                h, head, targets, mask, denominator,
                chunk_tokens=cfg.ce_chunk_tokens, compute_dtype=cfg.dtype,
                tp=self.tp)
        if self.tp is not None and (cfg.use_fused_ce
                                    or not cfg.tie_embeddings):
            # the vocab-split loss: chunked and recomputed as the fused CE,
            # or one tile of every token (the materialized logits' loss;
            # a tied model's is its f32 logits' below)
            fused = cfg.use_fused_ce
            loss_sum, count = vocab_parallel_cross_entropy_sum(
                h, head, targets, self.tp, mask,
                chunk_tokens=(cfg.ce_chunk_tokens if fused
                              else targets.numel()),
                compute_dtype=cfg.dtype, checkpointed=fused)
        elif cfg.use_fused_ce:
            loss_sum, count = fused_cross_entropy_sum(
                h, head, targets, mask, chunk_tokens=cfg.ce_chunk_tokens,
                compute_dtype=cfg.dtype)
        else:
            loss_sum, count = token_loss_sum(self.logits(h), targets, mask)
        if denominator is None:
            denominator = torch.clamp_min(count, 1.0)
        return loss_sum / denominator


def _layer_step(layer: LlamaBlock, h, cos, sin):
    """One pipeline layer (`ops.pipeline.gpipe_apply`'s stage function)."""
    return layer(h, cos, sin)


def _init_order(model: Llama):
    """(name, parameter or None, shape, dtype) of every weight of the
    whole model in its order; None for a weight another pipeline stage
    owns."""
    for n, p in model.named_parameters(recurse=False):
        yield n, p, tuple(p.shape), p.dtype
    for i, layer in enumerate(model.layers):
        if isinstance(layer, AbsentLayer):
            for n, shape, dtype in layer.shapes:
                yield f"layers.{i}.{n}", None, shape, dtype
        else:
            for n, p in layer.named_parameters(prefix=f"layers.{i}"):
                yield n, p, tuple(p.shape), p.dtype


def init_params_(model: Llama, generator: torch.Generator,
                 place=None) -> Llama:
    """Fill ``model``'s weights in place from ``generator`` (which lives
    on the model's device), scaled like flax's initialisers: linears
    normal(0, 1/sqrt(fan_in)) (lecun_normal, without its truncation), the
    embedding normal(0, 1/sqrt(dim)), norm gains one.

    With ``place`` (the sharded init of a model whose weights are shards,
    `parallel.strategy`): each weight's FULL value is drawn in the same
    order on the generator's device and handed to ``place(name, param,
    full)``, which keeps the rank's shard; the full tensor is freed before
    the next. The values are the eager init's, bit for bit."""
    with torch.no_grad():
        for name, p, shape, dtype in _init_order(model):
            if place is not None or p is None:
                full = torch.empty(shape, dtype=dtype,
                                   device=generator.device)
            else:
                full = p
            if len(shape) == 1:
                full.fill_(1.0)
            else:
                fan_in = model.cfg.dim if name == "tok_embed" else shape[1]
                full.normal_(0.0, 1.0 / math.sqrt(fan_in),
                             generator=generator)
            if p is None:
                # another stage's weight: drawn to keep the stream
                del full
            elif place is not None:
                place(name, p, full)
                del full
    return model


def init_weights(cfg: LlamaConfig, generator: torch.Generator,
                 device=None) -> Llama:
    """A serving `Llama` on ``device`` (default the CUDA card) with
    random weights drawn from ``generator`` (`init_params_`)."""
    return init_params_(Llama(cfg, device=device), generator)


_LAYER_KERNELS = ("wqkv", "wo", "w_gate_up", "w_down")
_LAYER_NORMS = ("attn_norm", "mlp_norm")

#: per-layer tensor-parallel placement (twin of the JAX `_PER_LAYER_SPECS`)
#: in the port's ``[out, in]`` layout, so each JAX column split is a split
#: of dim 0 here: column-parallel wqkv and w_gate_up, row-parallel wo and
#: w_down, replicated norm gains
_PER_LAYER_SPECS: Dict[str, tuple] = {
    "wqkv": ("tensor", None),
    "wo": (None, "tensor"),
    "w_gate_up": ("tensor", None),
    "w_down": (None, "tensor"),
    "attn_norm": (),
    "mlp_norm": (),
}


def llama_param_specs(cfg: LlamaConfig) -> Dict[str, tuple]:
    """Megatron-style tensor-parallel placement of every weight (twin of
    the JAX `llama_param_specs`), keyed by the port's parameter names:
    per-dimension mesh axes, ``()`` replicated. The embedding and the
    lm_head split the vocabulary. The strategies overlay ``fsdp`` on a
    free dimension."""
    specs: Dict[str, tuple] = {"tok_embed": ("tensor", None),
                               "final_norm": ()}
    if not cfg.tie_embeddings:
        specs["lm_head"] = ("tensor", None)
    for i in range(cfg.n_layers):
        for k, v in _PER_LAYER_SPECS.items():
            specs[f"layers.{i}.{k}"] = v
    return specs


def llama_fused_rows(cfg: LlamaConfig) -> Dict[str, tuple]:
    """The fused weights' row groups, by parameter name: ``wqkv`` is
    q|k|v, ``w_gate_up`` gate|up. A tensor split keeps each group's
    share together on every rank (`parallel.tensor.fused_row_permutation`)."""
    hd = cfg.head_dim
    out: Dict[str, tuple] = {}
    for i in range(cfg.n_layers):
        out[f"layers.{i}.wqkv"] = (cfg.n_heads * hd, cfg.n_kv_heads * hd,
                                   cfg.n_kv_heads * hd)
        out[f"layers.{i}.w_gate_up"] = (cfg.hidden_dim, cfg.hidden_dim)
    return out


def check_tensor_parallel(cfg: LlamaConfig, tensor: int) -> None:
    """``tensor`` must divide every dimension a rank's shard splits: the
    KV heads (each rank whole KV groups), the q heads, the MLP width and
    the vocabulary. Raises naming the first that it does not."""
    for what, n in (("n_kv_heads", cfg.n_kv_heads), ("n_heads", cfg.n_heads),
                    ("hidden_dim", cfg.hidden_dim),
                    ("vocab_size", cfg.vocab_size)):
        if n % tensor:
            raise ValueError(
                f"tensor={tensor} does not divide {what}={n}: a tensor "
                "rank holds whole KV groups, q heads, MLP columns and "
                "vocabulary rows")


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
    passes float32 for its master weights). Norm gains stay f32. A tied
    config's tree has no ``lm_head``."""
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
          "final_norm": t(params_np["final_norm"], torch.float32)}
    if not cfg.tie_embeddings:
        sd["lm_head"] = t(np.asarray(params_np["lm_head"]["kernel"]).T, wd)
    for i in range(cfg.n_layers):
        lp = layer(i)
        for name in _LAYER_KERNELS:
            sd[f"layers.{i}.{name}"] = t(np.asarray(lp[name]).T, wd)
        for name in _LAYER_NORMS:
            sd[f"layers.{i}.{name}"] = t(lp[name], torch.float32)
    return sd


def init_cache(cfg: LlamaConfig, batch: int, max_len: int, device=None):
    """Zeroed dense KV cache ``(k, v)``, each [n_layers, B, max_len, Hkv,
    head_dim] in ``cfg.dtype`` on ``device`` (default the CUDA card)."""
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    dev = resolve_device(device)
    return (torch.zeros(shape, dtype=cfg.dtype, device=dev),
            torch.zeros(shape, dtype=cfg.dtype, device=dev))


@torch.no_grad()
def generate(model: Llama, prompt, max_new_tokens: int,
             temperature: float = 0.0, top_k: Optional[int] = None,
             seed: int = 0, cache_len: Optional[int] = None,
             prompt_lengths=None, cache=None) -> torch.Tensor:
    """Autoregressive decoding over a dense KV cache (twin of the JAX
    `generate`): the prompt's prefill (from an empty cache without a
    pad, `flash_attention`; the hand-written kernel on the card), then
    one single-token step per new token through the masked cache path.

    Greedy when ``temperature == 0``; otherwise temperature (and top-k)
    sampling with the serving engine's per-request key scheme: the key
    state starts at the scheduler's ``_key_data(seed)`` and splits once
    per token, and every row draws from the same split, so a request
    the engine serves emits exactly ``generate(prompt, ..., seed=
    req.seed)``. ``cache_len`` sizes the cache (any length >= prompt +
    max_new_tokens; default exactly that). ``prompt_lengths`` ([B] ints)
    declares a LEFT-padded ragged batch: row b's real prompt is its last
    ``prompt_lengths[b]`` columns and decodes as that prompt alone.
    ``cache`` is the caller's `init_cache` buffer, updated in place (the
    twin of the JAX donation; one is made when it is None). Returns
    [B, max_new_tokens] int32 on the model's device."""
    from ray_lightning_tpu_torch.serve.engine import _sample_one, _split_key
    from ray_lightning_tpu_torch.serve.scheduler import _key_data

    dev = model.device
    if not isinstance(prompt, torch.Tensor):
        prompt = torch.from_numpy(np.array(prompt, np.int64))
    prompt = prompt.to(dev, torch.long)
    B, S0 = prompt.shape
    explicit_cache_len = cache_len is not None
    if cache_len is None:
        cache_len = S0 + max_new_tokens
    if cache_len < S0 + max_new_tokens:
        raise ValueError(
            f"cache_len ({cache_len}) is smaller than prompt ({S0}) + "
            f"max_new_tokens ({max_new_tokens})")
    if cache_len > model.cfg.max_seq_len:
        what = (f"cache_len ({cache_len})" if explicit_cache_len else
                f"prompt ({S0}) + max_new_tokens ({max_new_tokens})")
        raise ValueError(
            f"{what} exceeds max_seq_len ({model.cfg.max_seq_len})")
    pad = None
    if prompt_lengths is not None:
        lengths = np.asarray(prompt_lengths, np.int32)
        if lengths.shape != (B,):
            raise ValueError(
                f"prompt_lengths must have shape ({B},), got "
                f"{lengths.shape}")
        if (lengths < 1).any() or (lengths > S0).any():
            # a length beyond the prompt width would be a NEGATIVE pad:
            # RoPE positions would shift up and every decode be wrong
            raise ValueError(
                f"prompt_lengths must be within [1, {S0}] (the padded "
                f"prompt width), got {lengths.tolist()}")
        pad = torch.from_numpy(S0 - lengths).to(dev)
    want = (model.cfg.n_layers, B, cache_len, model.cfg.n_kv_heads,
            model.cfg.head_dim)
    if cache is None:
        cache = init_cache(model.cfg, B, cache_len, device=dev)
    elif tuple(cache[0].shape) != want or tuple(cache[1].shape) != want:
        raise ValueError(f"cache leaves must be {want}, got "
                         f"{tuple(cache[0].shape)}")
    h = model.hidden(prompt, cache, 0, pad=pad)
    last = model.logits(h[:, -1])
    out = torch.zeros((B, max_new_tokens), dtype=torch.int32, device=dev)
    key = _key_data(seed)
    for t in range(max_new_tokens):
        key, draw = _split_key(key)
        if temperature == 0.0:
            tok = torch.argmax(last, dim=-1)
        else:
            tok = torch.stack([
                _sample_one(last[b], draw, float(temperature),
                            int(top_k or 0)) for b in range(B)])
        out[:, t] = tok.to(torch.int32)
        if t + 1 == max_new_tokens:
            break  # the last token's own K/V is never read
        pos = torch.full((B,), S0 + t, dtype=torch.long, device=dev)
        last = model(tok[:, None], cache, pos, pad=pad)[:, 0]
    return out


def token_loss_sum(logits: torch.Tensor, targets: torch.Tensor,
                   mask: Optional[torch.Tensor] = None):
    """(sum of the mask-weighted token CE, sum of the mask), f32 scalars:
    the JAX `cross_entropy_loss` (optax's integer-label softmax CE, the
    mask excluding padding) before its division."""
    logits = logits.float()
    losses = (torch.logsumexp(logits, dim=-1)
              - logits.gather(-1, targets.long()[..., None]).squeeze(-1))
    m = (torch.ones_like(losses) if mask is None else mask.float())
    return (losses * m).sum(), m.sum()


class LlamaModule(TpuModule):
    """TpuModule wrapper: next-token prediction on {"tokens": [B, S+1]}
    (or {"inputs", "targets"} pairs), twin of the JAX `LlamaModule`. The
    model keeps f32 master weights with gradients on and computes in
    ``cfg.dtype``; the optimizer is AdamW (betas 0.9 / 0.95) on every
    parameter under optax's warmup-cosine schedule. The AdamW is torch's
    fused one with a tensor lr under `DeviceLambdaLR`: the trainguard's
    skip (``found_inf``) then leaves the moments, the step counts and the
    schedule's position as they were, on the device. ``mu_dtype=
    torch.bfloat16`` (the twin of optax's ``mu_dtype``) stores the first
    moment in bf16 through `core.optim.MuAdamW`, whose one-launch kernel
    computes the update from the f32 moment before rounding it; the second
    moment stays f32. ``mu_dtype`` None or ``torch.float32`` is the fused
    AdamW."""

    def __init__(self, cfg: Optional[LlamaConfig] = None,
                 lr: float = 3e-4, weight_decay: float = 0.1,
                 warmup_steps: int = 100, total_steps: int = 10000,
                 mu_dtype: Optional[Any] = None, **cfg_overrides):
        super().__init__()
        if cfg is None:
            cfg = LlamaConfig(**cfg_overrides)
        elif cfg_overrides:
            cfg = dataclasses.replace(cfg, **cfg_overrides)
        self.cfg = cfg
        self.lr = lr
        self.weight_decay = weight_decay
        self.warmup_steps = warmup_steps
        self.total_steps = total_steps
        self.mu_dtype = mu_dtype
        self.save_hyperparameters(
            cfg=cfg, lr=lr, weight_decay=weight_decay,
            warmup_steps=warmup_steps, total_steps=total_steps,
            mu_dtype=mu_dtype)

    def configure_model(self) -> Llama:
        return Llama(self.cfg, device=self.device,
                     param_dtype=torch.float32).requires_grad_(True)

    def init_params(self, generator: torch.Generator, batch=None,
                    place=None):
        """`init_params_`; with ``place`` (the trainer's sharded init of a
        meta-built, wrapped model) each full weight goes through it, and
        the RoPE tables are recomputed on the generator's device."""
        if place is not None:
            self.model.reset_rope_(generator.device)
        init_params_(self.model, generator, place)
        return dict(self.model.named_parameters())

    def param_specs(self, params=None) -> Dict[str, tuple]:
        """The tensor-parallel placement (`llama_param_specs`)."""
        return llama_param_specs(self.cfg)

    def fused_rows(self) -> Dict[str, tuple]:
        """The fused weights' row groups (`llama_fused_rows`)."""
        return llama_fused_rows(self.cfg)

    def check_tensor_parallel(self, tensor: int) -> None:
        check_tensor_parallel(self.cfg, tensor)

    def schedule(self, step):
        """The learning rate of update ``step`` (0-based; an int, or a
        device tensor as `DeviceLambdaLR` passes it)."""
        return warmup_cosine_decay(step, 0.0, self.lr, self.warmup_steps,
                                   max(self.total_steps, 2),
                                   end_value=self.lr * 0.1)

    def configure_optimizers(self):
        from ray_lightning_tpu_torch.core.schedule import scheduled

        lr = self.lr
        kw = dict(lr=torch.tensor(lr, dtype=torch.float32,
                                  device=self.device),
                  betas=(0.9, 0.95), eps=1e-8,
                  weight_decay=self.weight_decay)
        if self.mu_dtype in (None, torch.float32):
            opt = torch.optim.AdamW(self.model.parameters(), fused=True, **kw)
        elif self.mu_dtype == torch.bfloat16:
            from ray_lightning_tpu_torch.core.optim import MuAdamW

            opt = MuAdamW(self.model.parameters(), **kw)
        else:
            raise ValueError(f"mu_dtype={self.mu_dtype}: bfloat16 (MuAdamW) "
                             "or float32 / None (the fused AdamW)")

        return opt, scheduled(opt, self.schedule, lr)

    def _split(self, batch):
        if "tokens" in batch:
            toks = batch["tokens"]
            return toks[:, :-1], toks[:, 1:], batch.get("mask")
        return batch["inputs"], batch["targets"], batch.get("mask")

    def check_sequence_parallel(self, seq: int) -> None:
        """`ShardedMesh(seq=)` shards the sequence only under
        ``cfg.seq_parallel`` (and not with the pipeline path)."""
        if not self.cfg.seq_parallel:
            raise ValueError(
                f"ShardedMesh(seq={seq}): LlamaConfig(seq_parallel=True) "
                "shards the sequence; without it every seq rank would "
                "train the same tokens")

    def pipeline_stage(self, name: str, pipe: int) -> Optional[int]:
        """The pipeline stage that owns the parameter ``name`` over
        ``pipe`` stages (None: replicated over them)."""
        if not Llama.pipeline_owned(name):
            return None
        return int(name.split(".")[1]) // (self.cfg.n_layers // pipe)

    def check_pipeline(self, pipe: int) -> None:
        """`ShardedMesh(pipe=)` needs the GPipe path, which composes with
        data parallelism only (the JAX exclusions)."""
        if self.cfg.pipeline_microbatches <= 0:
            raise ValueError(
                f"ShardedMesh(pipe={pipe}): set LlamaConfig("
                "pipeline_microbatches=M) for the GPipe decoder path")
        if self.cfg.n_layers % pipe:
            raise ValueError(f"{self.cfg.n_layers} layers not divisible by "
                             f"pipe={pipe}")

    def _loss(self, params, inputs, targets, mask):
        """The token mean over the GLOBAL batch, as the JAX module's loss
        over its global array: each rank divides its mask-weighted sum by
        the token count of every rank that holds other tokens (the
        data-parallel ranks, and under the ``seq`` axis each rank's chunk
        of the sequence) together, times their number, so the mean over
        those ranks (of the loss, and of the gradients the strategy
        averages) is the global mean even where the ranks' masks keep
        different numbers of tokens."""
        model = self.model
        inner = getattr(model, "module", model)
        if getattr(inner, "sp", None) is not None:
            inputs, targets, mask = (inner.seq_chunk(inputs),
                                     inner.seq_chunk(targets),
                                     inner.seq_chunk(mask))
        count = (mask.float().sum() if mask is not None
                 else torch.tensor(float(targets.numel()),
                                   device=targets.device))
        strategy = getattr(self.trainer, "strategy", None)
        dp = strategy.loss_ranks if strategy is not None else 1
        if dp > 1:
            count = strategy.reduce_sum(count)
        denominator = torch.clamp_min(count, 1.0) / dp
        return self.apply(params, inputs, targets=targets, mask=mask,
                          denominator=denominator)

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

    def generate(self, prompt, max_new_tokens: int, **kw) -> torch.Tensor:
        """KV-cache autoregressive decoding (`generate`) with the trained
        weights."""
        if self.model is None:
            raise RuntimeError("fit or load a checkpoint first")
        return generate(self.model, prompt, max_new_tokens, **kw)
