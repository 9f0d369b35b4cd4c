"""BERT-style bidirectional encoder for fine-tuning (twin of
`ray_lightning_tpu/models/bert.py`): BASELINE.json config 3 ("BERT-base
fine-tune").

Numerics follow the JAX model: f32 parameters, activations in
``cfg.dtype`` (bf16); every dense layer is `ops.precision.dense_f32_acc`
(``F32AccDense``: narrow operands, f32 accumulator and bias, one
rounding); LayerNorm statistics in f32 with ``cfg.norm_eps``; the exact
(erf) GELU in f32 on ``w_up``'s output; the pooler a tanh in f32 over
the widened ``[CLS]`` row; an f32 classifier. The fused ``wqkv`` is
split q|k|v and attention is `ops.attention.flash_attention(causal=
False, mask=...)`: with no padding mask the hand-written flash kernels,
forward and both backward passes, at head dim 64 for BERT-base; with a
mask (or ``use_flash=False``) the dense reference, as in JAX. No layer
is rematerialised (JAX BERT has no remat). Dropout draws its masks from
the explicit `torch.Generator` the trainer passes each step.

Under the tensor axis (`parallel.strategy.ShardedMesh(tensor=n)`, the
Megatron table `bert_param_specs`) each rank runs ``n_heads / n`` heads:
``wqkv`` and ``w_up`` are column-parallel (their bias shards added to
the f32 local product before its one rounding), ``wo`` and ``w_down``
row-parallel (the replicated bias added once, after the f32 all-reduce),
the token table vocab-parallel; the fused ``wqkv``'s rows (weight and
bias) are put head-aligned (`bert_fused_rows`) and back in the canonical
order in every state dict. Every dropout mask is drawn on a replicated
tensor, from the step's generator, which every tensor rank holds in the
same state: the masks are the one-card fit's.

Weights live in one state dict whose keys mirror the flax tree:
``encoder.{tok_embed,pos_embed,type_embed}`` ([rows, D] tables),
``encoder.embed_ln``, ``encoder.layers.{i}.{wqkv,wo,attn_ln,w_up,
w_down,mlp_ln}``, ``pooler``, ``classifier``; dense weights in the
`nn.Linear` layout ``[out, in]``. The layers are a Python loop;
`params_from_jax` reads both of the JAX layouts (``scan_layers`` on and
off).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ray_lightning_tpu_torch.core.module import TpuModule
from ray_lightning_tpu_torch.ops.attention import (
    dot_product_attention,
    flash_attention,
)
from ray_lightning_tpu_torch.ops.precision import (
    dense_f32_acc,
    pin_f32_accumulation,
)
from ray_lightning_tpu_torch.parallel.tensor import (
    column_linear,
    local,
    row_linear,
    vocab_parallel_embedding,
)


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    dim: int = 768
    n_layers: int = 12
    n_heads: int = 12
    hidden_dim: int = 3072
    max_seq_len: int = 512
    type_vocab_size: int = 2
    dropout: float = 0.1
    norm_eps: float = 1e-12
    dtype: Any = torch.bfloat16
    #: attention through `flash_attention` (the kernels where no mask is
    #: given); False: always the dense reference
    use_flash: bool = True

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    @classmethod
    def base(cls, **kw) -> "BertConfig":
        return cls(**kw)

    @classmethod
    def tiny(cls, **kw) -> "BertConfig":
        return cls(**{**dict(vocab_size=256, dim=64, n_layers=2, n_heads=4,
                             hidden_dim=128, max_seq_len=128), **kw})


class Dense(nn.Module):
    """A dense layer's f32 weight ``[out, in]`` and bias; `dense_f32_acc`
    in the activations' dtype. Under the tensor group ``tp`` a ``split``
    of "column" (this rank's output rows) or "row" (its input columns)
    runs `parallel.tensor`'s column- or row-parallel linear; None is
    replicated."""

    #: the rank's tensor group (`parallel.tensor.TensorParallel`), or None
    tp = None

    def __init__(self, d_in: int, d_out: int, device=None,
                 split: Optional[str] = None):
        super().__init__()
        self.split = split
        self.weight = nn.Parameter(torch.empty(d_out, d_in, device=device))
        self.bias = nn.Parameter(torch.zeros(d_out, device=device))

    def forward(self, x):
        w, b = local(self.weight), local(self.bias)
        if self.tp is None or self.split is None:
            return dense_f32_acc(x, w, b)
        linear = column_linear if self.split == "column" else row_linear
        return linear(x, w.to(x.dtype), self.tp, b)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm(epsilon=eps, dtype=dtype, param_dtype=f32)``:
    statistics and affine in f32, the result in x's dtype."""

    def __init__(self, dim: int, eps: float, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))

    def forward(self, x):
        return F.layer_norm(x.float(), (x.shape[-1],), local(self.weight),
                            local(self.bias), self.eps).to(x.dtype)


def dropout(x: torch.Tensor, rate: float, generator) -> torch.Tensor:
    """flax ``nn.Dropout``: keep with probability 1 - rate, scale kept
    values by 1 / (1 - rate); the mask drawn from ``generator``, or none
    (deterministic) when ``generator`` is None or the rate is 0."""
    if generator is None or rate == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) \
        >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


class BertLayer(nn.Module):
    #: `parallel.strategy.FSDP` shards each layer as its own unit
    fsdp_unit = True
    #: the rank's tensor group, or None off the tensor axis
    tp = None

    def __init__(self, cfg: BertConfig, device=None):
        super().__init__()
        self.cfg = cfg
        d = cfg.dim
        self.wqkv = Dense(d, 3 * d, device, split="column")
        self.wo = Dense(d, d, device, split="row")
        self.attn_ln = LayerNorm(d, cfg.norm_eps, device)
        self.w_up = Dense(d, cfg.hidden_dim, device, split="column")
        self.w_down = Dense(cfg.hidden_dim, d, device, split="row")
        self.mlp_ln = LayerNorm(d, cfg.norm_eps, device)

    def forward(self, x, mask=None, generator=None):
        cfg = self.cfg
        b, s, _ = x.shape
        # this rank's heads: its q|k|v rows are head-aligned
        heads = cfg.n_heads // (1 if self.tp is None else self.tp.size)
        d = heads * cfg.head_dim
        shape = (b, s, heads, cfg.head_dim)
        q, k, v = (t.reshape(shape) for t in self.wqkv(x).split(d, dim=-1))
        if cfg.use_flash:
            attn = flash_attention(q, k, v, causal=False, mask=mask)
        else:
            attn = dot_product_attention(q, k, v, causal=False, mask=mask)
        # the dropouts follow the row-parallel all-reduces: each mask is
        # drawn on the replicated output
        attn = dropout(self.wo(attn.reshape(b, s, d)), cfg.dropout,
                       generator)
        x = self.attn_ln(x + attn)
        # the exact (erf) GELU in f32, as the JAX layer computes it
        h = F.gelu(self.w_up(x).float()).to(cfg.dtype)
        h = dropout(self.w_down(h), cfg.dropout, generator)
        return self.mlp_ln(x + h)


class BertEncoder(nn.Module):
    """[B, S] token ids (+ optional type ids and padding mask) -> [B, S, D]
    in ``cfg.dtype``. Building one pins f32 accumulation for the dense
    layers' bf16 backward GEMMs, as the Llama does."""

    #: the rank's tensor group (the token table's vocabulary split), or
    #: None
    tp = None

    def __init__(self, cfg: BertConfig, device=None):
        super().__init__()
        pin_f32_accumulation()
        self.cfg = cfg
        d = cfg.dim
        self.tok_embed = nn.Parameter(torch.empty(cfg.vocab_size, d,
                                                  device=device))
        self.pos_embed = nn.Parameter(torch.empty(cfg.max_seq_len, d,
                                                  device=device))
        if cfg.type_vocab_size:
            self.type_embed = nn.Parameter(torch.empty(
                cfg.type_vocab_size, d, device=device))
        self.embed_ln = LayerNorm(d, cfg.norm_eps, device)
        self.layers = nn.ModuleList(
            [BertLayer(cfg, device) for _ in range(cfg.n_layers)])

    def forward(self, input_ids, attention_mask=None, token_type_ids=None,
                generator=None):
        """``generator`` draws the dropout masks (training); None is the
        deterministic forward."""
        cfg = self.cfg
        s = input_ids.shape[1]

        def embed(table, ids):
            # the row is taken from the f32 table, then rounded, so its
            # gradient scatters into the table in f32
            return F.embedding(ids, local(table)).to(cfg.dtype)

        if self.tp is None:
            x = embed(self.tok_embed, input_ids)
        else:
            # the f32 rows summed over the vocabulary's ranks, then
            # rounded once
            x = vocab_parallel_embedding(input_ids, local(self.tok_embed),
                                         self.tp).to(cfg.dtype)
        x = x + embed(self.pos_embed,
                      torch.arange(s, device=input_ids.device))[None]
        if cfg.type_vocab_size:
            if token_type_ids is None:
                token_type_ids = torch.zeros_like(input_ids)
            x = x + embed(self.type_embed, token_type_ids)
        x = dropout(self.embed_ln(x), cfg.dropout, generator)
        mask = attention_mask.bool() if attention_mask is not None else None
        for layer in self.layers:
            x = layer(x, mask, generator)
        return x


class BertForSequenceClassification(nn.Module):
    def __init__(self, cfg: BertConfig, num_classes: int = 2, device=None):
        super().__init__()
        self.cfg = cfg
        self.encoder = BertEncoder(cfg, device)
        self.pooler = Dense(cfg.dim, cfg.dim, device)
        self.classifier = nn.Linear(cfg.dim, num_classes, device=device)

    def enable_tensor_parallel(self, tp) -> None:
        """Run on this rank's shards of the tensor group ``tp``
        (`parallel.tensor.TensorParallel`); the strategy has made the
        weights those shards (`parallel.strategy.ShardedMesh`)."""
        check_tensor_parallel(self.cfg, tp.size)
        for m in self.modules():
            if isinstance(m, (BertEncoder, BertLayer, Dense)):
                m.tp = tp

    def forward(self, input_ids, attention_mask=None, token_type_ids=None,
                generator=None):
        x = self.encoder(input_ids, attention_mask, token_type_ids,
                         generator)
        # the pooler's pre-activation rounded once to the encoder's dtype,
        # then only the bounded tanh input widened
        pooled = torch.tanh(self.pooler(x[:, 0]).float())
        pooled = dropout(pooled, self.cfg.dropout, generator)
        return F.linear(pooled, local(self.classifier.weight),
                        local(self.classifier.bias))


#: per-layer tensor-parallel placement (the JAX table) in the port's
#: ``[out, in]`` layout: each JAX column split is a split of dim 0 here
_PER_LAYER_SPECS: Dict[str, tuple] = {
    "wqkv.weight": ("tensor", None), "wqkv.bias": ("tensor",),
    "wo.weight": (None, "tensor"), "wo.bias": (),
    "w_up.weight": ("tensor", None), "w_up.bias": ("tensor",),
    "w_down.weight": (None, "tensor"), "w_down.bias": (),
    "attn_ln.weight": (), "attn_ln.bias": (),
    "mlp_ln.weight": (), "mlp_ln.bias": (),
}


def bert_param_specs(cfg: BertConfig) -> Dict[str, tuple]:
    """Megatron placement (twin of the JAX `bert_param_specs`), keyed by
    the port's parameter names: column-split QKV and up, row-split O and
    down, the token table split by vocabulary; norms, the other tables,
    the pooler and the classifier replicated. The strategies overlay
    ``fsdp`` on a free dimension."""
    specs: Dict[str, tuple] = {
        "encoder.tok_embed": ("tensor", None),
        "encoder.pos_embed": (), "encoder.type_embed": (),
        "encoder.embed_ln.weight": (), "encoder.embed_ln.bias": (),
    }
    for i in range(cfg.n_layers):
        for k, v in _PER_LAYER_SPECS.items():
            specs[f"encoder.layers.{i}.{k}"] = v
    return specs


def bert_fused_rows(cfg: BertConfig) -> Dict[str, tuple]:
    """The fused ``wqkv``'s row groups, weight and bias: q|k|v along
    dimension 0, {name: (parts, 0)}. A tensor split keeps each rank's
    share of q, k and v together (`parallel.tensor.fused_row_permutation`)."""
    parts = (cfg.dim, cfg.dim, cfg.dim)
    return {f"encoder.layers.{i}.wqkv.{leaf}": (parts, 0)
            for i in range(cfg.n_layers) for leaf in ("weight", "bias")}


def check_tensor_parallel(cfg: BertConfig, tensor: int) -> None:
    """``tensor`` must divide every dimension a rank's shard splits: the
    heads, the MLP width and the vocabulary. Raises naming the first that
    it does not."""
    for what, n in (("n_heads", cfg.n_heads), ("hidden_dim", cfg.hidden_dim),
                    ("vocab_size", cfg.vocab_size)):
        if n % tensor:
            raise ValueError(
                f"tensor={tensor} does not divide {what}={n}: a tensor "
                "rank holds whole heads, MLP columns and vocabulary rows")


def init_params_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Fill ``model``'s weights in place from ``generator`` (on the
    model's device), scaled like flax's initialisers: dense weights
    ``lecun_normal`` (truncated at 2 sigma, variance 1/fan_in), the
    embedding tables normal(0, 1/sqrt(dim)), biases zero, LayerNorm
    gains one."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.dim() == 1:
                p.fill_(0.0 if name.endswith("bias") else 1.0)
            elif name.endswith("embed"):
                p.normal_(0.0, 1.0 / math.sqrt(p.shape[1]),
                          generator=generator)
            else:
                std = 1.0 / math.sqrt(p.shape[1]) / 0.87962566103423978
                nn.init.trunc_normal_(p, 0.0, std, -2 * std, 2 * std,
                                      generator=generator)
    return model


_DENSE = ("wqkv", "wo", "w_up", "w_down")
_NORMS = ("attn_ln", "mlp_ln")


def _encoder_from_jax(enc: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    def t(a):
        return torch.tensor(np.ascontiguousarray(np.asarray(a)),
                            dtype=torch.float32)

    sd = {"tok_embed": t(enc["tok_embed"]["embedding"]),
          "pos_embed": t(enc["pos_embed"]["embedding"]),
          "embed_ln.weight": t(enc["embed_ln"]["scale"]),
          "embed_ln.bias": t(enc["embed_ln"]["bias"])}
    if "type_embed" in enc:
        sd["type_embed"] = t(enc["type_embed"]["embedding"])
    if "layers" in enc:
        n = len(np.asarray(enc["layers"]["wqkv"]["kernel"]))
        layer = lambda i: {k: {n2: np.asarray(v)[i] for n2, v in d.items()}  # noqa: E731
                           for k, d in enc["layers"].items()}
    else:
        n = sum(k.startswith("layer_") for k in enc)
        layer = lambda i: enc[f"layer_{i}"]  # noqa: E731
    for i in range(n):
        lp = layer(i)
        for name in _DENSE:
            sd[f"layers.{i}.{name}.weight"] = t(np.asarray(
                lp[name]["kernel"]).T)
            sd[f"layers.{i}.{name}.bias"] = t(lp[name]["bias"])
        for name in _NORMS:
            sd[f"layers.{i}.{name}.weight"] = t(lp[name]["scale"])
            sd[f"layers.{i}.{name}.bias"] = t(lp[name]["bias"])
    return sd


def params_from_jax(params_np: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX BERT's flax params (numpy leaves) as this model's f32
    state dict: a `BertForSequenceClassification` tree (``encoder``,
    ``pooler``, ``classifier``) gives the classifier's keys, a
    `BertEncoder` tree the encoder's. Both layer layouts are read:
    ``layers/<name>`` stacked ``[L, ...]`` (``scan_layers=True``) and
    ``layer_{i}/<name>``. Dense kernels ``[in, out]`` are transposed."""
    if "encoder" not in params_np:
        return _encoder_from_jax(params_np)
    sd = {f"encoder.{k}": v
          for k, v in _encoder_from_jax(params_np["encoder"]).items()}
    for name in ("pooler", "classifier"):
        p = params_np[name]
        sd[f"{name}.weight"] = torch.tensor(np.ascontiguousarray(
            np.asarray(p["kernel"]).T), dtype=torch.float32)
        sd[f"{name}.bias"] = torch.tensor(np.asarray(p["bias"]),
                                          dtype=torch.float32)
    return sd


class BertClassifierModule(TpuModule):
    """Fine-tune BERT for sequence classification (twin of the JAX
    module). Batch: {"input_ids": [B, S], "labels": [B]} and optionally
    "attention_mask" and "token_type_ids". The optimizer is optax's
    ``adamw`` (betas 0.9 / 0.999, eps 1e-8, every parameter decayed)
    under its warmup-cosine schedule, step 0 at lr 0: torch's fused
    AdamW with a tensor lr under `DeviceLambdaLR`. Runs under
    `SingleDevice`, `DataParallel`, `FSDP` and `ShardedMesh`, the tensor
    axis included (`bert_param_specs`, `bert_fused_rows`; a ``tensor``
    that does not divide the heads, the MLP width or the vocabulary
    raises, `check_tensor_parallel`)."""

    def __init__(self, cfg: Optional[BertConfig] = None,
                 num_classes: int = 2, lr: float = 2e-5,
                 weight_decay: float = 0.01, warmup_steps: int = 100,
                 total_steps: int = 10_000, **cfg_overrides):
        super().__init__()
        if cfg is None:
            cfg = BertConfig(**cfg_overrides)
        elif cfg_overrides:
            cfg = dataclasses.replace(cfg, **cfg_overrides)
        self.cfg = cfg
        self.num_classes = num_classes
        self.lr = lr
        self.weight_decay = weight_decay
        self.warmup_steps = warmup_steps
        self.total_steps = total_steps
        self.save_hyperparameters(
            cfg=cfg, num_classes=num_classes, lr=lr,
            weight_decay=weight_decay, warmup_steps=warmup_steps,
            total_steps=total_steps)

    def configure_model(self) -> BertForSequenceClassification:
        return BertForSequenceClassification(self.cfg, self.num_classes,
                                             device=self.device)

    def init_params(self, generator: torch.Generator, batch=None):
        init_params_(self.model, generator)
        return dict(self.model.named_parameters())

    def param_specs(self, params=None) -> Dict[str, tuple]:
        return bert_param_specs(self.cfg)

    def fused_rows(self) -> Dict[str, tuple]:
        """The fused ``wqkv``'s row groups (`bert_fused_rows`)."""
        return bert_fused_rows(self.cfg)

    def check_tensor_parallel(self, tensor: int) -> None:
        check_tensor_parallel(self.cfg, tensor)

    def schedule(self, step):
        """The learning rate of update ``step`` (an int or a device
        tensor)."""
        from ray_lightning_tpu_torch.core.schedule import warmup_cosine_decay

        return warmup_cosine_decay(step, 0.0, self.lr, self.warmup_steps,
                                   max(self.total_steps, 2))

    def configure_optimizers(self):
        from ray_lightning_tpu_torch.core.schedule import scheduled

        opt = torch.optim.AdamW(
            self.model.parameters(), fused=True,
            lr=torch.tensor(self.lr, dtype=torch.float32,
                            device=self.device),
            betas=(0.9, 0.999), eps=1e-8, weight_decay=self.weight_decay)
        return opt, scheduled(opt, self.schedule, self.lr)

    def _forward(self, params, batch, generator=None):
        return self.apply(params, batch["input_ids"],
                          batch.get("attention_mask"),
                          batch.get("token_type_ids"), generator)

    def _loss_acc(self, logits, labels):
        labels = labels.long()
        loss = F.cross_entropy(logits.float(), labels)
        acc = (logits.argmax(-1) == labels).float().mean()
        return loss, acc

    def training_step(self, params, batch, rng):
        loss, acc = self._loss_acc(self._forward(params, batch, rng),
                                   batch["labels"])
        self.log("train_acc", acc)
        return loss

    def validation_step(self, params, batch):
        loss, acc = self._loss_acc(self._forward(params, batch),
                                   batch["labels"])
        return {"val_loss": loss, "val_acc": acc}

    def predict_step(self, params, batch):
        return self._forward(params, batch).argmax(-1)
