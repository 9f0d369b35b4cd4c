"""ResNet family, CIFAR and ImageNet stems (twin of
`ray_lightning_tpu/models/resnet.py`): BASELINE.json config 2 ("ResNet-50
/ CIFAR-10, data-parallel").

Batches are ``{"x": NHWC images, "y": int labels}``, as in JAX. Inside,
the model runs NCHW views of the NHWC input, which are ``channels_last``
tensors, the layout cuDNN's bf16 convolutions prefer. Numerics follow
the JAX model: f32 parameters, convolutions on ``dtype`` (bf16) operands,
GroupNorm statistics and affine in f32 with flax's epsilon (1e-6) and
``min(32, filters)`` groups, the pooled mean taken in f32 and an f32
head. Convolutions and GroupNorm are library calls (`F.conv2d`,
`F.group_norm`), as the JAX model leaves them to XLA: no Pallas kernel
is on this path.

flax's ``padding="SAME"`` is asymmetric where the stride does not divide
the padding: a 3x3/2 convolution on an even input pads (0, 1), the 7x7/2
ImageNet stem on 224 pads (2, 3), and the stem's 3x3/2 max pool pads
with -inf. Each such site pads explicitly (`_same_pads`).

Weights live in one state dict: ``stem``, ``norm`` (the stem's
GroupNorm), ``blocks.{i}.{conv0,conv1[,conv2],norm0,norm1[,norm2]
[,proj,proj_norm]}``, ``head``; convolutions ``[out, in, kh, kw]``
(flax's ``HWIO`` kernels transposed, `params_from_jax`), the head
``[out, in]``.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ray_lightning_tpu_torch.core.module import TpuModule

#: flax GroupNorm's default epsilon (torch's is 1e-5)
GN_EPS = 1e-6
#: `jax.nn.initializers.lecun_normal` draws a normal truncated at two
#: standard deviations, scaled up by this to keep the variance 1/fan_in
_TRUNC_STD = 0.87962566103423978


def _same_pads(n: int, k: int, s: int):
    """(low, high) padding of one spatial dim under flax's "SAME": the
    output is ceil(n / s), the extra row (if any) goes high."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def conv_same(x: torch.Tensor, w: torch.Tensor, stride: int,
              dtype) -> torch.Tensor:
    """flax ``nn.Conv(padding="SAME", use_bias=False)`` on NCHW ``x`` with
    an OIHW weight, on ``dtype`` operands."""
    k = w.shape[-1]
    (hl, hh), (wl, wh) = (_same_pads(x.shape[2], k, stride),
                          _same_pads(x.shape[3], k, stride))
    if hl == hh and wl == wh:
        return F.conv2d(x, w.to(dtype), stride=stride, padding=(hl, wl))
    return F.conv2d(F.pad(x, (wl, wh, hl, hh)), w.to(dtype), stride=stride)


def max_pool_same(x: torch.Tensor, k: int = 3, s: int = 2) -> torch.Tensor:
    """flax ``nn.max_pool(x, (k, k), (s, s), padding="SAME")``: the pad
    is -inf, so it never wins the max."""
    (hl, hh), (wl, wh) = _same_pads(x.shape[2], k, s), _same_pads(
        x.shape[3], k, s)
    return F.max_pool2d(F.pad(x, (wl, wh, hl, hh), value=float("-inf")),
                        k, s)


class GroupNorm(nn.Module):
    """flax ``nn.GroupNorm(num_groups, dtype=dtype, param_dtype=f32)``:
    statistics and the affine in f32, the result in ``dtype``."""

    def __init__(self, groups: int, channels: int, device=None):
        super().__init__()
        self.groups = groups
        self.weight = nn.Parameter(torch.ones(channels, device=device))
        self.bias = nn.Parameter(torch.zeros(channels, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.group_norm(x.float(), self.groups, self.weight, self.bias,
                            GN_EPS).to(x.dtype)


def _conv_weight(out_ch: int, in_ch: int, k: int, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(out_ch, in_ch, k, k, device=device))


class ResNetBlock(nn.Module):
    """Two 3x3 convolutions; a 1x1 projection where the shape changes."""

    fsdp_unit = True

    def __init__(self, in_ch: int, filters: int, strides: int = 1,
                 dtype=torch.bfloat16, device=None):
        super().__init__()
        self.strides, self.dtype = strides, dtype
        g = min(32, filters)
        self.conv0 = _conv_weight(filters, in_ch, 3, device)
        self.norm0 = GroupNorm(g, filters, device)
        self.conv1 = _conv_weight(filters, filters, 3, device)
        self.norm1 = GroupNorm(g, filters, device)
        self.has_proj = in_ch != filters or strides != 1
        if self.has_proj:
            self.proj = _conv_weight(filters, in_ch, 1, device)
            self.proj_norm = GroupNorm(g, filters, device)

    def forward(self, x):
        y = F.relu(self.norm0(conv_same(x, self.conv0, self.strides,
                                        self.dtype)))
        y = self.norm1(conv_same(y, self.conv1, 1, self.dtype))
        res = x
        if self.has_proj:
            res = self.proj_norm(conv_same(x, self.proj, self.strides,
                                           self.dtype))
        return F.relu(y + res)


class BottleneckBlock(nn.Module):
    """1x1 down, 3x3 (strided), 1x1 up to 4x the filters. As in JAX, the
    third norm keeps the block's ``min(32, filters)`` groups over its 4x
    channels and the projection's takes ``min(32, 4 * filters)``."""

    fsdp_unit = True

    def __init__(self, in_ch: int, filters: int, strides: int = 1,
                 dtype=torch.bfloat16, device=None):
        super().__init__()
        self.strides, self.dtype = strides, dtype
        g, out = min(32, filters), 4 * filters
        self.conv0 = _conv_weight(filters, in_ch, 1, device)
        self.norm0 = GroupNorm(g, filters, device)
        self.conv1 = _conv_weight(filters, filters, 3, device)
        self.norm1 = GroupNorm(g, filters, device)
        self.conv2 = _conv_weight(out, filters, 1, device)
        self.norm2 = GroupNorm(g, out, device)
        self.has_proj = in_ch != out or strides != 1
        if self.has_proj:
            self.proj = _conv_weight(out, in_ch, 1, device)
            self.proj_norm = GroupNorm(min(32, out), out, device)

    def forward(self, x):
        d = self.dtype
        y = F.relu(self.norm0(conv_same(x, self.conv0, 1, d)))
        y = F.relu(self.norm1(conv_same(y, self.conv1, self.strides, d)))
        y = self.norm2(conv_same(y, self.conv2, 1, d))
        res = x
        if self.has_proj:
            res = self.proj_norm(conv_same(x, self.proj, self.strides, d))
        return F.relu(y + res)


class ResNet(nn.Module):
    """``stage_sizes`` and ``block_cls`` pick the variant; NHWC [B, H, W,
    C] -> f32 logits [B, num_classes]."""

    def __init__(self, stage_sizes: Sequence[int], num_classes: int,
                 block_cls: Any = ResNetBlock, num_filters: int = 64,
                 cifar_stem: bool = False, dtype=torch.bfloat16,
                 in_channels: int = 3, device=None):
        super().__init__()
        self.cifar_stem, self.dtype = cifar_stem, dtype
        self.stem = _conv_weight(num_filters, in_channels,
                                 3 if cifar_stem else 7, device)
        self.norm = GroupNorm(min(32, num_filters), num_filters, device)
        blocks, ch = [], num_filters
        for i, n_blocks in enumerate(stage_sizes):
            for j in range(n_blocks):
                block = block_cls(ch, num_filters * 2 ** i,
                                  strides=2 if i > 0 and j == 0 else 1,
                                  dtype=dtype, device=device)
                blocks.append(block)
                ch = num_filters * 2 ** i * (
                    4 if block_cls is BottleneckBlock else 1)
        self.blocks = nn.ModuleList(blocks)
        self.head = nn.Linear(ch, num_classes, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # the NCHW view of an NHWC tensor is channels_last
        x = x.to(self.dtype).permute(0, 3, 1, 2)
        if self.cifar_stem:
            x = conv_same(x, self.stem, 1, self.dtype)
        else:
            x = max_pool_same(conv_same(x, self.stem, 2, self.dtype))
        x = F.relu(self.norm(x))
        for block in self.blocks:
            x = block(x)
        # the pooled mean straight to f32, as the f32 head reads it
        return self.head(x.float().mean(dim=(2, 3)))


def resnet18(num_classes=10, **kw):
    return ResNet([2, 2, 2, 2], num_classes, ResNetBlock, **kw)


def resnet34(num_classes=10, **kw):
    return ResNet([3, 4, 6, 3], num_classes, ResNetBlock, **kw)


def resnet50(num_classes=10, **kw):
    return ResNet([3, 4, 6, 3], num_classes, BottleneckBlock, **kw)


_VARIANTS = {"resnet18": resnet18, "resnet34": resnet34,
             "resnet50": resnet50}


def init_params_(model: ResNet, generator: torch.Generator) -> ResNet:
    """Fill ``model``'s weights in place from ``generator`` (on the
    model's device) with flax's initialisers: convolutions and the head
    ``lecun_normal`` (a normal truncated at 2 sigma, variance 1/fan_in),
    the head's bias zero, GroupNorm scale one and bias zero."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.dim() == 1:
                p.fill_(0.0 if name.endswith("bias") else 1.0)
                continue
            std = 1.0 / math.sqrt(p[0].numel()) / _TRUNC_STD
            nn.init.trunc_normal_(p, 0.0, std, -2 * std, 2 * std,
                                  generator=generator)
    return model


def params_from_jax(params_np: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX `ResNet`'s flax params (numpy leaves) as this model's
    state dict: ``HWIO`` conv kernels to ``OIHW``, the Dense head's
    ``[in, out]`` to ``[out, in]``, GroupNorm scale and bias as they
    are. The blocks' flax names (``ResNetBlock_{i}``,
    ``BottleneckBlock_{i}``) give their order."""

    def conv(k):
        return torch.tensor(np.ascontiguousarray(
            np.asarray(k).transpose(3, 2, 0, 1)))

    def norm(prefix, p):
        return {f"{prefix}.weight": torch.tensor(np.asarray(p["scale"])),
                f"{prefix}.bias": torch.tensor(np.asarray(p["bias"]))}

    sd = {"stem": conv(params_np["stem"]["kernel"]),
          **norm("norm", params_np["GroupNorm_0"]),
          "head.weight": torch.tensor(np.ascontiguousarray(
              np.asarray(params_np["head"]["kernel"]).T)),
          "head.bias": torch.tensor(np.asarray(params_np["head"]["bias"]))}
    kind = ("BottleneckBlock" if "BottleneckBlock_0" in params_np
            else "ResNetBlock")
    i = 0
    while f"{kind}_{i}" in params_np:
        for name, p in params_np[f"{kind}_{i}"].items():
            pre = f"blocks.{i}"
            if name.startswith("Conv_"):
                sd[f"{pre}.conv{name[5:]}"] = conv(p["kernel"])
            elif name == "proj":
                sd[f"{pre}.proj"] = conv(p["kernel"])
            elif name.startswith("GroupNorm_"):
                sd.update(norm(f"{pre}.norm{name[10:]}", p))
            else:
                sd.update(norm(f"{pre}.{name}", p))
        i += 1
    return sd


class ResNetModule(TpuModule):
    """Image classification on {"x": NHWC images, "y": int labels} (twin
    of the JAX `ResNetModule`). The optimizer is the JAX chain's: the
    gradients clipped to global norm 1, then nesterov SGD (momentum 0.9)
    with decoupled-into-the-gradient weight decay, under optax's
    warmup-cosine schedule (5% warmup, step 0 at lr 0). Here that is
    `clip_grad_norm_` inside the step, then torch's fused SGD with a
    tensor lr under `DeviceLambdaLR`."""

    def __init__(self, variant: str = "resnet50", num_classes: int = 10,
                 lr: float = 0.1, momentum: float = 0.9,
                 weight_decay: float = 1e-4, total_steps: int = 10_000,
                 cifar_stem: bool = True, dtype=torch.bfloat16):
        super().__init__()
        if variant not in _VARIANTS:
            raise ValueError(f"unknown variant {variant!r}; "
                             f"have {sorted(_VARIANTS)}")
        self.save_hyperparameters(
            variant=variant, num_classes=num_classes, lr=lr,
            momentum=momentum, weight_decay=weight_decay,
            total_steps=total_steps, cifar_stem=cifar_stem, dtype=dtype)
        self.variant = variant
        self.num_classes = num_classes
        self.lr = lr
        self.momentum = momentum
        self.weight_decay = weight_decay
        self.total_steps = total_steps
        self.cifar_stem = cifar_stem
        self.dtype = dtype

    def configure_model(self) -> ResNet:
        return _VARIANTS[self.variant](
            num_classes=self.num_classes, cifar_stem=self.cifar_stem,
            dtype=self.dtype, device=self.device)

    def init_params(self, generator: torch.Generator, batch=None):
        init_params_(self.model, generator)
        return dict(self.model.named_parameters())

    def schedule(self, step):
        """The learning rate of update ``step`` (an int or a device
        tensor): warmup over 5% of the run, then a cosine to 0."""
        from ray_lightning_tpu_torch.core.schedule import warmup_cosine_decay

        total = max(self.total_steps, 2)
        return warmup_cosine_decay(step, 0.0, self.lr, max(1, total // 20),
                                   total)

    def configure_optimizers(self):
        from ray_lightning_tpu_torch.core.schedule import scheduled

        opt = ClippedSGD(self.model.parameters(), max_norm=1.0,
                         lr=torch.tensor(self.lr, dtype=torch.float32,
                                         device=self.device),
                         momentum=self.momentum, nesterov=True,
                         weight_decay=self.weight_decay, fused=True)
        return opt, scheduled(opt, self.schedule, self.lr)

    def _loss_acc(self, params, batch):
        logits = self.apply(params, batch["x"])
        y = batch["y"].long()
        loss = F.cross_entropy(logits.float(), y)
        acc = (logits.argmax(-1) == y).float().mean()
        return loss, acc

    def training_step(self, params, batch, rng):
        loss, acc = self._loss_acc(params, batch)
        self.log("train_acc", acc)
        return loss

    def validation_step(self, params, batch):
        loss, acc = self._loss_acc(params, batch)
        return {"val_loss": loss, "val_acc": acc}

    def predict_step(self, params, batch):
        return self.apply(params, batch["x"]).argmax(-1)


class ClippedSGD(torch.optim.SGD):
    """torch's SGD whose step first clips the gradients to the global norm
    ``max_norm`` (`torch.nn.utils.clip_grad_norm_`, which reduces over
    FSDP2's sharded gradients): optax's ``chain(clip_by_global_norm,
    add_decayed_weights, sgd)``, which clips before the weight decay is
    added.

    The momentum buffers start as zeros, made here: torch's fused SGD
    makes them with ``empty_like`` in its first step and fills them in
    the kernel, which a step skipped through ``found_inf`` (the trainer's
    warm-up, the trainguard) never runs, so the next step would read
    uninitialised memory. From zeros, the first update is the same,
    ``buf = grad``."""

    def __init__(self, params, max_norm: float, **kw):
        super().__init__(params, **kw)
        self.max_norm = max_norm
        if self.defaults["momentum"]:
            for group in self.param_groups:
                for p in group["params"]:
                    self.state[p]["momentum_buffer"] = torch.zeros_like(
                        p, memory_format=torch.preserve_format)

    @torch.no_grad()
    def step(self, closure=None):
        grads = [p for g in self.param_groups for p in g["params"]
                 if p.grad is not None]
        torch.nn.utils.clip_grad_norm_(grads, self.max_norm, foreach=True)
        return super().step(closure)
