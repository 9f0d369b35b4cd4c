"""Mixture-of-Experts layer with expert parallelism (twin of
`ray_lightning_tpu/models/moe.py`).

The same static-shape GShard/Switch formulation as the JAX layer: top-k
routing with normalised weights in f32, a fixed capacity C per group of
tokens (tokens past it are dropped: their combine weight is zero),
one-hot dispatch and combine einsums, one batched matmul over the
stacked [E, D, 2F] and [E, F, D] expert weights, and the Switch
load-balance loss returned beside the output. Every einsum takes its
operands in ``dtype`` and accumulates in f32, rounded once.

Expert parallelism is explicit here, where XLA inserts it in JAX: under
the mesh's ``expert`` axis (`parallel.strategy.ShardedMesh(expert=n)`)
each rank holds E/n experts' weights (dimension 0 sharded, `param_specs`
from `moe_param_specs`), the dispatched [ng, E, C, D] goes to the
experts' owners through `parallel.comm.all_to_all` and comes back the
same way before the combine. The batch is split over the axis too, so
the aux loss's routing fraction and mean probability are averaged over
the batch ranks, as JAX takes them over the global batch.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ray_lightning_tpu_torch.core.module import TpuModule
from ray_lightning_tpu_torch.parallel.comm import (
    AxisGroup,
    all_to_all,
    mean_over,
)
from ray_lightning_tpu_torch.parallel.tensor import local


def _fit_group(total: int, target: int) -> int:
    """Largest divisor of ``total`` that is <= ``target``."""
    g = min(total, target)
    while g > 1 and total % g != 0:
        g -= 1
    return max(1, g)


def _ein(eq: str, a: torch.Tensor, b: torch.Tensor, dtype) -> torch.Tensor:
    """``einsum`` of operands rounded to ``dtype``, accumulated in f32 and
    rounded once to ``dtype``."""
    return torch.einsum(eq, a.to(dtype).float(), b.to(dtype).float()).to(
        dtype)


class MoEMLP(nn.Module):
    """Top-k routed SwiGLU expert bank: [B, S, D] -> ([B, S, D], aux).
    Weights in the JAX layout: ``router`` [D, E], ``w_gate_up`` [E, D,
    2F], ``w_down`` [E, F, D], all f32."""

    def __init__(self, dim: int, n_experts: int, hidden_dim: int,
                 top_k: int = 2, capacity_factor: float = 1.25,
                 dtype: Any = torch.bfloat16, group_size: int = 1024,
                 device=None):
        super().__init__()
        self.n_experts, self.hidden_dim = n_experts, hidden_dim
        self.top_k, self.capacity_factor = top_k, capacity_factor
        self.dtype, self.group_size = dtype, group_size
        f32 = dict(dtype=torch.float32, device=device)
        self.router = nn.Parameter(torch.empty(dim, n_experts, **f32))
        self.w_gate_up = nn.Parameter(
            torch.empty(n_experts, dim, 2 * hidden_dim, **f32))
        self.w_down = nn.Parameter(
            torch.empty(n_experts, hidden_dim, dim, **f32))
        #: the ``expert`` axis the bank is split over (None: every expert
        #: here), and the group of every rank holding other rows of the
        #: batch (rank = the data shard's index; None: the whole batch is
        #: here)
        self.ep: Optional[AxisGroup] = None
        self.batch: Optional[AxisGroup] = None
        self.reset_parameters()

    def reset_parameters(self) -> None:
        """The JAX initialisers' scales: router normal(0, 0.02), expert
        weights normal(0, 1/sqrt(fan_in)) (lecun_normal, untruncated)."""
        with torch.no_grad():
            self.router.normal_(0.0, 0.02)
            self.w_gate_up.normal_(0.0, 1.0 / math.sqrt(
                self.w_gate_up.shape[1]))
            self.w_down.normal_(0.0, 1.0 / math.sqrt(self.w_down.shape[1]))

    def _groups(self, G: int):
        """(groups here, group size, capacity, ranks a group spans) for G
        local tokens: the groups are those of the global batch (the batch
        ranks' tokens in shard order), as in JAX."""
        n = self.batch.size if self.batch is not None else 1
        gs = _fit_group(G * n, self.group_size)
        C = max(1, int(np.ceil(gs * self.capacity_factor * self.top_k
                               / self.n_experts)))
        if G % gs == 0:
            return G // gs, gs, C, 1
        if gs % G:
            raise NotImplementedError(
                f"MoE groups of {gs} tokens straddle the batch shards of "
                f"{G} tokens a rank: pick a group_size that divides or is "
                "a multiple of the tokens a rank holds")
        return 1, G, C, gs // G

    def _offsets(self, onehot: torch.Tensor, span: int) -> torch.Tensor:
        """[E] slots of each expert's capacity taken by the earlier ranks
        of this rank's group (0 when a group is a rank's own)."""
        if span == 1:
            return onehot.new_zeros(self.n_experts)
        import torch.distributed as dist

        counts = onehot.sum((0, 1, 2)).contiguous()
        every = [torch.empty_like(counts) for _ in range(self.batch.size)]
        dist.all_gather(every, counts, group=self.batch.group)
        first = self.batch.rank // span * span
        return sum(every[first:self.batch.rank], counts.new_zeros(
            self.n_experts))

    def forward(self, x: torch.Tensor):
        B, S, D = x.shape
        E, K, dt = self.n_experts, self.top_k, self.dtype
        ng, gs, C, span = self._groups(B * S)
        xg = x.reshape(ng, gs, D)

        logits = torch.einsum("nsd,de->nse", xg.float(),
                              local(self.router).float())
        probs = torch.softmax(logits, dim=-1)                # [ng, gs, E]
        top_w, top_e = torch.topk(probs, K, dim=-1)          # [ng, gs, K]
        top_w = top_w / torch.clamp_min(top_w.sum(-1, keepdim=True), 1e-9)

        onehot = F.one_hot(top_e, E).float()                 # [ng,gs,K,E]
        flat = onehot.reshape(ng, gs * K, E)
        pos = (torch.cumsum(flat, dim=1) - flat).reshape(ng, gs, K, E)
        pos = pos + self._offsets(onehot, span)
        pos = (pos * onehot).sum(-1).long()                  # [ng, gs, K]
        within = (pos < C).float()
        pos_oh = F.one_hot(pos.clamp_max(C), C + 1)[..., :C].float()
        disp = torch.einsum("nske,nskc->nsec", onehot * within[..., None],
                            pos_oh)
        comb = torch.einsum("nske,nskc->nsec",
                            onehot * (top_w * within)[..., None], pos_oh)

        # a rank's tokens fill their own slots of a group's buffers; the
        # expert FFN works slot by slot, so each rank's buffer is run as
        # it is
        expert_in = _ein("nsd,nsec->necd", xg, disp, dt)     # [ng,E,C,D]
        if self.ep is not None:
            # each rank's tokens to the owners of their experts:
            # [ng, E, C, D] -> [n * ng, E/n, C, D]
            expert_in = all_to_all(expert_in.contiguous(), self.ep,
                                   split_dim=1, concat_dim=0)
        gate_up = _ein("necd,edf->necf", expert_in, local(self.w_gate_up),
                       dt)
        gate, up = gate_up.chunk(2, dim=-1)
        h = (F.silu(gate.float()).to(dt) * up).to(dt)
        expert_out = _ein("necf,efd->necd", h, local(self.w_down), dt)
        if self.ep is not None:
            expert_out = all_to_all(expert_out.contiguous(), self.ep,
                                    split_dim=0, concat_dim=1)
        y = _ein("necd,nsec->nsd", expert_out, comb, dt)

        # Switch load-balance loss over the global batch: the raw routing
        # fraction (no capacity mask) and the mean router probability
        frac = onehot.sum(2).mean((0, 1))                    # [E]
        mean_p = probs.mean((0, 1))
        frac = mean_over(frac, self.batch)
        mean_p = mean_over(mean_p, self.batch)
        aux = E * torch.sum(frac * mean_p)
        return y.reshape(B, S, D).to(x.dtype), aux


def moe_param_specs(prefix: str = "") -> Dict[str, tuple]:
    """Expert-parallel placement: the stacked expert weights split on
    dimension 0 over ``expert``, the router replicated."""
    return {
        f"{prefix}router": (),
        f"{prefix}w_gate_up": ("expert", None, "tensor"),
        f"{prefix}w_down": ("expert", "tensor", None),
    }


class _MoENet(nn.Module):
    """Dense embed -> MoE over a length-1 sequence (residual) -> dense
    head: ``(logits f32, aux)``."""

    def __init__(self, in_features: int, dim: int, n_experts: int,
                 hidden_dim: int, top_k: int, num_classes: int, dtype):
        super().__init__()
        self.embed = nn.Linear(in_features, dim)
        self.moe = MoEMLP(dim, n_experts, hidden_dim, top_k, dtype=dtype)
        self.head = nn.Linear(dim, num_classes)

    def enable_expert_parallel(self, ep: AxisGroup,
                               batch: AxisGroup) -> None:
        self.moe.ep = ep
        self.moe.batch = batch

    def forward(self, x):
        h = self.embed(x.float())[:, None, :]
        y, aux = self.moe(h)
        return self.head((h + y)[:, 0]).float(), aux


def params_from_jax(params_np: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX `MoEClassifierModule`'s flax params (``embed``, ``moe``,
    ``head``; numpy leaves) as `_MoENet`'s state dict: dense kernels
    transposed to ``[out, in]``, the MoE weights as they are."""
    def t(a):
        return torch.tensor(np.ascontiguousarray(np.asarray(a)),
                            dtype=torch.float32)

    sd = {}
    for name in ("embed", "head"):
        sd[f"{name}.weight"] = t(np.asarray(params_np[name]["kernel"]).T)
        sd[f"{name}.bias"] = t(params_np[name]["bias"])
    for name in ("router", "w_gate_up", "w_down"):
        sd[f"moe.{name}"] = t(params_np["moe"][name])
    return sd


class MoEClassifierModule(TpuModule):
    """Small expert-parallel classifier (twin of the JAX module): the
    ``expert`` mesh axis end to end (router, aux loss, expert weights
    split over it) on {"x": [B, in_features], "y": [B]} batches. The JAX
    module infers the input width at init; here it is an argument."""

    def __init__(self, dim: int = 64, n_experts: int = 4,
                 hidden_dim: int = 128, top_k: int = 2,
                 num_classes: int = 4, lr: float = 1e-3,
                 aux_weight: float = 0.01, in_features: int = 32):
        super().__init__()
        self.save_hyperparameters(
            dim=dim, n_experts=n_experts, hidden_dim=hidden_dim,
            top_k=top_k, num_classes=num_classes, lr=lr,
            aux_weight=aux_weight, in_features=in_features)
        self.dim, self.n_experts = dim, n_experts
        self.hidden_dim, self.top_k = hidden_dim, top_k
        self.num_classes, self.lr = num_classes, lr
        self.aux_weight, self.in_features = aux_weight, in_features

    def configure_model(self):
        return _MoENet(self.in_features, self.dim, self.n_experts,
                       self.hidden_dim, self.top_k, self.num_classes,
                       torch.float32).to(self.device)

    def configure_optimizers(self):
        # one tensor at a time: the expert weights are DTensors under the
        # expert axis, the rest plain tensors
        return torch.optim.Adam(self.model.parameters(), lr=self.lr,
                                eps=1e-8, foreach=False)

    def param_specs(self, params=None) -> Dict[str, tuple]:
        return moe_param_specs("moe.")

    def _out(self, params, x):
        return self.apply(params, x)

    def training_step(self, params, batch, rng):
        logits, aux = self._out(params, batch["x"])
        loss = F.cross_entropy(logits, batch["y"].long())
        self.log("aux_loss", aux)
        return loss + self.aux_weight * aux

    def validation_step(self, params, batch):
        logits, aux = self._out(params, batch["x"])
        y = batch["y"].long()
        loss = F.cross_entropy(logits, y)
        acc = (logits.argmax(-1) == y).float().mean()
        return {"val_loss": loss, "val_acc": acc, "val_aux": aux}

    def predict_step(self, params, batch):
        return self._out(params, batch["x"])[0].argmax(-1)
