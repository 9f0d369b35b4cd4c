"""AdamW with a bf16 first moment (twin of optax's
``adamw(mu_dtype=jnp.bfloat16)``, the JAX `LlamaModule(mu_dtype=...)`'s
optimizer).

`MuAdamW` keeps ``exp_avg`` in bf16 (half the f32 moment's bytes) and
``exp_avg_sq`` and the parameters in f32, and steps every parameter with
one launch of the hand-written kernel (`ops/kernels/adamw.py`): the
update comes from the f32 new first moment, which is rounded to bf16
only for storage, as optax orders it. An f32 first moment is torch's
fused AdamW (`LlamaModule` takes that for ``mu_dtype`` None or f32). Under
`ops.dispatch.force_reference`, and on CPU tensors, the same arithmetic
runs as plain PyTorch.

It takes what the trainer and the trainguard give torch's fused
optimizers: a tensor ``lr`` that `core.schedule.DeviceLambdaLR` writes on
the device, and the ``found_inf`` flag, with which a step leaves
parameters, moments and step counts as they were, on the device
(``_step_supports_amp_scaling`` and ``fused=True`` mark it so). Its state
is torch's AdamW's, key for key (``step`` an f32 device scalar,
``exp_avg``, ``exp_avg_sq``; DTensors under FSDP2), so
`checkpoint.io` and `get_optimizer_state_dict` carry it unchanged. It
steps FSDP2's DTensor parameters through their local shards.
"""
from __future__ import annotations

from typing import Iterable

import torch

from ray_lightning_tpu_torch.ops import dispatch
from ray_lightning_tpu_torch.ops.kernels.adamw import (
    adamw_step_kernel,
    adamw_step_plain,
)
from ray_lightning_tpu_torch.parallel.tensor import local


class MuAdamW(torch.optim.Optimizer):
    """AdamW (decoupled weight decay on every parameter) whose first
    moment is stored in bf16. ``lr`` may be a float or a tensor
    (`DeviceLambdaLR` needs a tensor)."""

    #: the step honours ``found_inf`` on the device (the trainguard's skip)
    _step_supports_amp_scaling = True
    #: the stored first moment's dtype
    mu_dtype = torch.bfloat16

    def __init__(self, params: Iterable, lr=1e-3, betas=(0.9, 0.999),
                 eps: float = 1e-8, weight_decay: float = 1e-2):
        super().__init__(params, dict(lr=lr, betas=tuple(betas), eps=eps,
                                      weight_decay=weight_decay,
                                      fused=True))
        self._done = None

    def _init_state(self, p: torch.Tensor) -> dict:
        state = self.state[p]
        if not state:
            state["step"] = torch.zeros((), dtype=torch.float32,
                                        device=local(p).device)
            state["exp_avg"] = torch.zeros_like(p, dtype=self.mu_dtype)
            state["exp_avg_sq"] = torch.zeros_like(
                p, dtype=torch.float32)
        return state

    def load_state_dict(self, state_dict) -> None:
        """torch casts every loaded moment to its parameter's dtype; the
        first moment goes back to bf16 (exact: it was stored there)."""
        super().load_state_dict(state_dict)
        for state in self.state.values():
            if "exp_avg" in state and state["exp_avg"].dtype != self.mu_dtype:
                state["exp_avg"] = state["exp_avg"].to(self.mu_dtype)

    @staticmethod
    def _device_scalar(x, device: torch.device) -> torch.Tensor:
        if isinstance(x, torch.Tensor):
            return x.to(device=device, dtype=torch.float32)
        # filled on the device: no synchronising copy
        return torch.full((), float(x), dtype=torch.float32, device=device)

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        if getattr(self, "grad_scale", None) is not None:
            raise ValueError("MuAdamW takes found_inf but no grad_scale: "
                             "train in bf16 without loss scaling")
        found_inf = getattr(self, "found_inf", None)
        step_fn = (adamw_step_plain if dispatch.reference_forced()
                   else adamw_step_kernel)
        for group in self.param_groups:
            cols = ([], [], [], [], [])
            for p in group["params"]:
                if p.grad is None:
                    continue
                if p.grad.is_sparse:
                    raise ValueError("MuAdamW does not take sparse "
                                     "gradients")
                st = self._init_state(p)
                for col, x in zip(cols, (p, p.grad, st["exp_avg"],
                                         st["exp_avg_sq"], st["step"])):
                    col.append(local(x))
            if not cols[0]:
                continue
            dev = cols[0][0].device
            kw = {}
            if step_fn is adamw_step_kernel and dev.type == "cuda":
                if self._done is None or self._done.numel() < len(cols[0]):
                    self._done = torch.zeros(len(cols[0]),
                                             dtype=torch.int32, device=dev)
                kw["done"] = self._done
            b1, b2 = group["betas"]
            step_fn(*cols, self._device_scalar(group["lr"], dev),
                    None if found_inf is None
                    else self._device_scalar(found_inf, dev),
                    b1, b2, group["eps"], group["weight_decay"], **kw)
        return loss

