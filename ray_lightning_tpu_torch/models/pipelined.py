"""A pipeline-parallel classifier: hidden layers as a GPipe microbatch
pipeline over the mesh's ``pipe`` axis (twin of
`ray_lightning_tpu/models/pipelined.py`).

The stacked layer weights (``layers_w`` [L, d, d], ``layers_b`` [L, d])
are stage-sharded (`param_specs` puts the layer dimension on ``pipe``, so
`parallel.strategy.ShardedMesh(pipe=P)` makes each a DTensor whose local
shard is the stage's block), the compute path is
`ops.pipeline.gpipe_apply`, and everything else is the ordinary Trainer.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ray_lightning_tpu_torch.core.module import TpuModule
from ray_lightning_tpu_torch.ops.pipeline import (
    gpipe_apply,
    pipeline_param_spec,
)
from ray_lightning_tpu_torch.parallel.comm import AxisGroup


def _stage_fn(lp, h):
    """One pipeline layer: tanh(h @ w + b)."""
    return torch.tanh(h @ lp["w"] + lp["b"])


class PipelinedMLP(nn.Module):
    """inp [in, d] -> L stacked tanh layers -> head [d, classes], the
    JAX layout (kernels [in, out])."""

    def __init__(self, in_features: int, d: int, n_layers: int,
                 num_classes: int, microbatches: int):
        super().__init__()
        self.microbatches = microbatches
        self.inp = nn.Parameter(torch.empty(in_features, d))
        self.layers_w = nn.Parameter(torch.empty(n_layers, d, d))
        self.layers_b = nn.Parameter(torch.empty(n_layers, d))
        self.head = nn.Parameter(torch.empty(d, num_classes))
        #: the ``pipe`` axis (None: every layer here, the plain loop)
        self.pp = None
        self.reset_parameters()

    def reset_parameters(self) -> None:
        """The JAX init's scales: normal(0, 0.3) kernels, zero biases."""
        with torch.no_grad():
            for p in (self.inp, self.layers_w, self.head):
                p.normal_(0.0, 0.3)
            self.layers_b.zero_()

    def enable_pipeline(self, axis: AxisGroup) -> None:
        self.pp = axis

    def forward(self, x):
        h = x.float() @ self.inp
        h = gpipe_apply(_stage_fn, {"w": self.layers_w, "b": self.layers_b},
                        h, self.pp, microbatches=self.microbatches)
        return h @ self.head


def params_from_jax(params_np: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX `PipelinedMLPModule`'s params (numpy) as this model's."""
    def t(a):
        return torch.tensor(np.ascontiguousarray(np.asarray(a)),
                            dtype=torch.float32)

    return {"inp": t(params_np["inp"]),
            "layers_w": t(params_np["layers"]["w"]),
            "layers_b": t(params_np["layers"]["b"]),
            "head": t(params_np["head"])}


class PipelinedMLPModule(TpuModule):
    """Classifier with GPipe-pipelined hidden layers (twin of the JAX
    module): under ``ShardedMesh(data=..., pipe=P)`` each of the P stage
    groups owns ``n_layers / P`` layers. The input width is an argument
    (the JAX module infers it at init)."""

    def __init__(self, d: int = 32, n_layers: int = 4, num_classes: int = 4,
                 microbatches: int = 2, lr: float = 5e-2,
                 in_features: int = 8):
        super().__init__()
        self.save_hyperparameters(d=d, n_layers=n_layers,
                                  num_classes=num_classes,
                                  microbatches=microbatches, lr=lr,
                                  in_features=in_features)
        self.d, self.n_layers = d, n_layers
        self.num_classes, self.microbatches = num_classes, microbatches
        self.lr, self.in_features = lr, in_features

    def configure_model(self):
        return PipelinedMLP(self.in_features, self.d, self.n_layers,
                            self.num_classes, self.microbatches
                            ).to(self.device)

    def configure_optimizers(self):
        # one tensor at a time: the layer stacks are DTensors under pipe
        return torch.optim.Adam(self.model.parameters(), lr=self.lr,
                                eps=1e-8, foreach=False)

    def param_specs(self, params=None) -> Dict[str, tuple]:
        return {"layers_w": pipeline_param_spec(),
                "layers_b": pipeline_param_spec(),
                "inp": (), "head": ()}

    def check_pipeline(self, pipe: int) -> None:
        if self.n_layers % pipe:
            raise ValueError(f"{self.n_layers} layers not divisible by "
                             f"pipe={pipe}")

    def training_step(self, params, batch, rng):
        logits = self.apply(params, batch["x"])
        loss = F.cross_entropy(logits, batch["y"].long())
        self.log("ptl/loss", loss)
        return loss

    def validation_step(self, params, batch):
        logits = self.apply(params, batch["x"])
        return {"val_acc": (logits.argmax(-1) == batch["y"].long())
                .float().mean()}

    def predict_step(self, params, batch):
        return self.apply(params, batch["x"]).argmax(-1)
