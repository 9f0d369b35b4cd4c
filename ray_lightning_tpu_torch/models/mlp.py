"""MLP classifiers (twin of `ray_lightning_tpu/models/mlp.py`): the
reference's canonical train → checkpoint → load → predict models.

MNISTClassifier mirrors the reference's LightningMNISTClassifier
(reference tests/utils.py:96-145: 3-layer MLP 128→256→classes, Adam).
The JAX model is flax `Dense` layers; here `nn.Linear`, whose weight is
the transpose of the flax kernel (`params_from_jax`).
"""
from __future__ import annotations

from typing import Any, Dict, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ray_lightning_tpu_torch.core.module import TpuModule


class MLP(nn.Module):
    """Flatten, then ``features`` ReLU layers and a linear head."""

    def __init__(self, in_features: int, features: Sequence[int] = (128, 256),
                 num_classes: int = 10):
        super().__init__()
        widths = [in_features, *features, num_classes]
        self.dense = nn.ModuleList(
            [nn.Linear(a, b) for a, b in zip(widths[:-1], widths[1:])])

    def forward(self, x):
        x = x.reshape(x.shape[0], -1)
        for layer in self.dense[:-1]:
            x = F.relu(layer(x))
        return self.dense[-1](x)


def params_from_jax(params_np: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX `MLP`'s flax params (``Dense_{i}/{kernel,bias}``, numpy) as
    this model's state dict."""
    out = {}
    for i in range(len(params_np)):
        dense = params_np[f"Dense_{i}"]
        out[f"dense.{i}.weight"] = torch.tensor(
            np.ascontiguousarray(np.asarray(dense["kernel"]).T))
        out[f"dense.{i}.bias"] = torch.tensor(np.asarray(dense["bias"]))
    return out


class MLPClassifier(TpuModule):
    """Generic MLP classifier on {"x": [B, ...], "y": [B]} batches.

    The JAX module infers the input width at init; an `nn.Linear` needs
    it when built, so it is an argument here (64: `synthetic_mnist`)."""

    def __init__(self, features: Sequence[int] = (128, 256),
                 num_classes: int = 10, lr: float = 1e-3,
                 in_features: int = 64):
        super().__init__()
        self.save_hyperparameters(features=tuple(features),
                                  num_classes=num_classes, lr=lr,
                                  in_features=in_features)
        self.features = tuple(features)
        self.num_classes = num_classes
        self.lr = lr
        self.in_features = in_features

    def configure_model(self):
        return MLP(self.in_features, self.features, self.num_classes)

    def configure_optimizers(self):
        return torch.optim.Adam(self.model.parameters(), lr=self.lr,
                                eps=1e-8)

    def _metrics(self, params, batch):
        logits = self.apply(params, batch["x"])
        y = batch["y"].long()
        loss = F.cross_entropy(logits.float(), y)
        acc = (logits.argmax(-1) == y).float().mean()
        return loss, acc

    def training_step(self, params, batch, rng):
        loss, acc = self._metrics(params, batch)
        self.log("ptl/train_loss", loss)
        self.log("ptl/train_accuracy", acc)
        return loss

    def validation_step(self, params, batch):
        loss, acc = self._metrics(params, batch)
        return {"ptl/val_loss": loss, "ptl/val_accuracy": acc}

    def predict_step(self, params, batch):
        return self.apply(params, batch["x"]).argmax(-1)


class MNISTClassifier(MLPClassifier):
    """Reference examples/ray_ddp_example.py MNISTClassifier analog."""

    def __init__(self, lr: float = 1e-3, layer_1: int = 128,
                 layer_2: int = 256, in_features: int = 64):
        super().__init__(features=(layer_1, layer_2), num_classes=10, lr=lr,
                         in_features=in_features)
        self.hparams.clear()  # ctor signature differs from parent's
        self.save_hyperparameters(lr=lr, layer_1=layer_1, layer_2=layer_2,
                                  in_features=in_features)


def synthetic_mnist(n: int = 512, seed: int = 0, num_classes: int = 10):
    """Separable synthetic stand-in for MNIST (the JAX tests' own,
    `tests/utils.py` `synthetic_mnist`): class-dependent means make ≥0.5
    accuracy reachable in one epoch."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, num_classes, size=n).astype(np.int32)
    centers = rng.standard_normal((num_classes, 64)).astype(np.float32) * 3.0
    x = centers[y] + rng.standard_normal((n, 64)).astype(np.float32)
    return {"x": x, "y": y}
