"""The port's ResNet family against the JAX package's, on the CPU, f32.

Weights come from the JAX model's own `init` and cross through
`params_from_jax` (HWIO -> OIHW, the head transposed); the same numpy
images go through both:

  * flax "SAME" padding: every stride-2 site (3x3/2 and 1x1/2
    convolutions on even and odd inputs, the 7x7/2 stem on 224, the
    stem's 3x3/2 max pool padded with -inf) against flax's own layers;
  * `resnet18` and `resnet50` forward at full width (CIFAR stem, 32x32)
    and `resnet18` with the ImageNet stem on 224, logits within 1e-4 of
    the largest;
  * a 3-step `Trainer.fit` of a small ResNet (clipping that bites,
    nesterov SGD with weight decay, the warmup-cosine schedule) against
    the JAX `Trainer.fit`: loss and grad_norm within 1e-4 a step;
  * the module's surface: variants, unknown variant, predict, the
    schedule's step 0.
"""
from __future__ import annotations

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_lightning_tpu.core.callbacks import Callback as JaxCallback
from ray_lightning_tpu.core.data import DataLoader as JaxDataLoader
from ray_lightning_tpu.core.trainer import Trainer as JaxTrainer
from ray_lightning_tpu.models import resnet as jres
from ray_lightning_tpu.parallel.strategy import SingleDevice as JaxSingle
from ray_lightning_tpu_torch.core.callbacks import Callback
from ray_lightning_tpu_torch.core.data import DataLoader
from ray_lightning_tpu_torch.core.trainer import Trainer
from ray_lightning_tpu_torch.models import resnet
from ray_lightning_tpu_torch.parallel.strategy import SingleDevice

TOL = 1e-4


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


@pytest.mark.parametrize("n,k,s", [(32, 3, 2), (31, 3, 2), (16, 1, 2),
                                   (15, 1, 2), (224, 7, 2), (32, 3, 1),
                                   (7, 3, 2)])
def test_conv_same_padding_matches_flax(n, k, s):
    """`conv_same` against flax ``nn.Conv(padding="SAME")``: the pads
    (asymmetric at stride 2: (0, 1) for 3x3 on even inputs, (2, 3) for
    the 7x7 stem on 224) and the output."""
    rng = np.random.default_rng(n + k)
    x = rng.standard_normal((2, n, n, 3)).astype(np.float32)
    conv = fnn.Conv(4, (k, k), (s, s), use_bias=False, dtype=jnp.float32)
    params = conv.init(jax.random.key(0), x)["params"]
    want = np.asarray(conv.apply({"params": params}, x))
    w = torch.from_numpy(np.ascontiguousarray(
        np.asarray(params["kernel"]).transpose(3, 2, 0, 1)))
    got = resnet.conv_same(_nchw(x), w, s, torch.float32)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               atol=1e-5, rtol=1e-5)
    pads = jax.lax.padtype_to_pads((n,), (k,), (s,), "SAME")[0]
    assert resnet._same_pads(n, k, s) == tuple(pads)
    if (n, k, s) == (224, 7, 2):
        assert tuple(pads) == (2, 3)
    if (n, k, s) == (32, 3, 2):
        assert tuple(pads) == (0, 1)


@pytest.mark.parametrize("n", [112, 15, 8])
def test_max_pool_same_matches_flax(n):
    """The stem's 3x3/2 max pool with "SAME" padding: the pad is -inf, so
    an all-negative input never takes the pad's value."""
    x = -1 - np.random.default_rng(n).random((2, n, n, 4)).astype(
        np.float32)
    want = np.asarray(fnn.max_pool(jnp.asarray(x), (3, 3), (2, 2),
                                   padding="SAME"))
    got = resnet.max_pool_same(_nchw(x)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got < -1).all()


def _forward_pair(variant, hw, cifar_stem, num_filters=64, seed=0):
    jm = getattr(jres, variant)(num_classes=10, cifar_stem=cifar_stem,
                                dtype=jnp.float32, num_filters=num_filters)
    x = np.random.default_rng(seed).standard_normal(
        (2, hw, hw, 3)).astype(np.float32)
    params = jm.init(jax.random.key(seed), x)["params"]
    want = np.asarray(jm.apply({"params": params}, x))
    pm = getattr(resnet, variant)(num_classes=10, cifar_stem=cifar_stem,
                                  dtype=torch.float32,
                                  num_filters=num_filters)
    sd = resnet.params_from_jax(jax.tree.map(np.asarray, params))
    assert set(sd) == set(pm.state_dict())
    pm.load_state_dict(sd)
    with torch.no_grad():
        got = pm(torch.from_numpy(x)).numpy()
    return got, want


@pytest.mark.parametrize("variant,hw,cifar_stem", [
    ("resnet18", 32, True), ("resnet50", 32, True), ("resnet18", 224, False)])
def test_forward_matches_jax(variant, hw, cifar_stem):
    """Full-width forward logits at f32 within 1e-4 of the largest."""
    got, want = _forward_pair(variant, hw, cifar_stem)
    assert got.shape == want.shape == (2, 10)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL * scale)


def test_resnet50_param_count_and_groups():
    """The port's ResNet-50 holds the JAX model's parameters, shape for
    shape (23.5 M at 10 classes), and its GroupNorms the JAX groups: the
    bottleneck's third norm ``min(32, filters)`` over 4x the channels."""
    pm = resnet.resnet50(num_classes=10, dtype=torch.float32)
    n = sum(p.numel() for p in pm.parameters())
    jm = jres.resnet50(num_classes=10, dtype=jnp.float32)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.key(0), jnp.zeros((1, 32, 32, 3))))["params"]
    assert n == sum(int(np.prod(s.shape))
                    for s in jax.tree.leaves(shapes)) and n > 2e7
    small = resnet.resnet50(num_filters=8)
    assert small.blocks[0].norm2.groups == 8
    assert small.blocks[0].proj_norm.groups == 32


class _Rows:
    def __init__(self):
        self.rows = []

    def on_train_batch_end(self, trainer, module, metrics, batch_idx):
        self.rows.append((float(metrics["loss"]),
                          float(metrics["grad_norm"])))


class _JaxRows(_Rows, JaxCallback):
    pass


class _PortRows(_Rows, Callback):
    pass


class _SmallJax(jres.ResNetModule):
    def configure_model(self):
        return jres.ResNet([1, 1], self.num_classes, jres.ResNetBlock,
                           num_filters=8, cifar_stem=True,
                           dtype=jnp.float32)


class _SmallPort(resnet.ResNetModule):
    def configure_model(self):
        return resnet.ResNet([1, 1], self.num_classes, resnet.ResNetBlock,
                             num_filters=8, cifar_stem=True,
                             dtype=torch.float32, device=self.device)


def _cifar(n=24, seed=0):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 4, n).astype(np.int32)
    base = rng.standard_normal((4, 1, 1, 3)).astype(np.float32) * 3
    x = base[y] + 0.3 * rng.standard_normal((n, 16, 16, 3)).astype(
        np.float32)
    return {"x": x, "y": y}


def test_fit_matches_jax():
    """3 steps of a small ResNet (two stages, 8 filters, stride-2 second
    stage) from the JAX init, the JAX chain (clip 1.0, weight decay,
    nesterov SGD 0.9, warmup-cosine over 3 steps, step 0 at lr 0) against
    torch's fused SGD under `DeviceLambdaLR` with the clip in its step:
    per-step loss and grad_norm within 1e-4, the clip biting."""
    data = _cifar()
    kw = dict(variant="resnet18", num_classes=4, lr=0.2, total_steps=3)
    common = dict(max_steps=3, log_every_n_steps=1,
                  enable_checkpointing=False, enable_progress_bar=False,
                  seed=0)
    jm = _SmallJax(**kw)
    jm.setup()
    params = jax.tree.map(np.asarray, jm.model.init(
        jax.random.key(0), data["x"][:2])["params"])
    jm.params = jax.tree.map(jnp.asarray, params)  # donated by the fit
    jrec = _JaxRows()
    JaxTrainer(strategy=JaxSingle(), callbacks=[jrec], **common).fit(
        jm, JaxDataLoader(data, batch_size=8, shuffle=True, seed=0))

    pm = _SmallPort(**kw, dtype=torch.float32)
    pm.params = resnet.params_from_jax(params)
    rec = _PortRows()
    Trainer(strategy=SingleDevice(device="cpu"), callbacks=[rec],
            **common).fit(pm, DataLoader(data, batch_size=8, shuffle=True,
                                         seed=0))
    assert len(rec.rows) == len(jrec.rows) == 3
    np.testing.assert_allclose(rec.rows, jrec.rows, rtol=TOL, atol=TOL)
    assert max(g for _, g in rec.rows) > 1.0  # the clip bites
    assert rec.rows[-1][0] != rec.rows[0][0]  # updates happened


def test_module_surface():
    with pytest.raises(ValueError, match="unknown variant"):
        resnet.ResNetModule("resnet7")
    m = resnet.ResNetModule("resnet18", num_classes=3, total_steps=40,
                            dtype=torch.float32)
    assert m.schedule(0) == 0.0  # optax's step 0: lr 0
    np.testing.assert_allclose(m.schedule(2), 0.1)  # warmup: 2 steps
    m.device = torch.device("cpu")
    m.setup()
    m.params = m.init_params(torch.Generator().manual_seed(0))
    x = torch.from_numpy(_cifar(4)["x"])
    assert m.predict_step(m.params, {"x": x}).shape == (4,)
    opt, sched = m.configure_optimizers()
    assert type(opt).__name__ == "ClippedSGD" and opt.defaults["nesterov"]
    assert opt.defaults["fused"] and float(opt.param_groups[0]["lr"]) == 0.0
    assert isinstance(m.hparams["variant"], str)
