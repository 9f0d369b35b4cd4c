"""The port's training path against the JAX package's, on the CPU.

Numpy inputs from a seed, f32 throughout. Weights come from the JAX
model's own `init` and cross through `params_from_jax(dtype=float32)`
(the trainer's f32 master weights). Held against JAX:

  * `rms_norm`'s dx and dw against `jax.grad` of `rms_norm_pallas` in
    interpret mode (the port's `RMSNormFunction` backward);
  * `fused_cross_entropy` and its gradients, several chunks with a
    ragged last one;
  * the tiny `LlamaModule` loss and every parameter's gradient against
    `jax.value_and_grad`, fused CE on and off, block remat on and off;
  * `Trainer.fit` over 4 steps (warmup 1, so the learning rate is nonzero
    from step 1 on; gradient clipping that bites; gradient accumulation)
    against the JAX `Trainer.fit` on the same batches: per-step loss and
    grad_norm, and the final parameters.

Tolerances are stated per test; the CUDA kernels on this path are held
against their plain versions on the card by ``chip_smoke.py``.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_lightning_tpu.core.callbacks import Callback as JaxCallback
from ray_lightning_tpu.core.data import DataLoader as JaxDataLoader
from ray_lightning_tpu.core.trainer import Trainer as JaxTrainer
from ray_lightning_tpu.models.llama import Llama as JaxLlama
from ray_lightning_tpu.models.llama import LlamaConfig as JaxConfig
from ray_lightning_tpu.models.llama import LlamaModule as JaxLlamaModule
from ray_lightning_tpu.ops.fused_ce import (
    fused_cross_entropy as jax_fused_ce,
)
from ray_lightning_tpu.ops.pallas.rmsnorm import rms_norm_pallas
from ray_lightning_tpu.parallel.strategy import SingleDevice as JaxSingle
from ray_lightning_tpu_torch.core.callbacks import Callback, EarlyStopping
from ray_lightning_tpu_torch.core.data import DataLoader, DataModule
from ray_lightning_tpu_torch.core.module import TpuModule
from ray_lightning_tpu_torch.core.trainer import Trainer
from ray_lightning_tpu_torch.models.llama import (
    Llama,
    LlamaConfig,
    LlamaModule,
    params_from_jax,
    warmup_cosine_decay,
)
from ray_lightning_tpu_torch.ops import dispatch
from ray_lightning_tpu_torch.ops.fused_ce import fused_cross_entropy
from ray_lightning_tpu_torch.ops.kernels.rmsnorm import rms_norm_kernel
from ray_lightning_tpu_torch.ops.norms import rms_norm
from ray_lightning_tpu_torch.parallel.strategy import SingleDevice

#: tiny config shared by both packages (head_dim 16, GQA 2:1)
TINY = dict(vocab_size=256, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
            hidden_dim=128, max_seq_len=64)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _configs(**kw):
    jcfg = JaxConfig(**TINY, dtype=jnp.float32, remat=False,
                     **{k: v for k, v in kw.items() if k != "remat"})
    pcfg = LlamaConfig(**TINY, dtype=torch.float32, **kw)
    return jcfg, pcfg


def _jax_params(jcfg, seed=1):
    params = JaxLlama(jcfg).init(jax.random.key(seed),
                                 jnp.zeros((1, 4), jnp.int32))["params"]
    return jax.tree.map(np.asarray, params)


def _tokens(n, s, seed=0, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, (n, s + 1)
                                                ).astype(np.int32)


# ---- RMSNorm gradient --------------------------------------------------------


@pytest.mark.parametrize("shape", [(2, 5, 64), (7, 128)])
def test_rms_norm_grads_match_pallas(shape):
    """dx, dw of the port's `rms_norm` (the Function's ported backward)
    against `jax.grad` of the Pallas kernel's custom vjp; 2e-5."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal(shape).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(shape[-1])).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)

    def f(x, w):
        return (rms_norm_pallas(x, w, 1e-5) * g).sum()

    jdx, jdw = jax.grad(f, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    tx, tw = _t(x).requires_grad_(True), _t(w).requires_grad_(True)
    y = rms_norm(tx, tw, 1e-5)
    assert y.grad_fn is not None
    dx, dw = torch.autograd.grad(y, (tx, tw), _t(g))
    np.testing.assert_allclose(dx.numpy(), jdx, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(dw.numpy(), jdw, rtol=2e-5, atol=2e-5)
    # the plain path under force_reference agrees (autograd through it)
    with dispatch.force_reference():
        y2 = rms_norm(tx, tw, 1e-5)
    dx2, dw2 = torch.autograd.grad(y2, (tx, tw), _t(g))
    np.testing.assert_allclose(dx2.numpy(), dx.numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(dw2.numpy(), dw.numpy(), rtol=1e-5, atol=1e-5)
    assert rms_norm_kernel.launches == 0


# ---- fused cross-entropy -----------------------------------------------------


@pytest.mark.parametrize("B,S,chunk,masked", [
    (2, 15, 8, False),   # 30 tokens: 4 chunks, the last ragged
    (3, 7, 4, True),     # 21 tokens, masked
    (2, 8, 1024, False),  # one chunk (chunk clamps to T)
])
def test_fused_ce_matches_jax(B, S, chunk, masked):
    """Loss and d(hidden), d(lm_head) against the JAX default path; the
    port's lm_head is the [V, D] transpose. 2e-5 (relative to the largest
    gradient for the gradients)."""
    rng = np.random.default_rng(1)
    D, V = 32, 97
    h = rng.standard_normal((B, S, D)).astype(np.float32)
    w = (0.2 * rng.standard_normal((D, V))).astype(np.float32)
    t = rng.integers(0, V, (B, S)).astype(np.int32)
    m = (rng.random((B, S)) > 0.3).astype(np.float32) if masked else None

    def f(h, w):
        return jax_fused_ce(h, w, jnp.asarray(t),
                            None if m is None else jnp.asarray(m),
                            chunk_tokens=chunk, compute_dtype=jnp.float32)

    jl, (jdh, jdw) = jax.value_and_grad(f, argnums=(0, 1))(
        jnp.asarray(h), jnp.asarray(w))
    th = _t(h).requires_grad_(True)
    tw = _t(w.T).requires_grad_(True)
    loss = fused_cross_entropy(th, tw, _t(t), None if m is None else _t(m),
                               chunk_tokens=chunk,
                               compute_dtype=torch.float32)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=2e-5)
    for got, want in ((th.grad.numpy(), jdh), (tw.grad.numpy().T, jdw)):
        scale = max(float(np.abs(want).max()), 1e-3)
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5 * scale)


def test_fused_ce_inline_backward_raises():
    h = torch.zeros(1, 2, 4)
    with pytest.raises(NotImplementedError, match="Queue 1 item 3"):
        fused_cross_entropy(h, torch.zeros(8, 4), torch.zeros(1, 2).long(),
                            inline_backward=True)


# ---- LlamaModule loss and gradients ----------------------------------------


def _grads_as_port(jgrads, pcfg):
    return params_from_jax(jax.tree.map(np.asarray, jgrads), pcfg,
                           dtype=torch.float32)


@pytest.mark.parametrize("fused,remat", [(True, False), (False, False),
                                         (True, True), (False, True)])
def test_llama_module_loss_and_grads_match_jax(fused, remat):
    """The loss and the gradient of every parameter, f32: loss at 1e-5,
    gradients at 2e-5 of each tensor's largest entry."""
    jcfg, pcfg = _configs(fused_ce=fused, ce_chunk_tokens=24, remat=remat)
    params = _jax_params(jcfg)
    toks = _tokens(2, 20)
    mask = (np.random.default_rng(3).random((2, 20)) > 0.2).astype(
        np.float32)

    jm = JaxLlamaModule(jcfg)
    jm.setup()
    batch = {"tokens": jnp.asarray(toks), "mask": jnp.asarray(mask)}

    def jloss(p):
        return jm._loss(p, *jm._split(batch))

    jl, jg = jax.value_and_grad(jloss)(jax.tree.map(jnp.asarray, params))

    pm = LlamaModule(pcfg)
    pm.device = torch.device("cpu")
    pm.setup()
    pm.model.load_state_dict(params_from_jax(params, pcfg,
                                             dtype=torch.float32))
    pm.params = dict(pm.model.named_parameters())
    assert all(p.dtype == torch.float32 and p.requires_grad
               for p in pm.params.values())
    loss = pm.training_step(pm.params, {"tokens": _t(toks),
                                        "mask": _t(mask)}, None)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    want = _grads_as_port(jg, pcfg)
    assert set(want) == set(pm.params)
    for name, p in pm.params.items():
        w = want[name].numpy()
        scale = max(float(np.abs(w).max()), 1e-6)
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=2e-5,
                                   atol=2e-5 * scale, err_msg=name)
    assert pm.pop_logged()["train_loss"].item() == loss.item()


def test_llama_remat_policies_and_inline_ce_raise():
    with pytest.raises(NotImplementedError, match="remat_policy"):
        Llama(LlamaConfig.tiny(remat=True, remat_policy="dots"),
              device="cpu")
    Llama(LlamaConfig.tiny(remat=False, remat_policy="dots"), device="cpu")
    with pytest.raises(ValueError, match="remat_policy"):
        LlamaConfig.tiny(remat_policy="everything")
    with pytest.raises(ValueError, match="fused CE"):
        LlamaConfig.tiny(ce_inline_bwd=True)
    with pytest.raises(NotImplementedError, match="mu_dtype"):
        LlamaModule(LlamaConfig.tiny(), mu_dtype=torch.bfloat16)


def test_schedule_matches_optax():
    """`warmup_cosine_decay` step for step against optax (the JAX
    module's schedule), including step 0 (learning rate 0) and past the
    end (flat at the end value); 1e-5, as optax evaluates in f32."""
    for warmup, total in ((1, 4), (2, 8), (100, 10000), (3, 5)):
        sched = optax.warmup_cosine_decay_schedule(
            0.0, 3e-4, warmup, max(total, 2), end_value=3e-5)
        for step in list(range(12)) + [total + 5]:
            np.testing.assert_allclose(
                warmup_cosine_decay(step, 0.0, 3e-4, warmup, max(total, 2),
                                    end_value=3e-5),
                float(sched(step)), rtol=1e-5, atol=1e-12)
    assert warmup_cosine_decay(0, 0.0, 3e-4, 2, 8, 3e-5) == 0.0


# ---- Trainer.fit against the JAX Trainer.fit --------------------------------


class _JaxRecorder(JaxCallback):
    def __init__(self):
        self.rows = []

    def on_train_batch_end(self, trainer, module, metrics, batch_idx):
        self.rows.append((float(metrics["loss"]),
                          float(metrics["grad_norm"])))


class _Recorder(Callback):
    def __init__(self):
        self.rows = []

    def on_train_batch_end(self, trainer, module, metrics, batch_idx):
        self.rows.append((float(metrics["loss"]),
                          float(metrics["grad_norm"])))


FIT_CASES = {
    # name: (fused_ce, remat, gradient_clip_val, accumulate_grad_batches)
    "clip_fused_remat": (True, True, 0.5, 1),
    "clip_materialized": (False, False, 0.5, 1),
    "accumulate": (True, False, None, 2),
}


@pytest.mark.parametrize("name", list(FIT_CASES))
def test_trainer_fit_matches_jax(name):
    """4 optimizer steps of the tiny Llama (warmup 1: the learning rate is
    0 at step 0 and nonzero after, so three real updates), lr 1e-2,
    weight decay 0.1, shuffled batches from the same seeded loader. The
    per-step loss and grad_norm agree to 2e-5, the final parameters to
    2e-5 of each tensor's largest entry; clipping is shown to bite."""
    fused, remat, clip, accum = FIT_CASES[name]
    jcfg, pcfg = _configs(fused_ce=fused, ce_chunk_tokens=16, remat=remat)
    params = _jax_params(jcfg, seed=2)
    toks = _tokens(16, 12, seed=4)
    common = dict(max_steps=4, log_every_n_steps=1, gradient_clip_val=clip,
                  accumulate_grad_batches=accum, enable_checkpointing=False,
                  enable_progress_bar=False, seed=0)
    bs = 2 * accum

    jrec = _JaxRecorder()
    jm = JaxLlamaModule(jcfg, lr=1e-2, warmup_steps=1, total_steps=4)
    jm.params = jax.tree.map(jnp.asarray, params)
    JaxTrainer(strategy=JaxSingle(), callbacks=[jrec], **common).fit(
        jm, JaxDataLoader({"tokens": toks}, batch_size=bs, shuffle=True,
                          seed=0))

    rec = _Recorder()
    pm = LlamaModule(pcfg, lr=1e-2, warmup_steps=1, total_steps=4)
    pm.params = params_from_jax(params, pcfg, dtype=torch.float32)
    trainer = Trainer(strategy=SingleDevice(device="cpu"), callbacks=[rec],
                      **common)
    trainer.fit(pm, DataLoader({"tokens": toks}, batch_size=bs,
                               shuffle=True, seed=0))

    assert trainer.global_step == 4 and len(rec.rows) == 4
    np.testing.assert_allclose(rec.rows, jrec.rows, rtol=2e-5, atol=2e-5)
    if clip:
        assert max(g for _, g in rec.rows) > clip  # the clip bites
    assert trainer.callback_metrics["loss"] == rec.rows[-1][0]
    assert "train_loss" in trainer.callback_metrics
    want = params_from_jax(jax.tree.map(np.asarray, jm.params), pcfg,
                           dtype=torch.float32)
    start = params_from_jax(params, pcfg, dtype=torch.float32)
    assert set(pm.params) == set(want)
    for k, p in pm.params.items():
        w = want[k].numpy()
        np.testing.assert_allclose(
            p.detach().numpy(), w, rtol=2e-5,
            atol=2e-5 * max(float(np.abs(w).max()), 1e-6), err_msg=k)
    # the weights moved (step 0's zero learning rate is not the only one)
    assert not torch.equal(pm.params["lm_head"].detach(), start["lm_head"])


# ---- the rest of the training surface ----------------------------------------


class _Quadratic(TpuModule):
    """A one-parameter module: loss (w - target)^2 per row."""

    def configure_model(self):
        return torch.nn.Linear(1, 1, bias=False)

    def configure_optimizers(self):
        return torch.optim.SGD(self.model.parameters(), lr=0.1)

    def training_step(self, params, batch, rng):
        assert isinstance(rng, torch.Generator)
        self.seen_dtype = batch["y"].dtype
        w = self.model.weight[0, 0]
        loss = ((w - batch["y"]) ** 2).mean()
        self.log("w", w)
        return loss

    def validation_step(self, params, batch):
        w = self.model.weight[0, 0]
        return {"val_loss": ((w - batch["y"]) ** 2).mean()}

    def predict_step(self, params, batch):
        return self.apply(params, batch["x"])


def test_trainer_surface_on_a_small_module():
    """fit with validation (epochs, val_check_interval, limits, early
    stopping), then validate and predict on the trained weights."""
    y = np.full((8,), 2.0, np.float32)
    x = np.ones((8, 1), np.float32)
    data = {"x": x, "y": y}
    stop = EarlyStopping(monitor="val_loss", patience=1, min_delta=10.0)
    trainer = Trainer(strategy=SingleDevice(device="cpu"), max_epochs=5,
                      limit_train_batches=3, limit_val_batches=1,
                      val_check_interval=2, log_every_n_steps=2,
                      callbacks=[stop], enable_checkpointing=False, seed=0)
    m = _Quadratic()
    out = trainer.fit(m, DataLoader(data, batch_size=2),
                      DataLoader(data, batch_size=4))
    # epoch 0 validates at step 2 and at its end (step 3); the second
    # reading misses min_delta and patience 1 stops the fit there
    assert trainer.global_step == 3 and trainer.should_stop
    assert set(out) >= {"loss", "grad_norm", "w", "val_loss"}
    assert isinstance(m.params["weight"], torch.nn.Parameter)
    w_trained = m.params["weight"].item()
    np.testing.assert_allclose(trainer.validate(
        m, DataLoader(data, batch_size=4))["val_loss"],
        (w_trained - 2.0) ** 2, rtol=1e-6)
    preds = trainer.predict(m, DataLoader(data, batch_size=4))
    assert len(preds) == 2 and preds[0].shape == (4, 1)
    np.testing.assert_allclose(preds[0], w_trained, rtol=1e-6)


@pytest.mark.parametrize("shards", [(1, 0), (2, 1)])
def test_datamodule_and_loader_order_match_jax(shards):
    """The port's DataLoader yields the JAX loader's batches, shuffled
    per epoch and sharded the same way; a DataModule feeds fit, and
    precision="bf16" casts its float inputs."""
    n_shards, index = shards
    data = {"a": np.arange(10), "b": np.arange(10) * 2}
    for epoch in (0, 1):
        kw = dict(batch_size=2, shuffle=True, seed=5, num_shards=n_shards,
                  shard_index=index)
        jl, pl = JaxDataLoader(data, **kw), DataLoader(data, **kw)
        jl.set_epoch(epoch)
        pl.set_epoch(epoch)
        got, want = list(pl), list(jl)
        assert len(got) == len(pl) == len(want) == 5 // n_shards
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g["a"], w["a"])
            np.testing.assert_array_equal(g["b"], w["b"])

    class DM(DataModule):
        def train_dataloader(self):
            return DataLoader({"x": np.ones((4, 1), np.float32),
                               "y": np.zeros(4, np.float32)}, batch_size=2)

    t = Trainer(strategy=SingleDevice(device="cpu"), max_epochs=1,
                enable_checkpointing=False, enable_progress_bar=False,
                precision="bf16" if n_shards > 1 else "f32")
    m = _Quadratic()
    t.fit(m, datamodule=DM())
    assert t.global_step == 2
    assert m.seen_dtype == (torch.bfloat16 if n_shards > 1
                            else torch.float32)


@pytest.mark.parametrize("knob,value", [
    ("guard", True), ("telemetry", True), ("profile", True),
    ("profiler_dir", "prof"), ("compile_cache_dir", "cache"),
    ("enable_checkpointing", True),
])
def test_unported_trainer_knobs_raise(knob, value):
    kw = dict(enable_checkpointing=False)
    kw[knob] = value
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Trainer(**kw)


def test_unported_entry_points_raise():
    t = Trainer(strategy=SingleDevice(device="cpu"),
                enable_checkpointing=False)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        t.fit(_Quadratic(), [{"y": np.zeros(2, np.float32)}],
              ckpt_path="ckpt")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        t.save_checkpoint("ckpt")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        _Quadratic.load_from_checkpoint("ckpt")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        DataLoader({"a": np.zeros(2)}, prefetch=True)
    # the default device is the card: without one, fit raises
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Trainer(enable_checkpointing=False).fit(
                _Quadratic(), [{"y": np.zeros(2, np.float32)}])


def test_serving_model_keeps_bf16_weights_without_grads():
    """`params_from_jax` defaults to the serving dtype; the serving model's
    weights carry no gradient; the trainer's are f32 with gradients."""
    jcfg, _ = _configs()
    params = _jax_params(jcfg)
    cfg = LlamaConfig(**TINY)
    sd = params_from_jax(params, cfg)
    assert sd["layers.0.wqkv"].dtype == torch.bfloat16
    assert sd["layers.0.attn_norm"].dtype == torch.float32
    model = Llama(cfg, device="cpu")
    model.load_state_dict(sd)
    assert not any(p.requires_grad for p in model.parameters())
    m = LlamaModule(dataclasses.replace(cfg, dtype=torch.float32))
    m.device = torch.device("cpu")
    m.setup()
    assert all(p.requires_grad and p.dtype == torch.float32
               for p in m.model.parameters())


def test_checkpoint_recompute_keeps_the_dispatch_policy():
    """A block checkpointed under `force_reference` is recomputed under it
    even where the recomputation runs on another thread (autograd's
    device thread, for CUDA tensors), and the recomputed block saves what
    the forward saved."""
    import threading

    with dispatch.force_reference():
        _, recompute = dispatch.checkpoint_context_fn()
    seen = []

    def in_thread():
        seen.append(dispatch.reference_forced())
        with recompute:
            seen.append(dispatch.reference_forced())
        seen.append(dispatch.reference_forced())

    th = threading.Thread(target=in_thread)
    th.start()
    th.join()
    assert seen == [False, True, False]

    cfg = LlamaConfig(**TINY, dtype=torch.float32, remat=True)
    model = Llama(cfg, device="cpu", param_dtype=torch.float32)
    from ray_lightning_tpu_torch.models.llama import init_params_

    gen = torch.Generator()
    gen.manual_seed(0)
    init_params_(model, gen).requires_grad_(True)
    toks = _t(_tokens(2, 16))
    grads = []
    for forced in (False, True):
        model.zero_grad()
        if forced:
            with dispatch.force_reference():
                loss = model(toks[:, :-1]).logsumexp(-1).mean()
        else:
            loss = model(toks[:, :-1]).logsumexp(-1).mean()
        loss.backward()
        grads.append(model.layers[0].wqkv.grad.clone())
    np.testing.assert_allclose(grads[0].numpy(), grads[1].numpy(),
                               rtol=1e-5, atol=1e-6)
