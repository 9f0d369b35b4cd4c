"""The port's BERT against the JAX package's, on the CPU, f32.

Weights come from the JAX model's own `init` (both `scan_layers`
layouts) and cross through `params_from_jax`; the same numpy tokens go
through both:

  * encoder outputs and classifier logits within 1e-4 of JAX's, with
    flash on (JAX's Pallas kernel in interpret mode under `force_pallas`
    at head dim 64; the port's flash kernels' plain versions) and off,
    with and without a padding mask; a masked batch takes the dense path
    in both packages and launches no flash kernel;
  * the twin of tests/test_models.py::test_bert_padding_mask_matters;
  * a 3-step `Trainer.fit` (optax adamw under warmup-cosine against
    torch's fused AdamW under `DeviceLambdaLR`) within 2e-5 of the JAX
    fit's loss and grad_norm a step, for both layouts;
  * dropout drawn from the step's generator; `DataParallel` and `FSDP`
    in one process bitwise `SingleDevice`; the tensor axis refused
    naming its ROADMAP item; `bert_param_specs` against the JAX table.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from ray_lightning_tpu.core.callbacks import Callback as JaxCallback
from ray_lightning_tpu.core.data import DataLoader as JaxDataLoader
from ray_lightning_tpu.core.trainer import Trainer as JaxTrainer
from ray_lightning_tpu.models import bert as jbert
from ray_lightning_tpu.ops.attention import flash_uses_pallas
from ray_lightning_tpu.ops.dispatch import force_pallas
from ray_lightning_tpu.parallel.strategy import SingleDevice as JaxSingle
from ray_lightning_tpu_torch.core.callbacks import Callback
from ray_lightning_tpu_torch.core.data import DataLoader
from ray_lightning_tpu_torch.core.trainer import Trainer
from ray_lightning_tpu_torch.models import bert
from ray_lightning_tpu_torch.ops.kernels import flash
from ray_lightning_tpu_torch.parallel.strategy import SingleDevice
from tests import torch_jobs

TOL = 1e-4
#: head dim 64, which the JAX Pallas flash kernel (and the Hopper gate)
#: takes; BertConfig.tiny's 16 would send JAX to its reference
FLASH64 = dict(dim=128, n_heads=2)


def _cfgs(scan_layers=True, **kw):
    kw = {"dropout": 0.0, **FLASH64, **kw}
    return (jbert.BertConfig.tiny(dtype=jnp.float32,
                                  scan_layers=scan_layers, **kw),
            bert.BertConfig.tiny(dtype=torch.float32, **kw))


def synthetic_text(n=64, num_classes=2, seq=16, vocab=256, seed=0):
    """tests/test_models.py's set: the label sets the leading token."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, num_classes, n).astype(np.int32)
    ids = rng.integers(4, vocab, (n, seq)).astype(np.int32)
    ids[:, 0] = np.where(y == 0, 1, 2)
    mask = np.ones((n, seq), np.int32)
    return {"input_ids": ids, "attention_mask": mask, "labels": y}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("scan_layers", [True, False])
@pytest.mark.parametrize("use_flash", [True, False])
@pytest.mark.parametrize("masked", [False, True])
def test_classifier_and_encoder_match_jax(scan_layers, use_flash, masked):
    jc, pc = _cfgs(scan_layers, use_flash=use_flash)
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 256, (2, 16)).astype(np.int32)
    types = rng.integers(0, 2, (2, 16)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[1, 10:] = 0
    m = mask if masked else None
    jm = jbert.BertForSequenceClassification(jc, 3)
    params = jm.init(jax.random.key(0), ids)["params"]
    with force_pallas():
        # the JAX layer runs the Pallas kernel where flash is on and no
        # mask is given
        assert flash_uses_pallas((2, 16, 2, 64), (2, 16, 2, 64), None) \
            is True
        want = np.asarray(jm.apply({"params": params}, ids, m, types,
                                   deterministic=True))
        want_enc = np.asarray(jbert.BertEncoder(jc).apply(
            {"params": params["encoder"]}, ids, m, types,
            deterministic=True))
    params = jax.tree.map(np.asarray, params)
    pm = bert.BertForSequenceClassification(pc, 3)
    sd = bert.params_from_jax(params)
    assert set(sd) == set(pm.state_dict())
    pm.load_state_dict(sd)
    enc = bert.BertEncoder(pc)
    enc.load_state_dict(bert.params_from_jax(params["encoder"]))
    with torch.no_grad():
        got = pm(_t(ids), None if m is None else _t(m), _t(types)).numpy()
        got_enc = enc(_t(ids), None if m is None else _t(m),
                      _t(types)).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL,
                               atol=TOL * np.abs(want).max())
    rows = slice(None) if not masked else (0, slice(None))
    np.testing.assert_allclose(got_enc[rows], want_enc[rows], rtol=TOL,
                               atol=TOL * np.abs(want_enc).max())
    if masked:  # the unmasked rows of the padded sequence
        np.testing.assert_allclose(got_enc[1, :10], want_enc[1, :10],
                                   rtol=TOL,
                                   atol=TOL * np.abs(want_enc).max())


def test_attention_path_by_mask(monkeypatch):
    """Without a mask each layer goes through the flash kernels' wrapper
    (its plain version here); with one, through the dense reference and
    no flash wrapper at all, as in JAX."""
    _, pc = _cfgs()
    calls = []
    real = flash.flash_attention_kernel

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(bert, "flash_attention",
                        lambda q, k, v, causal, mask: (
                            spy(q, k, v, causal=causal) if mask is None
                            else bert.dot_product_attention(
                                q, k, v, causal=causal, mask=mask)))
    pm = bert.BertForSequenceClassification(pc, 2)
    bert.init_params_(pm, torch.Generator().manual_seed(0))
    ids = _t(np.ones((2, 16), np.int32))
    pm(ids)
    assert len(calls) == pc.n_layers
    pm(ids, torch.ones(2, 16, dtype=torch.int32))
    assert len(calls) == pc.n_layers


def test_bert_padding_mask_matters():
    """Masked positions must not influence the logits (twin of the JAX
    test): scrambled and masked tails give the same logits; unmasked,
    they change them."""
    pc = bert.BertConfig.tiny(use_flash=False, dropout=0.0,
                              dtype=torch.float32)
    module = bert.BertClassifierModule(pc)
    module.device = torch.device("cpu")
    module.setup()
    module.params = module.init_params(torch.Generator().manual_seed(0))
    batch = {k: _t(v) for k, v in synthetic_text(n=4, seq=8).items()}
    with torch.no_grad():
        base = module._forward(module.params, batch).numpy()
        batch2 = dict(batch)
        ids = batch["input_ids"].clone()
        ids[:, 4:] = 7
        mask = batch["attention_mask"].clone()
        mask[:, 4:] = 0
        batch2["input_ids"], batch2["attention_mask"] = ids, mask
        batch3 = dict(batch2, input_ids=batch["input_ids"])
        masked = module._forward(module.params, batch2).numpy()
        np.testing.assert_allclose(
            module._forward(module.params, batch3).numpy(), masked,
            atol=1e-5)
        unmasked = module._forward(module.params, dict(
            batch, input_ids=ids)).numpy()
    assert not np.allclose(base, unmasked, atol=1e-3)


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


COMMON = dict(max_steps=3, log_every_n_steps=1, enable_checkpointing=False,
              enable_progress_bar=False, seed=0)


@pytest.mark.parametrize("scan_layers,masked", [(True, False),
                                                (False, True)])
def test_fit_matches_jax(scan_layers, masked):
    """3 steps (warmup 1: step 0 at lr 0, then two real updates; weight
    decay on every parameter) from the JAX init in either layout: the
    per-step loss and grad_norm within 2e-5 of the JAX fit. Unmasked
    batches run the port's flash path (the kernels' plain versions)
    against JAX's reference attention; masked ones the dense path in
    both."""
    jc, pc = _cfgs(scan_layers)
    data = synthetic_text(n=24, seq=16)
    if not masked:
        del data["attention_mask"]
    kw = dict(num_classes=2, lr=1e-3, weight_decay=0.01, warmup_steps=1,
              total_steps=3)
    jm = jbert.BertClassifierModule(jc, **kw)
    jm.setup()
    params = jax.tree.map(np.asarray, jm.init_params(
        jax.random.key(1), {k: v[:2] for k, v in data.items()}))
    jm.params = jax.tree.map(jnp.asarray, params)  # donated by the fit
    jrec = _JaxRows()
    JaxTrainer(strategy=JaxSingle(), callbacks=[jrec], **COMMON).fit(
        jm, JaxDataLoader(data, batch_size=8, shuffle=True, seed=0))

    pm = bert.BertClassifierModule(pc, **kw)
    pm.params = bert.params_from_jax(params)
    rec = _PortRows()
    Trainer(strategy=SingleDevice(device="cpu"), callbacks=[rec],
            **COMMON).fit(pm, DataLoader(data, batch_size=8, shuffle=True,
                                         seed=0))
    assert len(rec.rows) == len(jrec.rows) == 3
    np.testing.assert_allclose(rec.rows, jrec.rows, rtol=2e-5, atol=2e-5)
    assert rec.rows[2][0] != rec.rows[1][0]


def _port_fit(strategy, dropout=0.0, seed=0):
    _, pc = _cfgs(dropout=dropout)
    data = synthetic_text(n=24, seq=16)
    del data["attention_mask"]
    module = bert.BertClassifierModule(pc, lr=1e-3, warmup_steps=1,
                                       total_steps=3)
    rec = _PortRows()
    trainer = Trainer(strategy=strategy, callbacks=[rec],
                      **{**COMMON, "seed": seed})
    try:
        trainer.fit(module, DataLoader(data, batch_size=8))
        params = {k: v.detach().clone() for k, v in
                  trainer.strategy.unwrap(module.model).state_dict().items()}
    finally:
        strategy.teardown()
    return rec.rows, params


@pytest.mark.parametrize("name", ["ddp", "fsdp"])
def test_group_strategies_in_process_match_single_device(name):
    """`DataParallel` / `FSDP` (each layer its own unit) in one process,
    a one-rank gloo group: bitwise `SingleDevice`'s fit."""
    ref_rows, ref = _port_fit(SingleDevice(device="cpu"))
    rows, params = _port_fit(torch_jobs.make_strategy(name))
    assert not dist.is_initialized()
    assert rows == ref_rows and len(rows) == 3
    for k, v in ref.items():
        got = params[k]
        got = got.full_tensor() if hasattr(got, "full_tensor") else got
        assert torch.equal(got, v), k


def test_dropout_draws_from_the_step_generator():
    """With dropout the training forward depends on the generator only:
    the same seed gives the same fit, another seed another one, and the
    evaluation forward none at all; about 1 - rate of values are kept."""
    a, _ = _port_fit(SingleDevice(device="cpu"), dropout=0.5, seed=0)
    b, _ = _port_fit(SingleDevice(device="cpu"), dropout=0.5, seed=0)
    c, _ = _port_fit(SingleDevice(device="cpu"), dropout=0.5, seed=1)
    assert a == b and a != c
    x = torch.ones(4000)
    g = torch.Generator().manual_seed(0)
    y = bert.dropout(x, 0.25, g)
    assert torch.allclose(y[y != 0], torch.tensor(1 / 0.75))
    assert abs(float((y > 0).float().mean()) - 0.75) < 0.03
    assert bert.dropout(x, 0.25, None) is x


def test_tensor_axis_refused_and_specs_match_jax():
    """The tensor axis raises naming its ROADMAP item (the fused wqkv has
    no head-aligned permutation yet); the spec table is the JAX one in
    the port's names and ``[out, in]`` layout."""
    from ray_lightning_tpu_torch.parallel.strategy import ShardedMesh

    _, pc = _cfgs()
    module = bert.BertClassifierModule(pc)
    with pytest.raises(NotImplementedError, match="item 16"):
        module.check_tensor_parallel(2)
    mesh = ShardedMesh(tensor=2, device="cpu")
    mesh.shape_only(2, module)
    with pytest.raises(NotImplementedError, match="item 16"):
        mesh.bind_module(module)
    jc = jbert.BertConfig.tiny(scan_layers=False, **FLASH64)
    jspecs = jbert.bert_param_specs(jc)
    specs = bert.bert_param_specs(pc)
    for path, spec in jspecs.items():
        parts = path.split("/")
        if parts[1].startswith("layer_"):
            name = f"encoder.layers.{parts[1][6:]}.{parts[2]}." + (
                "bias" if parts[3] == "bias" else "weight")
            want = tuple(spec)[::-1] if parts[3] == "kernel" else tuple(spec)
        else:
            name = f"encoder.{parts[1]}" + (
                "" if parts[2] == "embedding" else
                ".weight" if parts[2] == "scale" else ".bias")
            want = tuple(spec)
        assert tuple(specs[name]) == want, name
    assert len(specs) == len(jspecs)
