"""The port's trainguard (`ray_lightning_tpu_torch.resilience.guard`)
held against the JAX package's, in one process on the CPU.

Tier 1: `apply_guard` gives the JAX decisions and counters on shared
loss and grad_norm sequences; an injected NaN batch is skipped with the
final params BITWISE equal to a clean run without that batch (fused SGD,
fused Adam, and the Llama module's fused AdamW under `DeviceLambdaLR`);
guard on with no anomaly is bitwise guard off; a guarded step makes no
host read more than an unguarded one; the guarded tiny-Llama fit agrees
with the JAX guarded fit under the same fault plan (2e-5, counters
equal). Tier 2: escalation and its marker (the JAX payload), the blessed
stamp, retention floors, rollback skips. Tier 3: the digest equals the
JAX digest of the same bytes, and the probe's grouping and verdicts are
the JAX package's.
"""
from __future__ import annotations

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_lightning_tpu.resilience import guard as jguard
from ray_lightning_tpu.resilience.faults import Fault as JaxFault
from ray_lightning_tpu.resilience.faults import FaultInjector as JaxInjector
from ray_lightning_tpu.resilience.policy import RetryPolicy as JaxRetry
from ray_lightning_tpu.resilience.policy import (
    classify_failure as jax_classify,
)
from ray_lightning_tpu_torch.checkpoint import latest_checkpoint
from ray_lightning_tpu_torch.checkpoint.io import save_checkpoint
from ray_lightning_tpu_torch.core.callbacks import ModelCheckpoint
from ray_lightning_tpu_torch.core.data import DataLoader
from ray_lightning_tpu_torch.core.module import TpuModule
from ray_lightning_tpu_torch.core.schedule import DeviceLambdaLR
from ray_lightning_tpu_torch.core.trainer import Trainer
from ray_lightning_tpu_torch.models.mlp import MNISTClassifier
from ray_lightning_tpu_torch.parallel.strategy import SingleDevice
from ray_lightning_tpu_torch.resilience import guard as pguard
from ray_lightning_tpu_torch.resilience.faults import Fault, FaultInjector
from ray_lightning_tpu_torch.resilience.guard import (
    GuardCallback,
    GuardConfig,
    SDCDetectedError,
    TrainingAnomalyError,
    read_rollback_marker,
)
from ray_lightning_tpu_torch.resilience.policy import (
    FailureKind,
    RetryPolicy,
    classify_failure,
)
from ray_lightning_tpu_torch.runtime.group import WorkerError

# ------------------------------------------------------------- helpers


class BoringModel(TpuModule):
    """Linear(32, 2) under fused SGD (the JAX tests' BoringModel, which
    runs optax.sgd)."""

    def __init__(self, lr: float = 1e-2):
        super().__init__()
        self.save_hyperparameters(lr=lr)
        self.lr = lr

    def configure_model(self):
        return torch.nn.Linear(32, 2, device=self.device)

    def configure_optimizers(self):
        return torch.optim.SGD(self.model.parameters(), lr=self.lr,
                               fused=True)

    def _loss(self, params, batch):
        logits = self.apply(params, batch["x"])
        return torch.nn.functional.cross_entropy(
            logits.float(), batch["y"].long()), logits

    def training_step(self, params, batch, rng):
        loss, _ = self._loss(params, batch)
        self.log("train_loss", loss)
        return loss

    def validation_step(self, params, batch):
        loss, logits = self._loss(params, batch)
        return {"val_loss": loss,
                "val_acc": (logits.argmax(-1) == batch["y"]).float().mean()}


def random_dataset(n: int = 256, dim: int = 32, seed: int = 0):
    """The JAX tests' `random_dataset`."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, dim), dtype=np.float32)
    w = rng.standard_normal((dim, 2)).astype(np.float32)
    return {"x": x, "y": (x @ w).argmax(-1).astype(np.int32)}


class SkipLoader:
    """Drops selected (epoch, batch) pairs: the "clean run trained
    without that batch" reference."""

    def __init__(self, loader, skip):
        self.loader, self.skip, self._epoch = loader, set(skip), 0

    def set_epoch(self, epoch):
        self._epoch = epoch
        self.loader.set_epoch(epoch)

    def __iter__(self):
        for i, b in enumerate(iter(self.loader)):
            if (self._epoch, i) not in self.skip:
                yield b


def _loader(batch_size=32, seed=5):
    return DataLoader(random_dataset(), batch_size=batch_size, shuffle=True,
                      seed=seed)


def _trainer(tmp_path, guard=None, callbacks=None, **kw):
    kw.setdefault("max_epochs", 2)
    kw.setdefault("log_every_n_steps", 1)
    return Trainer(strategy=SingleDevice(device="cpu"),
                   enable_checkpointing=False, enable_progress_bar=False,
                   seed=7, default_root_dir=str(tmp_path), guard=guard,
                   callbacks=callbacks, **kw)


def _params(module):
    return {k: v.detach().clone() for k, v in module.params.items()}


def _assert_same(a, b):
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def _tiny_llama(lr=1e-2, warmup_steps=1, total_steps=8):
    from tests.torch_jobs import llama_module

    return llama_module(None, lr=lr, warmup_steps=warmup_steps,
                        total_steps=total_steps, remat=False)


def _llama_loader(n=16, seed=4, mask=True):
    from tests.torch_jobs import tokens

    data = {"tokens": tokens(n, 12, seed=seed)}
    if mask:
        data["mask"] = np.ones((n, 12), np.float32)
    return DataLoader(data, batch_size=2, shuffle=True, seed=0)


#: the three optimizers the built-in and test modules use, each one the
#: guard must hold back: fused SGD, fused Adam (MNISTClassifier), fused
#: AdamW with DeviceLambdaLR (LlamaModule)
MODULES = {
    "sgd": (BoringModel, _loader),
    "adam": (lambda: MNISTClassifier(lr=1e-2, layer_1=16, layer_2=16,
                                     in_features=32), _loader),
    "adamw_schedule": (_tiny_llama, _llama_loader),
}


# ------------------------------------------------------ tier 1: apply_guard

#: (loss, grad_norm) sequences: warmup, NaN loss, inf grad norm, spikes
SEQUENCES = {
    "nan_after_warmup": [(2.0, 1.0), (1.9, 1.0), (1.8, 1.0),
                         (float("nan"), 1.0), (1.7, 1.0), (1.6, 1.0)],
    "spike": [(2.0, 1.0), (1.9, 1.0), (1.8, 1.0), (1.7, 1.0), (90.0, 1.0),
              (1.6, 1.0), (200.0, 1.0), (1.5, 1.0)],
    "spike_in_warmup_passes": [(2.0, 1.0), (90.0, 1.0), (1.0, 1.0),
                               (1.0, 1.0)],
    "inf_grad_streak": [(1.0, float("inf")), (1.0, float("nan")),
                        (1.0, 2.0), (float("inf"), 1.0), (0.5, 1.0)],
}


@pytest.mark.parametrize("name", list(SEQUENCES))
def test_apply_guard_matches_jax(name):
    """Step by step, the port's decision and all five counters equal
    the JAX `apply_guard`'s on the same inputs (the EMA to f32
    rounding)."""
    cfg_kw = dict(warmup_steps=3, spike_factor=10.0, spike_margin=1.0)
    jcfg, pcfg = jguard.GuardConfig(**cfg_kw), GuardConfig(**cfg_kw)
    jg, pg = jguard.init_guard_state(), pguard.init_guard_state()
    jstep, pstep = jnp.zeros((), jnp.int32), torch.zeros((), dtype=torch.int32)
    zero = jnp.zeros(())
    for loss, gn in SEQUENCES[name]:
        _, _, jstep, jg, jm = jguard.apply_guard(
            jcfg, jg, jstep, jnp.float32(loss), jnp.float32(gn), zero, zero,
            zero, zero)
        bad, pstep, pg, pm = pguard.apply_guard(
            pcfg, pg, pstep, torch.tensor(loss), torch.tensor(gn))
        assert bool(bad) == bool(jm["guard_anomaly"])
        assert int(pstep) == int(jstep)
        for k in ("guard_anomaly", "guard_skipped_steps", "guard_streak",
                  "guard_last_anomaly"):
            assert int(pm[k]) == int(jm[k]), k
        for f in ("seen", "skipped", "streak", "last_anomaly"):
            assert int(getattr(pg, f)) == int(getattr(jg, f)), f
        np.testing.assert_allclose(float(pg.ema), float(jg.ema), rtol=1e-6)


# --------------------------------------------------- tier 1: the skip


@pytest.mark.parametrize("name", list(MODULES))
def test_nan_skip_bitwise_equals_clean_minus_batch(tmp_path, name):
    """nan_loss at step 3 is skipped on the device and the final params
    are BITWISE those of a clean run without that batch: the skipped
    update left the optimizer's state, its step counts and the
    schedule's position as they were."""
    make, loader = MODULES[name]
    clean = make()
    _trainer(tmp_path / "a", guard=GuardConfig(warmup_steps=2)).fit(
        clean, SkipLoader(loader(), {(0, 2)}))
    hurt = make()
    t = _trainer(tmp_path / "b", guard=GuardConfig(warmup_steps=2),
                 callbacks=[FaultInjector([Fault("nan_loss", None, 3, {})])])
    t.fit(hurt, loader())
    assert t.callback_metrics["guard_skipped_steps"] == 1
    assert t.callback_metrics["guard_last_anomaly"] == 2  # update index
    assert int(t.state.updates) == t.global_step - 1
    _assert_same(_params(clean), _params(hurt))


@pytest.mark.parametrize("name", list(MODULES))
def test_guard_disabled_changes_nothing(tmp_path, name):
    """Guard on with no anomaly trains bitwise as guard off, and the
    counters ride the metrics."""
    make, loader = MODULES[name]
    a, b = make(), make()
    _trainer(tmp_path / "a").fit(a, loader())
    t = _trainer(tmp_path / "b", guard=GuardConfig())
    t.fit(b, loader())
    assert t.callback_metrics["guard_skipped_steps"] == 0
    _assert_same(_params(a), _params(b))


def test_grad_blowup_is_skipped_and_training_recovers(tmp_path):
    t = _trainer(tmp_path, guard=GuardConfig(warmup_steps=2), callbacks=[
        FaultInjector([Fault("grad_blowup", None, 4, {"scale": "1e18"})])])
    t.fit(BoringModel(), _loader())
    assert t.callback_metrics["guard_skipped_steps"] >= 1
    assert np.isfinite(t.callback_metrics["loss"])
    assert t.callback_metrics["guard_streak"] == 0


class _HostReads:
    """Counts the Tensor methods that read a value on the host."""

    NAMES = ("item", "tolist", "__bool__", "__float__", "__int__")

    def __init__(self, monkeypatch):
        self.count = 0
        self.active = False
        for name in self.NAMES:
            orig = getattr(torch.Tensor, name)

            def wrapped(t, *a, _orig=orig, **k):
                if self.active:
                    self.count += 1
                return _orig(t, *a, **k)

            monkeypatch.setattr(torch.Tensor, name, wrapped)


def _count_host_reads(tmp_path, monkeypatch, make, loader, guard):
    """Host reads in the training loop outside the trainer's metric
    fetches (``log_every_n_steps`` past the run: one fetch, at the end)."""
    reads = _HostReads(monkeypatch)
    t = _trainer(tmp_path, guard=guard, log_every_n_steps=1000)
    run_epoch, fetch = t._run_train_epoch, t._host_metrics

    def counted_epoch(*a, **k):
        reads.active = True
        try:
            return run_epoch(*a, **k)
        finally:
            reads.active = False

    def uncounted_fetch(*a, **k):
        was, reads.active = reads.active, False
        try:
            return fetch(*a, **k)
        finally:
            reads.active = was

    t._run_train_epoch, t._host_metrics = counted_epoch, uncounted_fetch
    t.fit(make(), loader())
    return reads.count, t


@pytest.mark.parametrize("name", list(MODULES))
def test_guard_step_adds_no_host_syncs(tmp_path, monkeypatch, name):
    """Requirement (i): the decision stays on the device. Between the
    metric fetches a guarded fit calls no more of item / tolist / bool /
    float / int on a tensor than the unguarded one, and the counters
    still arrive with the fetch."""
    make, loader = MODULES[name]
    plain, _ = _count_host_reads(tmp_path / "a", monkeypatch, make, loader,
                                 None)
    guarded, t = _count_host_reads(tmp_path / "b", monkeypatch, make,
                                   loader, GuardConfig())
    assert guarded <= plain, (guarded, plain)
    assert "guard_skipped_steps" in t.callback_metrics
    # the instrument sees a host read where there is one
    reads = _HostReads(monkeypatch)
    reads.active = True
    float(torch.ones(()))
    bool(torch.ones(()))
    assert reads.count == 2


def test_guarded_llama_fit_matches_jax(tmp_path):
    """The tiny Llama under the same nan_loss plan in both packages
    (warmup 1, AdamW, warmup-cosine): per-step loss and grad_norm (NaN
    at the poisoned step in both) and the final weights agree to 2e-5,
    and every guard counter is equal."""
    from ray_lightning_tpu import DataLoader as JaxDataLoader
    from ray_lightning_tpu import SingleDevice as JaxSingle
    from ray_lightning_tpu import Trainer as JaxTrainer
    from ray_lightning_tpu.core.callbacks import Callback as JaxCallback
    from ray_lightning_tpu.models.llama import LlamaConfig as JaxConfig
    from ray_lightning_tpu.models.llama import Llama as JaxLlama
    from ray_lightning_tpu.models.llama import LlamaModule as JaxLlamaModule
    from ray_lightning_tpu_torch.models.llama import params_from_jax
    from tests.torch_jobs import TINY, StepRecorder, tokens

    jcfg = JaxConfig(**TINY, dtype=jnp.float32, remat=False)
    params = jax.tree.map(np.asarray, JaxLlama(jcfg).init(
        jax.random.key(2), jnp.zeros((1, 4), jnp.int32))["params"])
    data = {"tokens": tokens(16, 12, seed=4).astype(np.int32),
            "mask": np.ones((16, 12), np.float32)}
    common = dict(max_steps=6, log_every_n_steps=1,
                  enable_checkpointing=False, enable_progress_bar=False,
                  seed=0)

    class JaxRows(JaxCallback):
        def __init__(self):
            self.rows = []

        def on_train_batch_end(self, trainer, module, metrics, batch_idx):
            self.rows.append((float(metrics["loss"]),
                              float(metrics["grad_norm"])))

    jrec = JaxRows()
    jm = JaxLlamaModule(jcfg, lr=1e-2, warmup_steps=1, total_steps=6)
    jm.params = jax.tree.map(jnp.asarray, params)
    jt = JaxTrainer(strategy=JaxSingle(), guard=jguard.GuardConfig(
        warmup_steps=2), default_root_dir=str(tmp_path / "j"),
        callbacks=[JaxInjector([JaxFault("nan_loss", None, 3, {})]), jrec],
        **common)
    jt.fit(jm, JaxDataLoader(data, batch_size=2, shuffle=True, seed=0))

    rec = StepRecorder()
    pm = _tiny_llama(total_steps=6)
    pcfg = pm.cfg
    pm.params = params_from_jax(params, pcfg, dtype=torch.float32)
    pt = Trainer(strategy=SingleDevice(device="cpu"),
                 guard=GuardConfig(warmup_steps=2),
                 default_root_dir=str(tmp_path / "p"),
                 callbacks=[FaultInjector([Fault("nan_loss", None, 3, {})]),
                            rec], **common)
    pt.fit(pm, DataLoader(data, batch_size=2, shuffle=True, seed=0))

    assert np.isnan(rec.rows[2][0]) and np.isnan(jrec.rows[2][0])
    np.testing.assert_allclose(rec.rows, jrec.rows, rtol=2e-5, atol=2e-5)
    for k in ("guard_skipped_steps", "guard_streak", "guard_last_anomaly",
              "guard_anomaly"):
        assert pt.callback_metrics[k] == float(jt.callback_metrics[k]), k
    np.testing.assert_allclose(pt.callback_metrics["guard_loss_ema"],
                               float(jt.callback_metrics["guard_loss_ema"]),
                               rtol=2e-5)
    want = params_from_jax(jax.tree.map(np.asarray, jm.params), pcfg,
                           dtype=torch.float32)
    for k, p in pm.params.items():
        w = want[k].numpy()
        np.testing.assert_allclose(
            p.detach().numpy(), w, rtol=2e-5,
            atol=2e-5 * max(float(np.abs(w).max()), 1e-6), err_msg=k)


# ------------------------------------- the optimizers the guard can hold


class _LambdaModel(BoringModel):
    def configure_optimizers(self):
        opt = torch.optim.SGD(self.model.parameters(), lr=self.lr,
                              fused=True)
        return opt, torch.optim.lr_scheduler.LambdaLR(opt, lambda s: 1.0)


class _PlainAdam(BoringModel):
    def configure_optimizers(self):
        return torch.optim.Adam(self.model.parameters(), lr=self.lr)


@pytest.mark.parametrize("model,match", [
    (_PlainAdam, "fused optimizer"), (_LambdaModel, "DeviceLambdaLR")])
def test_unguardable_optimizer_raises(tmp_path, model, match):
    """A user optimizer or schedule whose state the skip cannot hold
    back raises, naming why, instead of degrading silently."""
    with pytest.raises(ValueError, match=match):
        _trainer(tmp_path, guard=True).fit(model(), _loader())
    # the same module trains without the guard
    _trainer(tmp_path, max_steps=1).fit(model(), _loader())


def test_device_lambda_lr_matches_lambdalr_and_holds_on_skip():
    """`DeviceLambdaLR` gives `LambdaLR`'s learning rates and holds its
    position while the optimizer's found_inf is set."""
    from ray_lightning_tpu_torch.models.llama import warmup_cosine_decay

    def fn(s):
        return warmup_cosine_decay(s, 0.0, 3e-4, 2, 8, 3e-5) / 3e-4

    w = torch.nn.Parameter(torch.zeros(3))
    host = torch.optim.lr_scheduler.LambdaLR(
        torch.optim.SGD([w], lr=3e-4), fn)
    opt = torch.optim.SGD([torch.nn.Parameter(torch.zeros(3))],
                          lr=torch.tensor(3e-4), fused=True)
    dev = DeviceLambdaLR(opt, fn)
    for _ in range(9):
        np.testing.assert_allclose(dev.get_last_lr(), host.get_last_lr(),
                                   rtol=1e-6, atol=1e-12)
        host.step()
        dev.step()
    lr = dev.get_last_lr()
    opt.found_inf = torch.ones(())
    dev.step()
    assert dev.last_epoch == 9 and dev.get_last_lr() == lr
    opt.found_inf = torch.zeros(())
    dev.step()
    assert dev.last_epoch == 10
    state = dev.state_dict()
    dev2 = DeviceLambdaLR(opt, fn)
    dev2.load_state_dict({"last_epoch": int(state["last_epoch"])})
    assert dev2.last_epoch == 10


# ------------------------------------------- tier 2: escalation/rollback


def _sticky_nan_fit(tmp_path, callbacks=None, **guard_kw):
    guard_kw.setdefault("warmup_steps", 1)
    guard_kw.setdefault("escalate_after", 3)
    guard_kw.setdefault("escalate_window", 8)
    t = _trainer(tmp_path, guard=GuardConfig(**guard_kw),
                 callbacks=list(callbacks or []))
    t.callbacks.append(FaultInjector(
        [Fault("nan_loss", None, 4, {"count": "10"})]))
    with pytest.raises(TrainingAnomalyError) as exc_info:
        t.fit(BoringModel(), _loader())
    return t, exc_info.value


def test_escalation_marker_matches_jax(tmp_path):
    """The JAX sticky-NaN fit and the port's escalate at the same step
    and write the same marker payload (all but its time stamp)."""
    from ray_lightning_tpu import SingleDevice as JaxSingle
    from ray_lightning_tpu import Trainer as JaxTrainer
    from tests.utils import BoringModel as JaxBoring

    _, err = _sticky_nan_fit(tmp_path / "p")
    jt = JaxTrainer(strategy=JaxSingle(), max_epochs=2, seed=7,
                    enable_checkpointing=False, enable_progress_bar=False,
                    log_every_n_steps=1, default_root_dir=str(tmp_path / "j"),
                    guard=jguard.GuardConfig(warmup_steps=1,
                                             escalate_after=3,
                                             escalate_window=8))
    jt.callbacks.append(JaxInjector(
        [JaxFault("nan_loss", None, 4, {"count": "10"})]))
    from ray_lightning_tpu import DataLoader as JaxDataLoader

    with pytest.raises(jguard.TrainingAnomalyError) as jexc:
        jt.fit(JaxBoring(), JaxDataLoader(random_dataset(), batch_size=32,
                                          shuffle=True, seed=5))
    assert (err.detected_step, err.last_good_step) == (
        jexc.value.detected_step, jexc.value.last_good_step) == (6, 3)
    mine = read_rollback_marker(str(tmp_path / "p"))
    theirs = jguard.read_rollback_marker(str(tmp_path / "j"))
    mine.pop("at"), theirs.pop("at")
    assert mine == theirs
    assert mine["kind"] == "anomaly-streak" and mine["epoch_batch"] == 6
    fc = classify_failure(err)
    assert fc.kind == FailureKind.CORRUPTION
    assert fc.cause == "anomaly-streak" and fc.restartable


def test_classify_corruption_from_worker_traceback():
    """The exception NAME travels in the worker traceback; the port's
    classification of the port's own names matches the JAX one's."""
    for mod in ("ray_lightning_tpu_torch", "ray_lightning_tpu"):
        tb = (f"Traceback ...\n{mod}.resilience.guard.TrainingAnomalyError:"
              " training anomaly escalation: 3 anomalous step(s) ...")
        fc = classify_failure(WorkerError(1, tb))
        assert fc.kind == FailureKind.CORRUPTION and fc.rank == 1
        assert fc.to_dict() == jax_classify(WorkerError(1, tb)).to_dict()
        sdc = WorkerError(0, f"Traceback ...\n{mod}.resilience.guard."
                             "SDCDetectedError: silent data corruption ...")
        assert classify_failure(sdc).cause == "sdc"


def test_retry_policy_rollback_budget():
    corruption = classify_failure(TrainingAnomalyError(6, 3, 8, 3))
    retry = classify_failure(TimeoutError("x"))
    for policy in (RetryPolicy(max_restarts=3, max_rollbacks=1),
                   JaxRetry(max_restarts=3, max_rollbacks=1)):
        assert policy.allows(0, 0, corruption, rollbacks=0)
        assert not policy.allows(0, 0, corruption, rollbacks=1)
        assert policy.allows(2, 0, retry, rollbacks=1)


def test_blessed_stamp_and_good_only_selection(tmp_path):
    """Checkpoints saved inside the anomaly window are stamped
    blessed=False; latest_checkpoint(good_only=True, max_step=...) skips
    them and anything past the rollback horizon."""
    ck = tmp_path / "ck"
    mc = ModelCheckpoint(dirpath=str(ck), monitor=None,
                         every_n_train_steps=1, save_top_k=-1)
    _sticky_nan_fit(tmp_path, callbacks=[mc])
    metas = {}
    for d in os.listdir(ck):
        with open(ck / d / "meta.json") as f:
            metas[d] = json.load(f)
    assert metas["step=3"]["blessed"] is True
    assert metas["step=4"]["blessed"] is False   # streak active
    assert metas["step=4"]["guard"]["streak"] >= 1
    assert metas["step=4"]["guard"]["updates"] == 3
    assert latest_checkpoint(str(ck)).endswith("step=6")
    marker = read_rollback_marker(str(tmp_path))
    good = latest_checkpoint(str(ck), good_only=True,
                             max_step=marker["last_good_step"])
    assert good.endswith("step=3")


def test_retention_never_deletes_last_blessed(tmp_path):
    """save_top_k pruning inside a long anomaly streak keeps the newest
    blessed checkpoint outside the newest-N window."""
    ck = tmp_path / "ck"
    mc = ModelCheckpoint(dirpath=str(ck), monitor=None,
                         every_n_train_steps=1, save_top_k=1)
    _sticky_nan_fit(tmp_path, callbacks=[mc])
    dirs = sorted(d for d in os.listdir(ck) if d.startswith("step="))
    assert "step=3" in dirs and "step=6" in dirs, dirs
    assert "step=4" not in dirs and "step=5" not in dirs, dirs


def test_retention_respects_probe_horizon(tmp_path):
    """With the SDC probe armed, the spared checkpoint is at or below
    the last probe-verified step (the JAX floor's second pass)."""
    ck = tmp_path / "ck"
    for step in (1, 2, 3, 4):
        save_checkpoint(str(ck / f"step={step}"),
                        {"w": torch.full((4,), float(step))},
                        {"global_step": step, "blessed": True})
    mc = ModelCheckpoint(dirpath=str(ck), save_top_k=1)
    mc._saved = [(-float(s), str(ck / f"step={s}")) for s in (1, 2, 3, 4)]

    class _T:
        _guard_probe_ok_step = 2

        class strategy:
            is_global_zero = True

    mc._prune(_T())
    assert sorted(os.listdir(ck)) == ["step=2", "step=4"]


def test_sweep_keep_last_n_protects_blessed(tmp_path):
    """TuneReportCheckpointCallback(keep_last_n=) spares the newest
    blessed checkpoint when every kept one is unblessed."""
    from ray_lightning_tpu_torch.sweep.callbacks import (
        TuneReportCheckpointCallback,
    )

    cb = TuneReportCheckpointCallback(keep_last_n=2)
    for step, blessed in ((1, True), (2, True), (3, False), (4, False),
                          (5, False)):
        path = str(tmp_path / f"checkpoint_{step:08d}")
        save_checkpoint(path, {"w": torch.full((8,), float(step))},
                        {"global_step": step, "blessed": blessed})
        cb._written.append(path)
    cb._prune()
    left = sorted(os.listdir(tmp_path))
    assert left == ["checkpoint_00000002", "checkpoint_00000004",
                    "checkpoint_00000005"], left


def test_rollback_resume_advances_past_poisoned_window(tmp_path):
    """Restore from the blessed checkpoint with the rollback marker: the
    poisoned window's batches are SKIPPED, not replayed."""
    ck = tmp_path / "ck"
    mc = ModelCheckpoint(dirpath=str(ck), monitor=None,
                         every_n_train_steps=1, save_top_k=-1)
    _sticky_nan_fit(tmp_path, callbacks=[mc])
    marker = read_rollback_marker(str(tmp_path))
    resume_from = latest_checkpoint(str(ck), good_only=True,
                                    max_step=marker["last_good_step"])
    assert resume_from.endswith("step=3")
    t2 = _trainer(tmp_path / "resume")
    t2.resume_skip_past = marker
    t2.fit(BoringModel(), _loader(), ckpt_path=resume_from)
    # epoch 0 restored at batch 3, window skipped through batch 6:
    # 2 batches left of epoch 0 + 8 of epoch 1 on top of the 3 restored
    assert t2.global_step == 3 + 2 + 8


def test_scratch_rollback_still_advances_past_window(tmp_path):
    t = _trainer(tmp_path)
    t.resume_skip_past = {"detected_step": 6, "last_good_step": 3,
                          "epoch": 0, "epoch_batch": 6}
    t.fit(BoringModel(), _loader())  # no ckpt_path: scratch
    assert t.global_step == 10


def test_stale_rollback_marker_is_ignored(tmp_path):
    ck = tmp_path / "ck"
    mc = ModelCheckpoint(dirpath=str(ck), monitor=None,
                         every_n_train_steps=1, save_top_k=-1)
    _trainer(tmp_path, callbacks=[mc]).fit(BoringModel(), _loader())
    t2 = _trainer(tmp_path / "resume")
    t2.resume_skip_past = {"detected_step": 6, "last_good_step": 3,
                           "epoch": 0, "epoch_batch": 6}
    t2.fit(BoringModel(), _loader(), ckpt_path=latest_checkpoint(str(ck)))
    assert t2.global_step == 16  # nothing skipped, nothing replayed


def test_escalation_respects_window_at_sparse_cadence(tmp_path):
    """K anomalies spread over a gap longer than the window do not
    escalate; K consecutive ones do, whatever the fetch cadence."""

    class _T:
        current_epoch = 0
        _epoch_batches_done = 0
        global_step = 0
        default_root_dir = str(tmp_path)

    cb = GuardCallback(GuardConfig(escalate_after=4, escalate_window=16),
                       marker_dir=str(tmp_path))
    cb._note(_T(), 50, 0.0, streak=0.0)
    cb._note(_T(), 100, 4.0, streak=1.0)  # no escalation
    with pytest.raises(TrainingAnomalyError):
        cb._note(_T(), 150, 8.0, streak=4.0)


def test_rollback_quarantines_poisoned_checkpoints(tmp_path):
    from ray_lightning_tpu_torch.resilience.supervisor import (
        _quarantine_newer_checkpoints,
    )

    for step in (1, 2, 3, 4):
        save_checkpoint(str(tmp_path / f"step={step}"),
                        {"w": torch.full((8,), float(step))},
                        {"global_step": step, "blessed": True})
    _quarantine_newer_checkpoints(str(tmp_path), 2)
    assert sorted(d for d in os.listdir(tmp_path)
                  if d.startswith("step=")) == ["step=1", "step=2"]
    moved = os.listdir(tmp_path / "quarantined.ckpts")
    assert sorted(m.split(".")[0] for m in moved) == ["step=3", "step=4"]
    assert latest_checkpoint(str(tmp_path)).endswith("step=2")


def test_rollback_target_picks_blessed_and_records_quarantine(tmp_path):
    """The supervisor's rollback: the newest blessed checkpoint at or
    below the marker's last-good step, the quarantine on disk, the
    rollback count in the marker."""
    from ray_lightning_tpu_torch.resilience.supervisor import (
        ResilienceConfig,
        _rollback_target,
    )

    for step, blessed in ((2, True), (3, False), (4, True)):
        save_checkpoint(str(tmp_path / f"step={step}"),
                        {"w": torch.full((8,), float(step))},
                        {"global_step": step, "blessed": blessed})
    pguard.write_rollback_marker(str(tmp_path), {
        "kind": "sdc", "detected_step": 4, "last_good_step": 3,
        "epoch": 0, "epoch_batch": 4, "quarantine": [1]})
    quarantined = []
    got = _rollback_target(ResilienceConfig(str(tmp_path)), 1, quarantined,
                           None)
    assert got.endswith("step=2") and quarantined == [1]
    with open(tmp_path / pguard.QUARANTINE_FILE) as f:
        assert json.load(f)["excluded"] == [1]
    assert read_rollback_marker(str(tmp_path))["rollbacks_performed"] == 1


# --------------------------------------------------- tier 3: the digest


def _bits(dtype, n=1000, seed=0):
    """Seeded random bytes of ``n`` elements of ``dtype`` (every bit
    pattern, NaNs included), as a numpy array of that width."""
    width = np.dtype(dtype).itemsize if dtype != "bfloat16" else 2
    raw = np.random.default_rng(seed).integers(
        0, 256, n * width, dtype=np.uint8)
    return raw


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16",
                                   "int32", "uint8", "bool"])
def test_leaf_digest_matches_jax(dtype):
    """The port's digest of a leaf equals the JAX digest of the same
    bytes exactly, and one flipped bit changes it."""
    raw = _bits(dtype)
    if dtype == "bool":
        a = raw % 2 == 1
        t = torch.from_numpy(a)
        j = jnp.asarray(a)
    elif dtype == "bfloat16":
        u = raw.view(np.uint16)
        t = torch.from_numpy(u.view(np.int16)).view(torch.bfloat16)
        j = jax.lax.bitcast_convert_type(jnp.asarray(u), jnp.bfloat16)
    else:
        a = raw.view(np.dtype(dtype))
        t = torch.from_numpy(a.copy())
        j = jnp.asarray(a)
    want = int(jguard._leaf_digest(j))
    assert int(pguard._leaf_digest(t)) == want
    if dtype != "bool":
        flipped = t.clone()
        from ray_lightning_tpu_torch.resilience.faults import _flip_bit

        _flip_bit(flipped, element=7, bit=3)
        assert int(pguard._leaf_digest(flipped)) != want


def test_leaf_digest_sees_every_bit_of_wide_dtypes():
    base = torch.tensor([3, 5, 7], dtype=torch.int64)
    flipped = base.clone()
    flipped[1] ^= 1 << 4
    assert int(pguard._leaf_digest(base)) != int(pguard._leaf_digest(flipped))
    hi = base.clone()
    hi[2] ^= 1 << 40  # the high half of the word reaches the sum too
    assert int(pguard._leaf_digest(base)) != int(pguard._leaf_digest(hi))


def test_tree_digest_of_mlp_params_matches_jax():
    """The JAX MLP's params and the same weights carried into the port
    by `params_from_jax` (kernels transposed: the sum does not care)
    have equal tree digests: the leaf order is the JAX flatten order."""
    from ray_lightning_tpu.models.mlp import MLP as JaxMLP
    from ray_lightning_tpu_torch.models.mlp import params_from_jax

    params = JaxMLP(features=(16, 8), num_classes=4).init(
        jax.random.key(0), jnp.zeros((1, 32)))["params"]
    want = int(jguard._tree_digest(params))
    got = params_from_jax(jax.tree.map(np.asarray, params))
    assert int(pguard._tree_digest(got)) == want
    assert int(pguard.local_digest(got)) == want


DIAGNOSE = [
    ([7, 7, 5, 7], [[0, 1, 2, 3]]),
    ([7, 5], [[0, 1]]),
    ([7, 7], [[0, 1]]),
    ([7, 5], []),
    ([1, 1, 2, 2, 3, 3], [[0, 2, 4], [1, 3, 5]]),
]


@pytest.mark.parametrize("digests,groups", DIAGNOSE)
def test_diagnose_digests_matches_jax(digests, groups):
    assert pguard.diagnose_digests(digests, groups) == \
        jguard.diagnose_digests(digests, groups)


@pytest.mark.parametrize("kind", ["dp", "fsdp", "dp_x_fsdp"])
def test_replica_groups_match_jax(devices8, kind):
    """DataParallel gives one group of every rank, FSDP singletons (no
    groups), a 2 x 4 data x fsdp mesh one group per fsdp coordinate:
    the JAX package's groups from the same layout."""
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from ray_lightning_tpu.parallel.mesh import MeshSpec

    spec, sizes = {"dp": ((None, None), dict(data=8)),
                   "fsdp": (("fsdp", None), dict(fsdp=8)),
                   "dp_x_fsdp": (("fsdp", None), dict(data=2, fsdp=4))}[kind]
    mesh = MeshSpec(**sizes).build(devices8)
    leaf = jax.device_put(jnp.zeros((16, 16)), NamedSharding(mesh, P(*spec)))
    want = jguard.replica_groups({"w": leaf}, mesh)
    got = pguard.replica_groups({"w": list(spec), "b": []}, sizes)
    assert got == want


def test_single_process_probe_records_only(tmp_path):
    """On one device there is no replica to compare: the probe runs at
    its cadence, records, and never raises."""
    t = _trainer(tmp_path, guard=GuardConfig(sdc_every_n_steps=2))
    t.fit(BoringModel(), _loader())
    assert t.callback_metrics["guard_sdc_probes"] == 8.0
    assert t._guard_probe_ok_step == 16


def test_bitflip_is_invisible_to_tier1(tmp_path):
    """A bit flip never produces a NaN or a spike: with the probe off the
    run ends "successfully" with no skipped step, and the weights differ
    from a clean run's."""
    clean = BoringModel()
    _trainer(tmp_path / "a", guard=GuardConfig()).fit(clean, _loader())
    hurt = BoringModel()
    t = _trainer(tmp_path / "b", guard=GuardConfig(), callbacks=[
        FaultInjector([Fault("bitflip_param", None, 3, {"bit": "20"})])])
    t.fit(hurt, _loader())
    assert t.callback_metrics["guard_skipped_steps"] == 0
    assert not all(torch.equal(a, b) for a, b in
                   zip(_params(clean).values(), _params(hurt).values()))


def test_nan_loss_fires_once_across_restarts(tmp_path):
    state = str(tmp_path / "fault_state")
    t = _trainer(tmp_path / "a", guard=GuardConfig(warmup_steps=2),
                 callbacks=[FaultInjector([Fault("nan_loss", None, 3, {})],
                                          state)])
    t.fit(BoringModel(), _loader())
    assert t.callback_metrics["guard_skipped_steps"] == 1
    t2 = _trainer(tmp_path / "b", guard=GuardConfig(warmup_steps=2),
                  callbacks=[FaultInjector([Fault("nan_loss", None, 3, {})],
                                           state)])
    t2.fit(BoringModel(), _loader())
    assert t2.callback_metrics["guard_skipped_steps"] == 0


def test_sdc_error_is_corruption():
    err = SDCDetectedError([1], 4, 2, digests=[1, 2, 1])
    fc = classify_failure(err)
    assert fc.kind == FailureKind.CORRUPTION and fc.cause == "sdc"
    assert jax_classify(jguard.SDCDetectedError([1], 4, 2)).to_dict() == \
        fc.to_dict()
