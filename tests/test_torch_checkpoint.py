"""Checkpoints of the port (`checkpoint/io.py` on
`torch.distributed.checkpoint`, `ModelCheckpoint`, resume), mirroring
`tests/test_checkpoint.py` and `tests/test_async_checkpoint.py` of the
JAX package, on the CPU in one process.

Beyond the JAX tests' assertions, a resumed fit is held to the
uninterrupted one bitwise (the same loss at every later step and the
same final weights), at a mid-epoch and at an epoch-boundary save.
"""
from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

from ray_lightning_tpu_torch.checkpoint import (
    latest_checkpoint,
    load_checkpoint,
    save_checkpoint,
    verify_checkpoint,
    wait_for_checkpoints,
)
from ray_lightning_tpu_torch.checkpoint.io import (
    compute_state_digest,
    read_meta,
    sharding_provenance,
)
from ray_lightning_tpu_torch.core.callbacks import (
    ModelCheckpoint,
    _ckpt_blessed,
    _ckpt_meta,
)
from ray_lightning_tpu_torch.core.data import DataLoader
from ray_lightning_tpu_torch.core.trainer import Trainer
from ray_lightning_tpu_torch.models.mlp import (
    MLPClassifier,
    MNISTClassifier,
    synthetic_mnist,
)
from ray_lightning_tpu_torch.parallel.strategy import SingleDevice
from tests.torch_jobs import StepRecorder


class Classifier(MLPClassifier):
    """`MLPClassifier` that records its checkpoint hooks."""

    def __init__(self, lr: float = 0.05):
        super().__init__(features=(16,), num_classes=10, lr=lr)
        self.hparams.clear()  # ctor signature differs from parent's
        self.save_hyperparameters(lr=lr)
        self.hook_calls = []

    def on_save_checkpoint(self, checkpoint):
        self.hook_calls.append("on_save_checkpoint")

    def on_load_checkpoint(self, checkpoint):
        self.hook_calls.append("on_load_checkpoint")


DATA = synthetic_mnist(128)  # 4 batches an epoch at batch size 32


def _loader(shuffle=True):
    return DataLoader(DATA, batch_size=32, shuffle=shuffle, seed=3)


def _trainer(root, callbacks=(), **kw):
    kw.setdefault("max_epochs", 1)
    return Trainer(strategy=SingleDevice(device="cpu"),
                   default_root_dir=str(root), enable_checkpointing=False,
                   enable_progress_bar=False, log_every_n_steps=1, seed=7,
                   callbacks=list(callbacks), **kw)


def _weights(module):
    return {k: v.detach().clone() for k, v in module.params.items()}


def test_best_model_path_and_load(tmp_path):
    module = Classifier()
    mc = ModelCheckpoint(monitor="ptl/val_loss", mode="min",
                         dirpath=str(tmp_path / "ckpts"))
    trainer = _trainer(tmp_path, [mc], max_epochs=2)
    trainer.fit(module, _loader(), _loader(False))
    assert trainer.checkpoint_callback is mc
    assert mc.best_model_path and os.path.isdir(mc.best_model_path)
    assert mc.best_model_score is not None
    assert verify_checkpoint(mc.best_model_path) == (True, "ok")
    loaded = Classifier.load_from_checkpoint(mc.best_model_path,
                                             device="cpu")
    assert loaded.hparams == module.hparams
    assert "on_load_checkpoint" in loaded.hook_calls
    assert "on_save_checkpoint" in module.hook_calls
    saved = load_checkpoint(mc.best_model_path)
    assert set(saved) >= {"params", "opt_state", "step", "hparams",
                          "global_step", "epoch"}
    for k, v in loaded.params.items():
        assert torch.equal(v.detach(), saved["params"][k])
    preds = trainer.predict(loaded, _loader(False))
    acc = np.mean(np.concatenate(preds) == DATA["y"])
    assert acc >= 0.5


def test_load_defaults_to_the_card(tmp_path, monkeypatch):
    """load_from_checkpoint with no device builds the model on the card,
    as every entry point of the port does: with no card it raises rather
    than running on the CPU unasked."""
    path = str(tmp_path / "mnist")
    trainer = _trainer(tmp_path)
    trainer.fit(MNISTClassifier(), _loader())
    trainer.save_checkpoint(path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MNISTClassifier.load_from_checkpoint(path)
    loaded = MNISTClassifier.load_from_checkpoint(path, device="cpu")
    assert loaded.device == torch.device("cpu")
    assert next(loaded.model.parameters()).device.type == "cpu"


def test_default_checkpoint_callback(tmp_path):
    """enable_checkpointing=True (the default) adds a ModelCheckpoint
    writing under default_root_dir."""
    trainer = Trainer(strategy=SingleDevice(device="cpu"),
                      default_root_dir=str(tmp_path),
                      enable_progress_bar=False)
    assert isinstance(trainer.checkpoint_callback, ModelCheckpoint)
    trainer.fit(Classifier(), _loader())
    path = trainer.checkpoint_callback.best_model_path
    assert path == str(tmp_path / "checkpoints" / "epoch=0")
    assert latest_checkpoint(str(tmp_path / "checkpoints")) == path


def test_save_top_k_prunes(tmp_path):
    mc = ModelCheckpoint(monitor="ptl/val_loss", save_top_k=1,
                         dirpath=str(tmp_path / "ckpts"))
    trainer = _trainer(tmp_path, [mc], max_epochs=4)
    trainer.fit(Classifier(), _loader(), _loader(False))
    kept = os.listdir(tmp_path / "ckpts")
    assert kept == [os.path.basename(mc.best_model_path)]


def test_step_cadence_pruned_and_exclusive(tmp_path):
    """Step-based saves respect save_top_k and suppress epoch saves, even
    for a monitored callback."""
    cb = ModelCheckpoint(dirpath=str(tmp_path / "ck"), monitor="ptl/val_loss",
                         every_n_train_steps=1, save_top_k=2)
    trainer = _trainer(tmp_path, [cb])
    trainer.fit(Classifier(), _loader(), _loader(False))  # 4 steps
    assert sorted(os.listdir(tmp_path / "ck")) == ["step=3", "step=4"]
    assert cb.best_model_path.endswith("step=4")


def _uninterrupted(tmp_path, epochs):
    rec = StepRecorder()
    module = Classifier()
    _trainer(tmp_path / "full", [rec], max_epochs=epochs).fit(module,
                                                              _loader())
    return rec.rows, _weights(module)


@pytest.mark.parametrize("stop_at,epochs", [(2, 2), (4, 2), (6, 2)])
def test_resume_equals_uninterrupted(tmp_path, stop_at, epochs):
    """A fit stopped by ``max_steps`` at ``stop_at`` (2 and 6 inside an
    epoch; 4 on the last batch of epoch 0), saved, and resumed from the
    checkpoint in a fresh trainer and module trains exactly the steps the
    uninterrupted fit trains after it, to the same weights. As in the JAX
    trainer, a stop by ``max_steps`` leaves the epoch marked unfinished,
    so the resume replays what is left of it (at step 4: nothing)."""
    want_rows, want_weights = _uninterrupted(tmp_path, epochs)
    assert len(want_rows) == 4 * epochs

    first = _trainer(tmp_path / "a", max_epochs=epochs, max_steps=stop_at)
    first.fit(Classifier(), _loader())
    assert first.global_step == stop_at
    ckpt = first.save_checkpoint(str(tmp_path / "mid"))
    meta = read_meta(ckpt)
    assert meta["mid_epoch"] is True
    assert (meta["epoch"], meta["epoch_batch"]) == (stop_at // 5,
                                                    stop_at % 4 or 4)

    rec = StepRecorder()
    module = Classifier()
    second = _trainer(tmp_path / "b", [rec], max_epochs=epochs)
    second.fit(module, _loader(), ckpt_path=ckpt)
    assert "on_load_checkpoint" in module.hook_calls
    assert second.global_step == 4 * epochs
    assert second.current_epoch == epochs - 1
    assert second.state.step == 4 * epochs
    assert rec.rows == want_rows[stop_at:]
    for k, v in want_weights.items():
        assert torch.equal(module.params[k].detach(), v), k


def test_epoch_boundary_resume_advances_epoch(tmp_path):
    """The JAX test's shape: a checkpoint saved at an epoch boundary
    resumes at the NEXT epoch."""
    trainer = _trainer(tmp_path / "a")
    trainer.fit(Classifier(), DataLoader(DATA, batch_size=32))
    ckpt = trainer.save_checkpoint(str(tmp_path / "end"))
    trainer_b = _trainer(tmp_path / "b", max_epochs=2)
    trainer_b.fit(Classifier(), DataLoader(DATA, batch_size=32),
                  ckpt_path=ckpt)
    assert trainer_b.global_step == 8  # exactly one more epoch


def test_resume_restores_optimizer_and_schedule(tmp_path):
    """The optimizer's moments and the LR schedule's position come back
    (a Llama module: AdamW under a warmup-cosine schedule)."""
    from tests.torch_jobs import llama_module, llama_data, tokens

    toks = tokens(8, 8, seed=1)
    first = _trainer(tmp_path / "a", max_steps=2)
    m1 = llama_module(None, warmup_steps=2, total_steps=8)
    first.fit(m1, llama_data(toks, None, 2))
    ckpt = first.save_checkpoint(str(tmp_path / "ck"))
    second = _trainer(tmp_path / "b", max_steps=3)
    m2 = llama_module(None, warmup_steps=2, total_steps=8)
    second.fit(m2, llama_data(toks, None, 2), ckpt_path=ckpt)
    assert second.state.scheduler.last_epoch == 3
    assert first.state.scheduler.last_epoch == 2
    saved = load_checkpoint(ckpt)
    assert saved["scheduler"]["last_epoch"] == 2
    assert int(saved["step"]) == 2
    exp_avg = saved["opt_state"]["state"]["lm_head"]["exp_avg"]
    assert exp_avg.shape == m1.params["lm_head"].shape
    assert float(exp_avg.abs().max()) > 0


def test_async_step_checkpointing(tmp_path):
    """Step-cadence async saves: non-blocking writes joined at fit end,
    every checkpoint restorable and verified."""
    cb = ModelCheckpoint(dirpath=str(tmp_path / "ck"),
                         every_n_train_steps=2, async_save=True,
                         save_top_k=-1)
    trainer = _trainer(tmp_path, [cb])
    trainer.fit(Classifier(), _loader())  # 4 steps
    names = sorted(os.listdir(tmp_path / "ck"))
    assert names == ["step=2", "step=4"]
    for name in names:
        path = str(tmp_path / "ck" / name)
        assert verify_checkpoint(path) == (True, "ok")
        restored = load_checkpoint(path)
        assert restored["global_step"] == int(name[5:])
    assert trainer.callback_metrics["ckpt_async_saves"] >= 2


@pytest.mark.parametrize("name", ["ddp", "fsdp"])
def test_async_saves_in_a_process_group(tmp_path, name):
    """Async saves under a group strategy (its one-rank gloo group; the
    background write coordinates over a gloo group of its own), twice in
    one process: each group's checkpoints verify and resume."""
    import torch.distributed as dist

    from tests.torch_jobs import make_strategy

    for run in ("a", "b"):
        cb = ModelCheckpoint(dirpath=str(tmp_path / run),
                             every_n_train_steps=2, async_save=True,
                             save_top_k=-1)
        strategy = make_strategy(name)
        trainer = Trainer(strategy=strategy, max_epochs=1, seed=7,
                          enable_checkpointing=False,
                          enable_progress_bar=False, callbacks=[cb])
        try:
            trainer.fit(Classifier(), _loader())
        finally:
            strategy.teardown()
        assert not dist.is_initialized()
        for step in (2, 4):
            path = str(tmp_path / run / f"step={step}")
            assert verify_checkpoint(path) == (True, "ok")
            assert read_meta(path)["mesh_spec"] == {
                "ddp": {"data": 1}, "fsdp": {"fsdp": 1}}[name]
    resumed = _trainer(tmp_path / "c", max_epochs=2)
    resumed.fit(Classifier(), _loader(),
                ckpt_path=str(tmp_path / "b" / "step=4"))
    assert resumed.global_step == 8


def test_async_save_with_top_k_prune(tmp_path):
    cb = ModelCheckpoint(dirpath=str(tmp_path / "ck"),
                         every_n_train_steps=1, async_save=True,
                         save_top_k=1)
    _trainer(tmp_path, [cb]).fit(Classifier(), _loader())
    assert os.listdir(tmp_path / "ck") == ["step=4"]
    assert latest_checkpoint(str(tmp_path / "ck")).endswith("step=4")


def _state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn(64, 32, generator=g),
                       "b": torch.randn(32, generator=g)},
            "step": 3}


def test_async_meta_deferred_until_finalized(tmp_path):
    """block=False must not publish meta.json (the completeness marker)
    over a write that has not committed; after wait_for_checkpoints()
    the checkpoint is complete and verifies."""
    path = str(tmp_path / "a")
    save_checkpoint(path, _state(), {"global_step": 3}, block=False)
    if os.path.exists(os.path.join(path, "meta.json")):
        # published early: only ever over a finished write
        assert verify_checkpoint(path)[0]
    wait_for_checkpoints()
    assert verify_checkpoint(path) == (True, "ok")
    assert read_meta(path)["global_step"] == 3
    got = load_checkpoint(path)
    assert torch.equal(got["params"]["w"], _state()["params"]["w"])


def _write(tmp_path, name, step, **meta):
    path = str(tmp_path / name)
    save_checkpoint(path, _state(step), {"global_step": step, **meta})
    return path


def test_latest_checkpoint_skips_torn_partial_and_corrupt(tmp_path):
    good = _write(tmp_path, "good", 1)
    torn = _write(tmp_path, "torn", 3)
    os.remove(os.path.join(torn, "meta.json"))
    partial = _write(tmp_path, "partial", 4)
    os.remove(os.path.join(partial, "state", ".metadata"))
    corrupt = _write(tmp_path, "corrupt", 5)
    data = [f for f in os.listdir(os.path.join(corrupt, "state"))
            if f.endswith(".distcp")][0]
    with open(os.path.join(corrupt, "state", data), "r+b") as f:
        f.seek(100)
        byte = f.read(1)
        f.seek(100)
        f.write(bytes([byte[0] ^ 0xFF]))
    assert verify_checkpoint(torn)[1].startswith("no meta.json")
    assert verify_checkpoint(partial)[1].startswith("partial state")
    assert verify_checkpoint(corrupt)[1].startswith("digest mismatch")
    assert verify_checkpoint(str(tmp_path / "nothing"))[0] is False
    assert latest_checkpoint(str(tmp_path)) == good
    # good_only skips an unblessed checkpoint; max_step caps the step
    newer = _write(tmp_path, "unblessed", 9, blessed=False)
    assert latest_checkpoint(str(tmp_path)) == newer
    assert (_ckpt_meta(newer), _ckpt_blessed(good)) == ((False, 9), None)
    assert latest_checkpoint(str(tmp_path), good_only=True) == good
    assert latest_checkpoint(str(tmp_path), max_step=8) == good
    assert latest_checkpoint(str(tmp_path / "none")) is None


@pytest.mark.parametrize("mode", ["full", "size", "off"])
def test_digest_modes(tmp_path, monkeypatch, mode):
    monkeypatch.setenv("RLT_CKPT_DIGEST", mode)
    path = _write(tmp_path, "ck", 1)
    meta = read_meta(path)
    assert meta["ckpt_digest_mode"] == mode
    assert ("ckpt_digest" in meta) == (mode != "off")
    if mode != "off":
        assert (meta["ckpt_digest"], meta["ckpt_files"]) == \
            compute_state_digest(path, mode)
    assert verify_checkpoint(path) == (True, "ok")


@pytest.mark.parametrize("bytes_a_thread,threads",
                         [(1 << 30, 1), (4096, 3), (1, 8)])
def test_write_threads_split_the_state_and_restore_it(tmp_path, monkeypatch,
                                                      bytes_a_thread, threads):
    """A blocking save writes a rank's items from one thread for each
    ``_BYTES_A_THREAD`` of its share (at least one, at most eight), each
    into its own file; the checkpoint verifies and loads back the same
    values. The share is 12 KiB here, so the rule is scaled down to it."""
    from ray_lightning_tpu_torch.checkpoint import io as ckpt_io

    monkeypatch.setattr(ckpt_io, "_BYTES_A_THREAD", bytes_a_thread)
    state = {f"w{i}": torch.randn(64, 8, generator=torch.Generator()
                                  .manual_seed(i)) for i in range(6)}
    path = save_checkpoint(str(tmp_path / "ck"), dict(state))
    files = [f for f in os.listdir(os.path.join(path, "state"))
             if f.endswith(".distcp")]
    assert len(files) == threads
    assert verify_checkpoint(path) == (True, "ok")
    got = load_checkpoint(path)
    for k, v in state.items():
        assert torch.equal(got[k], v), k


def test_provenance_stamps_are_verified(tmp_path):
    """A mesh's stamps are recorded, and a checkpoint whose stamps
    contradict themselves does not verify."""
    import types

    fake_mesh = types.SimpleNamespace(mesh_dim_names=("fsdp",), shape=(2,),
                                      device_type="cpu")
    stamps = sharding_provenance(fake_mesh, {"w": torch.zeros(3)})
    assert stamps["mesh_spec"] == {"fsdp": 2}
    assert stamps["topology"]["n_devices"] == 2
    assert stamps["param_specs"] == {"w": []}
    assert sharding_provenance(None, {"w": torch.zeros(3)}) == {}
    path = _write(tmp_path, "ck", 1, **stamps)
    assert verify_checkpoint(path) == (True, "ok")
    meta_path = os.path.join(path, "meta.json")
    with open(meta_path) as f:
        meta = json.load(f)
    meta["param_specs"] = {"w": ["tensor"]}
    with open(meta_path, "w") as f:
        json.dump(meta, f)
    assert "provenance mismatch" in verify_checkpoint(path)[1]


def test_resume_from_missing_checkpoint_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        _trainer(tmp_path).fit(Classifier(), _loader(),
                               ckpt_path=str(tmp_path / "nope"))
