"""The port's device prefetch (`pipeline/prefetch.py` and the trainer's
hot loop) against `tests/test_prefetch_pipeline.py`'s contracts.

The eight prefetcher contracts (order, backpressure, shutdown mid-stream,
exhaustion, a producer error re-raised at the consumer, occupancy, depth
0, depth validation) run once through the JAX `DevicePrefetcher` and once
through the port's, on the same scripted sources: both packages must
behave alike. Then the trainer: a prefetched fit is bitwise the
synchronous one, its occupancy lands in ``callback_metrics``, a
mid-epoch resume with the prefetcher on replays the rest of the epoch
exactly, and an early stop leaves no producer thread. On the CPU; the
side stream, the event and ``record_stream`` run only on the card
(``chip_smoke.py`` phase 10).
"""
from __future__ import annotations

import threading
import time

import numpy as np
import pytest
import torch

from ray_lightning_tpu.pipeline import prefetch as jax_prefetch
from ray_lightning_tpu_torch.core.callbacks import Callback, ModelCheckpoint
from ray_lightning_tpu_torch.core.data import ThrottledLoader
from ray_lightning_tpu_torch.core.trainer import Trainer
from ray_lightning_tpu_torch.parallel.strategy import SingleDevice
from ray_lightning_tpu_torch.pipeline import prefetch as torch_prefetch
from tests import torch_jobs

PACKAGES = {"jax": jax_prefetch, "torch": torch_prefetch}


@pytest.fixture(params=list(PACKAGES))
def pkg(request):
    return PACKAGES[request.param]


def test_preserves_order(pkg):
    pf = pkg.DevicePrefetcher(range(50), lambda x: x * 10, depth=3)
    assert list(pf) == [x * 10 for x in range(50)]
    assert pf.stats.batches == 50


def test_backpressure_bounds_lookahead(pkg):
    produced = []

    def place(x):
        produced.append(x)
        return x

    pf = pkg.DevicePrefetcher(range(100), place, depth=2)
    try:
        deadline = time.time() + 2.0
        while len(produced) < 3 and time.time() < deadline:
            time.sleep(0.01)
        # nothing consumed yet: at most depth buffered + 1 in hand
        assert len(produced) <= 3, produced
        assert next(pf) == 0
        time.sleep(0.1)
        assert len(produced) <= 4, produced
    finally:
        pf.close()


def test_shutdown_mid_stream_joins_producer(pkg):
    pf = pkg.DevicePrefetcher(range(1000), lambda x: x, depth=2)
    assert next(pf) == 0
    pf.close()
    assert not pf._thread.is_alive()
    with pytest.raises(StopIteration):
        next(pf)
    pf.close()  # idempotent


def test_exhaustion_joins_producer(pkg):
    pf = pkg.DevicePrefetcher(range(3), lambda x: x, depth=2)
    assert list(pf) == [0, 1, 2]
    pf._thread.join(timeout=5.0)
    assert not pf._thread.is_alive()


def test_producer_error_reraised_at_consumer(pkg):
    def place(x):
        if x == 3:
            raise ValueError("bad batch 3")
        return x

    pf = pkg.DevicePrefetcher(range(10), place, depth=2)
    got = []
    with pytest.raises(ValueError, match="bad batch 3"):
        for item in pf:
            got.append(item)
    assert got == [0, 1, 2]
    assert not pf._thread.is_alive()


def test_occupancy_with_slow_consumer(pkg):
    pf = pkg.DevicePrefetcher(range(20), lambda x: x, depth=2)
    out = []
    for item in pf:
        out.append(item)
        time.sleep(0.005)  # the consumer is slower than the producer
    assert out == list(range(20))
    assert pf.stats.occupancy > 0.5
    m = pf.stats.to_metrics()
    assert set(m) == {"prefetch_batches", "prefetch_occupancy",
                      "prefetch_wait_s", "prefetch_depth"}
    assert (m["prefetch_batches"], m["prefetch_depth"]) == (20.0, 2.0)


def test_depth_zero_is_synchronous(pkg):
    calls = []
    gen = pkg.prefetch_to_device(range(5), lambda x: calls.append(x) or x,
                                 depth=0)
    assert not isinstance(gen, pkg.DevicePrefetcher)
    assert calls == []  # lazy: nothing placed until consumed
    assert next(iter(gen)) == 0
    assert calls == [0]


def test_depth_validation(pkg):
    with pytest.raises(ValueError):
        pkg.DevicePrefetcher(range(5), lambda x: x, depth=0)


# ---- the trainer's hot loop -------------------------------------------------------


def _fit(tmp_path, *, prefetch, warm_start=True, max_epochs=2, max_steps=-1,
         callbacks=(), ckpt_path=None, toks=None):
    """The tiny Llama (the port's seeded init) over 6 batches an epoch."""
    toks = torch_jobs.tokens(12, 12, seed=4) if toks is None else toks
    rec = torch_jobs.StepRecorder()
    module = torch_jobs.llama_module(None, total_steps=12)
    trainer = Trainer(strategy=SingleDevice(device="cpu"),
                      max_epochs=max_epochs, max_steps=max_steps,
                      log_every_n_steps=1, enable_checkpointing=False,
                      enable_progress_bar=False, seed=11,
                      default_root_dir=str(tmp_path),
                      callbacks=[rec, *callbacks],
                      prefetch_to_device=prefetch, warm_start=warm_start)
    trainer.fit(module, torch_jobs.llama_data(toks), ckpt_path=ckpt_path)
    return trainer, module, rec.rows


def _same_params(a, b):
    assert set(a.params) == set(b.params)
    for k, v in a.params.items():
        assert torch.equal(v, b.params[k]), k


def test_bitwise_parity_prefetch_vs_sync(tmp_path):
    """The prefetcher reorders work, never data: the fit with the
    pipeline on (and the warm start) ends on bit-identical weights."""
    t_pre, m_pre, rows_pre = _fit(tmp_path / "a", prefetch=3)
    t_sync, m_sync, rows_sync = _fit(tmp_path / "b", prefetch=0,
                                     warm_start=False)
    assert rows_pre == rows_sync and len(rows_pre) == 12
    _same_params(m_pre, m_sync)
    assert t_pre.callback_metrics["prefetch_batches"] == 6.0
    assert "prefetch_batches" not in t_sync.callback_metrics


class _SlowConsumer(Callback):
    def on_train_batch_end(self, trainer, module, metrics, batch_idx):
        time.sleep(0.01)


def test_occupancy_metric_with_slow_consumer(tmp_path):
    """When the consumer is the bottleneck the pipeline runs ahead:
    occupancy above 0, and the stats land in callback_metrics."""
    from ray_lightning_tpu_torch.core.data import DataLoader

    loader = ThrottledLoader(
        DataLoader({"tokens": torch_jobs.tokens(12, 12, seed=4)},
                   batch_size=2), 0.002)
    trainer = Trainer(strategy=SingleDevice(device="cpu"), max_epochs=2,
                      log_every_n_steps=1, enable_checkpointing=False,
                      enable_progress_bar=False, default_root_dir=str(
                          tmp_path), prefetch_to_device=2,
                      callbacks=[_SlowConsumer()])
    trainer.fit(torch_jobs.llama_module(None, total_steps=12), loader)
    assert trainer.callback_metrics["prefetch_occupancy"] > 0.0
    assert trainer.callback_metrics["prefetch_batches"] > 0


def test_mid_epoch_resume_with_prefetch(tmp_path):
    """A mid-epoch checkpoint and a resume, the prefetcher on: the rest
    of the epoch replays exactly (its read-ahead does not move the
    resume offset), bitwise the uninterrupted fit."""
    _, m_full, rows_full = _fit(tmp_path / "full", prefetch=2)
    cb = ModelCheckpoint(dirpath=str(tmp_path / "ck"),
                         every_n_train_steps=4, save_top_k=-1)
    _fit(tmp_path / "head", prefetch=2, callbacks=[cb], max_steps=4)
    assert cb.best_model_path
    _, m_resumed, rows_tail = _fit(tmp_path / "tail", prefetch=2,
                                   ckpt_path=cb.best_model_path)
    assert rows_tail == rows_full[4:]
    _same_params(m_full, m_resumed)


def test_early_stop_leaves_no_threads(tmp_path):
    """max_steps inside an epoch leaves through the prefetcher's close;
    no producer thread outlives the fit."""
    before = {t.ident for t in threading.enumerate()}
    trainer, _, _ = _fit(tmp_path, prefetch=2, max_steps=2, max_epochs=5)
    time.sleep(0.1)
    leaked = [t for t in threading.enumerate()
              if t.ident not in before and "rlt-prefetch" in t.name
              and t.is_alive()]
    assert not leaked, leaked
    assert trainer.global_step == 2


def test_pinned_staging_only_for_the_card(monkeypatch):
    """`Strategy.shard_batch` pins host memory for a copy to the card
    (its copy is then truly asynchronous) and leaves CPU placement
    alone."""
    strategy = SingleDevice(device="cpu")
    strategy.setup()
    pinned = []
    monkeypatch.setattr(torch.Tensor, "pin_memory",
                        lambda t: pinned.append(t) or t)
    out = strategy.shard_batch({"a": np.arange(4)})
    assert out["a"].tolist() == [0, 1, 2, 3] and pinned == []
    strategy.device = torch.device("cuda", 0)
    moved = []
    monkeypatch.setattr(torch.Tensor, "to",
                        lambda t, *a, **k: moved.append(k) or t)
    strategy.shard_batch({"a": np.arange(4)})
    assert len(pinned) == 1 and moved == [{"non_blocking": True}]
