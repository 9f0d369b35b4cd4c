"""The port's native batcher (`ray_lightning_tpu_torch.native`: the JAX
package's `batcher.cpp`, built by the port's own binding) on the CPU,
against the JAX `NativeBatcher` and the numpy path: the five cases of
tests/test_native.py with every batch bitwise equal to the JAX
batcher's and the numpy path's for the same seed and epochs, the
zero-copy mode under the port's `DevicePrefetcher` equal to copy mode,
and the fallback made visible."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from ray_lightning_tpu.core.data import DataLoader as JaxDataLoader
from ray_lightning_tpu.native import NativeBatcher as JaxBatcher
from ray_lightning_tpu_torch import native
from ray_lightning_tpu_torch.core.data import DataLoader
from ray_lightning_tpu_torch.native import NativeBatcher


def _data(n=100, dim=8, seed=0):
    rng = np.random.default_rng(seed)
    return {"x": rng.standard_normal((n, dim)).astype(np.float32),
            "y": rng.integers(0, 5, n).astype(np.int32)}


def _equal(a: list, b: list) -> None:
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert set(x) == set(y)
        for k in x:
            assert x[k].dtype == y[k].dtype and x[k].shape == y[k].shape
            np.testing.assert_array_equal(x[k], y[k])


def test_native_matches_numpy_and_jax_batches():
    data = _data()
    order = np.random.default_rng(1).permutation(100)
    b, jb = NativeBatcher(data, batch_size=16), JaxBatcher(data, 16)
    b.set_epoch(order)
    jb.set_epoch(order)
    got = list(b)
    assert len(got) == 100 // 16
    _equal(got, [{k: v[order[i * 16:(i + 1) * 16]] for k, v in data.items()}
                 for i in range(len(got))])
    _equal(got, list(jb))
    b.close()
    jb.close()


def test_native_partial_tail_and_epochs():
    data = _data(n=20)
    b = NativeBatcher(data, batch_size=8, drop_last=False)
    jb = JaxBatcher(data, batch_size=8, drop_last=False)
    for epoch in range(3):
        order = np.random.default_rng(epoch).permutation(20)
        b.set_epoch(order)
        jb.set_epoch(order)
        batches = list(b)
        assert [len(x["y"]) for x in batches] == [8, 8, 4]
        np.testing.assert_array_equal(batches[2]["y"], data["y"][order[16:]])
        _equal(batches, list(jb))
    b.close()
    jb.close()


def test_native_zero_copy_mode():
    data = _data(n=32)
    b = NativeBatcher(data, batch_size=8, zero_copy=True)
    b.set_epoch(np.arange(32))
    seen = []
    for batch in b:
        assert isinstance(batch, native.SlotBatch) and batch.zero_copy
        assert not batch["y"].flags.owndata  # a view into the slot
        seen.append(batch["y"].copy())
    np.testing.assert_array_equal(np.concatenate(seen), data["y"])
    b.close()


def test_dataloader_prefetch_parity():
    """`DataLoader(prefetch=True)` yields the numpy path's batches and the
    JAX prefetching loader's, epoch by epoch (same shuffle, same shard),
    and says the native batcher made them."""
    data = _data(n=64)
    for shards in ((1, 0), (2, 1)):
        kw = dict(batch_size=16, shuffle=True, seed=3, num_shards=shards[0],
                  shard_index=shards[1])
        plain = DataLoader(data, **kw)
        fast = DataLoader(data, prefetch=True, **kw)
        jax_fast = JaxDataLoader(data, prefetch=True, **kw)
        assert fast.native is None
        for epoch in range(2):
            for loader in (plain, fast, jax_fast):
                loader.set_epoch(epoch)
            got = list(fast)
            _equal(got, list(plain))
            _equal(got, list(jax_fast))
        assert fast.native is True and plain.native is None
        assert fast._batcher.batches == 2 * 4 // shards[0]


def test_trainer_with_prefetch(tmp_path):
    """A fit fed by the native batcher is bitwise the numpy-fed fit."""
    from ray_lightning_tpu_torch.core.trainer import Trainer
    from ray_lightning_tpu_torch.models.mlp import (
        MLPClassifier,
        synthetic_mnist,
    )
    from ray_lightning_tpu_torch.parallel.strategy import SingleDevice

    data = synthetic_mnist(n=128)
    rows = {}
    for prefetch in (False, True):
        module = MLPClassifier(in_features=64)
        trainer = Trainer(strategy=SingleDevice(device="cpu"), max_epochs=2,
                          default_root_dir=str(tmp_path), seed=0,
                          enable_checkpointing=False,
                          enable_progress_bar=False)
        loader = DataLoader(data, batch_size=32, shuffle=True,
                            prefetch=prefetch)
        trainer.fit(module, loader)
        assert loader.native is (True if prefetch else None)
        rows[prefetch] = {k: v.detach().clone()
                          for k, v in module.params.items()}
        assert np.isfinite(float(trainer.callback_metrics["loss"]))
    for k in rows[False]:
        assert torch.equal(rows[False][k], rows[True][k]), k


@pytest.mark.parametrize("depth", [1, 2])
def test_zero_copy_under_device_prefetcher_equals_copy_mode(depth):
    """Views into the batcher's slots through the port's `DevicePrefetcher`
    on the CPU (where placing aliases the arrays, and the producer pulls
    the next batch, which takes the slot back, long before the consumer
    is done): every batch the consumer holds is copy mode's, also after
    the producer has run ahead."""
    from ray_lightning_tpu_torch.parallel.strategy import SingleDevice
    from ray_lightning_tpu_torch.pipeline.prefetch import DevicePrefetcher

    data = _data(n=96)
    strategy = SingleDevice(device="cpu")
    strategy.setup()
    order = np.random.default_rng(5).permutation(96)
    held = {}
    for zero_copy in (False, True):
        b = NativeBatcher(data, batch_size=8, depth=3, zero_copy=zero_copy)
        b.set_epoch(order)
        with DevicePrefetcher(b, strategy.shard_batch, depth=depth,
                              device="cpu") as pf:
            # hold every batch until the epoch is over
            held[zero_copy] = [dict(batch) for batch in pf]
        b.close()
    assert len(held[True]) == 12
    for a, z in zip(held[False], held[True]):
        for k in a:
            assert torch.equal(a[k], z[k])


def test_build_failure_falls_back_visibly(monkeypatch, caplog):
    """A batcher that cannot be built leaves the numpy path's batches,
    ``native`` False and a warning naming why; data the C ABI cannot
    carry does the same."""
    data = _data(n=32)
    monkeypatch.setattr(native, "load_library", lambda: None)
    loader = DataLoader(data, batch_size=8, shuffle=True, prefetch=True)
    with caplog.at_level("WARNING"):
        got = list(loader)
    assert loader.native is False and loader.prefetch is False
    assert "native batcher unavailable" in caplog.text
    loader.set_epoch(0)
    _equal(got, list(DataLoader(data, batch_size=8, shuffle=True)))
    monkeypatch.undo()
    strings = DataLoader({"x": np.array(["a"] * 8)}, batch_size=4,
                         prefetch=True)
    assert len(list(strings)) == 2 and strings.native is False
