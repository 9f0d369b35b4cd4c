"""Data loading: host-side batch iterators (twin of
`ray_lightning_tpu/core/data.py`).

Batches are dicts (or tuples) of numpy arrays with a leading batch axis;
the strategy moves them to the device. ``drop_last`` defaults to True so
every step sees one shape. The native prefetching batcher and
`ensure_sharded` (multi-process sharding) are not ported yet.
"""
from __future__ import annotations

from typing import Any, Iterable, Iterator, Optional

import numpy as np


class DataLoader:
    """Array-backed loader: seeded shuffling, batching, per-epoch reseed.

    `data` is a pytree (dict/tuple) of equal-length numpy arrays, or a
    callable epoch -> iterable for streaming sources."""

    def __init__(
        self,
        data: Any,
        batch_size: int = 1,
        shuffle: bool = False,
        seed: int = 0,
        drop_last: bool = True,
        num_shards: int = 1,
        shard_index: int = 0,
        prefetch: bool = False,
    ):
        if prefetch:
            raise NotImplementedError(
                "DataLoader(prefetch=True) needs the native batcher, which "
                "is not ported yet (ROADMAP Queue 1 item 13)")
        self.data = data
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.num_shards = num_shards
        self.shard_index = shard_index
        self._epoch = 0
        self._stream = callable(data)
        if self._stream:
            self._n = None
            return
        leaves = _leaves(data)
        if not leaves:
            raise ValueError("empty dataset")
        self._n = len(leaves[0])
        for leaf in leaves:
            if len(leaf) != self._n:
                raise ValueError("all arrays must share leading dim")

    def set_epoch(self, epoch: int) -> None:
        """DistributedSampler.set_epoch parity: reshuffles per epoch."""
        self._epoch = epoch

    def __len__(self) -> int:
        if self._stream:
            raise TypeError("streaming DataLoader has no length")
        n = self._n // self.num_shards
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self) -> Iterator[Any]:
        if self._stream:
            epoch, self._epoch = self._epoch, self._epoch + 1
            yield from self.data(epoch)
            return
        idx = np.arange(self._n)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self._epoch)
            rng.shuffle(idx)
        # contiguous equal-size shard per process (the DistributedSampler
        # analog; remainder examples are dropped)
        if self.num_shards > 1:
            per = self._n // self.num_shards
            shard = idx[self.shard_index * per:(self.shard_index + 1) * per]
        else:
            shard = idx
        n = len(shard)
        stop = n - n % self.batch_size if self.drop_last else n
        for start in range(0, stop, self.batch_size):
            yield _tree_take(self.data, shard[start:start + self.batch_size])
        self._epoch += 1


class DataModule:
    """Optional Lightning-style data container."""

    def setup(self) -> None: ...

    def train_dataloader(self) -> Iterable: ...

    def val_dataloader(self) -> Optional[Iterable]:
        return None

    def test_dataloader(self) -> Optional[Iterable]:
        return None

    def predict_dataloader(self) -> Optional[Iterable]:
        return None


def _leaves(data):
    if isinstance(data, dict):
        return list(data.values())
    if isinstance(data, (tuple, list)):
        return list(data)
    return [data]


def _tree_take(data, idx):
    if isinstance(data, dict):
        return {k: np.asarray(v)[idx] for k, v in data.items()}
    if isinstance(data, (tuple, list)):
        return type(data)(np.asarray(v)[idx] for v in data)
    return np.asarray(data)[idx]
