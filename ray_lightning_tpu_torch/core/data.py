"""Data loading: host-side batch iterators (twin of
`ray_lightning_tpu/core/data.py`).

Batches are dicts (or tuples) of numpy arrays with a leading batch axis;
the strategy moves them to the device. ``drop_last`` defaults to True so
every step sees one shape. In a multi-process job each process yields
only its shard (the DistributedSampler semantics), which
`ensure_sharded` forces onto the loaders. The native prefetching batcher
is not ported yet.
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
        sharded_externally: bool = False,
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
        #: ``data`` already holds or yields just THIS process's rows;
        #: `ensure_sharded` then leaves the loader alone
        self.sharded_externally = sharded_externally
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


class ThrottledLoader:
    """A loader with a fixed host delay a batch: the deliberately slow
    loader behind the prefetch evidence (pipeline/overlap.py, ``python
    -m ray_lightning_tpu_torch perf``), standing in for the decode and
    tokenisation time of a real input pipeline. Forwards ``set_epoch``
    and ``__len__``."""

    def __init__(self, inner: Any, delay_s: float):
        self.inner = inner
        self.delay_s = float(delay_s)

    def set_epoch(self, epoch: int) -> None:
        if hasattr(self.inner, "set_epoch"):
            self.inner.set_epoch(epoch)

    def __len__(self) -> int:
        return len(self.inner)

    def __iter__(self) -> Iterator[Any]:
        import time

        for batch in self.inner:
            if self.delay_s > 0:
                time.sleep(self.delay_s)
            yield batch


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


def resolve_loaders(module, data) -> tuple:
    """Accept a DataModule or (train, val) iterables and normalize."""
    if isinstance(data, DataModule):
        data.setup()
        return data.train_dataloader(), data.val_dataloader()
    return data, None


def ensure_sharded(loader: Any, num_shards: int, shard_index: int,
                   stage: str = "train") -> Any:
    """Force distributed shard semantics onto a loader (the reference's
    forced DistributedSampler, ray_ddp.py:293-303): forgetting them would
    have every process train on identical rows, silently.

    Returns the loader with ``num_shards``/``shard_index`` set. Raises on
    anything it cannot make safe:
      * a `DataLoader` already sharded differently;
      * a streaming `DataLoader`, unless constructed with
        ``sharded_externally=True``;
      * a plain iterable (list/generator), which has no shard handle.
    """
    if loader is None or num_shards <= 1:
        return loader
    if isinstance(loader, DataLoader):
        if loader.sharded_externally:
            return loader
        if loader._stream:
            raise ValueError(
                f"streaming {stage} DataLoader in a {num_shards}-process "
                "job: the data callable is opaque, so per-process "
                "sharding cannot be injected. Make the callable yield "
                "only this process's rows (torch.distributed.get_rank()) "
                "and construct the DataLoader with sharded_externally=True."
            )
        if loader.num_shards == 1:
            loader.num_shards = num_shards
            loader.shard_index = shard_index
            return loader
        if (loader.num_shards == num_shards
                and loader.shard_index == shard_index):
            return loader
        raise ValueError(
            f"{stage} DataLoader is sharded {loader.shard_index}/"
            f"{loader.num_shards} but this job runs as process "
            f"{shard_index}/{num_shards}. Drop the manual num_shards/"
            "shard_index arguments (the distributed launcher injects "
            "them) or make them match the job."
        )
    raise TypeError(
        f"{stage} data in a {num_shards}-process job must be a "
        f"ray_lightning_tpu_torch DataLoader (got {type(loader).__name__}): "
        "a plain iterable has no shard handle, so every process would "
        "train on identical rows. Wrap the data in DataLoader(...)."
    )
