"""Data loading: host-side batch iterators (twin of
`ray_lightning_tpu/core/data.py`).

Batches are dicts (or tuples) of numpy arrays with a leading batch axis;
the strategy moves them to the device. ``drop_last`` defaults to True so
every step sees one shape. In a multi-process job each process yields
only its shard (the DistributedSampler semantics), which
`ensure_sharded` forces onto the loaders. ``prefetch=True`` assembles the
batches on the native batcher's threads (`ray_lightning_tpu_torch.native`),
in the same order and shapes; where it cannot be built the loader takes
the numpy path, logs why, and says so in ``native``.
"""
from __future__ import annotations

import logging
import os
from typing import Any, Iterable, Iterator, Optional

import numpy as np

log = logging.getLogger(__name__)


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
        num_workers: Optional[int] = None,
        sharded_externally: bool = False,
    ):
        self.data = data
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.num_shards = num_shards
        self.shard_index = shard_index
        self.prefetch = prefetch
        #: with ``prefetch``: None before the first epoch, then True when
        #: the native batcher assembles the batches, False when the
        #: loader fell back to the numpy path (the reason is logged)
        self.native: Optional[bool] = None
        self._num_workers = num_workers
        self._batcher = None
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

    @property
    def num_workers(self) -> int:
        """The native batcher's thread count, read when it is built, so a
        strategy's ``RLT_NUM_CPUS_PER_WORKER`` (`RayXlaPlugin(
        num_cpus_per_worker=)`) applies to a loader made before the fit."""
        if self._num_workers is not None:
            return max(1, self._num_workers)
        return max(1, int(os.environ.get("RLT_NUM_CPUS_PER_WORKER", 2)))

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
        if self.prefetch and (batcher := self._get_batcher()) is not None:
            # the batcher's threads assemble the batches ahead of the
            # loop: the numpy path's order and shapes
            batcher.set_epoch(shard)
            yield from batcher
            self._epoch += 1
            return
        n = len(shard)
        stop = n - n % self.batch_size if self.drop_last else n
        for start in range(0, stop, self.batch_size):
            yield _tree_take(self.data, shard[start:start + self.batch_size])
        self._epoch += 1

    def _get_batcher(self):
        """The native batcher, built on first use; None (and ``native``
        False) for data it cannot carry (not a dict of numeric numpy
        arrays) or when the library cannot be built."""
        if self._batcher is not None:
            return self._batcher
        from ray_lightning_tpu_torch.native import NativeBatcher

        if not isinstance(self.data, dict) or not all(
                isinstance(v, np.ndarray)
                and (np.issubdtype(v.dtype, np.number) or v.dtype == np.bool_)
                for v in self.data.values()):
            why = "the data is not a dict of numeric numpy arrays"
        else:
            try:
                # copies out of its slots (the JAX loader's mode): a
                # batch stays valid however long its consumer holds it
                self._batcher = NativeBatcher(
                    self.data, self.batch_size, drop_last=self.drop_last,
                    n_threads=self.num_workers)
                self.native = True
                return self._batcher
            except (RuntimeError, ValueError) as exc:
                why = str(exc)
        log.warning("DataLoader(prefetch=True): the numpy path, not the "
                    "native batcher (%s)", why)
        self.prefetch, self.native = False, False
        return None


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
