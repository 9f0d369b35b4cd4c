"""Device prefetch: place the next batches while the step runs (twin of
`ray_lightning_tpu/pipeline/prefetch.py`).

The synchronous loop assembles a batch on the host, copies it to the
card, then enqueues the step; the card finishes the previous step while
the host copies, but the next step cannot be enqueued before its input
is there. `DevicePrefetcher` is the bounded N-buffer stage: one producer
thread pulls host batches from the iterator, runs the caller's
``place_fn`` (the strategy's placement, the trainer's accumulation
split) and parks up to ``depth`` placed batches in a bounded queue, so
the consumer's ``next()`` usually returns a batch whose copy was issued
a step ago.

On a card the producer issues its copies on a side CUDA stream of its
own (``torch.cuda.set_device`` first: the current device and stream are
per thread) from pinned host memory (`Strategy.shard_batch` pins), and
records an event after them. The consumer's stream waits on that event
before the step reads the batch, and every placed tensor is marked
``record_stream`` on the consumer's stream: the caching allocator must
not hand the batch's memory back to the side stream while the step
still reads it.

The JAX contracts, kept:

  * ORDER: batches come out in iterator order (one producer, a FIFO
    queue), so training is bitwise that of the synchronous path.
  * BACKPRESSURE: at most ``depth`` placed batches plus the one in the
    producer's hands exist at any time.
  * SHUTDOWN: ``close()`` (exhaustion and the context manager call it)
    stops and joins the producer; a mid-epoch ``break`` leaks no
    thread. Idempotent.
  * ERRORS: an exception on the producer side is re-raised at the
    consumer's ``next()``.
  * METRICS: `stats` counts the batches the consumer found waiting
    (`occupancy`) and the time it blocked (`wait_s`).
"""
from __future__ import annotations

import logging
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Iterable, Iterator, Optional

from ray_lightning_tpu_torch.telemetry.spans import (
    NULL_RECORDER,
    PH_DATA_WAIT,
    PH_H2D,
    THREAD_PRODUCER,
)

log = logging.getLogger(__name__)


@dataclass
class PrefetchStats:
    """Occupancy accounting for one prefetcher's lifetime."""

    batches: int = 0      # batches handed to the consumer
    hits: int = 0         # ...that were already buffered (no wait)
    wait_s: float = 0.0   # total consumer time blocked on the queue
    put_wait_s: float = 0.0  # total producer time blocked (backpressure)
    _depth: int = field(default=0, repr=False)

    @property
    def occupancy(self) -> float:
        """Share of batches served without blocking: 1.0 means the step
        never waited for its input, 0.0 no overlap at all."""
        return self.hits / self.batches if self.batches else 0.0

    def to_metrics(self) -> dict:
        return {
            "prefetch_batches": float(self.batches),
            "prefetch_occupancy": self.occupancy,
            "prefetch_wait_s": self.wait_s,
            "prefetch_depth": float(self._depth),
        }


class _Stop:
    """Queue sentinel: normal end of the source iterator."""


class _Raise:
    """Queue sentinel carrying a producer-side exception."""

    def __init__(self, exc: BaseException):
        self.exc = exc


def _cuda_tensors(tree: Any) -> list:
    """The CUDA tensors of a placed batch (dicts, tuples, lists)."""
    import torch

    if isinstance(tree, torch.Tensor):
        return [tree] if tree.is_cuda else []
    if isinstance(tree, dict):
        tree = tree.values()
    elif not isinstance(tree, (tuple, list)):
        return []
    return [t for v in tree for t in _cuda_tensors(v)]


class DevicePrefetcher(Iterable[Any]):
    """Iterate ``source`` with ``place_fn`` applied ``depth`` batches
    ahead on a producer thread.

    ``device``: the CUDA device the batches land on, whose side stream
    the producer copies on; None (or the CPU) places on the producer
    thread with no stream work. ``depth`` >= 1 bounds the buffer (2, the
    double buffer, is the trainer's default).
    """

    def __init__(self, source: Iterable[Any],
                 place_fn: Callable[[Any], Any],
                 depth: int = 2, name: str = "rlt-prefetch",
                 recorder: Any = None, device: Any = None):
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {depth}")
        import torch

        self.depth = depth
        #: telemetry recorder: h2d spans from the producer thread (tagged
        #: so goodput never charges them to the main thread) and
        #: data_wait spans when the consumer actually blocked
        self._recorder = recorder or NULL_RECORDER
        self.stats = PrefetchStats(_depth=depth)
        self._device = (torch.device(device) if device is not None
                        else None)
        self._cuda = self._device is not None and self._device.type == "cuda"
        if self._cuda and self._device.index is None:
            # the consumer's current card, which the producer thread must
            # make its own (a bare "cuda" names no card)
            self._device = torch.device("cuda", torch.cuda.current_device())
        self._source = iter(source)
        self._place = place_fn
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._closed = False
        self._thread = threading.Thread(
            target=self._produce, name=name, daemon=True)
        self._thread.start()

    # ---- producer --------------------------------------------------------

    def _produce(self) -> None:
        try:
            stream = None
            if self._cuda:
                import torch

                torch.cuda.set_device(self._device)
                stream = torch.cuda.Stream(self._device)
            for item in self._source:
                if self._stop.is_set():
                    return
                with self._recorder.span(PH_H2D, thread=THREAD_PRODUCER):
                    placed = self._place_one(item, stream)
                # a bounded put with a timeout poll, so close() can always
                # unblock the producer
                t0 = time.perf_counter()
                while not self._stop.is_set():
                    try:
                        self._q.put(placed, timeout=0.05)
                        break
                    except queue.Full:
                        continue
                self.stats.put_wait_s += time.perf_counter() - t0
            self._final_put(_Stop())
        except BaseException as exc:  # noqa: BLE001 — carried to consumer
            self._final_put(_Raise(exc))

    def _place_one(self, item: Any, stream) -> Any:
        """(placed batch, the event its copies complete at or None)."""
        if stream is None:
            return self._place(item), None
        import torch

        with torch.cuda.stream(stream):
            placed = self._place(item)
            ready = torch.cuda.Event()
            ready.record(stream)
        return placed, ready

    def _final_put(self, sentinel: Any) -> None:
        while not self._stop.is_set():
            try:
                self._q.put(sentinel, timeout=0.05)
                return
            except queue.Full:
                continue

    # ---- consumer --------------------------------------------------------

    def __iter__(self) -> Iterator[Any]:
        return self

    def __next__(self) -> Any:
        if self._closed:
            raise StopIteration
        hit = not self._q.empty()
        t0 = time.perf_counter()
        item = self._q.get()
        waited = time.perf_counter() - t0
        if isinstance(item, _Stop):
            self.close()
            raise StopIteration
        if isinstance(item, _Raise):
            self.close()
            raise item.exc
        placed, ready = item
        if ready is not None:
            import torch

            consumer = torch.cuda.current_stream(self._device)
            consumer.wait_event(ready)
            for t in _cuda_tensors(placed):
                # allocated on the side stream, read on this one
                t.record_stream(consumer)
        self.stats.batches += 1
        if hit:
            self.stats.hits += 1
        else:
            self.stats.wait_s += waited
            # the step's input was not there when the loop asked: the
            # span behind a goodput data_wait bucket
            self._recorder.record(PH_DATA_WAIT, t0, waited)
        return placed

    # ---- lifecycle -------------------------------------------------------

    def close(self) -> None:
        """Stop the producer and join it; safe to call repeatedly and
        from ``finally`` blocks. Buffered batches are dropped."""
        if self._closed:
            return
        self._closed = True
        self._stop.set()
        # drain so a producer blocked in put() sees the stop flag promptly
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5.0)
        if self._thread.is_alive():
            # a placement wedged for more than 5 s: do not hang the
            # trainer's exit on it, but never hide the leak either
            log.warning(
                "prefetch producer %r still alive after close(); a "
                "placement call is wedged (the thread is a daemon and "
                "will not block process exit)", self._thread.name)

    def __enter__(self) -> "DevicePrefetcher":
        return self

    def __exit__(self, *exc) -> Optional[bool]:
        self.close()
        return None


def prefetch_to_device(source: Iterable[Any],
                       place_fn: Callable[[Any], Any],
                       depth: int = 2, recorder: Any = None,
                       device: Any = None) -> Iterable[Any]:
    """Functional form: ``depth <= 0`` is the synchronous pipeline (place
    inline on the calling thread, no stream, no thread), so a call site
    switches with one knob. There the placement blocks the main thread
    and its h2d span is a main-thread span."""
    if depth <= 0:
        rec = recorder or NULL_RECORDER

        def _sync():
            for item in source:
                with rec.span(PH_H2D):
                    placed = place_fn(item)
                yield placed
        return _sync()
    return DevicePrefetcher(source, place_fn, depth=depth,
                            recorder=recorder, device=device)
