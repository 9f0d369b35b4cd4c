"""Worker-local session registry: rank + report side channel (twin of
`ray_lightning_tpu/runtime/session.py`).

Rebuild of the reference's per-worker singleton
(reference ray_lightning/session.py:1-63): callbacks running deep inside
the fit loop need the worker's rank and a handle to the driver-bound
queue without those being plumbed through every call.

The "queue" is the worker's channel back to the driver (bound by
runtime/worker.py before user code runs); items are tagged with the
sending rank and, if callable, executed driver-side by the pump's
trampoline (reference util.py:88-93). Items cross by the standard
`pickle`, so a callable item must be picklable by reference (a
module-level function, a `functools.partial` of one, or an instance of
a module-level class).
"""
from __future__ import annotations

from typing import Any, Optional


class TpuSession:
    def __init__(self, rank: int, world_size: int, queue: Optional[Any],
                 started_at: Optional[float] = None):
        self.rank = rank
        self.world_size = world_size
        self.queue = queue
        #: wall-clock of worker-process start
        self.started_at = started_at

    def put_queue(self, item: Any) -> None:
        if self.queue is None:
            raise ValueError(
                "this session has no report queue attached "
                "(reference analog: session.py:21-24)")
        self.queue.put_queue(item)


_session: Optional[TpuSession] = None


def init_session(rank: int, world_size: int = 1, queue: Optional[Any] = None,
                 started_at: Optional[float] = None,
                 _overwrite: bool = True) -> None:
    """Bind the process-global session. Re-binding is allowed so a worker
    process can be reused across execs; pass _overwrite=False for the
    reference's strict behavior (session.py:30-36)."""
    global _session
    if _session is not None and not _overwrite:
        raise ValueError("a session already exists in this process")
    _session = TpuSession(rank, world_size, queue, started_at=started_at)


def get_session() -> Optional[TpuSession]:
    return _session


def reset_session() -> None:
    global _session
    _session = None


def is_session_enabled() -> bool:
    """True iff running inside a runtime worker."""
    return _session is not None


def get_actor_rank() -> int:
    """Rank of this worker (reference session.py:56-58)."""
    if _session is None:
        raise RuntimeError("init_session must be called first")
    return _session.rank


def get_world_size() -> int:
    if _session is None:
        raise RuntimeError("init_session must be called first")
    return _session.world_size


def put_queue(item: Any) -> None:
    """Ship an item to the driver's pump (reference session.py:61-63).
    Callables are executed driver-side — the tune.report trampoline."""
    if _session is None:
        raise RuntimeError("init_session must be called first")
    _session.put_queue(item)
