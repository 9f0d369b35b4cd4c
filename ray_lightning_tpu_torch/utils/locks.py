"""Named locks for the telemetry recorders (the port's own copy of
`ray_lightning_tpu/analysis/lockwatch.py` ``san_lock``).

The JAX package's factory hands out an order-watching wrapper when its
sanitizer is armed; the watcher is not ported (ROADMAP Queue 1 item
13), so here every call returns a plain lock. The name stays at each
call site so that arming a watcher later changes this module alone.
"""
from __future__ import annotations

import threading


def san_lock(name: str) -> threading.Lock:
    """A lock for the subsystem ``name`` (the lock-order watcher's key;
    unused until the watcher is ported)."""
    del name
    return threading.Lock()
