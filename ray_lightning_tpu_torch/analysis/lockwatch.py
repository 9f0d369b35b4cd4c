"""lockwatch — runtime lock-order sanitizer (the dynamic half of
threadcheck; twin of `ray_lightning_tpu/analysis/lockwatch.py`).

``san_lock(name)`` is a drop-in ``threading.Lock`` factory the
port's subsystems use for every long-lived lock. Disarmed (the
default), it returns a *plain* ``threading.Lock``/``RLock`` — zero
wrapper, zero overhead, decided once at creation time. Under
``RLT_LOCKWATCH=1`` it returns a ``_SanLock`` that, on every
acquisition:

* records the per-thread stack of held san-locks,
* adds edges held-lock -> acquiring-lock to a process-global order
  graph and reports a **RLT702** finding the moment a cycle appears
  (the deadlock is diagnosed from ONE execution order — the opposite
  interleaving never has to happen),
* raises instead of deadlocking on a same-thread re-acquire of a
  non-reentrant lock,
* reports **RLT705** when a lock was held longer than
  ``RLT_LOCKWATCH_MAX_HOLD_S`` seconds (default: off).

Lock identity is the NAME, not the instance: every per-request
``san_lock("serve.driver.batch")`` is one node in the order graph, the
way kernel lockdep classes locks — orders must hold for the class, not
for the specific object the test happened to build.

Findings reuse the analysis Finding schema (rule ids RLT702/RLT705), so
the sanitizer's report and the static threadcheck report read the same.
``tests/conftest.py`` sets ``RLT_LOCKWATCH=1`` for the whole test suite,
so the port's locks are watched there too; ``chip_smoke.py`` arms it
before it imports the port and fails its run on any recorded cycle.
Child processes inherit the variable and arm themselves.

``threading.Condition(san_lock(...))`` works: ``_SanLock`` implements
the ``_is_owned``/``_release_save``/``_acquire_restore`` protocol
Condition probes for, with bookkeeping kept consistent across
``wait()`` (the wait window does not count toward held-too-long — the
lock really is released).

Imports neither torch nor numpy.
"""
from __future__ import annotations

import os
import sys
import threading
import time
from typing import Dict, List, Optional, Set, Tuple, Union

from ray_lightning_tpu_torch.analysis.findings import Finding

__all__ = [
    "san_lock", "lockwatch_armed", "lockwatch_findings",
    "lockwatch_cycles", "lockwatch_order", "reset_lockwatch",
    "assert_lockwatch_clean",
]

#: names of the JAX package's san_locks with no twin in the port, and why
NO_TWIN = {
    "checkpoint.io.ck": (
        "the JAX lock serializes orbax's StandardCheckpointer, whose wait "
        "nulls its one commit-thread handle (a wait racing a new save "
        "could lose the new write's handle); the port saves through DCP, "
        "whose async_save returns a Future a save, safe to wait on from "
        "any thread, with no shared handle to lose"),
}

# process-global sanitizer state; _META is a plain lock (the watcher
# must not watch itself)
_META = threading.Lock()
#: order graph: name -> {successor-name: "file:line" of first sighting}
_ORDER: Dict[str, Dict[str, str]] = {}
_FINDINGS: List[Finding] = []
_CYCLES: List[Tuple[str, ...]] = []
_TLS = threading.local()


def lockwatch_armed() -> bool:
    return os.environ.get("RLT_LOCKWATCH", "") not in ("", "0")


def san_lock(name: str, reentrant: bool = False):
    """A named lock. Disarmed: a raw threading.Lock/RLock (decided at
    creation — arm the env var before the module creating the lock is
    imported). Armed: an order-watching wrapper."""
    if not lockwatch_armed():
        return threading.RLock() if reentrant else threading.Lock()
    return _SanLock(name, reentrant=reentrant)


def _stack() -> list:
    st = getattr(_TLS, "stack", None)
    if st is None:
        st = _TLS.stack = []
    return st


def _site(depth: int = 2) -> str:
    """Caller's file:line, skipping lockwatch frames."""
    try:
        f = sys._getframe(depth)
        while f is not None and f.f_code.co_filename == __file__:
            f = f.f_back
        if f is None:
            return "<unknown>"
        return f"{os.path.basename(f.f_code.co_filename)}:{f.f_lineno}"
    except Exception:  # pragma: no cover - _getframe always exists on CPython
        return "<unknown>"


def _find_cycle(start: str, goal: str) -> Optional[Tuple[str, ...]]:
    """Path start ->* goal in _ORDER (callers hold _META)."""
    seen: Set[str] = set()
    path: List[str] = []

    def dfs(n: str) -> bool:
        if n == goal:
            path.append(n)
            return True
        if n in seen:
            return False
        seen.add(n)
        for m in _ORDER.get(n, ()):
            if dfs(m):
                path.append(n)
                return True
        return False

    return tuple(reversed(path)) if dfs(start) else None


def _record(finding: Finding) -> None:
    with _META:
        _FINDINGS.append(finding)


class _HeldEntry:
    __slots__ = ("lock", "t0", "depth", "site")

    def __init__(self, lock: "_SanLock", site: str):
        self.lock = lock
        self.t0 = time.monotonic()
        self.depth = 1
        self.site = site


class _SanLock:
    """Order-watching lock wrapper; see module docstring."""

    def __init__(self, name: str, reentrant: bool = False):
        self.name = name
        self.reentrant = reentrant
        self._inner = threading.RLock() if reentrant else threading.Lock()
        hold = os.environ.get("RLT_LOCKWATCH_MAX_HOLD_S", "")
        try:
            self.max_hold_s: Optional[float] = float(hold) if hold else None
        except ValueError:
            self.max_hold_s = None

    def __repr__(self):
        return f"<san_lock {self.name!r} reentrant={self.reentrant}>"

    # ---- lock protocol ---------------------------------------------------

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        st = _stack()
        mine = next((e for e in st if e.lock is self), None)
        site = _site()
        if mine is not None and not self.reentrant:
            _record(Finding(
                rule="RLT702",
                message=(f"same-thread re-acquire of non-reentrant lock "
                         f"`{self.name}` (first taken at {mine.site}) — "
                         f"this would deadlock; lockwatch raised instead"),
                file=site.split(":")[0], line=_int_line(site),
                symbol=self.name))
            raise RuntimeError(
                f"lockwatch: thread {threading.current_thread().name} "
                f"re-acquired non-reentrant san_lock({self.name!r}) "
                f"(first taken at {mine.site})")
        if mine is None:
            self._note_edges(st, site)
        ok = self._inner.acquire(blocking, timeout) if timeout != -1 \
            else self._inner.acquire(blocking)
        if not ok:
            return False
        if mine is not None:
            mine.depth += 1
        else:
            st.append(_HeldEntry(self, site))
        return True

    def release(self) -> None:
        st = _stack()
        mine = next((e for e in reversed(st) if e.lock is self), None)
        if mine is not None:
            mine.depth -= 1
            if mine.depth == 0:
                st.remove(mine)
                held = time.monotonic() - mine.t0
                if self.max_hold_s is not None and held > self.max_hold_s:
                    _record(Finding(
                        rule="RLT705",
                        message=(f"lock `{self.name}` held for "
                                 f"{held:.3f}s (> RLT_LOCKWATCH_MAX_HOLD_S="
                                 f"{self.max_hold_s}) — acquired at "
                                 f"{mine.site}"),
                        severity="warning", symbol=self.name))
        self._inner.release()

    def locked(self) -> bool:
        inner = self._inner
        return inner.locked() if hasattr(inner, "locked") else False

    __enter__ = acquire

    def __exit__(self, *exc):
        self.release()

    # ---- Condition protocol ----------------------------------------------

    def _is_owned(self) -> bool:
        return any(e.lock is self for e in _stack())

    def _release_save(self):
        """Condition.wait: fully release (even a reentrant depth>1 hold);
        returns the depth to restore."""
        st = _stack()
        mine = next((e for e in reversed(st) if e.lock is self), None)
        depth = mine.depth if mine is not None else 1
        for _ in range(depth):
            self.release()
        return depth

    def _acquire_restore(self, depth) -> None:
        for _ in range(depth):
            self.acquire()

    # ---- order graph ------------------------------------------------------

    def _note_edges(self, st: list, site: str) -> None:
        held_names = []
        for e in st:
            if e.lock.name != self.name and e.lock.name not in held_names:
                held_names.append(e.lock.name)
        if not held_names:
            return
        with _META:
            for h in held_names:
                succ = _ORDER.setdefault(h, {})
                if self.name in succ:
                    continue
                # new edge h -> self: a cycle exists iff self already
                # reaches h
                cycle = _find_cycle(self.name, h)
                succ[self.name] = site
                if cycle is None:
                    continue
                key = tuple(sorted(set(cycle)))
                if any(tuple(sorted(set(c))) == key for c in _CYCLES):
                    continue
                _CYCLES.append(cycle)
                hops = " -> ".join(cycle + (cycle[0],))
                _FINDINGS.append(Finding(
                    rule="RLT702",
                    message=(f"runtime lock-order cycle observed: {hops} "
                             f"(edge `{h}` -> `{self.name}` closed the "
                             f"cycle at {site}) — the opposite "
                             f"interleaving deadlocks"),
                    symbol=self.name))


def _int_line(site: str) -> Optional[int]:
    try:
        return int(site.rsplit(":", 1)[1])
    except (IndexError, ValueError):
        return None


# ---- reporting API ---------------------------------------------------------

def lockwatch_findings() -> List[Finding]:
    with _META:
        return list(_FINDINGS)


def lockwatch_cycles() -> List[Tuple[str, ...]]:
    with _META:
        return list(_CYCLES)


def lockwatch_order() -> List[Tuple[str, str, str]]:
    """The order graph observed so far: (held, then acquired, the
    "file:line" of its first sighting) for every edge."""
    with _META:
        return [(h, a, site) for h, succ in sorted(_ORDER.items())
                for a, site in sorted(succ.items())]


def reset_lockwatch() -> None:
    """Clear the order graph and findings (test isolation)."""
    with _META:
        _ORDER.clear()
        _FINDINGS.clear()
        _CYCLES.clear()


def assert_lockwatch_clean() -> None:
    """Raise AssertionError when any lock-order cycle was observed."""
    cycles = lockwatch_cycles()
    if cycles:
        lines = "\n".join(
            f.format() for f in lockwatch_findings() if f.rule == "RLT702")
        raise AssertionError(
            f"lockwatch observed {len(cycles)} lock-order cycle(s):\n"
            f"{lines}")
