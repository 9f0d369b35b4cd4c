"""The port's lock-order watcher (`ray_lightning_tpu_torch/analysis/
lockwatch.py`), held against the JAX package's cases
(`tests/test_lockwatch.py`) and its lock surface.

The tests drive ``_SanLock`` directly (arming is decided at ``san_lock()``
call time from the environment) around a snapshot of the process-global
order graph, so the suite's real observations survive them. Then the
surface: every JAX ``san_lock("...")`` name is a ``san_lock`` of the port
(collected from both trees by AST) but those listed in ``NO_TWIN`` with
their reason, and under ``RLT_LOCKWATCH=1`` (set for the whole suite by
``tests/conftest.py``) the port's named locks are the watcher's.
Discrete checks: equality.
"""
from __future__ import annotations

import ast
import os
import threading
import time

import pytest

from ray_lightning_tpu.analysis import lockwatch as jax_lockwatch
from ray_lightning_tpu_torch.analysis import lockwatch
from ray_lightning_tpu_torch.analysis.lockwatch import (
    NO_TWIN,
    _SanLock,
    assert_lockwatch_clean,
    lockwatch_armed,
    lockwatch_cycles,
    lockwatch_findings,
    san_lock,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def fresh_watch():
    """An empty order graph for the test; the suite's real observations
    (and this thread's held stack) restored after it."""
    with lockwatch._META:
        order = {k: dict(v) for k, v in lockwatch._ORDER.items()}
        found = list(lockwatch._FINDINGS)
        cycles = list(lockwatch._CYCLES)
    lockwatch.reset_lockwatch()
    try:
        yield
    finally:
        with lockwatch._META:
            lockwatch._ORDER.clear()
            lockwatch._ORDER.update(order)
            lockwatch._FINDINGS[:] = found
            lockwatch._CYCLES[:] = cycles
        if getattr(lockwatch._TLS, "stack", None):
            lockwatch._TLS.stack = []


def test_armed_and_disarmed_factory(monkeypatch):
    monkeypatch.setenv("RLT_LOCKWATCH", "1")
    assert lockwatch_armed() and jax_lockwatch.lockwatch_armed()
    assert isinstance(san_lock("lwt.factory"), _SanLock)
    monkeypatch.setenv("RLT_LOCKWATCH", "0")
    assert not lockwatch_armed() and not jax_lockwatch.lockwatch_armed()
    lk = san_lock("lwt.plain")
    assert not isinstance(lk, _SanLock)
    assert type(lk) is type(threading.Lock())
    with lk:  # a real lock, zero wrapper
        pass
    rlk = san_lock("lwt.plain.r", reentrant=True)
    with rlk:
        with rlk:
            pass


def _both(body):
    """Run ``body(lock_class)`` against the port's watcher and the JAX
    one, each on an empty graph, and return both (cycles, findings'
    (rule, symbol)) readings."""
    out = []
    for mod in (lockwatch, jax_lockwatch):
        with mod._META:
            saved = ({k: dict(v) for k, v in mod._ORDER.items()},
                     list(mod._FINDINGS), list(mod._CYCLES))
        mod.reset_lockwatch()
        try:
            body(mod._SanLock)
            out.append(([sorted(set(c)) for c in mod.lockwatch_cycles()],
                        sorted((f.rule, f.symbol or "")
                               for f in mod.lockwatch_findings())))
        finally:
            with mod._META:
                mod._ORDER.clear()
                mod._ORDER.update(saved[0])
                mod._FINDINGS[:] = saved[1]
                mod._CYCLES[:] = saved[2]
            mod._TLS.stack = []
    return out


def _inversion(L):
    a, b = L("LWT_A"), L("LWT_B")
    with a:
        with b:
            pass
    with b:
        with a:
            pass


def _consistent(L):
    a, b, c = L("LWT_1"), L("LWT_2"), L("LWT_3")
    for _ in range(3):
        with a:
            with b:
                with c:
                    pass


def _by_name(L):
    with L("LWT_N1"):
        with L("LWT_N2"):
            pass
    with L("LWT_N2"):  # fresh instances, same names
        with L("LWT_N1"):
            pass


def _self_deadlock(L):
    a = L("LWT_SELF")
    a.acquire()
    with pytest.raises(RuntimeError, match="re-acquired non-reentrant"):
        a.acquire()
    a.release()


def _reentrant(L):
    r = L("LWT_R", reentrant=True)
    with r:
        with r:
            assert r._is_owned()
    assert not r._is_owned()


@pytest.mark.parametrize("case", [_inversion, _consistent, _by_name,
                                  _self_deadlock, _reentrant],
                         ids=lambda f: f.__name__.strip("_"))
def test_watcher_reads_as_jax(case):
    """A cycle from ONE execution order, a consistent order, identity by
    name, the self-deadlock raise, reentrant nesting: the port's watcher
    reports what the JAX one does."""
    port, jax = _both(case)
    assert port == jax
    if case is _inversion or case is _by_name:
        assert len(port[0]) == 1


def test_cycle_is_reported_and_assert_raises(fresh_watch):
    _inversion(_SanLock)
    f = [f for f in lockwatch_findings() if f.rule == "RLT702"]
    assert len(f) == 1 and "cycle" in f[0].message
    assert set(lockwatch_cycles()[0]) == {"LWT_A", "LWT_B"}
    with pytest.raises(AssertionError, match="lock-order cycle"):
        assert_lockwatch_clean()


def test_held_too_long_reports_rlt705(fresh_watch, monkeypatch):
    monkeypatch.setenv("RLT_LOCKWATCH_MAX_HOLD_S", "0.05")
    slow = _SanLock("LWT_SLOW")  # threshold read at construction
    with slow:
        time.sleep(0.08)
    f = [f for f in lockwatch_findings() if f.rule == "RLT705"]
    assert len(f) == 1
    assert "LWT_SLOW" in f[0].message and f[0].severity == "warning"
    # report-only: never a cycle, never a failure
    assert lockwatch_cycles() == []
    assert_lockwatch_clean()


def test_condition_protocol_over_san_lock(fresh_watch):
    """threading.Condition(san_lock(...)): wait() fully releases the
    watched lock (another thread can notify) and restores it after."""
    lk = _SanLock("LWT_CV")
    cv = threading.Condition(lk)
    hit = []

    def waiter():
        with cv:
            cv.wait(timeout=5)
            hit.append(lk._is_owned())

    t = threading.Thread(target=waiter)
    t.start()
    deadline = time.monotonic() + 5
    while time.monotonic() < deadline:
        with cv:
            if cv._waiters:
                cv.notify()
                break
        time.sleep(0.01)
    t.join(5)
    assert hit == [True]
    assert not lk._is_owned()
    assert lockwatch_findings() == []


def _san_names(pkg: str) -> set:
    """Every ``san_lock("<name>")`` literal in the package's source."""
    names = set()
    for root, dirs, files in os.walk(os.path.join(ROOT, pkg)):
        dirs[:] = [d for d in dirs if d != "analysis"]
        for fn in files:
            if not fn.endswith(".py"):
                continue
            tree = ast.parse(open(os.path.join(root, fn),
                                  encoding="utf-8").read())
            for node in ast.walk(tree):
                if (isinstance(node, ast.Call)
                        and getattr(node.func, "id", None) == "san_lock"
                        and node.args
                        and isinstance(node.args[0], ast.Constant)):
                    names.add(node.args[0].value)
    return names


def test_every_jax_lock_name_has_a_twin_or_a_reason():
    jax_names = _san_names("ray_lightning_tpu")
    port_names = _san_names("ray_lightning_tpu_torch")
    assert len(jax_names) == 16
    assert jax_names - port_names == set(NO_TWIN) == {"checkpoint.io.ck"}
    assert all(len(why) > 40 for why in NO_TWIN.values())
    # the port's own locks, in the same scheme
    assert port_names - jax_names == {"ops.build", "serve.channel"}


def test_the_suite_arms_the_port_locks():
    """``tests/conftest.py`` sets RLT_LOCKWATCH=1 before any import, so
    the port's module-level and instance locks are the watcher's, each
    under its name."""
    from ray_lightning_tpu_torch.checkpoint import io
    from ray_lightning_tpu_torch.native import _lib_lock
    from ray_lightning_tpu_torch.ops import build
    from ray_lightning_tpu_torch.resilience.health import HealthMonitor
    from ray_lightning_tpu_torch.sweep.resources import ResourcePool

    assert lockwatch_armed()
    for lock, name in ((io._META_LOCK, "checkpoint.io.meta"),
                       (_lib_lock, "native.lib"),
                       (build._lock, "ops.build"),
                       (HealthMonitor(1)._lock, "resilience.health.monitor"),
                       (ResourcePool(total_gpus=1)._lock,
                        "sweep.resources.pool")):
        assert isinstance(lock, _SanLock) and lock.name == name
    assert io._FIN_CV._lock is io._META_LOCK
