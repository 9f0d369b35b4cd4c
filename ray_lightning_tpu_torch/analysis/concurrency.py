"""threadcheck — host-side concurrency static analyzer (RLT7xx; twin of
`ray_lightning_tpu/analysis/concurrency.py`, framework-free, so a
faithful port).

The host side around the step is a real threaded system: a prefetch
producer, an async checkpoint finalizer, heartbeat/report threads,
accept loops, replica drivers. threadcheck audits that layer the way the
linter audits step code — whole-package AST pass, same Finding
vocabulary, same `# rlt: disable=` suppression syntax.

Thread model (what the analyzer actually proves):

* **thread-reachable code** — every ``threading.Thread(target=X)`` is
  resolved (bare name, ``self.method``, nested def, lambda) and the
  target's same-file call graph is closed over a fixpoint, exactly like
  the linter's traced-set propagation. Anything in that closure runs
  off the spawning thread.
* **guarded-by sets** — the stack of ``with <lock>:`` statements
  lexically enclosing a statement. A "lock" is an expression whose
  initializer is a known lock constructor (``threading.Lock/RLock/
  Condition/Semaphore``, ``analysis.lockwatch.san_lock``, whichever
  package it is imported from: the constructor's last name decides) or
  whose name
  says so (``*lock*``, ``*cond*``, ``*mutex*``, ``*cv*``).
  ``Condition(underlying)`` aliases to the underlying lock.
* **lock identity** — ``san_lock("name")`` locks are identified by
  their name package-wide; anonymous locks by ``file:Class.attr``.
  The RLT702 acquisition graph (edge A->B = B acquired while A held,
  through nested ``with`` chains *and* same-file calls) is merged
  across every file before cycle detection.

Rules:

* RLT701 unguarded-shared-mutation — ``self.X`` written in
  thread-reachable code and read/written outside it with no common
  lock. Sanctioned: attributes initialized to a synchronized carrier
  (``queue.Queue``, ``deque(maxlen=...)``, ``threading.Event``, locks),
  accesses in ``__init__`` or in the function that spawns the thread
  (they happen-before ``start()``).
* RLT702 lock-order-inversion — cycle in the package-wide acquisition
  graph.
* RLT703 thread-leak — started non-daemon thread with no ``join()``
  reachable for its binding.
* RLT704 signal-unsafe-handler — a ``signal.signal`` handler doing more
  than flag/``os.write``-class work (the bench.py/preempt.py flag-only
  discipline, enforced).
* RLT705 blocking-call-under-lock — sleep / thread join / subprocess /
  untimed queue op / file I/O while a lock is held. A lock whose every
  critical section is the same I/O (a dedicated append-serialization
  lock) is sanctioned: the hazard is a lock that also guards in-memory
  state.

Known limits (as the JAX analyzer's): resolution is
same-file (a thread target calling across modules is not followed);
``with``-based acquisition only (bare ``.acquire()`` is not tracked as
a guard); module-global races are out of scope for RLT701 (instance
attributes only). The runtime sanitizer (analysis/lockwatch.py) covers
the dynamic side of the same contract.

Imports neither torch nor numpy.
"""
from __future__ import annotations

import ast
import os
from typing import Dict, FrozenSet, List, Optional, Sequence, Set, Tuple

from ray_lightning_tpu_torch.analysis.findings import Finding
from ray_lightning_tpu_torch.analysis.linter import (
    _FileLint,
    _dotted,
    iter_python_files,
)

# ---- vocabulary ------------------------------------------------------------

#: constructors whose product is a lock (guard) — dotted suffixes
_LOCK_CTORS = {
    "Lock", "RLock", "Condition", "Semaphore", "BoundedSemaphore",
    "san_lock",
}
#: constructors whose product is its own synchronization — an attribute
#: initialized to one of these is sanctioned for RLT701
_SYNC_CTORS = _LOCK_CTORS | {
    "Queue", "SimpleQueue", "LifoQueue", "PriorityQueue",
    "Event", "Barrier", "local",
}
#: name heuristic for a with-expression that is a lock even when its
#: initializer is out of view (imported, built elsewhere)
_LOCKISH = ("lock", "mutex", "cond", "_cv")

#: receiver method calls that mutate the receiver (write, not read)
_MUTATORS = {
    "append", "appendleft", "add", "update", "pop", "popleft",
    "extend", "insert", "remove", "discard", "clear", "setdefault",
    "put", "put_nowait",
}

#: ops banned inside a signal handler (everything else — assignments,
#: os.write/os._exit, Event.set, arithmetic — is the sanctioned
#: flag-only discipline)
_HANDLER_BANNED_ATTRS = {
    "acquire", "flush", "sleep", "put", "get", "join", "start",
}
_HANDLER_BANNED_ROOTS = ("log", "logger", "logging", "subprocess")

#: blocking-call classes for RLT705
_IO_METHODS = {"write", "read", "readline", "readlines", "send", "recv",
               "sendall", "accept", "connect", "flush"}


def _self_chain(node: ast.AST) -> Optional[str]:
    """'a.b' for a self.a.b chain (root self stripped), else None."""
    d = _dotted(node)
    if d and d.startswith("self."):
        return d[len("self."):]
    return None


class _CFunc:
    """One function/method, with call edges for the reachability fixpoint."""

    __slots__ = ("node", "name", "qualname", "cls", "parent", "calls",
                 "thread", "spawner", "acquires", "blocking")

    def __init__(self, node, name: str, qualname: str, cls: Optional[str],
                 parent: Optional["_CFunc"]):
        self.node = node
        self.name = name
        self.qualname = qualname
        self.cls = cls
        self.parent = parent
        self.calls: Set[Tuple[str, str]] = set()   # ("self"|"name", name)
        self.thread = False      # in a thread target's call closure
        self.spawner = False     # constructs a Thread (pre-start publication)
        #: lock ids acquired in the body (directly; closed transitively
        #: by the file pass)
        self.acquires: Set[str] = set()
        #: transitive blocking calls: (klass, desc)
        self.blocking: Set[Tuple[str, str]] = set()


class _Access:
    __slots__ = ("cls", "chain", "write", "held", "func", "node")

    def __init__(self, cls, chain, write, held, func, node):
        self.cls = cls
        self.chain = chain
        self.write = write
        self.held: FrozenSet[str] = held
        self.func: _CFunc = func
        self.node = node


class _Spawn:
    __slots__ = ("node", "func", "daemon", "binding", "target_key")

    def __init__(self, node, func, daemon, binding, target_key):
        self.node = node
        self.func: _CFunc = func
        self.daemon = daemon            # True / False / None (absent)
        self.binding = binding          # "x" | "self.x" | None
        self.target_key = target_key    # ("self"|"name", name) | None


class _FileScan:
    """Everything one file contributes to the package-wide analysis."""

    def __init__(self, lint: _FileLint, relpath: str):
        self.lint = lint
        self.relpath = relpath
        self.funcs: List[_CFunc] = []
        self.by_name: Dict[str, List[_CFunc]] = {}
        self.by_method: Dict[Tuple[str, str], _CFunc] = {}
        self.accesses: List[_Access] = []
        self.spawns: List[_Spawn] = []
        self.joins: Set[str] = set()          # bindings with a .join() call
        self.daemon_sets: Set[str] = set()    # bindings with .daemon = True
        #: (handler_func_or_body, install_node)
        self.handlers: List[Tuple[object, ast.AST]] = []
        #: lock id -> constructor kind ("Lock"/"RLock"/...), when seen
        self.lock_kinds: Dict[str, str] = {}
        #: attr/name -> sanctioned-sync ctor name (RLT701 sanction)
        self.sync_attrs: Dict[Tuple[Optional[str], str], str] = {}
        #: attr/name -> san_lock("<name>") — the name IS the package-wide
        #: lock identity (shared with the runtime sanitizer)
        self.san_names: Dict[Tuple[Optional[str], str], str] = {}
        #: alias: (cls, chain) -> (cls, chain) — Condition(underlying)
        self.lock_alias: Dict[Tuple[Optional[str], str],
                              Tuple[Optional[str], str]] = {}
        #: (A, B, node) — B acquired (or blockingly entered) under A
        self.order_edges: List[Tuple[str, str, ast.AST]] = []
        #: candidate RLT705: (msg, node, lockid, klass)
        self.blocking_candidates: List[Tuple[str, ast.AST, str, str]] = []
        #: lock id -> list of per-section io flags (for the dedicated-
        #: I/O-lock sanction)
        self.lock_sections: Dict[str, List[bool]] = {}


# ---- pass 1: function table + initializer tables ---------------------------

class _Collector(ast.NodeVisitor):
    def __init__(self, scan: _FileScan):
        self.scan = scan
        self._cls: List[str] = []
        self._fn: List[_CFunc] = []

    def visit_ClassDef(self, node: ast.ClassDef):
        self._cls.append(node.name)
        self.generic_visit(node)
        self._cls.pop()

    def _handle_func(self, node):
        cls = self._cls[-1] if self._cls else None
        parent = self._fn[-1] if self._fn else None
        prefix = (parent.qualname + ".") if parent else (
            (cls + ".") if cls else "")
        fn = _CFunc(node, node.name, prefix + node.name, cls, parent)
        self.scan.funcs.append(fn)
        self.scan.by_name.setdefault(node.name, []).append(fn)
        if cls is not None and parent is None:
            self.scan.by_method[(cls, node.name)] = fn
        self._fn.append(fn)
        self.generic_visit(node)
        self._fn.pop()

    visit_FunctionDef = _handle_func
    visit_AsyncFunctionDef = _handle_func

    def visit_Call(self, node: ast.Call):
        if self._fn:
            d = _dotted(node.func)
            if d is not None:
                if d.startswith("self.") and "." not in d[5:]:
                    self._fn[-1].calls.add(("self", d[5:]))
                elif "." not in d:
                    self._fn[-1].calls.add(("name", d))
        self.generic_visit(node)

    def visit_Assign(self, node: ast.Assign):
        self._record_init(node.targets, node.value)
        self.generic_visit(node)

    def visit_AnnAssign(self, node: ast.AnnAssign):
        if node.value is not None:
            self._record_init([node.target], node.value)
        self.generic_visit(node)

    def _record_init(self, targets, value):
        """Track `x = threading.Lock()` / `self._q = queue.Queue()` /
        `self._cond = threading.Condition(self._lock)` initializers."""
        if not isinstance(value, ast.Call):
            return
        ctor = _dotted(value.func)
        if ctor is None:
            return
        last = ctor.rsplit(".", 1)[-1]
        cls = self._cls[-1] if self._cls else None
        for t in targets:
            chain = _self_chain(t)
            key = (cls, chain) if chain else (
                (None, t.id) if isinstance(t, ast.Name) else None)
            if key is None or key[1] is None:
                continue
            if last in _SYNC_CTORS:
                self.scan.sync_attrs[key] = last
            if last == "deque" and any(k.arg == "maxlen"
                                       for k in value.keywords):
                self.scan.sync_attrs[key] = "deque(maxlen)"
            if last == "Condition" and value.args:
                under = value.args[0]
                uchain = _self_chain(under)
                ukey = ((cls, uchain) if uchain else
                        ((None, under.id)
                         if isinstance(under, ast.Name) else None))
                if ukey is not None:
                    self.scan.lock_alias[key] = ukey
            if last in ("san_lock", "san_rlock") and value.args \
                    and isinstance(value.args[0], ast.Constant) \
                    and isinstance(value.args[0].value, str):
                self.scan.san_names[key] = value.args[0].value
            if last in _LOCK_CTORS:
                lid = _lock_id_for_key(self.scan, key, value)
                self.scan.lock_kinds[lid] = last


def _lock_id_for_key(scan: _FileScan, key, ctor_call=None) -> str:
    """Stable package-wide identity for a lock binding. san_lock names
    ARE the identity (that is the point of naming them); anonymous locks
    get a file-qualified one."""
    if ctor_call is not None:
        d = _dotted(ctor_call.func) or ""
        if d.rsplit(".", 1)[-1] in ("san_lock", "san_rlock"):
            if ctor_call.args and isinstance(ctor_call.args[0], ast.Constant) \
                    and isinstance(ctor_call.args[0].value, str):
                return ctor_call.args[0].value
    if key in scan.san_names:
        return scan.san_names[key]
    cls, chain = key
    if cls:
        return f"{scan.relpath}:{cls}.{chain}"
    return f"{scan.relpath}:{chain}"


# ---- pass 2: per-function body scan with a held-lock stack -----------------

class _BodyScan:
    """Walks one function body tracking the with-lock stack; collects
    accesses, order edges, blocking calls, spawns, joins, handlers."""

    def __init__(self, scan: _FileScan, fn: _CFunc):
        self.scan = scan
        self.fn = fn
        self.held: List[str] = []
        #: io-flag stack parallel to `held` (does the current section of
        #: each held lock contain blocking I/O?)
        self._section_io: List[List[bool]] = []

    # -- lock resolution --

    def _lock_id(self, expr: ast.AST) -> Optional[str]:
        d = _dotted(expr)
        if d is None:
            return None
        cls = self.fn.cls
        chain = _self_chain(expr)
        key = (cls, chain) if chain else (None, d)
        key = self.scan.lock_alias.get(key, key)
        known = (key in self.scan.sync_attrs
                 and self.scan.sync_attrs[key] in _LOCK_CTORS)
        last = key[1].rsplit(".", 1)[-1].lower()
        if not known and not any(t in last for t in _LOCKISH):
            return None
        return _lock_id_for_key(self.scan, key)

    # -- the walk --

    def run(self):
        for stmt in self.fn.node.body:
            self._stmt(stmt)

    def _stmt(self, node: ast.AST):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return  # scanned as its own _CFunc
        if isinstance(node, (ast.With, ast.AsyncWith)):
            self._with(node)
            return
        if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            self._assign(node)
            return
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.expr):
                self._expr(child)
            elif isinstance(child, ast.stmt):
                self._stmt(child)
            else:
                for sub in ast.iter_child_nodes(child):
                    if isinstance(sub, ast.expr):
                        self._expr(sub)
                    elif isinstance(sub, ast.stmt):
                        self._stmt(sub)

    def _with(self, node):
        new: List[str] = []
        for item in node.items:
            lid = self._lock_id(item.context_expr)
            if lid is not None:
                for h in self.held:
                    self.scan.order_edges.append((h, lid, item.context_expr))
                self.fn.acquires.add(lid)
                new.append(lid)
            else:
                self._expr(item.context_expr)
        for lid in new:
            self.held.append(lid)
            self._section_io.append([False])
        for stmt in node.body:
            self._stmt(stmt)
        for lid in reversed(new):
            self.held.pop()
            io_flag = self._section_io.pop()
            self.scan.lock_sections.setdefault(lid, []).append(io_flag[0])

    def _assign(self, node):
        targets = (node.targets if isinstance(node, ast.Assign)
                   else [node.target])
        for t in targets:
            self._store_target(t)
        if getattr(node, "value", None) is not None:
            self._expr(node.value)

    def _store_target(self, t: ast.AST):
        chain = _self_chain(t)
        if chain is not None and isinstance(t, ast.Attribute):
            self._access(chain, write=True, node=t)
            return
        if isinstance(t, ast.Subscript):
            chain = _self_chain(t.value)
            if chain is not None:
                self._access(chain, write=True, node=t)
            else:
                self._expr(t.value)
            self._expr(t.slice)
            return
        if isinstance(t, (ast.Tuple, ast.List)):
            for el in t.elts:
                self._store_target(el)
            return
        if isinstance(t, ast.Attribute) and isinstance(t.value, ast.Name):
            # t.daemon = True on a local thread binding
            if t.attr == "daemon":
                self.scan.daemon_sets.add(t.value.id)

    def _expr(self, node: ast.AST):
        if isinstance(node, ast.Call):
            self._call(node)
            return
        if isinstance(node, ast.Attribute):
            chain = _self_chain(node)
            if chain is not None:
                self._access(chain, write=False, node=node)
                return  # the whole chain was consumed
        if isinstance(node, ast.Lambda):
            self._expr(node.body)
            return
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.expr):
                self._expr(child)

    def _access(self, chain: str, write: bool, node: ast.AST):
        self.scan.accesses.append(_Access(
            self.fn.cls, chain, write, frozenset(self.held), self.fn, node))

    # -- calls: spawns, joins, blocking, handler installs, call edges --

    def _call(self, node: ast.Call):
        d = _dotted(node.func)
        last = d.rsplit(".", 1)[-1] if d else None

        if last == "Thread" and (d in ("Thread", "threading.Thread")
                                 or d.endswith(".Thread")):
            self._spawn(node)
        elif last == "signal" and d in ("signal.signal", "_signal.signal"):
            if len(node.args) >= 2:
                self.scan.handlers.append((node.args[1], node))
        elif d is not None:
            self._maybe_blocking(node, d, last)
            if isinstance(node.func, ast.Attribute):
                chain = _self_chain(node.func)
                if chain is not None and "." in chain:
                    # self.x.append(...) — mutation of self.x
                    base, meth = chain.rsplit(".", 1)
                    if meth in _MUTATORS:
                        self._access(base, write=True, node=node)
                    elif meth == "join":
                        self.scan.joins.add("self." + base)
                        self._access(base, write=False, node=node)
                    else:
                        self._access(base, write=False, node=node)
                elif (isinstance(node.func.value, ast.Name)
                      and node.func.attr == "join"):
                    self.scan.joins.add(node.func.value.id)
                else:
                    self._expr(node.func.value)

        for a in node.args:
            self._expr(a)
        for k in node.keywords:
            self._expr(k.value)

    def _spawn(self, node: ast.Call):
        self.fn.spawner = True
        daemon = None
        target_key = None
        for k in node.keywords:
            if k.arg == "daemon" and isinstance(k.value, ast.Constant):
                daemon = bool(k.value.value)
            if k.arg == "target":
                t = k.value
                td = _dotted(t)
                if td and td.startswith("self.") and "." not in td[5:]:
                    target_key = ("self", td[5:])
                elif td and "." not in td:
                    target_key = ("name", td)
        binding = self._binding_of(node)
        self.scan.spawns.append(
            _Spawn(node, self.fn, daemon, binding, target_key))

    def _binding_of(self, node: ast.Call) -> Optional[str]:
        """`x = Thread(...)` / `self.t = Thread(...)` binding, found by
        checking the parent Assign — the walk visits values through
        _assign so the parent targets are in scope via a second pass."""
        parent = getattr(node, "_rlt_parent_assign", None)
        if parent is None:
            return None
        for t in parent.targets if isinstance(parent, ast.Assign) else []:
            if isinstance(t, ast.Name):
                return t.id
            c = _self_chain(t)
            if c is not None:
                return "self." + c
        return None

    def _maybe_blocking(self, node: ast.Call, d: str, last: str):
        kwargs = {k.arg for k in node.keywords}
        klass = None
        if d in ("time.sleep", "sleep"):
            klass = "sleep"
        elif d.startswith("subprocess."):
            klass = "subprocess"
        elif d == "open":
            klass = "io"
        elif last in _IO_METHODS and not d.startswith("os."):
            klass = "io"
        elif last in ("get", "put") and "timeout" not in kwargs:
            base = d.rsplit(".", 1)[0].rsplit(".", 1)[-1].lower()
            if "q" == base or "queue" in base or base.endswith("q"):
                if not any(k.arg == "block" for k in node.keywords):
                    klass = "queue"
        elif last == "join" and isinstance(node.func, ast.Attribute):
            base = _dotted(node.func.value)
            if base and ("thread" in base.lower()
                         or base in self.scan.daemon_sets
                         or any(s.binding == base for s in self.scan.spawns)):
                klass = "join"
        if klass is None:
            return
        self.fn.blocking.add((klass, d))
        if self.held:
            if klass in ("io", "subprocess"):
                for flag in self._section_io:
                    flag[0] = True
            self.scan.blocking_candidates.append((
                f"`{d}(...)` ({klass}) runs while holding "
                f"{_short_lock(self.held[-1])}",
                node, self.held[-1], klass))


def _short_lock(lid: str) -> str:
    return f"lock `{lid}`" if ":" not in lid else f"lock `{lid.split(':', 1)[1]}`"


def _annotate_assign_parents(tree: ast.AST) -> None:
    """Stamp Call nodes with their enclosing Assign so _binding_of can
    recover `x = Thread(...)` bindings without a parent map."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
            node.value._rlt_parent_assign = node  # type: ignore[attr-defined]


# ---- the package pass ------------------------------------------------------

def _scan_file(source: str, filename: str, relpath: str) -> Optional[_FileScan]:
    try:
        tree = ast.parse(source, filename=filename)
    except SyntaxError:
        return None  # the shardcheck linter owns RLT001
    _annotate_assign_parents(tree)
    scan = _FileScan(_FileLint(source, filename), relpath)
    _Collector(scan).visit(tree)
    # module-level code is a scope too (handler installs, global lock
    # nests); scan it as a synthetic function outside by_name/by_method
    scan.funcs.append(_CFunc(tree, "<module>", "<module>", None, None))
    for fn in scan.funcs:
        _BodyScan(scan, fn).run()
    _close_file_fixpoints(scan)
    _per_file_rules(scan)
    return scan


def _close_file_fixpoints(scan: _FileScan) -> None:
    """Propagate thread-reachability, transitive lock acquisition, and
    transitive blocking over the same-file call graph."""
    # seed thread-reachable from spawn targets
    for s in scan.spawns:
        if s.target_key is None:
            continue
        kind, name = s.target_key
        targets: List[_CFunc] = []
        if kind == "self" and s.func.cls is not None:
            f = scan.by_method.get((s.func.cls, name))
            targets = [f] if f else scan.by_name.get(name, [])
        else:
            targets = scan.by_name.get(name, [])
        for f in targets:
            f.thread = True
    changed = True
    while changed:
        changed = False
        for fn in scan.funcs:
            callees: List[_CFunc] = []
            for kind, name in fn.calls:
                if kind == "self" and fn.cls is not None:
                    f = scan.by_method.get((fn.cls, name))
                    callees.extend([f] if f else [])
                else:
                    callees.extend(scan.by_name.get(name, []))
            for f in callees:
                if fn.thread and not f.thread:
                    f.thread = True
                    changed = True
                before = len(fn.acquires) + len(fn.blocking)
                fn.acquires |= f.acquires
                fn.blocking |= f.blocking
                if len(fn.acquires) + len(fn.blocking) != before:
                    changed = True
    # cross-function order edges + blocking-under-lock: a call made while
    # holding L reaches everything the callee acquires / blocks on
    _CrossCallScan(scan).run()


class _CrossCallScan:
    """Second body walk: now that per-function acquire/blocking summaries
    exist, attribute them to call sites made under a held lock."""

    def __init__(self, scan: _FileScan):
        self.scan = scan

    def run(self):
        for fn in self.scan.funcs:
            self._walk(fn, fn.node, [])

    def _resolve(self, fn: _CFunc, node: ast.Call) -> List[_CFunc]:
        d = _dotted(node.func)
        if d is None:
            return []
        if d.startswith("self.") and "." not in d[5:] and fn.cls:
            f = self.scan.by_method.get((fn.cls, d[5:]))
            return [f] if f else []
        if "." not in d:
            return self.scan.by_name.get(d, [])
        return []

    def _walk(self, fn: _CFunc, node: ast.AST, held: List[str]):
        if isinstance(node, (ast.With, ast.AsyncWith)) and node is not fn.node:
            body_scan = _BodyScan(self.scan, fn)
            new = [lid for item in node.items
                   if (lid := body_scan._lock_id(item.context_expr))]
            for stmt in node.body:
                self._walk(fn, stmt, held + new)
            return
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and node is not fn.node:
            return
        if isinstance(node, ast.Call) and held:
            for callee in self._resolve(fn, node):
                for lid in callee.acquires:
                    for h in held:
                        if h != lid:
                            self.scan.order_edges.append((h, lid, node))
                for klass, desc in callee.blocking:
                    if klass in ("io", "subprocess"):
                        # mark every held lock's current section as io —
                        # approximated at section granularity elsewhere;
                        # here we only keep the finding candidate
                        pass
                    self.scan.blocking_candidates.append((
                        f"call to `{callee.qualname}()` blocks "
                        f"(`{desc}`, {klass}) while holding "
                        f"{_short_lock(held[-1])}",
                        node, held[-1], klass))
        for child in ast.iter_child_nodes(node):
            self._walk(fn, child, held)


def _per_file_rules(scan: _FileScan) -> None:
    _rule_701(scan)
    _rule_703(scan)
    _rule_704(scan)
    # RLT705 finalized at package level (needs the dedicated-I/O-lock
    # sanction computed across all sections of each lock)


def _rule_701(scan: _FileScan) -> None:
    groups: Dict[Tuple[Optional[str], str], List[_Access]] = {}
    for a in scan.accesses:
        groups.setdefault((a.cls, a.chain), []).append(a)
    for (cls, chain), accs in sorted(groups.items(),
                                     key=lambda kv: (kv[0][0] or "",
                                                     kv[0][1])):
        first = chain.split(".", 1)[0]
        if (cls, first) in scan.sync_attrs or (cls, chain) in scan.sync_attrs:
            continue  # synchronized carrier: its own synchronization
        thread_writes = [a for a in accs if a.write and a.func.thread
                         and a.func.name != "__init__"]
        outside = [a for a in accs
                   if not a.func.thread and a.func.name != "__init__"
                   and not a.func.spawner]
        if not thread_writes or not outside:
            continue
        for w in thread_writes:
            racy = [o for o in outside if not (w.held & o.held)]
            if racy:
                o = racy[0]
                scan.lint.add(
                    "RLT701",
                    f"`self.{chain}` is written in thread-reachable "
                    f"`{w.func.qualname}` and accessed in "
                    f"`{o.func.qualname}` (line {o.node.lineno}) with no "
                    f"common lock — guard both sides or hand it over via "
                    f"a queue.Queue/Event/deque(maxlen=...)",
                    node=w.node, symbol=f"{cls}.{chain}" if cls else chain)
                break  # one finding per attribute is enough signal


def _rule_703(scan: _FileScan) -> None:
    for s in scan.spawns:
        if s.daemon is True:
            continue
        b = s.binding
        if b is not None and (b in scan.joins or b in scan.daemon_sets):
            continue
        how = (f"bound to `{b}`" if b else "never bound to a name")
        scan.lint.add(
            "RLT703",
            f"non-daemon thread started in `{s.func.qualname}` ({how}) "
            f"has no join() on any path — process exit will block on it; "
            f"join it on the exit path or pass daemon=True",
            node=s.node)


def _rule_704(scan: _FileScan) -> None:
    for handler_expr, install in scan.handlers:
        bodies: List[ast.AST] = []
        label = "<handler>"
        seen: Set[int] = set()
        frontier: List[object] = [handler_expr]
        while frontier:
            h = frontier.pop()
            if isinstance(h, ast.Lambda):
                bodies.append(h.body)
                label = "<lambda>"
                continue
            fns: List[_CFunc] = []
            if isinstance(h, ast.Name):
                fns = scan.by_name.get(h.id, [])
            elif isinstance(h, ast.Attribute):
                c = _self_chain(h)
                if c and "." not in c:
                    fns = [f for f in [scan.by_method.get((cls, c))
                                       for cls in {f.cls for f in scan.funcs
                                                   if f.cls}]
                           if f]
            for f in fns:
                if id(f) in seen:
                    continue
                seen.add(id(f))
                label = f.qualname
                bodies.append(f.node)
                for kind, name in f.calls:
                    if kind == "name":
                        frontier.extend(scan.by_name.get(name, []))
                    elif f.cls:
                        m = scan.by_method.get((f.cls, name))
                        if m:
                            frontier.append(m)
        for body in bodies:
            bad = _handler_banned_op(body)
            if bad is not None:
                op, node = bad
                scan.lint.add(
                    "RLT704",
                    f"signal handler `{label}` does `{op}` — handlers "
                    f"must only flag and return (set an Event/flag, "
                    f"os.write, os._exit); do the real work at the next "
                    f"batch boundary (the bench.py/preempt.py "
                    f"discipline)",
                    node=node if hasattr(node, "lineno") else install)
                break


def _handler_banned_op(body: ast.AST):
    for node in ast.walk(body):
        if isinstance(node, (ast.With, ast.AsyncWith)):
            return ("with-statement (lock?)", node)
        if not isinstance(node, ast.Call):
            continue
        d = _dotted(node.func)
        if d is None:
            continue
        if d in ("print", "open", "input"):
            return (d, node)
        root = d.split(".", 1)[0]
        last = d.rsplit(".", 1)[-1]
        if root in _HANDLER_BANNED_ROOTS:
            return (d, node)
        if root == "os":
            continue  # os.write / os._exit / os.kill — sanctioned
        if last in _HANDLER_BANNED_ATTRS or d in ("time.sleep", "sleep"):
            return (d, node)
    return None


# ---- package-level finalization --------------------------------------------

def _finalize_705(scans: List[_FileScan]) -> None:
    sections: Dict[str, List[bool]] = {}
    for s in scans:
        for lid, flags in s.lock_sections.items():
            sections.setdefault(lid, []).extend(flags)
    io_dedicated = {lid for lid, flags in sections.items()
                    if flags and all(flags)}
    for s in scans:
        for msg, node, lid, klass in s.blocking_candidates:
            if klass in ("io", "subprocess") and lid in io_dedicated:
                continue  # the lock EXISTS to serialize this I/O
            s.lint.add(
                "RLT705",
                msg + " — copy state out under the lock and do the slow "
                "work outside",
                node=node)


def _finalize_702(scans: List[_FileScan]) -> None:
    graph: Dict[str, Dict[str, Tuple[str, int]]] = {}
    kinds: Dict[str, str] = {}
    for s in scans:
        kinds.update(s.lock_kinds)
        for a, b, node in s.order_edges:
            if a == b:
                continue  # self-edge: runtime lockwatch's department
            graph.setdefault(a, {}).setdefault(
                b, (s.relpath, getattr(node, "lineno", 0)))
    reported: Set[FrozenSet[str]] = set()
    for start in sorted(graph):
        path: List[str] = []
        on_path: Set[str] = set()

        def dfs(n: str) -> Optional[List[str]]:
            path.append(n)
            on_path.add(n)
            for m in sorted(graph.get(n, ())):
                if m == start and len(path) > 1:
                    return path[:]
                if m not in on_path and m in graph:
                    cyc = dfs(m)
                    if cyc:
                        return cyc
            path.pop()
            on_path.discard(n)
            return None

        cycle = dfs(start)
        if not cycle:
            continue
        key = frozenset(cycle)
        if key in reported:
            continue
        reported.add(key)
        hops = []
        for i, n in enumerate(cycle):
            nxt = cycle[(i + 1) % len(cycle)]
            f, ln = graph[n][nxt]
            hops.append(f"`{n}` -> `{nxt}` ({f}:{ln})")
        anchor = graph[cycle[0]][cycle[1 % len(cycle)]]
        scan0 = next((s for s in scans if s.relpath == anchor[0]), scans[0])
        scan0.lint.findings.append(Finding(
            rule="RLT702",
            message=("lock-order cycle: " + ", ".join(hops)
                     + " — two threads taking these in opposite orders "
                       "deadlock; impose one global acquisition order"),
            file=scan0.lint.filename, line=anchor[1]))


# ---- public API ------------------------------------------------------------

def check_concurrency_sources(
        sources: Sequence[Tuple[str, str]]) -> List[Finding]:
    """Run threadcheck over (filename, source) pairs as one package."""
    scans: List[_FileScan] = []
    for filename, source in sources:
        rel = os.path.basename(filename)
        s = _scan_file(source, filename, rel)
        if s is not None:
            scans.append(s)
    if not scans:
        return []
    _finalize_705(scans)
    _finalize_702(scans)
    out: List[Finding] = []
    for s in scans:
        out.extend(s.lint.findings)
    return out


def check_concurrency_paths(paths: Sequence[str]) -> List[Finding]:
    """Run threadcheck over files/dirs (dirs expand recursively). Files
    that do not parse are skipped — the shardcheck linter owns RLT001."""
    files = iter_python_files(paths)
    common = os.path.commonpath([os.path.abspath(f) for f in files]) \
        if len(files) > 1 else os.path.dirname(os.path.abspath(files[0])) \
        if files else ""
    scans: List[_FileScan] = []
    for f in files:
        try:
            with open(f, "r", encoding="utf-8") as fh:
                source = fh.read()
        except OSError:
            continue
        rel = os.path.relpath(os.path.abspath(f), common) if common else f
        s = _scan_file(source, f, rel)
        if s is not None:
            scans.append(s)
    if not scans:
        return []
    _finalize_705(scans)
    _finalize_702(scans)
    out: List[Finding] = []
    for s in scans:
        out.extend(s.lint.findings)
    return out


def summarize(findings: Sequence[Finding]) -> dict:
    """Counts-by-rule block for bench JSON lines (backend-down safe —
    pure host-side AST work)."""
    by_rule: Dict[str, int] = {}
    for f in findings:
        by_rule[f.rule] = by_rule.get(f.rule, 0) + 1
    return {"total": len(findings), "by_rule": dict(sorted(by_rule.items()))}
