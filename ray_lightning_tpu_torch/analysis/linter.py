"""The code linter: an AST pass over source files for the PyTorch idioms
that surface as per-step device syncs, irreproducible draws, NaN
gradients, silent request drops or a job pinned to one world size —
only after minutes on the cards (twin of
`ray_lightning_tpu/analysis/linter.py`, retargeted at torch).

Zero hardware, zero target-module imports: files are parsed, never
executed. Imports neither torch nor numpy.

What counts as *step code* (the scope of RLT201, RLT202, RLT204, RLT206
and RLT402; JAX's "traced code"):

  * the TpuModule step hooks (training_step/validation_step/test_step/
    predict_step — `TRACED_STEP_HOOKS`): the Trainer runs them once a
    batch;
  * functions the torch transforms run once a step or under a tracer
    (`_TRACE_TRANSFORMS`): decorated with ``@torch.compile`` (bare or
    called, or through ``partial``), ``@torch.jit.script``; the function
    a transform is called on (``torch.compile(step)``,
    ``checkpoint(self._block, x)``, ``torch.func.grad(loss_fn)``,
    ``vmap``, ``functional_call``), a bare name or ``self.method``; the
    ``forward`` and ``backward`` of a ``torch.autograd.Function``
    subclass;
  * anything those functions call, resolved within the same file
    (``self.helper(...)`` -> the method; ``helper(...)`` -> the
    module-level def) to a fixpoint — a host sync hidden two helpers
    deep under ``training_step`` is still a sync per step.

Mesh-axis literal rules (RLT101/RLT103) fire anywhere in the file: on a
``PartitionSpec(...)`` call, as in JAX, and on the port's spec tuples —
each tuple of axis names (a string or a tuple of strings a dimension)
inside a ``*param_specs*`` function, or assigned to a name holding
``specs``/``SPECS``. A typo'd axis raises at the strategy's setup; the
linter says so before anything runs.

The rules JAX ties to tracing or to a jit recompile: RLT203 (wallclock)
and RLT205 (static args) have no counterpart in an eager step and are not
flagged (`findings.NOT_FLAGGED`); RLT204 (print) is the per-step host
sync of printing a tensor; RLT502 reads ``torch.compile``'d callees.

Suppression: `# rlt: disable=RLT201` (comma-separate for several, bare
`# rlt: disable` for all) on the offending line;
`# rlt: disable-file=RLT204` anywhere disables a rule for the file.
"""
from __future__ import annotations

import ast
import os
import re
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from ray_lightning_tpu_torch.analysis.findings import (  # noqa: F401
    Finding, TRACED_STEP_HOOKS,
)

#: canonical mesh-axis vocabulary (parallel/mesh.py AXIS_ORDER, inlined
#: so the linter parses files without importing torch)
KNOWN_MESH_AXES: Tuple[str, ...] = (
    "data", "pipe", "fsdp", "expert", "seq", "tensor",
)

#: dotted names that make the decorated/wrapped function step code: the
#: torch transforms that run a function once a step or under a tracer
_TRACE_TRANSFORMS: Set[str] = {
    "torch.compile",
    "torch.jit.script", "torch.jit.trace",
    "torch.utils.checkpoint.checkpoint", "checkpoint",
    "torch.func.grad", "torch.func.grad_and_value", "torch.func.vmap",
    "torch.func.functional_call", "torch.func.vjp", "torch.func.jvp",
    "torch.func.jacrev", "torch.func.jacfwd", "torch.vmap",
    "func.grad", "func.vmap", "func.functional_call", "grad", "vmap",
    "grad_and_value", "functional_call",
}

#: base classes whose ``forward``/``backward`` are step code
_AUTOGRAD_FUNCTION_BASES: Set[str] = {
    "torch.autograd.Function", "autograd.Function", "Function",
}

#: calls that copy a device value to the host (or wait for the device)
_HOST_TRANSFER_CALLS: Set[str] = {
    "np.asarray", "np.array", "np.ascontiguousarray",
    "numpy.asarray", "numpy.array", "numpy.ascontiguousarray",
    "torch.cuda.synchronize", "cuda.synchronize",
}
#: no-argument tensor methods that copy to the host
_HOST_TRANSFER_METHODS: Set[str] = {"item", "tolist", "cpu", "numpy"}

_RNG_ROOTS: Tuple[str, ...] = ("random.", "np.random.", "numpy.random.")

#: torch sampling calls: each draws from the global generator unless it
#: is given ``generator=``
_TORCH_SAMPLERS: Set[str] = {
    "rand", "randn", "randint", "randperm", "rand_like", "randn_like",
    "randint_like", "bernoulli", "multinomial", "normal", "poisson",
}
#: in-place tensor samplers (``x.uniform_()``), same rule
_TORCH_INPLACE_SAMPLERS: Set[str] = {
    "uniform_", "normal_", "bernoulli_", "exponential_", "geometric_",
    "cauchy_", "log_normal_", "random_",
}

_SUPPRESS_RE = re.compile(
    r"#\s*rlt:\s*disable(?P<scope>-file)?(?:\s*=\s*(?P<rules>[A-Z0-9,\s]+))?"
)


def _dotted(node: ast.AST) -> Optional[str]:
    """'a.b.c' for a Name/Attribute chain, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _is_trace_transform(expr: ast.AST) -> bool:
    """True when `expr` (a decorator or a call's func) is one of the torch
    transforms — directly, or through `partial(torch.compile, ...)`."""
    name = _dotted(expr)
    if name in _TRACE_TRANSFORMS:
        return True
    if isinstance(expr, ast.Call):
        fname = _dotted(expr.func)
        if fname in _TRACE_TRANSFORMS:
            return True  # e.g. @torch.compile(mode=...)
        if fname in ("partial", "functools.partial") and expr.args:
            return _is_trace_transform(expr.args[0])
    return False


def _spec_axes(node: ast.AST) -> Optional[List[Tuple[str, ast.AST]]]:
    """The axis names of a spec tuple literal — each element None, an
    axis-name string or a tuple of them, at least one name — else None."""
    if not isinstance(node, ast.Tuple) or not node.elts:
        return None
    axes: List[Tuple[str, ast.AST]] = []
    for el in node.elts:
        if isinstance(el, ast.Constant) and el.value is None:
            continue
        if isinstance(el, ast.Constant) and isinstance(el.value, str):
            axes.append((el.value, el))
        elif isinstance(el, ast.Tuple) and el.elts and all(
                isinstance(e, ast.Constant) and isinstance(e.value, str)
                for e in el.elts):
            axes.extend((e.value, e) for e in el.elts)
        else:
            return None
    return axes or None


def _spec_values(root: ast.AST) -> Iterable[ast.AST]:
    """Where a spec table keeps its specs: dict literal and dict
    comprehension values, ``table[key] = ...`` values, returned values."""
    for sub in ast.walk(root):
        if isinstance(sub, ast.Dict):
            yield from sub.values
        elif isinstance(sub, ast.DictComp):
            yield sub.value
        elif isinstance(sub, ast.Assign) and any(
                isinstance(t, ast.Subscript) for t in sub.targets):
            yield sub.value
        elif isinstance(sub, ast.Return) and sub.value is not None:
            yield sub.value
    if isinstance(root, ast.Tuple):
        yield root


class _Func:
    """One function/method with enough context for the step-code
    fixpoint."""

    __slots__ = ("node", "qualname", "cls", "parent", "calls", "traced")

    def __init__(self, node, qualname: str, cls: Optional[str],
                 parent: Optional["_Func"]):
        self.node = node
        self.qualname = qualname
        self.cls = cls
        self.parent = parent
        self.calls: Set[Tuple[str, str]] = set()  # ("self"|"name", name)
        self.traced = False


class _Collector(ast.NodeVisitor):
    """First pass: function table, call edges, step-code seeds, and the
    spec-literal checks (which are scope-independent)."""

    def __init__(self, linter: "_FileLint"):
        self.lint = linter
        self._cls: List[ast.ClassDef] = []
        self._fn: List[_Func] = []
        self.funcs: List[_Func] = []
        #: simple name -> funcs (cheap resolution for bare calls)
        self.by_name: Dict[str, List[_Func]] = {}
        #: (cls, name) -> func, for self.x(...) resolution
        self.by_method: Dict[Tuple[str, str], _Func] = {}
        self.spec_ctors: Set[str] = {"PartitionSpec"}
        #: call-form transform targets, marked after the walk (a target
        #: may be defined below the call)
        self._targets: List[Tuple[Optional[str], ast.AST]] = []
        #: spec tuples already checked (a tuple seen twice reports once)
        self._specs_seen: Set[int] = set()

    # ---- imports: which local names mean PartitionSpec -------------------

    def visit_ImportFrom(self, node: ast.ImportFrom):
        if node.module and node.module.startswith("jax"):
            for alias in node.names:
                if alias.name == "PartitionSpec":
                    self.spec_ctors.add(alias.asname or alias.name)
        self.generic_visit(node)

    # ---- function table --------------------------------------------------

    def visit_ClassDef(self, node: ast.ClassDef):
        self._cls.append(node)
        self.generic_visit(node)
        self._cls.pop()

    def _handle_func(self, node):
        cls_node = self._cls[-1] if self._cls else None
        cls = cls_node.name if cls_node is not None else None
        parent = self._fn[-1] if self._fn else None
        prefix = (parent.qualname + ".") if parent else (
            (cls + ".") if cls else "")
        fn = _Func(node, prefix + node.name, cls, parent)
        self.funcs.append(fn)
        self.by_name.setdefault(node.name, []).append(fn)
        if cls is not None and parent is None:
            self.by_method[(cls, node.name)] = fn

        if any(_is_trace_transform(d) for d in node.decorator_list):
            fn.traced = True
        if cls is not None and parent is None and (
                node.name in TRACED_STEP_HOOKS
                or (node.name in ("forward", "backward") and any(
                    _dotted(b) in _AUTOGRAD_FUNCTION_BASES
                    for b in cls_node.bases))):
            fn.traced = True
        if "param_specs" in node.name:
            for value in _spec_values(node):
                self._check_spec_tuple(value)

        self._fn.append(fn)
        self.generic_visit(node)
        self._fn.pop()

    visit_FunctionDef = _handle_func
    visit_AsyncFunctionDef = _handle_func

    # ---- spec tables assigned to a *specs* name ----------------------------

    def visit_Assign(self, node: ast.Assign):
        if any(isinstance(t, ast.Name) and "specs" in t.id.lower()
               or isinstance(t, ast.Attribute) and "specs" in t.attr.lower()
               for t in node.targets):
            for value in _spec_values(node.value):
                self._check_spec_tuple(value)
        self.generic_visit(node)

    # ---- calls: edges, call-form transforms, spec literals ----------------

    def visit_Call(self, node: ast.Call):
        cur = self._fn[-1] if self._fn else None
        if cur is not None:
            if isinstance(node.func, ast.Name):
                cur.calls.add(("name", node.func.id))
            elif (isinstance(node.func, ast.Attribute)
                    and isinstance(node.func.value, ast.Name)
                    and node.func.value.id == "self"):
                cur.calls.add(("self", node.func.attr))

        # call-form wrapping: torch.compile(step), checkpoint(self.block,
        # x) make local `step` / the method `block` step code
        if _is_trace_transform(node.func) and node.args:
            cls = self._cls[-1].name if self._cls else None
            self._targets.append((cls, node.args[0]))

        fname = _dotted(node.func)
        if fname is not None and (
                fname in self.spec_ctors
                or fname.split(".")[-1] == "PartitionSpec"):
            self._check_spec_literal(node)
        self.generic_visit(node)

    def mark_targets(self) -> None:
        """Mark the functions the call-form transforms were given."""
        for cls, target in self._targets:
            if isinstance(target, ast.Name):
                for fn in self.by_name.get(target.id, ()):
                    fn.traced = True
            elif (isinstance(target, ast.Attribute)
                    and isinstance(target.value, ast.Name)
                    and target.value.id == "self" and cls is not None):
                fn = self.by_method.get((cls, target.attr))
                if fn is not None:
                    fn.traced = True

    # ---- rule bodies -----------------------------------------------------

    def _check_axes(self, axes: List[Tuple[str, ast.AST]], what: str):
        seen: Set[str] = set()
        for name, anode in axes:
            if name not in self.lint.known_axes:
                self.lint.add(
                    "RLT101",
                    f"{what} axis {name!r} is not a mesh axis "
                    f"(known: {', '.join(self.lint.known_axes)}); the "
                    "composition logic would silently drop it and "
                    "replicate the leaf",
                    anode)
            if name in seen:
                self.lint.add(
                    "RLT103",
                    f"mesh axis {name!r} used twice in one {what}",
                    anode)
            seen.add(name)

    def _check_spec_literal(self, node: ast.Call):
        axes: List[Tuple[str, ast.AST]] = []
        for arg in node.args:
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                axes.append((arg.value, arg))
            elif isinstance(arg, ast.Tuple):
                for el in arg.elts:
                    if (isinstance(el, ast.Constant)
                            and isinstance(el.value, str)):
                        axes.append((el.value, el))
        self._check_axes(axes, "PartitionSpec")

    def _check_spec_tuple(self, node: ast.AST):
        """A spec tuple of the port (per-dimension axis names)."""
        if id(node) in self._specs_seen:
            return
        axes = _spec_axes(node)
        if axes is None:
            return
        self._specs_seen.add(id(node))
        for el in node.elts:
            self._specs_seen.add(id(el))
        self._check_axes(axes, "spec")


def _is_unordered_iterable(node: ast.AST) -> Optional[str]:
    if isinstance(node, (ast.Set, ast.SetComp)):
        return "a set literal"
    if isinstance(node, ast.Call):
        name = _dotted(node.func)
        if name in ("set", "frozenset"):
            return f"{name}()"
        if name == "vars":
            return "vars()"
    if isinstance(node, ast.Attribute) and node.attr == "__dict__":
        return "__dict__"
    return None


class _FileLint:
    """Per-file state: source, suppressions, findings."""

    def __init__(self, source: str, filename: str,
                 extra_axes: Sequence[str] = ()):
        self.filename = filename
        self.known_axes = tuple(KNOWN_MESH_AXES) + tuple(extra_axes)
        self.findings: List[Finding] = []
        self.nodes: List[ast.AST] = []
        self._line_off: Dict[int, Set[str]] = {}
        self._file_off: Set[str] = set()
        for i, text in enumerate(source.splitlines(), start=1):
            m = _SUPPRESS_RE.search(text)
            if not m:
                continue
            rules = {r.strip() for r in (m.group("rules") or "").split(",")
                     if r.strip()} or {"*"}
            if m.group("scope"):
                self._file_off |= rules
            else:
                self._line_off.setdefault(i, set()).update(rules)

    def add(self, rule: str, message: str, node: Optional[ast.AST] = None,
            symbol: Optional[str] = None):
        line = getattr(node, "lineno", None)
        off = self._line_off.get(line, set()) | self._file_off
        if rule in off or "*" in off:
            return
        self.findings.append(Finding(
            rule=rule, message=message, file=self.filename, line=line,
            col=getattr(node, "col_offset", None), symbol=symbol,
        ))


def _own_nodes(fn_node) -> Iterable[ast.AST]:
    """All nodes of a function body EXCLUDING nested function defs (each
    nested def is linted as its own traced function); lambdas belong to
    the enclosing function."""
    stack: List[ast.AST] = list(ast.iter_child_nodes(fn_node))
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


# ---- RLT402: NaN through the untaken where branch --------------------------

#: math whose derivative (or value) is non-finite outside its domain —
#: the functions the torch.where gradient trap involves (torch spellings)
_RLT402_RISKY: Set[str] = {
    "log", "log1p", "log2", "log10", "sqrt", "rsqrt", "reciprocal",
    "div", "divide", "true_divide", "pow", "float_power",
    "asin", "acos", "atanh", "arcsin", "arccos", "arctanh",
}

#: wrappers that mask/clamp the INPUT — their subtree is considered
#: guarded and never flagged
_RLT402_GUARDS: Set[str] = {
    "clip", "clamp", "clamp_min", "clamp_max", "maximum", "minimum",
    "abs", "where", "nan_to_num", "relu", "softplus", "exp", "logaddexp",
    "logsumexp",
}

#: roots of a dotted call that are modules, not tensors (a method call
#: on anything else is a tensor method: ``x.log()``)
_NOT_TENSORS = ("math", "np", "numpy", "random", "os", "time", "self",
                "log", "logger", "logging")


def _rlt402_torch_op(name: Optional[str]) -> Optional[str]:
    """The op name of a torch math call (``torch.log``,
    ``torch.special.log1p``, a tensor method ``x.log()``), else None."""
    if not name or "." not in name:
        return None
    root, last = name.split(".", 1)[0], name.rsplit(".", 1)[-1]
    if root == "torch" or root not in _NOT_TENSORS:
        return last
    return None


def _rlt402_risky_in(expr: ast.AST) -> Optional[str]:
    """A risky op inside ``expr`` (skipping guarded subtrees), described
    for the message, else None."""
    stack: List[ast.AST] = [expr]
    while stack:
        node = stack.pop()
        if isinstance(node, ast.Call):
            name = _dotted(node.func) or ""
            last = name.split(".")[-1]
            if last in _RLT402_GUARDS:
                continue  # the input is masked — do not descend
            if _rlt402_torch_op(name) in _RLT402_RISKY:
                arg = (node.args[0] if name.startswith("torch.")
                       and node.args else getattr(node.func, "value",
                                                  None))
                if arg is not None and _rlt402_guarded(arg):
                    continue  # f(clamped_input): the sanctioned fix
                return f"{name}()"
        elif isinstance(node, ast.BinOp):
            if isinstance(node.op, ast.Div) and not _rlt402_guarded(
                    node.right):
                # x / torch.clamp_min(d, eps) is the sanctioned fix and
                # must not be flagged — only an unguarded denominator
                return "a division"
            if isinstance(node.op, ast.Pow) and _rlt402_pow_risky(node):
                return "a power"
        stack.extend(ast.iter_child_nodes(node))
    return None


def _rlt402_pow_risky(node: ast.BinOp) -> bool:
    """x ** k is finite-gradient for positive-integer constant k; only
    fractional/negative/variable exponents (x**0.5 == sqrt, x**-1 ==
    reciprocal) hit the invalid-domain trap — and a clamped base is the
    sanctioned fix."""
    exp = node.right
    if (isinstance(exp, ast.Constant) and isinstance(exp.value, int)
            and exp.value >= 1):
        return False
    return not _rlt402_guarded(node.left)


def _rlt402_guarded(expr: ast.AST) -> bool:
    """True when the expression already masks its input: a guard call
    anywhere inside, or an additive epsilon (x + 1e-6)."""
    for node in ast.walk(expr):
        if isinstance(node, ast.Call):
            last = (_dotted(node.func) or "").split(".")[-1]
            if last in _RLT402_GUARDS:
                return True
        elif isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add):
            return True
    return False


def _lint_rlt402_call(lint: _FileLint, node: ast.Call,
                      fname: Optional[str], sym: str) -> None:
    if fname == "torch.where" and len(node.args) == 3:
        for branch, which in ((node.args[1], "taken"),
                              (node.args[2], "untaken")):
            risky = _rlt402_risky_in(branch)
            if risky:
                lint.add(
                    "RLT402",
                    f"{risky} inside a torch.where branch: BOTH branches "
                    f"evaluate, and the {which}-branch NaN/inf flows "
                    "back through its gradient into the whole gradient "
                    "— mask the INPUT (torch.where(cond, x, 1.0) inside "
                    "the op), not the output", node, sym)
                break  # one finding per where-call is enough
        return
    if (fname is not None and fname.startswith("torch.")
            and fname.split(".")[-1] in ("log", "log1p", "log2",
                                         "log10", "sqrt", "rsqrt")
            and node.args):
        arg = node.args[0]
        if _root_name(arg) == "batch" and not _rlt402_guarded(arg):
            lint.add(
                "RLT402",
                f"{fname}() on a raw batch value: one out-of-domain "
                "row (a zero, a negative) makes the loss NaN for the "
                "whole step — clamp or shift the input "
                "(torch.clamp_min(x, eps)) before the transform", node,
                sym)


def _to_host(node: ast.Call) -> bool:
    """``x.to("cpu")`` / ``x.to(device="cpu")``: a copy to the host."""
    if not (isinstance(node.func, ast.Attribute) and node.func.attr == "to"):
        return False
    vals = list(node.args[:1]) + [k.value for k in node.keywords
                                  if k.arg == "device"]
    return any(isinstance(v, ast.Constant) and v.value == "cpu"
               for v in vals)


def _unseeded_draw(node: ast.Call, fname: Optional[str]) -> Optional[str]:
    """A torch sampling call given no ``generator=``, described, else
    None."""
    if any(k.arg == "generator" for k in node.keywords):
        return None
    if fname is not None and fname.startswith("torch.") \
            and fname.split(".")[-1] in _TORCH_SAMPLERS:
        return f"{fname}()"
    if (isinstance(node.func, ast.Attribute)
            and node.func.attr in _TORCH_INPLACE_SAMPLERS):
        return f".{node.func.attr}()"
    return None


def _lint_traced_body(lint: _FileLint, fn: _Func) -> None:
    sym = fn.qualname
    for node in _own_nodes(fn.node):
        if isinstance(node, ast.Call):
            fname = _dotted(node.func)
            if fname in _HOST_TRANSFER_CALLS:
                lint.add("RLT201",
                         f"{fname}() inside step code is a host transfer "
                         "or a wait for the device — a device sync every "
                         "step; keep values on device (or move this out "
                         "of the step)", node, sym)
            elif ((isinstance(node.func, ast.Attribute)
                   and node.func.attr in _HOST_TRANSFER_METHODS
                   and not node.args and not node.keywords)
                  or _to_host(node)):
                what = ".to('cpu')" if _to_host(node) \
                    else f".{node.func.attr}()"
                lint.add("RLT201",
                         f"{what} inside step code is a host transfer "
                         "— a device sync every step", node, sym)
            elif fname is not None and fname.startswith(_RNG_ROOTS):
                lint.add("RLT202",
                         f"{fname}() is Python/numpy RNG: it is not drawn "
                         "from the module's seeded torch.Generator, so "
                         "the draws differ across ranks and resumes — "
                         "draw from the module's generator instead",
                         node, sym)
            elif (draw := _unseeded_draw(node, fname)) is not None:
                lint.add("RLT202",
                         f"{draw} without generator= draws from torch's "
                         "global generator, not the module's seeded one: "
                         "the draws differ across ranks and resumes — "
                         "pass generator=", node, sym)
            elif fname == "print":
                lint.add("RLT204",
                         "print() in step code runs every step: a tensor "
                         "argument is copied to the host to be printed "
                         "(a device sync), and the console I/O sits on "
                         "the hot path — log through self.log or on the "
                         "log cadence", node, sym)
            else:
                _lint_rlt402_call(lint, node, fname, sym)
        elif isinstance(node, (ast.For, ast.AsyncFor)):
            what = _is_unordered_iterable(node.iter)
            if what:
                lint.add("RLT206",
                         f"iterating {what} in step code: unordered "
                         "iteration makes parameter/collective order "
                         "nondeterministic across processes — sort it",
                         node, sym)
        elif isinstance(node, ast.comprehension):
            what = _is_unordered_iterable(node.iter)
            if what:
                lint.add("RLT206",
                         f"comprehension over {what} in step code: "
                         "unordered iteration makes parameter/collective "
                         "order nondeterministic across processes — "
                         "sort it", node.iter, sym)


# ---- RLT304: host sync in the per-batch hot loop --------------------------

#: iterator names that mark a `for` loop as a per-batch training/eval
#: loop (the RLT304 scope). Deliberately specific — `data` alone would
#: flag every list walk in sight.
_LOADER_NAME_TOKENS: Tuple[str, ...] = (
    "loader", "dataloader", "batches", "dataiter",
)

#: calls flagged on step outputs inside the hot loop (outside cadence)
_HOT_SYNC_CALLS: Set[str] = {
    "float", "int",
    "np.asarray", "np.array", "numpy.asarray", "numpy.array",
}

_HOT_SYNC_METHODS: Set[str] = {"item", "tolist", "cpu", "numpy"}

#: calls that wait for the device whatever their arguments
_HOT_WAITS: Set[str] = {"torch.cuda.synchronize", "cuda.synchronize"}


def _to_device(node: ast.Call) -> bool:
    """``x.cuda()`` / ``x.to(device)`` / ``x.to("cuda")``: a copy to the
    card (``.to(dtype)`` is not one)."""
    if not isinstance(node.func, ast.Attribute):
        return False
    if node.func.attr == "cuda":
        return True
    if node.func.attr != "to":
        return False
    vals = list(node.args[:1]) + [k.value for k in node.keywords
                                  if k.arg == "device"]
    for v in vals:
        if isinstance(v, ast.Constant) and isinstance(v.value, str) \
                and v.value.startswith("cuda"):
            return True
        name = (_dotted(v) or "").split(".")[-1].lower()
        if "device" in name or name in ("dev", "cuda"):
            return True
    return False


def _loader_like(expr: ast.AST) -> bool:
    """Does this `for` iterator look like a per-batch data source?"""
    if isinstance(expr, ast.Call):
        fname = _dotted(expr.func) or ""
        last = fname.split(".")[-1].lower()
        if last in ("enumerate", "iter", "zip", "islice"):
            return any(_loader_like(a) for a in expr.args)
        # loader factories: train_dataloader(), DataLoader(...)
        return "dataloader" in last
    name = _dotted(expr)
    if name is None:
        return False
    last = name.split(".")[-1].lower()
    return last == "dl" or any(t in last for t in _LOADER_NAME_TOKENS)


def _under_cadence_guard(node: ast.AST, parents: Dict[int, ast.AST]) -> bool:
    """True when `node` sits under an `if` whose test contains a `%`
    (the `if step % N == 0:` log-cadence idiom) — a sync every N steps
    is the sanctioned pattern, not the per-step bug."""
    cur = parents.get(id(node))
    while cur is not None:
        if isinstance(cur, ast.If) and any(
                isinstance(n, ast.BinOp) and isinstance(n.op, ast.Mod)
                for n in ast.walk(cur.test)):
            return True
        cur = parents.get(id(cur))
    return False


def _root_name(expr: ast.AST) -> Optional[str]:
    """The base Name of a value expression: metrics / metrics["loss"] /
    out.loss → "metrics"/"out"."""
    while isinstance(expr, (ast.Subscript, ast.Attribute, ast.Starred)):
        expr = expr.value
    if isinstance(expr, ast.Name):
        return expr.id
    return None


def _walk_own_loop(stmts: List[ast.stmt]) -> Iterable[ast.AST]:
    """Nodes of one hot loop's body, EXCLUDING nested function defs and
    nested loader-like `for` loops — each nested hot loop is linted as
    its own loop (walking into it here would report its findings twice:
    once for the outer loop, once for its own pass)."""
    stack: List[ast.AST] = list(stmts)
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue
        if isinstance(node, ast.For) and _loader_like(node.iter):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


def _loop_step_outputs(loop: ast.For) -> Set[str]:
    """Names assigned inside the loop body from a call whose callee name
    contains 'step' — the step outputs whose per-batch host fetch RLT304
    flags. Tuple unpacking (`state, metrics = step(...)`) counts."""
    outs: Set[str] = set()
    for node in _walk_own_loop(loop.body):
        if not isinstance(node, ast.Assign):
            continue
        if not isinstance(node.value, ast.Call):
            continue
        callee = _dotted(node.value.func) or ""
        if "step" not in callee.split(".")[-1].lower():
            continue
        for tgt in node.targets:
            elts = tgt.elts if isinstance(tgt, ast.Tuple) else [tgt]
            for el in elts:
                if isinstance(el, ast.Name):
                    outs.add(el.id)
    return outs


#: method names that emit/persist telemetry when called on a
#: telemetry-shaped receiver (RLT501 arm A)
_TELEMETRY_METHODS: Set[str] = {
    "span", "record", "emit", "flush", "start_trace", "stop_trace",
}

#: receiver-name tokens that mark an object as telemetry machinery
_TELEMETRY_TOKENS: Tuple[str, ...] = (
    "telemetry", "recorder", "tracer", "profiler", "span",
)


def _telemetry_call(node: ast.Call) -> Optional[str]:
    """A human-readable description when this call is telemetry emission
    (RLT501 arm A), else None."""
    if isinstance(node.func, ast.Attribute):
        meth = node.func.attr
        if meth not in _TELEMETRY_METHODS:
            return None
        recv = _dotted(node.func.value) or ""
        low = recv.lower()
        if any(tok in low for tok in _TELEMETRY_TOKENS):
            return f"{recv}.{meth}"
        return None
    fname = _dotted(node.func) or ""
    if fname.split(".")[-1] in ("record_span", "emit_span"):
        return fname
    return None


def _lint_hot_loop(lint: _FileLint, loop: ast.For,
                   symbol: Optional[str]) -> None:
    step_outputs = _loop_step_outputs(loop)
    # parent links within the loop body, for the cadence-guard walkup
    parents: Dict[int, ast.AST] = {}
    for node in _walk_own_loop(loop.body):
        for child in ast.iter_child_nodes(node):
            parents[id(child)] = node
    for node in _walk_own_loop(loop.body):
        if not isinstance(node, ast.Call):
            continue
        if _under_cadence_guard(node, parents):
            continue
        tele = _telemetry_call(node)
        if tele is not None:
            lint.add(
                "RLT501",
                f"{tele}() inside the per-batch loop outside a cadence "
                "guard — hand-rolled per-step telemetry puts flushes/"
                "captures (and whatever backs this recorder) on the hot "
                "path it exists to measure. Use the trainer's built-in "
                "instrumentation (Trainer(telemetry=...) already spans "
                "these seams from a bounded ring), or guard the call "
                "with the log cadence (if step % N == 0) "
                "(docs/OBSERVABILITY.md)", node, symbol)
            continue
        fname = _dotted(node.func)
        if _to_device(node):
            lint.add(
                "RLT304",
                "un-prefetched copy to the card in the per-batch loop: "
                "the host->device placement sits on the critical path "
                "every step — overlap it with compute "
                "(pipeline.DevicePrefetcher / "
                "Trainer(prefetch_to_device=N))", node, symbol)
            continue
        if fname in _HOT_WAITS:
            lint.add(
                "RLT304",
                f"{fname}() inside the per-batch loop waits for the "
                "device every step — the launch queue drains and the "
                "card idles; wait on the log cadence (if step % N == 0) "
                "or not at all", node, symbol)
            continue
        target: Optional[ast.AST] = None
        what = None
        if fname in _HOT_SYNC_CALLS and node.args:
            target = node.args[0]
            what = f"{fname}()"
        elif (isinstance(node.func, ast.Attribute)
                and node.func.attr in _HOT_SYNC_METHODS
                and not node.args and not node.keywords):
            target = node.func.value
            what = f".{node.func.attr}()"
        if target is None:
            continue
        root = _root_name(target)
        if root is not None and root in step_outputs:
            lint.add(
                "RLT304",
                f"{what} on step output {root!r} inside the "
                "per-batch loop forces a device sync every step — "
                "the launch queue drains and the card idles; fetch "
                "on the log cadence (if step % N == 0) or keep it on "
                "device", node, symbol)


class _HotLoopLint:
    """RLT304 driver: finds per-batch loops in NON-traced code (traced
    bodies are RLT201 territory) — both inside functions and at module
    level — and lints each."""

    def __init__(self, lint: _FileLint):
        self.lint = lint

    def run(self, tree: ast.Module, funcs: List["_Func"]) -> None:
        for fn in funcs:
            if fn.traced:
                continue
            for node in _own_nodes(fn.node):
                if isinstance(node, ast.For) and _loader_like(node.iter):
                    _lint_hot_loop(self.lint, node, fn.qualname)
        # module-level training scripts (examples, quick experiments)
        stack: List[ast.AST] = list(tree.body)
        while stack:
            node = stack.pop()
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
                continue
            if isinstance(node, ast.For) and _loader_like(node.iter):
                _lint_hot_loop(self.lint, node, None)
            stack.extend(ast.iter_child_nodes(node))


#: APIs whose failures surface as WorkerError (or carry one): a trivial
#: broad except around these is the anti-pattern RLT401 names. The
#: distinctive names match anywhere; the GENERIC ones (`launch`,
#: `supervise` — plenty of unrelated code has an `app.launch()`) match
#: only when the file imports them from this package.
_WORKER_API_NAMES: Set[str] = {
    "WorkerGroup", "WorkerError", "fit_distributed", "run_distributed",
    "validate_distributed", "test_distributed", "predict_distributed",
    "launch_cpu_spmd", "fit_supervised",
}

_WORKER_API_GENERIC: Set[str] = {"launch", "supervise"}

#: group-handle methods: `<something>group.run(...)` etc.
_WORKER_GROUP_METHODS: Set[str] = {"run", "run_single", "wait", "start"}


def _is_trivial_handler_body(body: List[ast.stmt]) -> bool:
    """Only pass/continue/`...` — the failure vanishes without a trace."""
    for stmt in body:
        if isinstance(stmt, (ast.Pass, ast.Continue)):
            continue
        if (isinstance(stmt, ast.Expr)
                and isinstance(stmt.value, ast.Constant)
                and stmt.value.value is Ellipsis):
            continue
        return False
    return bool(body)


def _handler_swallows(handler: ast.ExceptHandler) -> Optional[str]:
    """The caught-type description when this handler is broad enough to
    eat a WorkerError (bare, Exception/BaseException, or WorkerError
    itself — directly or inside a tuple), else None."""
    t = handler.type
    if t is None:
        return "bare except:"
    types = t.elts if isinstance(t, ast.Tuple) else [t]
    for el in types:
        name = _dotted(el)
        base = name.split(".")[-1] if name else None
        if base in ("Exception", "BaseException", "WorkerError"):
            return f"except {base}"
    return None


def _mentions_worker_api(nodes: List[ast.stmt],
                         known: Set[str]) -> Optional[str]:
    """A worker-API name used inside these statements, else None."""
    for stmt in nodes:
        for node in ast.walk(stmt):
            if isinstance(node, ast.Name) and node.id in known:
                return node.id
            if isinstance(node, ast.Attribute):
                if node.attr in known:
                    return node.attr
                if (node.attr in _WORKER_GROUP_METHODS
                        and isinstance(node.value, ast.Name)
                        and "group" in node.value.id.lower()):
                    return f"{node.value.id}.{node.attr}"
    return None


class _ResilienceLint(ast.NodeVisitor):
    """RLT401: the two code shapes that defeat supervision.

    (a) a bare/broad ``except`` with a trivial body (pass/continue/...)
        wrapped around worker-group APIs — the WorkerError carrying the
        dead rank's classification and log tail evaporates;
    (b) a ``WorkerGroup`` that is started but has no ``shutdown()``
        reachable from a ``finally`` and is not managed by ``with`` —
        the failure path leaks live worker processes (and on a pod,
        their hosts' chips). Groups handed away (returned, stored on
        self) are the caller's responsibility and are not flagged.
    """

    def __init__(self, lint: "_FileLint"):
        self.lint = lint
        self._known = set(_WORKER_API_NAMES)

    def visit_ImportFrom(self, node: ast.ImportFrom):
        # the generic names ('launch', 'supervise') become worker APIs
        # only with import evidence — an unrelated app.launch() must
        # never trip the rule
        if node.module and node.module.startswith("ray_lightning_tpu"):
            for alias in node.names:
                if alias.name in _WORKER_API_GENERIC:
                    self._known.add(alias.asname or alias.name)
        self.generic_visit(node)

    def visit_Try(self, node: ast.Try):
        for handler in node.handlers:
            caught = _handler_swallows(handler)
            if caught is None or not _is_trivial_handler_body(handler.body):
                continue
            api = _mentions_worker_api(node.body, self._known)
            if api is not None:
                self.lint.add(
                    "RLT401",
                    f"{caught} with a pass-only body swallows failures "
                    f"from {api}() — a dead worker's WorkerError (rank, "
                    "cause, log tail) vanishes and the run reads as "
                    "success; let it propagate to the supervisor, or "
                    "handle and re-raise",
                    handler)
        self.generic_visit(node)

    @staticmethod
    def _walk_scope(body: List[ast.stmt]):
        """Every node under these statements EXCLUDING nested function
        bodies (each def is its own ownership scope)."""
        stack: List[ast.AST] = list(body)
        while stack:
            node = stack.pop()
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
                continue
            yield node
            stack.extend(ast.iter_child_nodes(node))

    def _scan_scope(self, body: List[ast.stmt]) -> None:
        """One function scope (nested defs are their own scopes)."""
        assigns: List[Tuple[str, ast.Call]] = []
        started: Set[str] = set()
        shutdown_in_finally: Set[str] = set()
        with_managed: Set[str] = set()
        escaped: Set[str] = set()  # returned/yielded: ownership left
        for node in self._walk_scope(body):
            if isinstance(node, ast.Assign) and isinstance(
                    node.value, ast.Call):
                call = node.value
                chained_start = False
                if (isinstance(call.func, ast.Attribute)
                        and call.func.attr == "start"
                        and isinstance(call.func.value, ast.Call)):
                    # g = WorkerGroup(...).start()
                    call = call.func.value
                    chained_start = True
                callee = _dotted(call.func) or ""
                if callee.split(".")[-1] == "WorkerGroup":
                    for tgt in node.targets:
                        if isinstance(tgt, ast.Name):
                            assigns.append((tgt.id, call))
                            if chained_start:
                                started.add(tgt.id)
                        # self.group = WorkerGroup(...): lifecycle is
                        # managed elsewhere on the object — not flagged
            elif isinstance(node, ast.With):
                for item in node.items:
                    ctx = item.context_expr
                    if isinstance(ctx, ast.Name):
                        with_managed.add(ctx.id)
            elif isinstance(node, (ast.Return, ast.Yield)) and isinstance(
                    getattr(node, "value", None), ast.Name):
                escaped.add(node.value.id)
            elif (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and isinstance(node.func.value, ast.Name)
                    and node.func.attr == "start"):
                started.add(node.func.value.id)
            elif isinstance(node, ast.Try) and node.finalbody:
                for fin_node in self._walk_scope(node.finalbody):
                    if (isinstance(fin_node, ast.Call)
                            and isinstance(fin_node.func, ast.Attribute)
                            and fin_node.func.attr == "shutdown"
                            and isinstance(fin_node.func.value, ast.Name)):
                        shutdown_in_finally.add(fin_node.func.value.id)
        for name, call in assigns:
            if name in with_managed or name in escaped:
                continue
            if name not in started:
                continue  # never started: nothing leaked yet
            if name in shutdown_in_finally:
                continue
            self.lint.add(
                "RLT401",
                f"WorkerGroup {name!r} is start()ed with no "
                f"{name}.shutdown() in a finally and no `with` block — "
                "a failure between start and teardown leaks the worker "
                "processes (on a pod: their hosts' chips). Use `with "
                "WorkerGroup(...) as g:` or try/finally",
                call)

    def visit_FunctionDef(self, node: ast.FunctionDef):
        self._scan_scope(node.body)
        self.generic_visit(node)

    def visit_AsyncFunctionDef(self, node: ast.AsyncFunctionDef):
        self._scan_scope(node.body)
        self.generic_visit(node)

    def visit_Module(self, node: ast.Module):
        self._scan_scope(node.body)
        self.generic_visit(node)


# ---- RLT501 arm B: unbounded event accumulation in callback code ----------

#: the hooks that run once per batch — an unbounded append here grows
#: for the life of the run
_BATCH_HOOKS: Tuple[str, ...] = (
    "on_train_batch_start", "on_train_batch_end",
)


def _self_attr(node: ast.AST) -> Optional[str]:
    """'X' for ``self.X`` (through a subscript: ``self.X[0]``)."""
    while isinstance(node, ast.Subscript):
        node = node.value
    if (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return node.attr
    return None


class _TelemetryCallbackLint:
    """RLT501 arm B: ``self.X.append(...)`` in a per-batch Callback hook
    where nothing in the class ever bounds X — no deque(maxlen=...)
    construction, no reassignment/truncation outside __init__, no
    clear/pop. The sanctioned shapes (ThroughputMonitor's
    ``self._times = self._times[-window:]``, a ring deque, an explicit
    flush-and-clear) all leave bounding evidence the scan accepts."""

    def __init__(self, lint: _FileLint):
        self.lint = lint

    @staticmethod
    def _is_callback(cls: ast.ClassDef) -> bool:
        for base in cls.bases:
            name = _dotted(base) or ""
            if name.split(".")[-1].endswith("Callback"):
                return True
        return False

    def run(self, tree: ast.Module) -> None:
        for node in self.lint.nodes:
            if isinstance(node, ast.ClassDef) and self._is_callback(node):
                self._scan_class(node)

    def _scan_class(self, cls: ast.ClassDef) -> None:
        bounded: Set[str] = set()
        appends: List[Tuple[str, ast.Call]] = []
        for item in cls.body:
            if not isinstance(item, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                continue
            for node in ast.walk(item):
                if isinstance(node, ast.Assign):
                    for tgt in node.targets:
                        attr = _self_attr(tgt)
                        if attr is None:
                            continue
                        if item.name != "__init__":
                            # truncation / replacement in a hook body
                            bounded.add(attr)
                        elif (isinstance(node.value, ast.Call)
                              and (_dotted(node.value.func) or ""
                                   ).split(".")[-1] == "deque"):
                            bounded.add(attr)  # ring from birth
                elif isinstance(node, ast.Delete):
                    for tgt in node.targets:
                        attr = _self_attr(tgt)
                        if attr is not None:
                            bounded.add(attr)
                elif (isinstance(node, ast.Call)
                        and isinstance(node.func, ast.Attribute)):
                    attr = _self_attr(node.func.value)
                    if attr is None:
                        continue
                    if node.func.attr in ("clear", "pop", "popleft"):
                        bounded.add(attr)
                    elif (node.func.attr == "append"
                            and item.name in _BATCH_HOOKS):
                        appends.append((attr, node))
        for attr, call in appends:
            if attr in bounded:
                continue
            self.lint.add(
                "RLT501",
                f"self.{attr}.append(...) in a per-batch callback hook "
                f"with no bound in class {cls.name!r} (no deque(maxlen), "
                "no truncation/clear/pop anywhere) — the list grows for "
                "the life of the run; buffer in a bounded ring "
                "(collections.deque(maxlen=N) or truncate on append) "
                "and flush on a cadence (docs/OBSERVABILITY.md)",
                call, cls.name)


# ---- RLT502: serve-loop recompile -----------------------------------------
#
# The serving trap, in torch: a decode loop that calls a torch.compile'd
# function with a Python-varying shape — a sequence buffer grown by
# torch.cat every iteration, or a prompt sliced to its un-bucketed length
# — so every new shape silently recompiles (dynamo guards on shapes). The
# rule is deliberately narrow: the callee must be compiled in this file,
# and the argument must provably change shape across iterations of the
# enclosing loop. The port itself compiles nothing.

#: growth constructors: `x = torch.cat([x, ...])` and friends rebind x to
#: a longer buffer every trip
_RLT502_GROWERS: Set[str] = {
    "cat", "concat", "concatenate", "append", "hstack", "vstack",
    "column_stack", "stack", "pad",
}


def _rlt502_is_jit_expr(expr: ast.AST) -> bool:
    """torch.compile / partial(torch.compile, ...) (as decorator or
    call)."""
    name = _dotted(expr)
    if name is not None:
        return name == "torch.compile"
    if isinstance(expr, ast.Call):
        fname = _dotted(expr.func) or ""
        if fname.split(".")[-1] == "partial" and expr.args:
            return _rlt502_is_jit_expr(expr.args[0])
        return _rlt502_is_jit_expr(expr.func)
    return False


def _rlt502_jitted_names(nodes: List[ast.AST]) -> Set[str]:
    """Local names known to be compiled callables: decorated defs and
    `name = torch.compile(...)`-style assignments."""
    names: Set[str] = set()
    for node in nodes:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if any(_rlt502_is_jit_expr(d) for d in node.decorator_list):
                names.add(node.name)
        elif isinstance(node, ast.Assign) and isinstance(node.value,
                                                        ast.Call):
            if (_rlt502_is_jit_expr(node.value.func)
                    or _rlt502_is_jit_expr(node.value)):
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        names.add(t.id)
    return names


def _rlt502_own_loop_nodes(loop: ast.AST) -> Iterable[ast.AST]:
    """One loop's body nodes, excluding nested defs AND nested loops
    (each nested loop is linted as its own loop)."""
    stack: List[ast.AST] = list(loop.body) + list(
        getattr(loop, "orelse", []))
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda, ast.For, ast.While)):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


def _rlt502_growing_names(own: List[ast.AST]) -> Set[str]:
    """Names rebound inside the loop from a concatenate/append/... of
    THEMSELVES — a buffer that grows every iteration."""
    grow: Set[str] = set()
    for node in own:
        if not isinstance(node, ast.Assign):
            continue
        if not isinstance(node.value, ast.Call):
            continue
        callee = (_dotted(node.value.func) or "").split(".")[-1]
        if callee not in _RLT502_GROWERS:
            continue
        used = {n.id for n in ast.walk(node.value)
                if isinstance(n, ast.Name)}
        for t in node.targets:
            if isinstance(t, ast.Name) and t.id in used:
                grow.add(t.id)
    return grow


def _rlt502_varying_names(loop: ast.AST, own: List[ast.AST]) -> Set[str]:
    """Names whose VALUE changes per iteration: the for target plus
    anything (re)assigned in the loop body."""
    vary: Set[str] = set()
    if isinstance(loop, ast.For):
        vary |= {n.id for n in ast.walk(loop.target)
                 if isinstance(n, ast.Name)}
    for node in own:
        if isinstance(node, ast.Assign):
            for t in node.targets:
                for n in ast.walk(t):
                    if isinstance(n, ast.Name):
                        vary.add(n.id)
        elif isinstance(node, ast.AugAssign) and isinstance(node.target,
                                                            ast.Name):
            vary.add(node.target.id)
    return vary


def _rlt502_varying_slice(arg: ast.AST, vary: Set[str]) -> Optional[str]:
    """A slice bound inside ``arg`` that references a loop-varying name
    (``x[:t]`` — shape changes per trip). Integer INDEXING (``x[t]``)
    keeps the shape constant and never fires."""
    for node in ast.walk(arg):
        if not isinstance(node, ast.Subscript):
            continue
        slices = (node.slice.elts if isinstance(node.slice, ast.Tuple)
                  else [node.slice])
        for sl in slices:
            if not isinstance(sl, ast.Slice):
                continue
            for bound in (sl.lower, sl.upper):
                if bound is None:
                    continue
                for n in ast.walk(bound):
                    if isinstance(n, ast.Name) and n.id in vary:
                        return n.id
    return None


class _ServeLoopLint:
    """RLT502 driver: every for/while loop outside step code that calls
    a compiled function of this file with a per-iteration-varying
    shape."""

    def __init__(self, lint: _FileLint):
        self.lint = lint

    def _lint_loop(self, loop: ast.AST, jitted: Set[str],
                   symbol: Optional[str],
                   outer_vary: Set[str]) -> None:
        own = list(_rlt502_own_loop_nodes(loop))
        grow = _rlt502_growing_names(own)
        # an ENCLOSING loop's targets vary per iteration here too: the
        # canonical per-request-outer / per-token-inner serve loop
        # slices by the outer loop's un-bucketed length
        # (`for l in lens: while ...: step(params, toks[:, :l])`)
        vary = _rlt502_varying_names(loop, own) | outer_vary
        for node in own:
            if not isinstance(node, ast.Call):
                continue
            if not (isinstance(node.func, ast.Name)
                    and node.func.id in jitted):
                continue
            for arg in list(node.args) + [kw.value for kw in
                                          node.keywords]:
                if isinstance(arg, ast.Name) and arg.id in grow:
                    detail = (f"{arg.id!r} is grown by cat/append "
                              "inside the loop")
                elif (sliced := _rlt502_varying_slice(arg, vary)) \
                        is not None:
                    detail = (f"sliced by loop-varying {sliced!r}")
                else:
                    continue
                self.lint.add(
                    "RLT502",
                    f"compiled {node.func.id}() is called in this loop "
                    f"with an argument whose shape changes every "
                    f"iteration ({detail}): each new shape silently "
                    "recompiles — the classic serve-loop trap (growing "
                    "sequence axis / un-bucketed prompt lengths). Keep "
                    "device shapes fixed: decode into a position-indexed "
                    "KV cache (models.llama.generate), pad prompts to a "
                    "bucket, or serve through the fixed-capacity slot "
                    "engine (serve.DecodeEngine)", node, symbol)
                break

    def run(self, tree: ast.Module, funcs: List["_Func"]) -> None:
        jitted = _rlt502_jitted_names(self.lint.nodes)
        if not jitted:
            return
        traced_nodes = {id(fn.node) for fn in funcs if fn.traced}

        def walk(stmts, symbol, outer_vary: Set[str]):
            for node in stmts:
                if isinstance(node, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                    if id(node) not in traced_nodes:
                        walk(node.body, node.name, set())
                    continue
                if isinstance(node, ast.Lambda):
                    continue
                if isinstance(node, (ast.For, ast.While)):
                    self._lint_loop(node, jitted, symbol, outer_vary)
                    inner_vary = outer_vary | _rlt502_varying_names(
                        node, list(_rlt502_own_loop_nodes(node)))
                    walk(list(node.body) + list(node.orelse), symbol,
                         inner_vary)
                    continue
                walk(list(ast.iter_child_nodes(node)), symbol,
                     outer_vary)

        walk(tree.body, None, set())


class _PinnedWorldLint:
    """RLT601 pinned-world-size (docs/ELASTIC.md): code that computes
    per-host batch or rank math from a HARDCODED device count instead
    of the mesh/plan helpers breaks the moment the elastic supervisor
    reshards the job onto a different world size. Two arms:

      A ``torch.cuda.device_count() == 8`` / ``dist.get_world_size()
        != 4`` (JAX's ``jax.device_count()``, ``len(jax.devices())``) —
        an ==/!= pin of a topology query against a literal >= 2
        (capability checks ``== 1`` / ``> 1`` are fine and common);
      B ``batch // 8`` / ``global_batch % 16`` / ``rank // 4`` — batch/
        world/rank-named values floor-divided or modulo'd by a literal
        power-of-two >= 2 (the device-count constants jobs get pinned
        to). Deriving the divisor from the mesh
        (``mesh.batch_size_divisor``, ``plan.dp_degree``) never fires:
        those are names/calls, not literals.
    """

    #: terminal attribute names of the topology queries arm A watches
    _COUNT_CALLS = ("device_count", "local_device_count",
                    "process_count", "global_device_count",
                    "get_world_size")
    _NAME_RE = re.compile(r"(?:^|_)(batch|bsz|world|rank)(?:_|$|size)",
                          re.IGNORECASE)

    def __init__(self, lint: _FileLint):
        self.lint = lint

    def run(self, tree: ast.Module) -> None:
        for node in self.lint.nodes:
            if isinstance(node, ast.Compare):
                self._compare(node)
            elif (isinstance(node, ast.BinOp)
                    and isinstance(node.op, (ast.FloorDiv, ast.Mod))):
                self._divmod(node)

    def _is_count_call(self, node: ast.AST) -> bool:
        if not isinstance(node, ast.Call):
            return False
        name = (_dotted(node.func) or "").split(".")[-1]
        if name in self._COUNT_CALLS:
            return True
        if name == "len" and node.args:
            inner = node.args[0]
            if isinstance(inner, ast.Call):
                iname = (_dotted(inner.func) or "").split(".")[-1]
                return iname in ("devices", "local_devices")
        return False

    def _compare(self, node: ast.Compare) -> None:
        sides = [node.left] + list(node.comparators)
        for op, lhs, rhs in zip(node.ops, sides, sides[1:]):
            if not isinstance(op, (ast.Eq, ast.NotEq)):
                continue
            for call, lit in ((lhs, rhs), (rhs, lhs)):
                if (self._is_count_call(call)
                        and isinstance(lit, ast.Constant)
                        and isinstance(lit.value, int)
                        and lit.value >= 2):
                    self.lint.add(
                        "RLT601",
                        f"topology query pinned to a hardcoded world "
                        f"size ({lit.value}): this code dies on any "
                        "other topology, so the elastic supervisor can "
                        "never reshard the job (docs/ELASTIC.md). Gate "
                        "on capability (> 1) or derive the expectation "
                        "from the mesh/plan (MeshSpec.resolve, "
                        "plan.dp_degree)", node)
                    return

    def _divmod(self, node: ast.BinOp) -> None:
        rhs = node.right
        if not (isinstance(rhs, ast.Constant)
                and isinstance(rhs.value, int)):
            return
        v = rhs.value
        if v < 2 or (v & (v - 1)):  # literal power-of-two >= 2 only
            return
        name = _dotted(node.left)
        if name is None and isinstance(node.left, ast.Subscript):
            name = _dotted(node.left.value)
        if name is None or not self._NAME_RE.search(
                name.split(".")[-1]):
            return
        op = "//" if isinstance(node.op, ast.FloorDiv) else "%"
        self.lint.add(
            "RLT601",
            f"per-host batch/rank math against a hardcoded device "
            f"count ({name} {op} {v}): the divisor is pinned to one "
            "world size, so an elastic reshard (or any other topology) "
            "silently mis-shards. Derive it from the mesh "
            "(parallel.mesh.batch_size_divisor(mesh), plan.dp_degree) "
            "— docs/ELASTIC.md", node)


# ---- RLT503: unbounded ledger reads on cadence-polled paths ---------------

#: terminal names of the evidence-ledger readers that parse a whole
#: growing *.jsonl (or a directory of them) per call; every one accepts
#: a tail/window bound its cadence-polled callers must thread
#: (telemetry/spans.py ledger_tail_lines is the shared substrate)
_LEDGER_READERS: Set[str] = {
    "read_spans", "read_metrics", "read_all_metrics",
    "newest_metrics_per_replica", "aggregate_metrics_dir",
    "load_signal_from_dir", "load_signal", "read_ledger",
    "read_ledgers", "read_incidents", "load_timeline",
    "load_timeline_events",
}

#: kwargs whose presence (with anything but a literal None) marks the
#: call bounded. A threaded VARIABLE counts — the caller owns the
#: bound; the defect this rule hunts is the reader given no bound at
#: all on a polled path.
_LEDGER_BOUND_KWARGS: Set[str] = {
    "tail_bytes", "max_bytes", "window", "limit", "last_n",
}


def _rlt503_bounded(call: ast.Call) -> bool:
    for kw in call.keywords:
        if kw.arg in _LEDGER_BOUND_KWARGS:
            if isinstance(kw.value, ast.Constant) \
                    and kw.value.value is None:
                continue
            return True
    return False


def _rlt503_loop_nodes(loop: ast.AST) -> Iterable[ast.AST]:
    """One loop's body nodes, nested loops included, nested function
    defs excluded (they run on their own schedule, not per poll)."""
    stack: List[ast.AST] = list(loop.body) + list(
        getattr(loop, "orelse", ()) or ())
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


def _rlt503_is_sleep(node: ast.AST) -> bool:
    if not isinstance(node, ast.Call):
        return False
    name = _dotted(node.func) or ""
    return name.split(".")[-1] == "sleep"


class _LedgerTailLint:
    """RLT503 unbounded-ledger-read (docs/OBSERVABILITY.md): a
    cadence-polled code path — a loop that sleeps between iterations
    (`monitor --follow`, a controller poll loop), or any same-file
    function reachable from one — parses an entire evidence ledger
    into memory every poll. The appended-forever ledgers make that a
    cost that grows with run age; every reader takes a tail/window
    bound, and threading one (even as a variable) sanctions the call.
    Reachability follows the same same-file call edges the traced-set
    fixpoint uses, so a reader two helpers below the follow loop still
    fires."""

    def __init__(self, lint: _FileLint):
        self.lint = lint
        self._reported: Set[int] = set()

    def _lint_call(self, node: ast.AST,
                   symbol: Optional[str]) -> None:
        if not isinstance(node, ast.Call) or id(node) in self._reported:
            return
        name = (_dotted(node.func) or "").split(".")[-1]
        if name not in _LEDGER_READERS or _rlt503_bounded(node):
            return
        self._reported.add(id(node))
        self.lint.add(
            "RLT503",
            f"{name}() parses its whole ledger on a cadence-polled "
            "path with no tail/window bound: the *.jsonl evidence "
            "ledgers are append-only and grow for the life of the "
            "run, so every poll re-parses all of history and the "
            "live view's cost grows without bound. Thread a bound "
            "(tail_bytes= / window= — the readers keep the "
            "clock-alignment header and the newest entries, which is "
            "all a live view needs; docs/OBSERVABILITY.md "
            "'unified timeline')", node, symbol)

    def run(self, tree: ast.Module, coll: "_Collector") -> None:
        polled: Set[int] = set()
        fn_of_id = {id(fn.node): fn for fn in coll.funcs}

        def _seed_from_loop(loop: ast.AST, cls: Optional[str],
                            symbol: Optional[str]) -> None:
            nodes = list(_rlt503_loop_nodes(loop))
            if not any(_rlt503_is_sleep(n) for n in nodes):
                return
            for n in nodes:
                self._lint_call(n, symbol)
                if not isinstance(n, ast.Call):
                    continue
                if isinstance(n.func, ast.Name):
                    for callee in coll.by_name.get(n.func.id, ()):
                        if callee.cls is None and callee.parent is None:
                            polled.add(id(callee.node))
                elif (isinstance(n.func, ast.Attribute)
                        and isinstance(n.func.value, ast.Name)
                        and n.func.value.id == "self"
                        and cls is not None):
                    callee = coll.by_method.get((cls, n.func.attr))
                    if callee is not None:
                        polled.add(id(callee.node))

        for fn in coll.funcs:
            for node in _own_nodes(fn.node):
                if isinstance(node, (ast.While, ast.For)):
                    _seed_from_loop(node, fn.cls, fn.qualname)
        # module-level polling scripts
        stack: List[ast.AST] = list(tree.body)
        while stack:
            node = stack.pop()
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
                continue
            if isinstance(node, (ast.While, ast.For)):
                _seed_from_loop(node, None, None)
                continue
            stack.extend(ast.iter_child_nodes(node))

        # propagate polled-ness along same-file call edges (the traced
        # fixpoint's resolution rules)
        changed = True
        while changed:
            changed = False
            for fn in coll.funcs:
                if id(fn.node) not in polled:
                    continue
                for kind, name in fn.calls:
                    if kind == "self" and fn.cls is not None:
                        callee = coll.by_method.get((fn.cls, name))
                        if callee is not None and \
                                id(callee.node) not in polled:
                            polled.add(id(callee.node))
                            changed = True
                    elif kind == "name":
                        for callee in coll.by_name.get(name, ()):
                            if callee.cls is None \
                                    and callee.parent is None \
                                    and id(callee.node) not in polled:
                                polled.add(id(callee.node))
                                changed = True
        for node_id in polled:
            fn = fn_of_id.get(node_id)
            if fn is None:
                continue
            for node in _own_nodes(fn.node):
                self._lint_call(node, fn.qualname)


# ---- RLT504: per-token channel chatter ------------------------------------

#: iteration sources that are one TICK's emitted tokens — the engine
#: returns them as a batch, so anything looping them is per-token
_RLT504_EMISSIONS_RE = re.compile(
    r"(?:^|_)(emissions|emitted|toks|tokens)(?:_|$)", re.IGNORECASE)
#: channel-shaped receivers: the request channel's writer/reader, the
#: worker side-channel queue, or anything named like one
_RLT504_RECEIVER_RE = re.compile(
    r"(?:^|_)(queue|channel|chan|writer|reader|sock|conn|pipe)"
    r"(?:_|$|\d)", re.IGNORECASE)
#: send/recv verbs that cost a syscall (+fsync on the command log) each
_RLT504_VERBS = {"send", "put", "put_nowait", "recv", "poll",
                 "send_bytes", "recv_bytes"}


class _ChannelChatterLint:
    """RLT504 per-token-channel-chatter (docs/SERVING.md "the request
    channel"): a serving worker's per-tick loop over the engine's
    emitted tokens doing an UNBATCHED channel operation per element.
    The engine tick already amortized the device work into one call; a
    per-token queue put / channel send / reader poll reintroduces a
    syscall (and on the command log an fsync) per TOKEN, so the wire
    chatter scales with tokens/tick instead of ticks and the worker
    loop stalls on I/O between emissions. The batched discipline —
    accumulate the tick's emissions, ONE side-channel item per
    iteration, ONE highest-seq ack per poll batch
    (serve/driver.py `_replica_session_main`) — never fires: its
    sends sit outside the per-token loop."""

    def __init__(self, lint: _FileLint):
        self.lint = lint

    @staticmethod
    def _emissions_name(it: ast.AST) -> Optional[str]:
        """Terminal name in the loop's iterable that reads as a token
        batch (`last_emissions`, `emitted`, `toks`) — looks through
        zip()/enumerate()/attribute chains."""
        for node in ast.walk(it):
            name = None
            if isinstance(node, ast.Name):
                name = node.id
            elif isinstance(node, ast.Attribute):
                name = node.attr
            if name and _RLT504_EMISSIONS_RE.search(name):
                return name
        return None

    def _lint_loop(self, loop: ast.For,
                   symbol: Optional[str]) -> None:
        src = self._emissions_name(loop.iter)
        if src is None:
            return
        for node in _rlt503_loop_nodes(loop):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in _RLT504_VERBS):
                continue
            recv = (_dotted(node.func.value) or "").split(".")[-1]
            if not _RLT504_RECEIVER_RE.search(recv):
                continue
            self.lint.add(
                "RLT504",
                f"{recv}.{node.func.attr}() runs once per element of "
                f"{src!r} — an unbatched channel operation per emitted "
                "TOKEN: each pays a syscall (+fsync on the command "
                "log) and a receiver wakeup, so wire chatter scales "
                "with tokens/tick instead of ticks and the decode "
                "loop stalls on I/O the engine tick already "
                "amortized. Batch the tick's emissions into ONE "
                "side-channel item and ack ONE highest-seq per poll "
                "batch (serve/channel.py, docs/SERVING.md 'the "
                "request channel')", node, symbol)

    def run(self, tree: ast.Module, funcs: List["_Func"]) -> None:
        traced_nodes = {id(fn.node) for fn in funcs if fn.traced}

        def walk(stmts, symbol):
            for node in stmts:
                if isinstance(node, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                    # a traced loop has no channel to chatter on —
                    # same scope rule as the other serve-loop lints
                    if id(node) not in traced_nodes:
                        walk(node.body, node.name)
                    continue
                if isinstance(node, ast.Lambda):
                    continue
                if isinstance(node, ast.For):
                    self._lint_loop(node, symbol)
                walk(list(ast.iter_child_nodes(node)), symbol)

        walk(tree.body, None)


# ---- RLT309: redundant prefix prefill -------------------------------------

#: serving submission verbs — one request enqueued per call
_RLT309_SUBMIT_VERBS = {"submit", "enqueue"}
#: prompt-concatenation spellings (torch.cat, np.concatenate + friends)
_RLT309_CONCAT = {"cat", "concatenate", "concat", "hstack"}


class _PrefixPrefillLint:
    """RLT309 redundant-prefix-prefill (docs/SERVING.md "prefix
    cache"): a serve-side loop submitting one request per iteration
    whose prompt PREPENDS a loop-invariant prefix — the shared system
    prompt — while the file never arms ``prefix_cache=True``. Every
    request then re-prefills the identical prefix tokens and holds its
    own pool copy of them; the scheduler's prefix cache prefills the
    common prefix ONCE and maps the full blocks into each table at
    refcount (`serve/kv_cache.py PrefixCache`, copy-on-write on
    divergence). Any ``prefix_cache=True`` keyword in the file
    sanctions it — the cache is armed, the loop is the intended
    usage."""

    def __init__(self, lint: _FileLint):
        self.lint = lint

    @staticmethod
    def _armed(nodes: List[ast.AST]) -> bool:
        for node in nodes:
            if not isinstance(node, ast.Call):
                continue
            for kw in node.keywords:
                if (kw.arg == "prefix_cache"
                        and isinstance(kw.value, ast.Constant)
                        and kw.value.value is True):
                    return True
        return False

    @staticmethod
    def _const_prefix(expr: ast.AST,
                      variant: Set[str]) -> Optional[str]:
        """The loop-invariant Name a prompt expression PREPENDS, or
        None. Covers ``np.concatenate([sys, tail])`` (list/tuple or
        vararg form) and ``sys + tail``."""
        if isinstance(expr, ast.Call):
            fname = (_dotted(expr.func) or "").split(".")[-1]
            if fname in _RLT309_CONCAT and expr.args:
                seq = expr.args[0]
                first = (seq.elts[0]
                         if isinstance(seq, (ast.List, ast.Tuple))
                         and seq.elts else seq)
                if (isinstance(first, ast.Name)
                        and first.id not in variant):
                    return first.id
        if isinstance(expr, ast.BinOp) and isinstance(expr.op, ast.Add):
            if (isinstance(expr.left, ast.Name)
                    and expr.left.id not in variant):
                return expr.left.id
        return None

    def _lint_loop(self, loop: ast.For,
                   symbol: Optional[str]) -> None:
        variant: Set[str] = {
            n.id for n in ast.walk(loop.target)
            if isinstance(n, ast.Name)}
        assigns: Dict[str, ast.AST] = {}
        nodes = list(_rlt503_loop_nodes(loop))
        for node in nodes:
            if isinstance(node, ast.Assign):
                for tgt in node.targets:
                    for n in ast.walk(tgt):
                        if isinstance(n, ast.Name):
                            variant.add(n.id)
                if (len(node.targets) == 1
                        and isinstance(node.targets[0], ast.Name)):
                    assigns[node.targets[0].id] = node.value
            elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
                for n in ast.walk(node.target):
                    if isinstance(n, ast.Name):
                        variant.add(n.id)
        for node in nodes:
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in _RLT309_SUBMIT_VERBS):
                continue
            for sub in ast.walk(node):
                if not isinstance(sub, ast.Call):
                    continue
                for kw in sub.keywords:
                    if kw.arg != "prompt":
                        continue
                    expr = kw.value
                    if (isinstance(expr, ast.Name)
                            and expr.id in assigns):
                        expr = assigns[expr.id]
                    prefix = self._const_prefix(expr, variant)
                    if prefix is None:
                        continue
                    recv = (_dotted(node.func.value)
                            or "").split(".")[-1]
                    self.lint.add(
                        "RLT309",
                        f"{recv}.{node.func.attr}() re-submits the "
                        f"loop-invariant prefix {prefix!r} on every "
                        "request's prompt without prefix_cache=True: "
                        "each request PREFILLS the identical prefix "
                        "again and pins its own pool copy of those "
                        "blocks. Arm the scheduler's prefix cache "
                        "(Scheduler(engine, prefix_cache=True)) — the "
                        "common prefix prefills ONCE and the full "
                        "blocks map into every table by refcount, "
                        "copy-on-write on divergence (serve/"
                        "kv_cache.py, docs/SERVING.md 'prefix cache')",
                        node, symbol)
                    return

    def run(self, tree: ast.Module, funcs: List["_Func"]) -> None:
        if self._armed(self.lint.nodes):
            return
        traced_nodes = {id(fn.node) for fn in funcs if fn.traced}

        def walk(stmts, symbol):
            for node in stmts:
                if isinstance(node, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                    # traced code has no scheduler to submit to —
                    # same scope rule as the other serve-loop lints
                    if id(node) not in traced_nodes:
                        walk(node.body, node.name)
                    continue
                if isinstance(node, ast.Lambda):
                    continue
                if isinstance(node, ast.For):
                    self._lint_loop(node, symbol)
                walk(list(ast.iter_child_nodes(node)), symbol)

        walk(tree.body, None)


# ---- RLT505: silent request drop ------------------------------------------

#: serving submission verbs — one request enters the system per call
_RLT505_SUBMIT_VERBS = {"submit", "enqueue"}
#: drains whose return value IS the typed record set — discarding it
#: discards the only evidence the request was rejected
_RLT505_DRAINS = {"take_sheds"}
#: record buffers a consumer may clear only after reading
_RLT505_BUFFERS = {"last_sheds", "last_preemptions"}


class _SilentDropLint:
    """RLT505 silent-request-drop (docs/SERVING.md "traffic & SLO
    classes"): serving code that makes a request disappear without a
    typed record. Two shapes:

    * a broad ``except``/``except Exception`` whose body only
      ``pass``/``continue``s wrapped around a `submit()`/`enqueue()`
      call — the request vanishes with no terminal status, no shed
      record, no counter;
    * `take_sheds()` called as a bare expression statement (or a
      ``last_sheds``/``last_preemptions`` buffer ``.clear()``ed) —
      the scheduler produced typed shed/preemption records and the
      caller threw them away, so the stream never gets its terminal
      meta and the client retries blind.

    The graceful-overload contract is explicit degradation: every
    rejected rid ends with a reason + retry-after hint. A consumer
    that intentionally discards (e.g. a lockstep follower whose
    LEADER owns emission) sanctions the line with
    ``# rlt: disable=RLT505``."""

    def __init__(self, lint: _FileLint):
        self.lint = lint

    @staticmethod
    def _swallows(handler: ast.ExceptHandler) -> bool:
        """Broad handler whose body only pass/continue/...-es."""
        t = handler.type
        broad = t is None or (
            isinstance(t, (ast.Name, ast.Attribute))
            and (_dotted(t) or "").split(".")[-1]
            in ("Exception", "BaseException"))
        if not broad:
            return False
        for stmt in handler.body:
            if isinstance(stmt, (ast.Pass, ast.Continue)):
                continue
            if (isinstance(stmt, ast.Expr)
                    and isinstance(stmt.value, ast.Constant)):
                continue
            return False
        return True

    def _lint_try(self, node: ast.Try, symbol: Optional[str]) -> None:
        submits = [
            sub for stmt in node.body for sub in ast.walk(stmt)
            if isinstance(sub, ast.Call)
            and isinstance(sub.func, ast.Attribute)
            and sub.func.attr in _RLT505_SUBMIT_VERBS]
        if not submits:
            return
        for handler in node.handlers:
            if not self._swallows(handler):
                continue
            call = submits[0]
            recv = (_dotted(call.func.value) or "").split(".")[-1]
            self.lint.add(
                "RLT505",
                f"a broad except around {recv}.{call.func.attr}() "
                "swallows the failure with a bare pass — the request "
                "vanishes with no terminal status, no typed shed "
                "record, no counter: the client retries blind and "
                "the loss is invisible to watch/metrics. Record a "
                "terminal outcome (or re-raise); rejection must be "
                "EXPLICIT — a typed record with a retry-after hint "
                "(docs/SERVING.md 'traffic & SLO classes')",
                handler, symbol)

    def _lint_expr(self, node: ast.Expr,
                   symbol: Optional[str]) -> None:
        call = node.value
        if not (isinstance(call, ast.Call)
                and isinstance(call.func, ast.Attribute)):
            return
        verb = call.func.attr
        if verb in _RLT505_DRAINS:
            recv = (_dotted(call.func.value) or "").split(".")[-1]
            self.lint.add(
                "RLT505",
                f"{recv}.{verb}() drained as a bare statement — the "
                "typed shed records (rid, reason, retry_after_s) are "
                "produced and immediately discarded: every shed "
                "stream loses its terminal status and the drop is "
                "silent (docs/SERVING.md 'traffic & SLO classes'). "
                "Turn each record into a terminal outcome on the "
                "stream; an intentional discard (lockstep follower — "
                "the leader owns emission) sanctions the line with "
                "# rlt: disable=RLT505", node, symbol)
            return
        if (verb == "clear" and isinstance(call.func.value,
                                           ast.Attribute)
                and call.func.value.attr in _RLT505_BUFFERS):
            self.lint.add(
                "RLT505",
                f"{call.func.value.attr}.clear() wipes the "
                "scheduler's typed record buffer without reading it "
                "— shed/preemption evidence is destroyed before any "
                "consumer could turn it into terminal stream status "
                "(docs/SERVING.md 'traffic & SLO classes')",
                node, symbol)

    def run(self, tree: ast.Module, funcs: List["_Func"]) -> None:
        traced_nodes = {id(fn.node) for fn in funcs if fn.traced}

        def walk(stmts, symbol):
            for node in stmts:
                if isinstance(node, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                    # traced code has no scheduler to drop from —
                    # same scope rule as the other serve-loop lints
                    if id(node) not in traced_nodes:
                        walk(node.body, node.name)
                    continue
                if isinstance(node, ast.Lambda):
                    continue
                if isinstance(node, ast.Try):
                    self._lint_try(node, symbol)
                elif isinstance(node, ast.Expr):
                    self._lint_expr(node, symbol)
                walk(list(ast.iter_child_nodes(node)), symbol)

        walk(tree.body, None)


def lint_source(source: str, filename: str = "<string>",
                extra_axes: Sequence[str] = ()) -> List[Finding]:
    """Lint one file's source text. Never imports the target."""
    lint = _FileLint(source, filename, extra_axes)
    try:
        tree = ast.parse(source, filename=filename)
    except SyntaxError as exc:
        lint.add("RLT001", f"does not parse: {exc.msg}",
                 type("_N", (), {"lineno": exc.lineno or 1,
                                 "col_offset": exc.offset or 0})())
        return lint.findings
    #: every node of the file, walked once for the rules that scan it all
    lint.nodes = list(ast.walk(tree))

    coll = _Collector(lint)
    coll.visit(tree)
    coll.mark_targets()
    res = _ResilienceLint(lint)
    # imports first, regardless of where they sit in the file (a Try
    # above a late import must still see the imported generic names)
    for node in lint.nodes:
        if isinstance(node, ast.ImportFrom):
            res.visit_ImportFrom(node)
    res.visit(tree)

    # step-code fixpoint: containment + same-file call edges
    changed = True
    while changed:
        changed = False
        for fn in coll.funcs:
            if fn.traced:
                continue
            if fn.parent is not None and fn.parent.traced:
                fn.traced = True
                changed = True
                continue
        for fn in coll.funcs:
            if not fn.traced:
                continue
            for kind, name in fn.calls:
                if kind == "self" and fn.cls is not None:
                    callee = coll.by_method.get((fn.cls, name))
                    if callee is not None and not callee.traced:
                        callee.traced = True
                        changed = True
                elif kind == "name":
                    for callee in coll.by_name.get(name, ()):
                        # bare-name calls resolve to module-level defs
                        # only (a method never shadows a global name)
                        if callee.cls is None and callee.parent is None \
                                and not callee.traced:
                            callee.traced = True
                            changed = True

    for fn in coll.funcs:
        if fn.traced:
            _lint_traced_body(lint, fn)
    # RLT304 needs the FINAL step-code set: hot-loop rules fire only
    # outside it (a loop in step code is RLT201's scope)
    _HotLoopLint(lint).run(tree, coll.funcs)
    _TelemetryCallbackLint(lint).run(tree)
    _ServeLoopLint(lint).run(tree, coll.funcs)
    _PinnedWorldLint(lint).run(tree)
    _LedgerTailLint(lint).run(tree, coll)
    _ChannelChatterLint(lint).run(tree, coll.funcs)
    _PrefixPrefillLint(lint).run(tree, coll.funcs)
    _SilentDropLint(lint).run(tree, coll.funcs)
    return lint.findings


def iter_python_files(targets: Sequence[str]) -> List[str]:
    """Expand files / directories (recursively) to .py paths."""
    out: List[str] = []
    for t in targets:
        if os.path.isdir(t):
            for root, dirs, files in os.walk(t):
                dirs[:] = sorted(d for d in dirs
                                 if d not in ("__pycache__", ".git"))
                out.extend(os.path.join(root, f) for f in sorted(files)
                           if f.endswith(".py"))
        else:
            out.append(t)
    return out


def lint_paths(paths: Sequence[str],
               extra_axes: Sequence[str] = ()) -> List[Finding]:
    """Lint files and/or directories; returns all findings."""
    findings: List[Finding] = []
    for path in iter_python_files(paths):
        with open(path, "r", encoding="utf-8") as fh:
            findings.extend(lint_source(fh.read(), path, extra_axes))
    return findings
