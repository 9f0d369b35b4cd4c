"""numcheck (twin of `ray_lightning_tpu/analysis/numcheck.py`): the
mixed-precision audit (RLT8xx) of the train step, over the operator
stream tracecheck records (`tracecheck.Recorder`), where the JAX module
walks a jaxpr.

Each rule in torch's semantics:

  * RLT801 low-precision-accumulation — a GEMM (``mm``, ``bmm``,
    ``addmm``, ...) with a bf16/f16 output and a contraction longer than
    `LOW_PRECISION_EXTENT`, traced while cuBLAS may reduce its split-K
    partial sums in the narrow dtype
    (``torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction``
    on, torch's default). Under `ops.precision.pin_f32_accumulation` the
    same GEMM accumulates in f32 and rounds once: the form the rule
    sanctions, as ``preferred_element_type=f32`` is in JAX. The JAX
    rule's other half, a ``reduce_sum`` over a bf16 operand, cannot fire
    in torch: its reductions of a bf16 tensor accumulate in f32 (the
    operator's ``opmath`` type) and round once, whatever the flags.
  * RLT802 unstable-primitive-in-low-precision — exp/exp2/log/log2/
    log1p/rsqrt on a bf16/f16 operand, unless the operand is
    max-subtracted (``x - amax(x)``, tracked through layout operators).
    Torch computes these in f32 inside the kernel but takes and returns
    the narrow dtype, as XLA does, so the rule reads the same.
  * RLT803 cast-churn — an f32 value rounded to bf16/f16 and converted
    straight back to f32 with only layout operators between, in the
    forward. Rounding a GEMM's fresh f32 output once is RLT801's
    prescription and opens no round trip; a rounding in the backward is a
    cotangent taking its primal's dtype at an autograd function's
    boundary, and a forward rounding read back by the backward a saved
    activation: the seams the JAX rule sanctions across custom-vjp
    files.
  * RLT804 low-precision-gradient-collective — a gradient all-reduce or
    reduce-scatter (tracecheck's `CollectiveEvent`s: FSDP's unit
    reduce-scatters, a DDP bucket) on a bf16/f16 payload while the
    optimizer state of its parameters is stored wider; widths from
    `costmodel.DTYPE_WIDTHS`, the table the plan checker's RLT105 reads.
  * RLT805 quant-contract — an int8/int4 value converted to float and
    used by float arithmetic before a multiply or divide by an f32 (or
    wider) scale, or scaled by a narrower one.

The module also holds the static pass behind ``lint --numerics``
(`check_numerics_sources`): a ``torch.matmul``/``torch.mm``/
``torch.bmm``/``torch.einsum``/``F.linear`` call with an operand cast
inline to bf16/f16 (``.to(torch.bfloat16)``, ``.bfloat16()``,
``.half()``) in a file that never pins f32 accumulation (RLT801), or an
operand cast inline to int8 (RLT805); and the JAX forms (``jnp.dot``...
with an inline ``.astype(jnp.bfloat16)`` and no
``preferred_element_type``), as the port's linter reads both.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

from ray_lightning_tpu_torch.analysis.costmodel import dtype_width
from ray_lightning_tpu_torch.analysis.findings import Finding

__all__ = [
    "LOW_PRECISION_EXTENT", "numcheck_stream", "numcheck_jaxpr",
    "check_gradient_collectives", "check_numerics_sources",
    "check_numerics_paths", "summarize",
]

#: contraction extents at or below this are sanctioned for RLT801 (a
#: K-term bf16 sum loses ~log2(K) of its 8 mantissa bits: 256 terms cost
#: at most one decimal digit)
LOW_PRECISION_EXTENT = 256

_LOW_FLOAT = frozenset({"bfloat16", "float16"})
_QUANT_INT = frozenset({"int8", "int4", "uint4"})
_FLOATS = frozenset({"bfloat16", "float16", "float32", "float64",
                     "float8_e4m3fn", "float8_e5m2"})

#: operators that move or relabel bytes: provenance rides through
_CARRIES = frozenset({
    "aten.view", "aten._unsafe_view", "aten.reshape", "aten.permute",
    "aten.transpose", "aten.t", "aten.expand", "aten.slice",
    "aten.select", "aten.unsqueeze", "aten.squeeze", "aten.alias",
    "aten.detach", "aten.as_strided", "aten.clone", "aten.contiguous",
    "aten.split", "aten.unbind", "aten.split_with_sizes", "aten.narrow",
    "aten.neg", "aten.gather", "aten.index", "aten.cat",
    "aten.constant_pad_nd", "aten.lift_fresh",
})
_GEMMS = frozenset({"aten.mm", "aten.bmm", "aten.addmm", "aten.baddbmm",
                    "aten.matmul", "aten.dot", "aten.linear"})
_UNSTABLE = frozenset({"aten.exp", "aten.exp2", "aten.log", "aten.log2",
                       "aten.log1p", "aten.rsqrt"})
_MAXES = frozenset({"aten.amax", "aten.max", "aten.logsumexp"})
_FLOAT_MATH = frozenset({"aten.add", "aten.sub", "aten.sum",
                         "aten.mean"}) | _GEMMS
_SCALES = frozenset({"aten.mul", "aten.div"})


@dataclasses.dataclass
class _Prov:
    #: (dtype it was rounded from, event index, in the backward?) of a
    #: narrow value. A forward rounding read back by the backward (a
    #: saved bf16 activation upcast by an autograd rule) is the seam the
    #: JAX rule sanctions across custom-vjp files: not a round trip.
    cast_from: Optional[Tuple[str, int, bool]] = None
    submax: bool = False
    is_max: bool = False
    quant: bool = False
    acc: bool = False
    widest: Optional[str] = None
    #: the pending RLT803 this value's upcast opened (dropped when a GEMM
    #: takes the value: widening a GEMM's operands is how the CPU form of
    #: `ops.precision.linear_f32_out` accumulates in f32, no round trip)
    churn: Optional[tuple] = None


def _wider(a: Optional[str], b: Optional[str]) -> Optional[str]:
    if a is None or a not in _FLOATS:
        return b if b in _FLOATS else a
    if b is None or b not in _FLOATS:
        return a
    return a if (dtype_width(a) or 0) >= (dtype_width(b) or 0) else b


def _contraction(ev) -> int:
    shapes = ev.in_shapes
    if ev.name in ("aten.addmm", "aten.baddbmm") and len(shapes) > 1:
        return shapes[1][-1] if shapes[1] else 0
    return shapes[0][-1] if shapes and shapes[0] else 0


def numcheck_stream(events: Sequence[Any]
                    ) -> Tuple[List[Finding], Dict[str, Any]]:
    """RLT801/802/803/805 over a recorded operator stream (a
    `tracecheck.Recorder`'s ``events``); returns ``(findings, info)``,
    ``info["loss_widest_dtype"]`` being the widest float dtype on the
    provenance of the forward's last output (the loss)."""
    prov: Dict[int, _Prov] = {}
    findings: List[Finding] = []
    seen = set()
    last_fwd: Optional[_Prov] = None
    pending: Dict[tuple, Tuple[str, str]] = {}

    def read(i: int) -> _Prov:
        return prov.get(i) or _Prov()

    def once(rule: str, key, message: str, symbol: str) -> None:
        if (rule, key) in seen:
            return
        seen.add((rule, key))
        findings.append(Finding(rule, message, symbol=symbol))

    for idx, ev in enumerate(events):
        if getattr(ev, "kind", None) is not None:
            continue
        name = ev.name
        ins = [read(i) for i in ev.in_ids]
        in_dt = ev.in_dtypes
        out_dt = ev.out_dtypes[0] if ev.out_dtypes else None
        where = f"{name} {list(ev.in_shapes[:2])}"
        sym = (ev.unit or name)
        widest = None
        for p, d in zip(ins, in_dt):
            widest = _wider(widest, _wider(p.widest, d))
        new = _Prov(widest=_wider(widest, out_dt))
        if name in _GEMMS:
            k = _contraction(ev)
            if out_dt in _LOW_FLOAT and k > LOW_PRECISION_EXTENT and \
                    ev.extra.get("reduced"):
                once("RLT801", (name, ev.in_shapes),
                     f"{where}: a {out_dt} GEMM over a {k}-long "
                     "contraction traced with cuBLAS's reduced-precision "
                     "reduction on: its split-K partial sums may round in "
                     f"{out_dt} — pin f32 accumulation "
                     "(ops.precision.pin_f32_accumulation)", sym)
            for p in ins:
                pending.pop(p.churn, None)
            in_w = min((dtype_width(d) or 4) for d in in_dt) if in_dt else 4
            new.acc = (dtype_width(out_dt) or 0) > in_w
            if any(p.quant for p in ins):
                once("RLT805", (name, ev.in_shapes),
                     f"{where}: float GEMM on an int8-origin value with "
                     "no dequantization scale applied", sym)
        elif name in _UNSTABLE:
            if in_dt and in_dt[0] in _LOW_FLOAT and not ins[0].submax:
                once("RLT802", (name, ev.in_shapes),
                     f"{where}: {name.split('.')[-1]} of a {in_dt[0]} "
                     "operand that is not max-subtracted: exp overflows "
                     "at x>88, log and rsqrt lose their low bits — "
                     "upcast to float32 first", sym)
        elif name == "aten._to_copy" and in_dt and out_dt:
            src = ins[0]
            bwd = bool(ev.extra.get("bwd"))
            if out_dt in _LOW_FLOAT and in_dt[0] in ("float32", "float64"):
                # a rounding in the backward is a cotangent taking its
                # primal's dtype at an autograd function's boundary (the
                # seam the JAX rule sanctions across custom-vjp files)
                if not src.acc and not bwd:
                    new.cast_from = (in_dt[0], idx, bwd)
            elif out_dt in ("float32", "float64") and in_dt[0] in \
                    _LOW_FLOAT and src.cast_from is not None and \
                    src.cast_from[2] == bwd:
                nbytes = 1
                for d in ev.out_shapes[0] if ev.out_shapes else ():
                    nbytes *= d
                wasted = nbytes * ((dtype_width(in_dt[0]) or 2) + (
                    dtype_width(out_dt) or 4))
                key = ("RLT803", src.cast_from[1])
                if key not in seen:
                    new.churn = key
                    pending[key] = (
                        f"{where}: a {src.cast_from[0]} value rounded to "
                        f"{in_dt[0]} and converted straight back to "
                        f"{out_dt}: the round trip buys nothing, costs a "
                        f"rounding and moves {int(wasted)} bytes", sym)
            if in_dt[0] in _QUANT_INT and out_dt in _FLOATS:
                new.quant = True
            elif src.quant and out_dt in _FLOATS:
                new.quant = True
            new.submax = src.submax
        elif name in _CARRIES:
            if ins:
                new.cast_from = ins[0].cast_from
                new.submax = ins[0].submax
                new.is_max = ins[0].is_max
                new.quant = ins[0].quant
                new.churn = ins[0].churn
        elif name in _MAXES:
            new.is_max = True
        elif name == "aten.sub" and len(ins) > 1 and ins[1].is_max:
            new.submax = True
        elif name in _SCALES and ins and any(p.quant for p in ins):
            scales = [d for p, d in zip(ins, in_dt) if not p.quant]
            if scales and all(d in _FLOATS for d in scales):
                narrow = [d for d in scales if (dtype_width(d) or 4) < 4]
                if narrow:
                    once("RLT805", (name, ev.in_shapes),
                         f"{where}: an int8-origin value scaled by a "
                         f"{narrow[0]} scale: the scale must be float32 "
                         "or wider", sym)
                new.quant = False
            else:
                new.quant = True
        elif name in _FLOAT_MATH and any(p.quant for p in ins) and \
                out_dt in _FLOATS:
            once("RLT805", (name, ev.in_shapes),
                 f"{where}: float arithmetic on an int8-origin value with "
                 "no dequantization scale applied", sym)
        for i in ev.out_ids:
            prov[i] = new
        if not ev.extra.get("bwd") and ev.out_dtypes and \
                ev.out_dtypes[0] in _FLOATS:
            last_fwd = new
    for key, (message, sym) in pending.items():
        once(key[0], key[1:], message, sym)
    info: Dict[str, Any] = {}
    if last_fwd is not None:
        info["loss_widest_dtype"] = last_fwd.widest
    return findings, info


#: the JAX name: the port walks the recorded operator stream, not a jaxpr
numcheck_jaxpr = numcheck_stream


def _opt_width(named_params: Mapping[str, Any],
               named_opt: Mapping[str, Any]) -> Dict[str, float]:
    """The widest optimizer state a parameter has, by parameter name
    (state keys are ``<state>/<param>``, as `tracecheck` names them)."""
    out: Dict[str, float] = {}
    for opath, leaf in named_opt.items():
        pname = opath.split("/", 1)[-1]
        if pname not in named_params:
            continue
        p = named_params[pname]
        if tuple(getattr(leaf, "shape", ())) != tuple(p.shape):
            continue
        w = dtype_width(leaf.dtype) or 0.0
        out[pname] = max(out.get(pname, 0.0), w)
    return out


def check_gradient_collectives(
        events: Sequence[Any],
        named_params: Mapping[str, Any],
        named_opt: Mapping[str, Any]) -> List[Finding]:
    """RLT804 over tracecheck's `CollectiveEvent`s: a gradient all-reduce
    or reduce-scatter whose payload is bf16/f16 while the optimizer state
    of its parameter (an FSDP unit's event names the unit: every
    parameter under it) is stored wider."""
    opt_w = _opt_width(named_params, named_opt)
    findings: List[Finding] = []
    seen = set()
    for ev in events:
        if getattr(ev, "kind", None) not in ("all_reduce", "psum",
                                             "reduce_scatter"):
            continue
        dt = getattr(ev, "dtype", None)
        path = getattr(ev, "param_path", None)
        if dt not in _LOW_FLOAT or not path or \
                not path.startswith("params/"):
            continue
        ppath = path.split("/", 1)[1]
        ws = [w for n, w in opt_w.items()
              if n == ppath or n.startswith(ppath + ".")
              or ppath == "<root>"]
        ow = max(ws, default=0.0)
        gw = dtype_width(dt) or 0.0
        if ow > gw and (ev.source, path) not in seen:
            seen.add((ev.source, path))
            findings.append(Finding(
                "RLT804",
                f"gradient {ev.kind} over {'x'.join(ev.axes)} runs on a "
                f"{dt} payload while {ppath}'s optimizer state is stored "
                f"{ow:g}-byte wide: the ring reduction accumulates in the "
                "wire dtype before the optimizer sees the sum — reduce "
                "the gradients in float32 (FSDP's MixedPrecisionPolicy "
                f"reduce_dtype) [at {ev.source}]", symbol=path))
    return findings


def summarize(findings: Sequence[Finding]) -> dict:
    """Counts by rule, as `concurrency.summarize` gives them."""
    by_rule: Dict[str, int] = {}
    for f in findings:
        by_rule[f.rule] = by_rule.get(f.rule, 0) + 1
    return {"total": len(findings), "by_rule": dict(sorted(by_rule.items()))}


# --------------------------------------------------------------------------
# the static pass — `lint --numerics`
# --------------------------------------------------------------------------

_AST_DOT_CALLS = frozenset({
    "torch.matmul", "torch.mm", "torch.bmm", "torch.einsum",
    "torch.tensordot", "F.linear", "torch.nn.functional.linear",
    "jnp.dot", "jnp.matmul", "jnp.einsum", "jnp.tensordot",
    "jax.numpy.dot", "jax.numpy.matmul", "jax.numpy.einsum",
    "lax.dot_general", "jax.lax.dot_general",
})
_JAX_CALLS = frozenset(c for c in _AST_DOT_CALLS
                       if c.split(".")[0] in ("jnp", "jax", "lax"))
_AST_LOW_FLOAT = frozenset({
    "torch.bfloat16", "torch.float16", "torch.half", "jnp.bfloat16",
    "jnp.float16", "jax.numpy.bfloat16", "jax.numpy.float16",
    "np.float16", "bfloat16", "float16",
})
_AST_QUANT = frozenset({
    "torch.int8", "jnp.int8", "jnp.int4", "jax.numpy.int8",
    "jax.numpy.int4", "np.int8", "int8", "int4",
})
_LOW_METHODS = {"bfloat16": "torch.bfloat16", "half": "torch.float16"}
_PINS = ("pin_f32_accumulation",
         "allow_bf16_reduced_precision_reduction")


def _ast_dotted(node) -> Optional[str]:
    import ast

    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _cast_target(node) -> Optional[str]:
    """The dtype an inline cast of ``node`` names (``x.to(torch.bfloat16)``,
    ``x.to(dtype=...)``, ``x.type(...)``, ``x.bfloat16()``, ``x.half()``,
    ``x.astype(jnp.bfloat16)``), else None."""
    import ast

    if not (isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)):
        return None
    attr = node.func.attr
    if attr in _LOW_METHODS and not node.args:
        return _LOW_METHODS[attr]
    if attr == "char" and not node.args:
        return "torch.int8"
    if attr not in ("to", "type", "astype"):
        return None
    args = list(node.args) + [kw.value for kw in node.keywords
                              if kw.arg == "dtype"]
    for arg in args:
        if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
            return arg.value
        name = _ast_dotted(arg)
        if name is not None and (name in _AST_LOW_FLOAT
                                 or name in _AST_QUANT):
            return name
    return None


def check_numerics_sources(
        sources: Sequence[Tuple[str, str]]) -> List[Finding]:
    """Run the static numerics pass over (filename, source) pairs."""
    import ast

    from ray_lightning_tpu_torch.analysis.linter import _FileLint

    out: List[Finding] = []
    for filename, source in sources:
        try:
            tree = ast.parse(source)
        except SyntaxError:
            continue  # the linter owns RLT001
        pinned = any(p in source for p in _PINS)
        lint = _FileLint(source, filename)
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            callee = _ast_dotted(node.func)
            if callee not in _AST_DOT_CALLS:
                continue
            jax_form = callee in _JAX_CALLS
            sanctioned = (any(kw.arg == "preferred_element_type"
                              for kw in node.keywords) if jax_form
                          else pinned)
            for arg in node.args:
                dt = _cast_target(arg)
                if dt is None:
                    continue
                if dt in _AST_LOW_FLOAT and not sanctioned:
                    fix = ("add preferred_element_type=jnp.float32"
                           if jax_form else
                           "pin f32 accumulation "
                           "(ops.precision.pin_f32_accumulation) or keep "
                           "the operands float32")
                    lint.add(
                        "RLT801",
                        f"{callee} consumes an operand cast inline to "
                        f"{dt} with no f32 accumulation: the contraction "
                        f"may accumulate (and round) in the narrow dtype "
                        f"— {fix}", node=node)
                    break
                if dt in _AST_QUANT:
                    lint.add(
                        "RLT805",
                        f"{callee} consumes an operand cast inline to "
                        f"{dt}: quantized payloads need their f32 "
                        "dequantization scale applied before float math",
                        node=node)
                    break
        out.extend(lint.findings)
    return out


def check_numerics_paths(paths: Sequence[str]) -> List[Finding]:
    """The static pass over files and directories (recursively)."""
    from ray_lightning_tpu_torch.analysis.linter import iter_python_files

    files = iter_python_files(paths)
    sources: List[Tuple[str, str]] = []
    common = ""
    if len(files) > 1:
        common = os.path.commonpath([os.path.abspath(f) for f in files])
    elif files:
        common = os.path.dirname(os.path.abspath(files[0]))
    for f in files:
        try:
            with open(f, "r", encoding="utf-8") as fh:
                source = fh.read()
        except OSError:
            continue
        rel = os.path.relpath(os.path.abspath(f), common) if common else f
        sources.append((rel, source))
    return check_numerics_sources(sources)
