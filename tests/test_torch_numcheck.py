"""numcheck (`ray_lightning_tpu_torch/analysis/numcheck.py`) on twin
programs: the same computation written in jnp (walked by the JAX
numcheck over its jaxpr) and in torch (walked over the operator stream
tracecheck records), each rule's firing and sanctioned forms held case
for case with `tests/test_numcheck.py`; RLT804 over collective events;
the static pass behind ``lint --numerics`` on both spellings; and the
half of RLT801 torch's semantics cannot reach (a bf16 sum accumulates in
f32), shown."""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_lightning_tpu.analysis import numcheck as jnc
from ray_lightning_tpu_torch.analysis import numcheck as nc
from ray_lightning_tpu_torch.analysis.tracecheck import (
    CollectiveEvent,
    record_ops,
)
from ray_lightning_tpu_torch.ops.precision import pin_f32_accumulation


def _jax_rules(fn, *args):
    return sorted({f.rule for f in jnc.numcheck_jaxpr(
        jax.make_jaxpr(fn)(*args))[0]})


def _torch_rules(fn, *args, reduced=True):
    flag = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
        reduced
    try:
        with record_ops() as rec:
            fn(*args)
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            flag
    return sorted({f.rule for f in nc.numcheck_stream(rec.events)[0]})


def _pair(shape, dtype):
    x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    jd = {"bf16": jnp.bfloat16, "f32": jnp.float32, "i8": jnp.int8}[dtype]
    td = {"bf16": torch.bfloat16, "f32": torch.float32,
          "i8": torch.int8}[dtype]
    if dtype == "i8":
        x = np.clip(x * 40, -127, 127)
    return jnp.asarray(x).astype(jd), torch.from_numpy(x).to(td)


# (name, jax fn, torch fn, operands, the rules both fire)
TWINS = [
    ("RLT801 bf16 GEMM, long contraction",
     lambda a, b: a @ b, lambda a, b: a @ b,
     [((8, 512), "bf16"), ((512, 8), "bf16")], ["RLT801"]),
    ("RLT801 small extent sanctioned",
     lambda a, b: a @ b, lambda a, b: a @ b,
     [((8, 64), "bf16"), ((64, 8), "bf16")], []),
    ("RLT802 exp of bf16",
     lambda x: jnp.exp(x), lambda x: torch.exp(x), [((4, 8), "bf16")],
     ["RLT802"]),
    ("RLT802 log of bf16",
     lambda x: jnp.log(x), lambda x: torch.log(x), [((4, 8), "bf16")],
     ["RLT802"]),
    ("RLT802 f32 operand sanctioned",
     lambda x: jnp.exp(x), lambda x: torch.exp(x), [((4, 8), "f32")], []),
    ("RLT802 max-subtracted sanctioned",
     lambda x: jnp.exp(x - jnp.max(x, axis=-1, keepdims=True)),
     lambda x: torch.exp(x - x.amax(dim=-1, keepdim=True)),
     [((4, 8), "bf16")], []),
    ("RLT803 round trip",
     lambda x: x.astype(jnp.bfloat16).astype(jnp.float32) * 2,
     lambda x: x.to(torch.bfloat16).to(torch.float32) * 2,
     [((4, 8), "f32")], ["RLT803"]),
    ("RLT803 compute between sanctioned",
     lambda x: (x.astype(jnp.bfloat16) * 3).astype(jnp.float32),
     lambda x: (x.to(torch.bfloat16) * 3).to(torch.float32),
     [((4, 8), "f32")], []),
    ("RLT805 unscaled int8 in float math",
     lambda q, y: q.astype(jnp.float32) + y,
     lambda q, y: q.to(torch.float32) + y,
     [((4, 8), "i8"), ((4, 8), "f32")], ["RLT805"]),
    ("RLT805 f32 scale sanctioned",
     lambda q, s: q.astype(jnp.float32) * s + 1.0,
     lambda q, s: q.to(torch.float32) * s + 1.0,
     [((4, 8), "i8"), ((4, 8), "f32")], []),
    ("RLT805 bf16 scale",
     lambda q, s: q.astype(jnp.bfloat16) * s,
     lambda q, s: q.to(torch.bfloat16) * s,
     [((4, 8), "i8"), ((4, 8), "bf16")], ["RLT805"]),
]


@pytest.mark.parametrize("name,jfn,tfn,operands,rules", TWINS,
                         ids=[t[0] for t in TWINS])
def test_twin_programs_fire_alike(name, jfn, tfn, operands, rules):
    pairs = [_pair(s, d) for s, d in operands]
    assert _jax_rules(jfn, *[p[0] for p in pairs]) == rules
    assert _torch_rules(tfn, *[p[1] for p in pairs]) == rules


def test_rlt801_sanctioned_under_pinned_f32_accumulation():
    """The form RLT801 sanctions in torch: the same bf16 GEMM with cuBLAS's
    reduced-precision reduction off (`pin_f32_accumulation`), as
    ``preferred_element_type=f32`` is in JAX."""
    a, b = _pair((8, 512), "bf16")[1], _pair((512, 8), "bf16")[1]
    assert _torch_rules(lambda x, y: x @ y, a, b, reduced=False) == []
    ja, jb = _pair((8, 512), "bf16")[0], _pair((512, 8), "bf16")[0]
    assert _jax_rules(lambda x, y: jax.lax.dot(
        x, y, preferred_element_type=jnp.float32).astype(jnp.bfloat16),
        ja, jb) == []
    flag = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    try:
        pin_f32_accumulation()
        assert not (torch.backends.cuda.matmul
                    .allow_bf16_reduced_precision_reduction)
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            flag


def test_rlt801_bf16_sum_cannot_fire_in_torch():
    """Why the reduction half of RLT801 never fires in the port: torch's
    sum of a bf16 tensor accumulates in f32 and rounds once (it equals
    the f32 sum rounded), where the JAX rule fires on a raw bf16
    reduce_sum."""
    x = torch.full((4096,), 1.0, dtype=torch.bfloat16) + \
        torch.linspace(0, 1e-2, 4096).to(torch.bfloat16)
    assert x.sum() == x.float().sum().to(torch.bfloat16)
    assert _torch_rules(lambda t: t.sum(), x) == []
    jx = jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
    assert _jax_rules(lambda t: jax.lax.reduce_sum_p.bind(
        t, axes=(0,)), jx) == ["RLT801"]


def _jev(**kw):
    base = dict(axes=("data",), source="s", count=1, wire_bytes=0,
                time_us=0.0, implicit=False, payload_bytes=8)
    base.update(kw)
    return types.SimpleNamespace(**base)


@pytest.mark.parametrize("kind,jkind,dtype,fire", [
    ("reduce_scatter", "reduce_scatter", "bfloat16", True),
    ("all_reduce", "psum", "bfloat16", True),
    ("all_reduce", "psum", "float32", False),
    ("all_gather", "all_gather", "bfloat16", False),
])
def test_rlt804_on_gradient_collectives_as_jax(kind, jkind, dtype, fire):
    params = {"layers.0.w": torch.zeros(8, 8)}
    opt = {"exp_avg/layers.0.w": torch.zeros(8, 8)}
    ev = CollectiveEvent(kind=kind, axes=("fsdp",), payload_bytes=128,
                         count=1, wire_bytes=0, time_us=0.0, implicit=False,
                         source="FSDP::post_backward_reduce (layers.0)",
                         param_path="params/layers.0", dtype=dtype)
    got = nc.check_gradient_collectives([ev, ev], params, opt)
    jparams = {"layers/w/kernel": types.SimpleNamespace(
        shape=(8, 8), dtype=np.dtype("float32"))}
    jopt = {"mu/layers/w/kernel": jparams["layers/w/kernel"]}
    want = jnc.check_gradient_collectives(
        [_jev(kind=jkind, dtype=dtype, param_path="params/layers/w/kernel")],
        jparams, jopt)
    assert [f.rule for f in got] == [f.rule for f in want] == (
        ["RLT804"] if fire else [])
    bf16_opt = {"exp_avg/layers.0.w": torch.zeros(8, 8,
                                                  dtype=torch.bfloat16)}
    assert nc.check_gradient_collectives([ev], params, bf16_opt) == []


SOURCES = {
    "torch inline bf16 operand": (
        "import torch\n"
        "def f(x, w):\n"
        "    return torch.matmul(x.to(torch.bfloat16), w)\n", ["RLT801"]),
    "torch .bfloat16() into F.linear": (
        "import torch.nn.functional as F\n"
        "def f(x, w):\n"
        "    return F.linear(x.bfloat16(), w)\n", ["RLT801"]),
    "torch pinned f32 accumulation": (
        "import torch\n"
        "from ray_lightning_tpu_torch.ops.precision import "
        "pin_f32_accumulation\n"
        "pin_f32_accumulation()\n"
        "def f(x, w):\n"
        "    return torch.mm(x.to(torch.bfloat16), w)\n", []),
    "torch inline int8 operand": (
        "import torch\n"
        "def f(x, w):\n"
        "    return torch.mm(x.to(torch.int8), w)\n", ["RLT805"]),
    "jnp inline astype": (
        "import jax.numpy as jnp\n"
        "def f(x, w):\n"
        "    return jnp.dot(x.astype(jnp.bfloat16), w)\n", ["RLT801"]),
    "jnp with preferred_element_type": (
        "import jax.numpy as jnp\n"
        "def f(x, w):\n"
        "    return jnp.dot(x.astype(jnp.bfloat16), w, "
        "preferred_element_type=jnp.float32)\n", []),
}


@pytest.mark.parametrize("name", list(SOURCES))
def test_static_pass(name):
    src, rules = SOURCES[name]
    got = [f.rule for f in nc.check_numerics_sources([("m.py", src)])]
    assert got == rules
    if name.startswith("jnp"):
        want = [f.rule for f in jnc.check_numerics_sources([("m.py", src)])]
        assert got == want


def test_lint_numerics_on_the_package_exits_clean(capsys):
    import json

    from ray_lightning_tpu_torch.__main__ import main

    assert main(["lint", "--numerics", "--no-concurrency", "--json"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["ok"] and out["counts"]["error"] == 0


def test_summarize_counts_by_rule():
    from ray_lightning_tpu_torch.analysis.findings import Finding

    fs = [Finding("RLT801", "a"), Finding("RLT801", "b"),
          Finding("RLT803", "c")]
    assert nc.summarize(fs) == jnc.summarize(fs) == {
        "total": 3, "by_rule": {"RLT801": 2, "RLT803": 1}}
