"""The port's plan checker (`ray_lightning_tpu_torch/analysis/
plan_checker.py`) held against the JAX package's, case for case
(`tests/test_analysis_plan.py`): the structural rules on one spec, the
overlay audit, optimizer-state widening, and `check_plan` on the meta
device over a shape-only mesh for `LlamaModule`, `MoEClassifierModule`
and `BertClassifierModule` — clean where JAX's is clean, and each planted
defect given the rule id JAX gives the same configuration. RLT106
(donation) has no torch counterpart: JAX reports it on its drifting
optimizer, the port's report lists it as not checked, with why.
Discrete checks: equality of rule ids.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from ray_lightning_tpu import analysis as jax_analysis
from ray_lightning_tpu.models import bert as jax_bert
from ray_lightning_tpu.models import llama as jax_llama
from ray_lightning_tpu.models import moe as jax_moe
from ray_lightning_tpu.parallel import strategy as jax_strategy
from ray_lightning_tpu_torch.analysis import plan_checker
from ray_lightning_tpu_torch.analysis.plan_checker import (
    check_donation,
    check_opt_state_dtypes,
    check_param_specs,
    check_plan,
    spec_findings,
)
from ray_lightning_tpu_torch.models.bert import (
    BertClassifierModule,
    BertConfig,
)
from ray_lightning_tpu_torch.models.llama import (
    Llama,
    LlamaConfig,
    LlamaModule,
)
from ray_lightning_tpu_torch.models.moe import MoEClassifierModule
from ray_lightning_tpu_torch.parallel.strategy import FSDP, ShardedMesh

MESH = {"data": 1, "pipe": 1, "fsdp": 8, "expert": 1, "seq": 1,
        "tensor": 1}


class _Leaf:
    def __init__(self, shape, dtype=np.float32):
        self.shape = tuple(shape)
        self.dtype = (dtype if isinstance(dtype, torch.dtype)
                      else np.dtype(dtype))


def rules(findings):
    return sorted(f.rule for f in findings)


def rule_set(findings):
    return sorted({f.rule for f in findings})


# ---- one spec: the structural core --------------------------------------

SPEC_CASES = {
    # name: (spec as a tuple, shape)
    "unknown axis": (("fdsp", None), (64, 64)),  # rlt: disable=RLT101
    "uneven": (("fsdp", None), (63, 64)),
    "duplicate across dims": (("fsdp", "fsdp"), (64, 64)),  # rlt: disable=RLT103
    "duplicate in a dim": ((("fsdp", "fsdp"), None), (64, 64)),  # rlt: disable=RLT103
    "rank overflow": ((None, None, "fsdp"), (64, 64)),
    "good": ((("data", "fsdp"), "tensor"), (64, 64)),
    "empty": ((), (64, 64)),
    "size-one axis on an odd dim": (("tensor", None), (63, 64)),
}


@pytest.mark.parametrize("name", list(SPEC_CASES))
def test_spec_findings_as_jax(name):
    spec, shape = SPEC_CASES[name]
    got = spec_findings(spec, shape, MESH, path="w")
    want = jax_analysis.spec_findings(P(*spec), shape, MESH, path="w")
    assert rules(got) == rules(want)
    assert [f.symbol for f in got] == [f.symbol for f in want]


def test_overlay_stale_path_and_quiet_as_jax():
    params = {"layers.0.wqkv": _Leaf((128, 64))}
    jparams = {"layers/wqkv/kernel": _Leaf((2, 64, 128))}
    got = check_param_specs({"layers.0.renamed": ()}, params, MESH)
    want = jax_analysis.check_param_specs(
        {"layers/renamed/kernel": P()}, jparams, MESH)
    assert rules(got) == rules(want) == ["RLT107"]
    assert check_param_specs({"layers.0.wqkv": ("fsdp", None)}, params,
                             MESH) == []
    assert check_param_specs(None, params, MESH) == []


def test_opt_state_widening_as_jax():
    """The same leaves through both (the suffix-and-shape match, the
    width rule), then the port's own state names over torch dtypes."""
    bf16 = np.dtype(jax_llama.jnp.bfloat16)
    params = {"w": _Leaf((64, 64), bf16)}
    opt = {"0/mu/w": _Leaf((64, 64), np.float32),
           "0/nu/w": _Leaf((64, 64), bf16),
           "1/count": _Leaf((), np.int32)}
    got = check_opt_state_dtypes(params, opt)
    want = jax_analysis.check_opt_state_dtypes(params, opt)
    assert rules(got) == rules(want) == ["RLT105"]
    assert got[0].symbol == want[0].symbol == "0/mu/w"
    tparams = {"layers.0.w": _Leaf((64, 64), torch.bfloat16)}
    topt = {"exp_avg/layers.0.w": _Leaf((64, 64), torch.bfloat16),
            "exp_avg_sq/layers.0.w": _Leaf((64, 64), torch.float32)}
    fs = check_opt_state_dtypes(tparams, topt)
    assert rules(fs) == ["RLT105"] and fs[0].symbol == "exp_avg_sq/layers.0.w"
    assert check_opt_state_dtypes(
        {"w": _Leaf((4,), torch.float32)},
        {"exp_avg/w": _Leaf((4,), torch.bfloat16)}) == []


def test_donation_has_no_counterpart():
    """JAX finds RLT106 on a donated buffer that cannot alias; a torch
    step updates in place, and the port says so instead of passing."""
    donated = {"params/w": (_Leaf((8, 8)), P("fsdp", None))}
    outputs = {"params/w": (_Leaf((8, 8)), P(None, "fsdp"))}
    assert rules(jax_analysis.check_donation(donated, outputs)) == ["RLT106"]
    why = check_donation(donated, outputs)
    assert isinstance(why, str) and "in place" in why


# ---- check_plan: the whole engine, no devices ---------------------------

def _tokens():
    return {"tokens": np.zeros((8, 129), np.int32)}


def _moe_batch():
    return {"x": np.zeros((8, 16), np.float32),
            "y": np.zeros((8,), np.int32)}


def _bert_batch():
    return {"input_ids": np.zeros((8, 16), np.int32),
            "labels": np.zeros((8,), np.int32)}


CLEAN = {
    "llama fsdp=8": (
        lambda: (LlamaModule(LlamaConfig.tiny()),
                 ShardedMesh(fsdp=8, device="cpu"), 8),
        lambda: (jax_llama.LlamaModule(jax_llama.LlamaConfig.tiny()),
                 jax_strategy.ShardedMesh(fsdp=8), 8, _tokens())),
    "llama fsdp=2 x tensor=2": (
        lambda: (LlamaModule(LlamaConfig.tiny()),
                 ShardedMesh(fsdp=2, tensor=2, device="cpu"), 4),
        lambda: (jax_llama.LlamaModule(jax_llama.LlamaConfig.tiny()),
                 jax_strategy.ShardedMesh(fsdp=2, tensor=2), 4, _tokens())),
    "moe data=2 x expert=4": (
        lambda: (MoEClassifierModule(in_features=16),
                 ShardedMesh(data=2, expert=4, device="cpu"), 8),
        lambda: (jax_moe.MoEClassifierModule(),
                 jax_strategy.ShardedMesh(data=2, expert=4), 8,
                 _moe_batch())),
    "bert fsdp=8": (
        lambda: (BertClassifierModule(BertConfig.tiny(dropout=0.0),
                                      num_classes=2),
                 ShardedMesh(fsdp=8, device="cpu"), 8),
        lambda: (jax_bert.BertClassifierModule(
            jax_bert.BertConfig.tiny(dropout=0.0), num_classes=2),
                 jax_strategy.ShardedMesh(fsdp=8), 8, _bert_batch())),
    "bert fsdp=2 x tensor=2": (
        lambda: (BertClassifierModule(BertConfig.tiny(dropout=0.0),
                                      num_classes=2),
                 ShardedMesh(fsdp=2, tensor=2, device="cpu"), 4),
        lambda: (jax_bert.BertClassifierModule(
            jax_bert.BertConfig.tiny(dropout=0.0), num_classes=2),
                 jax_strategy.ShardedMesh(fsdp=2, tensor=2), 4,
                 _bert_batch())),
    "moe expert=2 x tensor=2": (
        lambda: (MoEClassifierModule(in_features=16),
                 ShardedMesh(expert=2, tensor=2, device="cpu"), 4),
        lambda: (jax_moe.MoEClassifierModule(),
                 jax_strategy.ShardedMesh(expert=2, tensor=2), 4,
                 _moe_batch())),
}


@pytest.mark.parametrize("name", list(CLEAN))
def test_bundled_models_check_clean_as_jax(name):
    port, jax = CLEAN[name]
    assert jax_analysis.check_plan(*jax()) == []
    report = check_plan(*port())
    assert report == [], report.format()
    assert set(report.not_checked) == {"RLT106"}
    assert "not checked RLT106" in report.format()


def _typo_llama(base):
    class Bad(base):
        def param_specs(self, params=None):
            sp = dict(super().param_specs(params))
            if isinstance(self, LlamaModule):
                sp["final_norm"] = ("fdsp",)  # rlt: disable=RLT101
                sp["layers.0.renamed"] = ()
            else:
                sp["final_norm"] = P("fdsp")  # rlt: disable=RLT101
                sp["layers/renamed/kernel"] = P()
            return sp
    return Bad


def _typo_bert(base):
    class Bad(base):
        def param_specs(self, params=None):
            sp = dict(super().param_specs(params))
            key = next(iter(sp))
            sp[key] = (("tensr",) if isinstance(self, BertClassifierModule)
                       else P("tensr"))  # rlt: disable=RLT101
            return sp
    return Bad


class _Bf16Llama(LlamaModule):
    """bf16 parameters under `MuAdamW`, whose second moment stays f32."""

    def configure_model(self):
        return Llama(self.cfg, device=self.device,
                     param_dtype=torch.bfloat16).requires_grad_(True)


def _jax_bf16_llama():
    import jax
    import jax.numpy as jnp
    import optax

    class Bf16Params(jax_llama.LlamaModule):
        def configure_optimizers(self):
            return optax.adam(1e-3, mu_dtype=jnp.float32)

        def init_params(self, rng, batch):
            params = super().init_params(rng, batch)
            return jax.tree.map(
                lambda x: x.astype(jnp.bfloat16)
                if x.dtype == np.dtype(np.float32) else x, params)

    return Bf16Params(jax_llama.LlamaConfig.tiny())


DEFECTS = {
    # name: (rules both must report, the port's configuration, JAX's)
    "typo'd axis and stale path": (
        {"RLT101", "RLT107"},
        lambda: (_typo_llama(LlamaModule)(LlamaConfig.tiny()),
                 ShardedMesh(fsdp=8, device="cpu"), 8),
        lambda: (_typo_llama(jax_llama.LlamaModule)(
            jax_llama.LlamaConfig.tiny()),
                 jax_strategy.ShardedMesh(fsdp=8), 8, _tokens())),
    "uneven tensor split": (
        {"RLT102"},
        lambda: (LlamaModule(LlamaConfig.tiny()),
                 ShardedMesh(data=1, fsdp=1, tensor=5, device="cpu"), 5),
        lambda: (jax_llama.LlamaModule(jax_llama.LlamaConfig.tiny()),
                 jax_strategy.ShardedMesh(data=1, fsdp=1, tensor=5), 5,
                 _tokens())),
    "widened optimizer state": (
        {"RLT105"},
        lambda: (_Bf16Llama(LlamaConfig.tiny(), mu_dtype=torch.bfloat16),
                 ShardedMesh(fsdp=8, device="cpu"), 8),
        lambda: (_jax_bf16_llama(), jax_strategy.ShardedMesh(fsdp=8), 8,
                 _tokens())),
    "bert typo'd axis": (
        {"RLT101"},
        lambda: (_typo_bert(BertClassifierModule)(
            BertConfig.tiny(dropout=0.0), num_classes=2),
                 ShardedMesh(fsdp=8, device="cpu"), 8),
        lambda: (_typo_bert(jax_bert.BertClassifierModule)(
            jax_bert.BertConfig.tiny(dropout=0.0), num_classes=2),
                 jax_strategy.ShardedMesh(fsdp=8), 8, _bert_batch())),
}


@pytest.mark.parametrize("name", list(DEFECTS))
def test_planted_defect_gets_the_jax_rule(name):
    want, port, jax = DEFECTS[name]
    assert set(rule_set(jax_analysis.check_plan(*jax()))) == want
    assert set(rule_set(check_plan(*port()))) == want


def test_other_optimizers_are_reported_not_checked():
    """An optimizer whose state the checker does not model (SGD here)
    leaves RLT105 not checked, with why."""
    class SgdLlama(LlamaModule):
        def configure_optimizers(self):
            return torch.optim.SGD(self.model.parameters(), lr=0.1)

    report = check_plan(SgdLlama(LlamaConfig.tiny()), FSDP(device="cpu"), 4)
    assert report == []
    assert "SGD" in report.not_checked["RLT105"]
    assert plan_checker.optimizer_state_leaves(
        torch.optim.SGD([torch.nn.Parameter(torch.ones(2))]), {}) is None


def test_strategy_guard_reads_the_plan_checker():
    """The live path: `ShardedMesh` runs `plan_checker.spec_findings` on
    each composed spec and raises on an error, by the leaf's name."""
    class Uneven(LlamaModule):
        def param_specs(self, params=None):
            return {"final_norm": ("fsdp",)}

    strategy = ShardedMesh(fsdp=3, device="cpu")
    strategy.shape_only(3, Uneven(LlamaConfig.tiny()))
    with pytest.raises(ValueError, match="RLT102.*final_norm"):
        strategy.leaf_spec("final_norm", (64,))
    with pytest.raises(ValueError, match="RLT101"):
        ShardedMesh(fsdp=2, device="cpu")._require_known_axes(
            "w", ("fdsp",))  # rlt: disable=RLT101
