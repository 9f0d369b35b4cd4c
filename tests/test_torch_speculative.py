"""Speculative decoding in the port (`serve/engine.py` `build_spec_step`,
the scheduler's admission and growth, the driver's arming) against the
JAX package's (the cases of tests/test_speculative.py), on the CPU.

The same weights (`params_from_jax` of the suite's tiny f32 target and
of an independent draft, init key 2) serve the same greedy requests
through the JAX draft-armed engine and the port's: the streams agree
token for token with each other and with JAX `generate`, at k = 1, 3
and 4. A self-draft accepts every proposal. Each gate raises as the JAX
one does, and `speculative_plan` prices what JAX's does.
"""
from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch

from ray_lightning_tpu.models.llama import Llama as JaxLlama
from ray_lightning_tpu.models.llama import generate as jax_generate
from ray_lightning_tpu.serve import audit as jaudit
from ray_lightning_tpu.serve import engine as jeng
from ray_lightning_tpu.serve import scheduler as jsched
from ray_lightning_tpu.serve.driver import (
    ReplicaGroupConfig as JaxReplicaGroupConfig,
)
from ray_lightning_tpu.serve.driver import ServeDriver as JaxServeDriver
from ray_lightning_tpu_torch.models.llama import (
    Llama,
    LlamaConfig,
    params_from_jax,
)
from ray_lightning_tpu_torch.serve import audit
from ray_lightning_tpu_torch.serve import engine as peng
from ray_lightning_tpu_torch.serve import scheduler as psched
from ray_lightning_tpu_torch.serve.driver import (
    ReplicaGroupConfig,
    ServeDriver,
)
from ray_lightning_tpu_torch.serve.engine import (
    DecodeEngine,
    DraftConfig,
    EngineConfig,
)
from ray_lightning_tpu_torch.serve.scheduler import Request, Scheduler

GEOM = dict(capacity=4, block_size=4, blocks_per_slot=8, prefill_chunk=4)


def _port(params, cfg):
    model = Llama(cfg, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params),
                                          cfg))
    return model


@pytest.fixture(scope="module")
def setup(tiny_llama_f32):
    """(JAX target, its params, JAX draft, its params, the port's target
    and draft on the same weights, 6 prompts)."""
    _, jmodel, params, tokens = tiny_llama_f32
    jdraft = JaxLlama(jmodel.cfg)
    dparams = jax.jit(jdraft.init)(jax.random.key(2), tokens)["params"]
    cfg = LlamaConfig.tiny(dtype=torch.float32)
    rng = np.random.default_rng(60)
    prompts = [rng.integers(0, cfg.vocab_size, 11 + i % 3).astype(np.int32)
               for i in range(6)]
    return (jmodel, params, jdraft, dparams, _port(params, cfg),
            _port(dparams, cfg), prompts)


@pytest.fixture(scope="module")
def jax_refs(setup):
    """JAX `generate`'s greedy streams, 6 new tokens a prompt."""
    jmodel, params, *_, prompts = setup
    return {f"s{i}": np.asarray(jax_generate(
        jmodel, params, p[None], 6, temperature=0.0, seed=3 + i))[0].tolist()
        for i, p in enumerate(prompts)}


def _requests(cls, prompts, max_new=6):
    return [cls(rid=f"s{i}", prompt=p, max_new_tokens=max_new, seed=3 + i)
            for i, p in enumerate(prompts)]


def _drain(sched, reqs):
    for r in reqs:
        sched.submit(r)
    out = {}
    while sched.busy():
        for c in sched.tick():
            out[c.rid] = list(c.tokens)
    return out


@pytest.mark.parametrize("k", [1, 3, 4])
def test_speculative_greedy_token_identical(setup, jax_refs, k):
    """Token identity both ways: the port's draft-armed engine against
    the JAX draft-armed engine's streams and against JAX `generate`;
    the acceptance rate is the JAX engine's too."""
    jmodel, params, jdraft, dparams, model, draft, prompts = setup
    jeng_ = jeng.DecodeEngine(
        jmodel, params, jeng.EngineConfig(**GEOM,
                                          draft=jeng.DraftConfig(k=k)),
        draft_model=jdraft, draft_params=dparams)
    jeng_.warmup()
    js = jsched.Scheduler(jeng_)
    want = _drain(js, _requests(jsched.Request, prompts))
    eng = DecodeEngine(model, EngineConfig(**GEOM, draft=DraftConfig(k=k)),
                       device="cpu", draft_model=draft)
    eng.warmup()
    assert eng.attention_path == eng.prefill_path == "reference-gather"
    sched = Scheduler(eng)
    got = _drain(sched, _requests(Request, prompts))
    assert got == want == jax_refs
    assert sched.accepted_tokens_per_step == js.accepted_tokens_per_step
    assert sched.accepted_tokens_per_step >= 1.0
    if k == 1:
        assert sched.accepted_tokens_per_step == 1.0


def test_self_draft_reaches_full_acceptance(setup, jax_refs):
    """The target drafting for itself (its own weights given as the
    draft's) agrees with every proposal: each decode slot-step emits the
    full k-token chunk."""
    jmodel, params, *_, model, _, prompts = setup
    eng = DecodeEngine(model, EngineConfig(
        capacity=2, block_size=4, blocks_per_slot=8, prefill_chunk=4,
        draft=DraftConfig(k=4)), device="cpu", draft_model=model,
        draft_params=params_from_jax(jax.tree.map(np.asarray, params),
                                     model.cfg))
    eng.warmup()
    sched = Scheduler(eng)
    out = _drain(sched, [Request(rid="s0", prompt=prompts[0],
                                 max_new_tokens=8, seed=3)])
    ref = np.asarray(jax_generate(jmodel, params, prompts[0][None], 8,
                                  temperature=0.0, seed=3))[0].tolist()
    assert out["s0"] == ref
    assert sched.accepted_tokens_per_step == 4.0


def test_inline_driver_serves_speculative_replicas(setup, jax_refs):
    """Two inline replicas share one draft built from a JAX-layout tree
    of its weights; every stream equals JAX `generate`."""
    _, params, _, dparams, model, _, prompts = setup
    cfg = ReplicaGroupConfig(
        n_replicas=2, engine=EngineConfig(**GEOM, draft=DraftConfig(k=3)),
        draft_model_cfg=model.cfg, device="cpu")
    res = ServeDriver(model.cfg, model, cfg,
                      draft_params=jax.tree.map(np.asarray, dparams)).run(
        _requests(Request, prompts))
    assert res.outputs == jax_refs


# ---- gates, each raising as JAX's does -------------------------------------


def _both(fn):
    """(the port's exception, JAX's) from ``fn(package)``."""
    caught = []
    for pkg in ("port", "jax"):
        with pytest.raises(Exception) as info:
            fn(pkg)
        caught.append(info.value)
    return caught


ENGINE_CONFIG_GATES = {
    "prefill_batch": dict(capacity=2, block_size=4, blocks_per_slot=4,
                          prefill_chunk=4, prefill_batch=2, k=2),
    "draft k": dict(capacity=2, block_size=4, blocks_per_slot=2,
                    prefill_chunk=4, k=9),
    "k must be >= 1": dict(capacity=2, block_size=4, blocks_per_slot=4,
                           prefill_chunk=4, k=0),
}


@pytest.mark.parametrize("match", list(ENGINE_CONFIG_GATES))
def test_engine_config_gates_raise_as_jax(match):
    kw = dict(ENGINE_CONFIG_GATES[match])
    k = kw.pop("k")

    def build(pkg):
        mod = {"port": peng, "jax": jeng}[pkg]
        return mod.EngineConfig(**kw, draft=mod.DraftConfig(k=k))

    port, jx = _both(build)
    assert type(port) is type(jx) is ValueError
    assert match in str(port) and match in str(jx)
    # the dict form (a config's round trip to a process replica)
    assert EngineConfig(capacity=2, block_size=4, blocks_per_slot=4,
                        prefill_chunk=4, draft={"k": 3}).draft == \
        DraftConfig(k=3)


@pytest.mark.parametrize("case", ["greedy-only", "max_slot_len"])
def test_validate_request_gates_raise_as_jax(case):
    prompt = np.arange(6, dtype=np.int32)
    temp = 0.7 if case == "greedy-only" else 0.0
    geom = dict(capacity=2, block_size=4, blocks_per_slot=4,
                prefill_chunk=4)

    def check(pkg):
        e, s = {"port": (peng, psched), "jax": (jeng, jsched)}[pkg]
        ecfg = e.EngineConfig(**geom, draft=e.DraftConfig(k=4))
        # fits without the draft's k-1 headroom, not with it
        s.validate_request(dataclasses.replace(ecfg, draft=None),
                           ecfg.pool_spec, s.Request(
                               rid="t", prompt=prompt, max_new_tokens=10,
                               seed=0))
        s.validate_request(ecfg, ecfg.pool_spec, s.Request(
            rid="t", prompt=prompt, max_new_tokens=10, seed=0,
            temperature=temp))

    port, jx = _both(check)
    assert type(port) is type(jx) is ValueError
    assert case in str(port) and case in str(jx)


def test_engine_construction_gates(setup):
    """No draft model, a draft of another vocabulary, a draft that does
    not cover the slot, a sharded replica: each refused."""
    *_, model, draft, _ = setup
    ecfg = EngineConfig(capacity=2, block_size=4, blocks_per_slot=4,
                        prefill_chunk=4, draft=DraftConfig(k=2))
    with pytest.raises(ValueError, match="draft model"):
        DecodeEngine(model, ecfg, device="cpu")
    other = Llama(dataclasses.replace(model.cfg, vocab_size=128),
                  device="cpu")
    with pytest.raises(ValueError, match="draft vocab"):
        DecodeEngine(model, ecfg, device="cpu", draft_model=other)
    short = Llama(dataclasses.replace(model.cfg, max_seq_len=8),
                  device="cpu")
    with pytest.raises(ValueError, match="DRAFT model's max_seq_len"):
        DecodeEngine(model, ecfg, device="cpu", draft_model=short)
    with pytest.raises(ValueError, match="unsharded"):
        DecodeEngine(model, ecfg, device="cpu", draft_model=draft,
                     mesh=object())


@pytest.mark.parametrize("case", ["process", "config", "driver"])
def test_driver_arming_gates_raise_as_jax(setup, case):
    """A draft is inline-only; ``engine.draft`` arms with
    ``draft_model_cfg``, and that with ``ServeDriver(draft_params=)``."""
    jmodel, jparams, *_, model, _, _ = setup
    geom = dict(capacity=2, block_size=4, blocks_per_slot=4,
                prefill_chunk=4)
    match = "inline-only" if case == "process" else "arm together"

    def arm(pkg):
        if pkg == "port":
            rcfg, drv, extra = ReplicaGroupConfig, ServeDriver, {
                "device": "cpu"}
            ecfg = EngineConfig(**geom, draft=DraftConfig(k=2))
            mcfg, weights = model.cfg, model
        else:
            rcfg, drv, extra = JaxReplicaGroupConfig, JaxServeDriver, {}
            ecfg = jeng.EngineConfig(**geom, draft=jeng.DraftConfig(k=2))
            mcfg, weights = jmodel.cfg, jparams
        if case == "process":
            rcfg(backend="process", engine=ecfg, draft_model_cfg=mcfg)
        elif case == "config":
            rcfg(backend="inline", engine=ecfg)
        else:  # draft_params missing
            drv(mcfg, weights, rcfg(backend="inline", engine=ecfg,
                                    draft_model_cfg=mcfg, **extra))

    port, jx = _both(arm)
    assert type(port) is type(jx) is ValueError
    assert match in str(port) and match in str(jx)


# ---- the cost model ----------------------------------------------------------


def test_speculative_plan_equals_jax_key_for_key():
    """f32 configs: every term equal. In bf16 the port counts the norm
    gains at the f32 the serving model stores them in, where the JAX plan
    counts every parameter at 2 bytes: the byte terms differ by exactly
    those gains' extra 2 bytes each (the live draft's bytes are the
    port's, `chip_smoke.py` phase 13 (a))."""
    import jax.numpy as jnp

    from ray_lightning_tpu.models.llama import LlamaConfig as JaxConfig

    for dtype, jdtype in ((torch.float32, jnp.float32),
                          (torch.bfloat16, jnp.bfloat16)):
        cfg = LlamaConfig.tiny(dtype=dtype, n_layers=4)
        jcfg = JaxConfig.tiny(dtype=jdtype, n_layers=4)
        geom = dict(capacity=2, block_size=4, blocks_per_slot=4,
                    prefill_chunk=4)
        got = audit.speculative_plan(
            cfg, dataclasses.replace(cfg, n_layers=1),
            EngineConfig(**geom, draft=DraftConfig(k=4)), accept_rate=0.5)
        want = jaudit.speculative_plan(
            jcfg, dataclasses.replace(jcfg, n_layers=1),
            jeng.EngineConfig(**geom, draft=jeng.DraftConfig(k=4)),
            accept_rate=0.5)
        assert set(got) == set(want)
        extra = (lambda n: 0 if dtype == torch.float32
                 else 2 * (2 * n + 1) * cfg.dim)
        byte_terms = {"draft_params_bytes": extra(1),
                      "hbm_read_bytes_per_tick_base": extra(4),
                      "hbm_read_bytes_per_tick_spec": extra(4)
                      + 4 * extra(1)}
        for key, v in want.items():
            if key in byte_terms:
                assert got[key] - v == byte_terms[key], key
            elif key == "memory_bound_speedup_x":
                assert got[key] == pytest.approx(v, rel=1e-2)
            else:
                assert got[key] == v, key
    with pytest.raises(ValueError, match="accept_rate"):
        audit.speculative_plan(cfg, cfg, EngineConfig(**geom),
                               accept_rate=1.5)
