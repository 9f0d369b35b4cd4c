"""Tensor-parallel serving replicas in the port against the JAX package
(the twin of tests/test_serve_session.py's TP=2 tests), on the CPU.

The suite's tiny f32 Llama (JAX init key 1, `params_from_jax` into the
port) serves through a TP=2 process replica of a live session: two
worker ranks joined over gloo, each holding its shard of the weights
(`serve.engine.serving_param_shardings`) and ``Hkv/2`` KV heads of the
pool, the leader journaling each iteration and the follower replaying
it. Greedy streams equal JAX `generate` token for token and sampled ones
the port's `generate` for their request. A leader SIGKILL respawns the
whole group on a fresh channel epoch, which replays to the same streams.
In a launched gloo group each rank's engine holds the bytes
`serve_memory_summary(tp=2)` prices, and the pool byte helpers equal
JAX's.
"""
from __future__ import annotations

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_lightning_tpu.models.llama import LlamaConfig as JaxConfig
from ray_lightning_tpu.models.llama import generate as jax_generate
from ray_lightning_tpu.serve import kv_cache as jkv
from ray_lightning_tpu_torch.models.llama import (
    Llama,
    LlamaConfig,
    generate,
    params_from_jax,
)
from ray_lightning_tpu_torch.runtime.launch import launch
from ray_lightning_tpu_torch.serve import kv_cache as pkv
from ray_lightning_tpu_torch.serve.audit import serve_memory_summary
from ray_lightning_tpu_torch.serve.channel import channel_dir
from ray_lightning_tpu_torch.serve.driver import (
    ReplicaGroupConfig,
    ServeDriver,
    save_params_npz,
)
from ray_lightning_tpu_torch.serve.engine import (
    EngineConfig,
    serving_param_shardings,
    serving_param_specs,
)
from ray_lightning_tpu_torch.serve.scheduler import Request
from tests import torch_jobs

ENGINE = dict(capacity=2, block_size=4, blocks_per_slot=8, prefill_chunk=4)
T = 240


@pytest.fixture(scope="module")
def setup(tiny_llama_f32):
    """(JAX model, params, the port's twin, 6 ragged prompts, their
    references: JAX `generate` for the greedy ones, the port's for the
    sampled ones)."""
    _, jmodel, params, _ = tiny_llama_f32
    cfg = LlamaConfig.tiny(dtype=torch.float32)
    model = Llama(cfg, device="cpu")
    model.load_state_dict(params_from_jax(
        jax.tree.map(np.asarray, params), cfg))
    rng = np.random.default_rng(61)
    prompts = [rng.integers(0, cfg.vocab_size, 3 + i % 4).astype(np.int32)
               for i in range(6)]
    reqs = [Request(rid=f"r{i}", prompt=p, max_new_tokens=6,
                    temperature=0.6 if i % 2 else 0.0,
                    top_k=3 if i % 2 else None, seed=5 + i)
            for i, p in enumerate(prompts)]
    refs = {}
    for r in reqs:
        if r.temperature == 0.0:
            refs[r.rid] = np.asarray(jax_generate(
                jmodel, params, r.prompt[None], 6, temperature=0.0,
                seed=r.seed))[0].tolist()
        else:
            refs[r.rid] = generate(model, r.prompt[None], 6,
                                   temperature=r.temperature,
                                   top_k=r.top_k, seed=r.seed)[0].tolist()
    return jmodel, params, model, reqs, refs


def _drive(drv, reqs):
    for req in reqs:
        drv.submit(req)
    while drv.busy():
        drv.tick()
        time.sleep(0.01)
    return drv.stop()


@pytest.mark.parametrize("fault", [None, {"replica": 0,
                                          "kill_after_tokens": 10}],
                         ids=["streams", "leader_sigkill"])
def test_tp2_session_streams_equal_generate(setup, tmp_path, fault):
    """A TP=2 process replica streams every request as `generate` does;
    with its leader SIGKILL'd mid-stream the whole group respawns on
    ``epoch1`` of the command log and replays to the same streams."""
    _, _, model, reqs, refs = setup
    pp = str(tmp_path / "params.npz")
    save_params_npz(model, pp)
    run_dir = str(tmp_path / "run")
    drv = ServeDriver(model.cfg, pp, ReplicaGroupConfig(
        n_replicas=1, backend="process", tp=2, device="cpu",
        engine=EngineConfig(**ENGINE), run_dir=run_dir,
        start_timeout=T))
    drv.start(fault=fault)
    res = _drive(drv, reqs)
    assert res.outputs == refs
    assert len(res.meta) == len(reqs)
    plan = serve_memory_summary(model.cfg, EngineConfig(**ENGINE), tp=2)
    ranks = res.stats["replica_ranks"][0]
    assert [r["rank"] for r in ranks] == [0, 1]
    for r in ranks:
        assert r["steps"] == ranks[0]["steps"] > 0
        assert set(r["launches"]) >= {"paged_attention_kernel",
                                      "rms_norm_kernel"}
        for key in ("params_bytes", "pool_bytes", "last_logits_bytes"):
            assert r["live_bytes"][key] == plan[key], key
    files = sorted(p.name for p in channel_dir(run_dir, 0).iterdir())
    if fault is None:
        assert res.restarts == {0: 0}
        assert files == ["epoch0.cursor", "epoch0.jsonl"]
    else:
        assert res.restarts == {0: 1}
        assert "epoch1.jsonl" in files and "epoch1.cursor" in files


def test_tp_refusals(setup):
    """A sharded replica is a process group, of a live session, without
    the prefix cache (as in JAX)."""
    from types import SimpleNamespace

    from ray_lightning_tpu_torch.serve.scheduler import Scheduler

    _, _, model, reqs, _ = setup
    with pytest.raises(ValueError, match="backend='process'"):
        ReplicaGroupConfig(tp=2, device="cpu")
    ecfg = EngineConfig(**ENGINE)
    sharded = SimpleNamespace(cfg=ecfg, spec=ecfg.pool_spec, mesh=object())
    with pytest.raises(ValueError, match="unsharded"):
        Scheduler(sharded, prefix_cache=True)
    drv = ServeDriver(model.cfg, "unused.npz", ReplicaGroupConfig(
        backend="process", tp=2, device="cpu"))
    with pytest.raises(ValueError, match="dynamic-session only"):
        drv.run(reqs)


def test_tp2_engine_ranks_hold_the_planned_bytes(setup):
    """Two launched gloo ranks, each a `DecodeEngine(mesh=)`: the greedy
    streams equal JAX `generate`, and each rank's live parameter, pool
    and logits bytes equal `serve_memory_summary(tp=2)`'s terms."""
    _, _, model, reqs, refs = setup
    greedy = [r for r in reqs if r.temperature == 0.0]
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    kw = dict(vocab_size=256, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
              hidden_dim=128, max_seq_len=256, remat=False)
    out = launch(torch_jobs.serve_tp_rank, 2, device="cpu", timeout=T,
                 args=(sd, kw, ENGINE, greedy))
    plan = serve_memory_summary(model.cfg, EngineConfig(**ENGINE), tp=2)
    for rank in out:
        assert rank["outputs"] == {r.rid: refs[r.rid] for r in greedy}
        assert rank["pool_kv_heads"] == 1
        for key in ("params_bytes", "pool_bytes", "last_logits_bytes"):
            assert rank[key] == plan[key], key


def test_rank_shards_reassemble_the_weights(setup):
    """Each weight's rank pieces, in rank order, are the weight (the
    fused rows put back in their canonical order); the specs are
    `llama_param_specs`', tensor-only."""
    from ray_lightning_tpu_torch.models.llama import llama_fused_rows
    from ray_lightning_tpu_torch.parallel.tensor import (
        TensorParallel,
        fused_row_permutation,
    )

    _, _, model, _, _ = setup
    sd = model.state_dict()
    specs = dict(serving_param_specs(model))
    assert specs["layers.0.wqkv"] == ("tensor", None)
    assert specs["layers.0.wo"] == (None, "tensor")
    assert specs["final_norm"] == ()
    fused = llama_fused_rows(model.cfg)
    pieces = [serving_param_shardings(model, sd, TensorParallel(None, 2, r))
              for r in range(2)]
    for name, full in sd.items():
        spec = specs[name]
        if "tensor" not in spec:
            assert all(p[name] is full for p in pieces)
            continue
        joined = torch.cat([p[name] for p in pieces],
                           dim=spec.index("tensor"))
        if name in fused:
            joined = joined[torch.argsort(fused_row_permutation(
                fused[name], 2))]
        assert torch.equal(joined, full), name


@pytest.mark.parametrize("tp", [1, 2, 3])
def test_pool_bytes_equal_jax(tp):
    """`validate_pool_tp`, `pool_shard_bytes` and `serve_kv_plan_bytes`
    against JAX's on the same configurations, every lane pairing."""
    kw = dict(n_layers=2, n_heads=4, n_kv_heads=2, dim=64)
    for pdt, jdt in ((torch.float32, jnp.float32),
                     (torch.bfloat16, jnp.bfloat16)):
        cfg, jcfg = LlamaConfig.tiny(**kw, dtype=pdt), \
            JaxConfig.tiny(**kw, dtype=jdt)
        spec = pkv.PagedPoolSpec(n_blocks=17, block_size=4,
                                 blocks_per_slot=8)
        jspec = jkv.PagedPoolSpec(n_blocks=17, block_size=4,
                                  blocks_per_slot=8)
        if cfg.n_kv_heads % tp:
            for fn in (pkv.validate_pool_tp, jkv.validate_pool_tp):
                with pytest.raises(ValueError, match="n_kv_heads"):
                    fn(cfg if fn is pkv.validate_pool_tp else jcfg, tp)
            continue
        assert pkv.pool_shard_bytes(cfg, spec, tp) == \
            jkv.pool_shard_bytes(jcfg, jspec, tp)
        assert pkv.gathered_view_bytes(cfg, spec, 3) == \
            jkv.gathered_view_bytes(jcfg, jspec, 3)
        for fused in (False, True):
            for fused_prefill in (False, True):
                got = pkv.serve_kv_plan_bytes(
                    cfg, spec, 4, fused=fused, prefill_batch=2,
                    fused_prefill=fused_prefill, tp=tp)
                want = jkv.serve_kv_plan_bytes(
                    jcfg, jspec, 4, fused=fused, prefill_batch=2,
                    fused_prefill=fused_prefill, tp=tp)
                assert got == {k: int(v) for k, v in want.items()}
        k, v = pkv.init_pool(cfg, spec, "cpu", tp=tp)
        assert k.shape == (2, 17, 4, 2 // tp, 16) and v.shape == k.shape
        assert 2 * k.numel() * k.element_size() == \
            pkv.pool_shard_bytes(cfg, spec, tp)
    assert pkv.pool_partition_spec(1) == ()
    assert pkv.pool_partition_spec(2) == (None, None, None, "tensor", None)
    with pytest.raises(ValueError, match="tp must be >= 1"):
        pkv.validate_pool_tp(cfg, 0)
