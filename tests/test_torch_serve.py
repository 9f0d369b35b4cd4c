"""The PyTorch port's serving path against the JAX package's, on the CPU.

The port's `Scheduler` + `DecodeEngine` (kernel lanes, whose wrappers run
their plain versions on CPU tensors, and reference lanes) serve the same
greedy requests as the JAX `Scheduler` + `DecodeEngine` under
`force_pallas` (Pallas kernels in interpret mode), on the same weights:
completions must match token for token. JAX's threefry sampling bits are
not reproduced, so sampled requests are held to the port's own contract:
a request's stream depends on its seed only, not on batch order, slot or
capacity."""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_lightning_tpu.models.llama import Llama as JaxLlama
from ray_lightning_tpu.models.llama import LlamaConfig as JaxConfig
from ray_lightning_tpu.ops import dispatch as jax_dispatch
from ray_lightning_tpu.serve.engine import DecodeEngine as JaxEngine
from ray_lightning_tpu.serve.engine import EngineConfig as JaxEngineConfig
from ray_lightning_tpu.serve.scheduler import Request as JaxRequest
from ray_lightning_tpu.serve.scheduler import Scheduler as JaxScheduler
from ray_lightning_tpu.serve.scheduler import _key_data as jax_key_data
from ray_lightning_tpu_torch.models.llama import (
    Llama,
    LlamaConfig,
    params_from_jax,
)
from ray_lightning_tpu_torch.serve.engine import (
    DecodeEngine,
    EngineConfig,
    _split_key,
)
from ray_lightning_tpu_torch.serve.kv_cache import BlockAllocator
from ray_lightning_tpu_torch.serve.scheduler import (
    Request,
    Scheduler,
    _key_data,
)

COMMON = dict(vocab_size=256, dim=128, n_layers=2, n_heads=2, n_kv_heads=1,
              hidden_dim=256, max_seq_len=128)
ENGINE = dict(capacity=4, block_size=8, blocks_per_slot=4, prefill_chunk=4)


@pytest.fixture(scope="module")
def models():
    """The JAX suite's kernel-tiling tiny model (head_dim 64, GQA 2:1)
    and the port's twin on the same weights."""
    jmodel = JaxLlama(JaxConfig(**COMMON, remat=False, dtype=jnp.float32))
    params = jax.jit(jmodel.init)(jax.random.key(1),
                                  jnp.zeros((1, 4), jnp.int32))["params"]
    cfg = LlamaConfig(**COMMON, dtype=torch.float32)
    model = Llama(cfg, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params),
                                          cfg))
    rng = np.random.default_rng(100)
    prompts = [rng.integers(0, 256, 3 + i % 5).astype(np.int32)
               for i in range(8)]  # ragged 3-7 tokens
    return jmodel, params, model, prompts


def _requests(cls, prompts, sampled=False, max_new=6):
    return [cls(rid=f"r{i}", prompt=p, max_new_tokens=max_new,
                temperature=0.7 if sampled and i % 2 else 0.0,
                top_k=5 if sampled and i % 2 else None, seed=21 + i)
            for i, p in enumerate(prompts)]


def _drain(sched, reqs):
    for r in reqs:
        sched.submit(r)
    out = {}
    while sched.busy():
        for c in sched.tick():
            out[c.rid] = c.tokens
    return out


@pytest.fixture(scope="module")
def jax_streams(models):
    """Greedy completions of the JAX engine's kernel lanes."""
    jmodel, params, _, prompts = models
    out = {}
    with jax_dispatch.force_pallas():
        for pb in (1, 2):
            eng = JaxEngine(jmodel, params,
                            JaxEngineConfig(**ENGINE, prefill_batch=pb))
            assert eng.fused and eng.fused_prefill
            out[pb] = _drain(JaxScheduler(eng), _requests(JaxRequest,
                                                          prompts))
    return out


@pytest.mark.parametrize("prefill_batch", [1, 2])
@pytest.mark.parametrize("use_kernels", [True, False])
def test_greedy_completions_match_jax(models, jax_streams, prefill_batch,
                                      use_kernels):
    _, _, model, prompts = models
    eng = DecodeEngine(model, EngineConfig(**ENGINE,
                                           prefill_batch=prefill_batch),
                       use_kernels=use_kernels, device="cpu")
    lane = "paged-kernel" if use_kernels else "reference-gather"
    assert (eng.attention_path, eng.prefill_path) == (lane, lane)
    got = _drain(Scheduler(eng), _requests(Request, prompts))
    assert got == jax_streams[prefill_batch]


@pytest.mark.parametrize("variant", ["on_demand", "prefix_cache"])
def test_scheduler_policies_keep_greedy_streams(models, jax_streams,
                                                variant):
    """An oversubscribed pool (growth, preemption, replay) and the
    prefix cache (shared prompt blocks) change the schedule, never a
    greedy stream."""
    _, _, model, prompts = models
    if variant == "on_demand":
        eng = DecodeEngine(model, EngineConfig(**ENGINE, n_blocks=6),
                           use_kernels=True, device="cpu")
        sched = Scheduler(eng, reserve="on_demand")
        reqs = _requests(Request, prompts)
    else:
        eng = DecodeEngine(model, EngineConfig(**ENGINE), use_kernels=True,
                           device="cpu")
        sched = Scheduler(eng, prefix_cache=True)
        # the prompts share a 9-token prefix (one full 8-token block)
        base = np.arange(9, dtype=np.int32) + 40
        prompts = [np.concatenate([base, p]) for p in prompts[:4]]
        reqs = _requests(Request, prompts)
    # the first request's prefill publishes the shared block; the rest
    # arrive after it and map it instead of prefilling it again
    got = _drain(sched, reqs[:1])
    got.update(_drain(sched, reqs[1:]))
    if variant == "on_demand":
        assert got == jax_streams[1]
    else:
        assert sched.shared_block_fraction > 0
        ref = _drain(Scheduler(DecodeEngine(
            model, EngineConfig(**ENGINE), use_kernels=False,
            device="cpu")), _requests(Request, prompts))
        assert got == ref


def _serve_sampled(model, prompts, capacity, prefill_batch, reverse):
    eng = DecodeEngine(model, EngineConfig(**{**ENGINE, "capacity": capacity},
                                           prefill_batch=prefill_batch),
                       use_kernels=True, device="cpu")
    reqs = _requests(Request, prompts, sampled=True)
    return _drain(Scheduler(eng), reqs[::-1] if reverse else reqs)


@pytest.fixture(scope="module")
def sampled_base(models):
    _, _, model, prompts = models
    return _serve_sampled(model, prompts, 4, 1, False)


@pytest.mark.parametrize("capacity,prefill_batch,reverse", [
    (4, 1, True),
    (2, 1, False),
    (3, 2, True),
])
def test_sampled_streams_depend_on_seed_only(models, sampled_base,
                                             capacity, prefill_batch,
                                             reverse):
    _, _, model, prompts = models
    got = _serve_sampled(model, prompts, capacity, prefill_batch, reverse)
    assert got == sampled_base


def test_mixed_batch_samples_and_keeps_greedy(sampled_base, jax_streams):
    """In the mixed set the greedy half still matches JAX token for
    token, and the sampled half departs from the greedy stream."""
    greedy = jax_streams[1]
    assert all(sampled_base[f"r{i}"] == greedy[f"r{i}"] for i in (0, 2, 4, 6))
    assert any(sampled_base[f"r{i}"] != greedy[f"r{i}"] for i in (1, 3, 5, 7))


@pytest.mark.parametrize("seed", [0, 21, 2**31 - 1, -1, 2**32 + 5])
def test_key_data_matches_jax(seed):
    np.testing.assert_array_equal(_key_data(seed), jax_key_data(seed))


def test_key_split_is_deterministic_and_advances():
    key = _key_data(7)
    nxt, draw = _split_key(key)
    nxt2, draw2 = _split_key(key)
    assert np.array_equal(nxt, nxt2) and draw == draw2
    assert not np.array_equal(nxt, key) and 0 <= draw < 2**63
    assert _split_key(nxt)[1] != draw


def test_engine_contract(models):
    _, _, model, _ = models
    cfg = EngineConfig(**ENGINE)
    with pytest.raises(RuntimeError, match="CUDA"):
        DecodeEngine(model, cfg)  # the default device is the card
    with pytest.raises(NotImplementedError):
        DecodeEngine(model, cfg, device="cpu", mesh=object())
    with pytest.raises(NotImplementedError):
        DecodeEngine(model, cfg, device="cpu", draft_model=model)
    with pytest.raises(ValueError, match="max_seq_len"):
        DecodeEngine(model, dataclasses.replace(cfg, blocks_per_slot=32),
                     device="cpu")
    with pytest.raises(ValueError, match="prefill_batch"):
        EngineConfig(capacity=2, prefill_batch=3)
    eng = DecodeEngine(model, cfg, device="cpu")  # ambient: CPU -> reference
    assert eng.attention_path == "reference-gather"
    eng = DecodeEngine(model, cfg, use_kernels=True, device="cpu")
    eng.warmup()
    assert eng.steps == 1
    eng.pool_k[:, 3] = 1.5
    eng.copy_block(3, 5)
    assert torch.equal(eng.pool_k[:, 5], eng.pool_k[:, 3])
    # a head_dim the kernels refuse falls to the reference lanes
    small = Llama(LlamaConfig.tiny(dtype=torch.float32), device="cpu")
    eng = DecodeEngine(small, cfg, use_kernels=True, device="cpu")
    assert eng.attention_path == eng.prefill_path == "reference-gather"


def test_block_allocator_refcounts():
    alloc = BlockAllocator(EngineConfig(**ENGINE).pool_spec)
    got = alloc.alloc(3)
    assert 0 not in got and alloc.refcount(got[0]) == 1
    alloc.incref(got[:1])
    assert alloc.decref(got) == got[1:]
    assert alloc.decref(got[:1]) == got[:1]
    with pytest.raises(ValueError, match="double free"):
        alloc.free(got[:1])
