"""The port's `generate` and `init_cache` against the JAX package's, on the
CPU (the cases of tests/test_generate.py).

Both models hold the same weights (`params_from_jax` of the suite's
canonical tiny-Llama build, f32) and take the same numpy prompts: greedy
tokens must equal the JAX `generate` token for token, and the cached
decode the port's own full forward. JAX's threefry sampling bits are not
reproduced, so sampled streams are held to the port's own contract: a
request served by the port's engine emits exactly ``generate(prompt,
..., seed=req.seed)``, greedy or sampled, whatever the batch around it.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_lightning_tpu.models.llama import generate as jax_generate
from ray_lightning_tpu_torch.models.llama import (
    Llama,
    LlamaConfig,
    LlamaModule,
    generate,
    init_cache,
    params_from_jax,
)
from ray_lightning_tpu_torch.serve.engine import DecodeEngine, EngineConfig
from ray_lightning_tpu_torch.serve.scheduler import Request, Scheduler


@pytest.fixture(scope="module")
def tiny(tiny_llama_f32):
    """(JAX model, JAX params, the port's twin, prompt [2, 8] int32)."""
    _, jmodel, params, prompt = tiny_llama_f32
    cfg = LlamaConfig.tiny(dtype=torch.float32)
    model = Llama(cfg, device="cpu")
    model.load_state_dict(params_from_jax(
        jax.tree.map(np.asarray, params), cfg))
    return jmodel, params, model, np.array(prompt)


def _greedy_nocache(model, prompt, n):
    """The port's full forward over the growing sequence each step."""
    toks = torch.from_numpy(prompt).long()
    out = []
    with torch.no_grad():
        for _ in range(n):
            nxt = model(toks)[:, -1].argmax(-1)
            out.append(nxt)
            toks = torch.cat([toks, nxt[:, None]], dim=1)
    return torch.stack(out, dim=1).numpy()


@pytest.mark.parametrize("n_new", [1, 6])
def test_greedy_tokens_equal_jax(tiny, n_new):
    jmodel, params, model, prompt = tiny
    want = np.asarray(jax_generate(jmodel, params, prompt, n_new))
    got = generate(model, prompt, n_new)
    assert got.dtype == torch.int32 and got.shape == (2, n_new)
    np.testing.assert_array_equal(got.numpy(), want)


def test_cached_decode_matches_full_forward(tiny):
    _, _, model, prompt = tiny
    np.testing.assert_array_equal(generate(model, prompt, 6).numpy(),
                                  _greedy_nocache(model, prompt, 6))


def test_prefill_logits_match_plain_forward(tiny):
    """The prefill over an `init_cache` buffer gives the full forward's
    logits (1e-4) and fills exactly the prompt's S0 cache entries."""
    _, _, model, prompt = tiny
    cfg = model.cfg
    toks = torch.from_numpy(prompt).long()
    cache = init_cache(cfg, prompt.shape[0], 16, device="cpu")
    assert cache[0].shape == (cfg.n_layers, 2, 16, cfg.n_kv_heads,
                              cfg.head_dim)
    assert cache[0].dtype == cfg.dtype
    with torch.no_grad():
        plain = model(toks)
        cached = model(toks, cache, 0)
    np.testing.assert_allclose(cached.numpy(), plain.numpy(), atol=1e-4,
                               rtol=1e-4)
    assert cache[0][:, :, :8].abs().sum() > 0
    assert cache[0][:, :, 8:].abs().sum() == 0


def test_sampling_modes_and_bounds(tiny):
    _, _, model, prompt = tiny
    out = generate(model, prompt, 4, temperature=0.8, top_k=8, seed=3)
    assert out.shape == (2, 4) and out.dtype == torch.int32
    assert (out >= 0).all() and (out < model.cfg.vocab_size).all()
    with pytest.raises(ValueError, match="max_seq_len"):
        generate(model, prompt, model.cfg.max_seq_len)


def test_module_level_generate(tiny):
    jmodel, params, model, prompt = tiny
    module = LlamaModule(model.cfg)
    with pytest.raises(RuntimeError, match="fit or load"):
        module.generate(prompt, 3)
    module.model = model
    out = module.generate(prompt, 3)
    np.testing.assert_array_equal(
        out.numpy(), np.asarray(jax_generate(jmodel, params, prompt, 3)))


def test_sampling_same_seed_same_tokens(tiny):
    _, _, model, prompt = tiny
    a = generate(model, prompt, 8, temperature=0.9, top_k=8, seed=5)
    b = generate(model, prompt, 8, temperature=0.9, top_k=8, seed=5)
    c = generate(model, prompt, 8, temperature=0.9, top_k=8, seed=6)
    assert torch.equal(a, b)
    assert not torch.equal(a, c)


def test_top_k_one_is_greedy(tiny):
    _, _, model, prompt = tiny
    greedy = generate(model, prompt, 6)
    for seed in (0, 9):
        assert torch.equal(generate(model, prompt, 6, temperature=1.3,
                                    top_k=1, seed=seed), greedy)


def test_cache_updated_in_place_and_cache_len(tiny):
    """The caller's `init_cache` buffer is the decode's cache (the twin of
    the JAX donation); any cache_len >= prompt + max_new decodes the
    same, and a shorter one raises as the JAX function does."""
    jmodel, params, model, prompt = tiny
    base = generate(model, prompt, 6)
    n = prompt.shape[1] + 6 + 9
    cache = init_cache(model.cfg, 2, n, device="cpu")
    k_ptr = cache[0].data_ptr()
    assert torch.equal(generate(model, prompt, 6, cache_len=n,
                                cache=cache), base)
    assert cache[0].data_ptr() == k_ptr
    # prompt + 5 decoded tokens were written; the last token's K/V never is
    s0 = prompt.shape[1]
    assert cache[0][:, :, s0 + 4].abs().sum() > 0
    assert cache[0][:, :, s0 + 5:].abs().sum() == 0
    for fn, args in ((jax_generate, (jmodel, params)), (generate, (model,))):
        with pytest.raises(ValueError, match="cache_len"):
            fn(*args, prompt, 6, cache_len=7)
    with pytest.raises(ValueError, match="cache leaves"):
        generate(model, prompt, 6, cache=init_cache(model.cfg, 2, 9,
                                                    device="cpu"))


def test_left_padded_ragged_batch_matches_unpadded(tiny):
    """A left-padded ragged batch decodes row for row like each prompt
    alone, and like the JAX padded batch."""
    jmodel, params, model, _ = tiny
    rng = np.random.default_rng(70)
    lens = [3, 8, 5]
    prompts = [rng.integers(0, model.cfg.vocab_size, n).astype(np.int32)
               for n in lens]
    s0 = max(lens)
    padded = np.zeros((3, s0), np.int32)
    for i, p in enumerate(prompts):
        padded[i, s0 - len(p):] = p
    out = generate(model, padded, 5, prompt_lengths=lens).numpy()
    np.testing.assert_array_equal(out, np.asarray(jax_generate(
        jmodel, params, jnp.asarray(padded), 5, prompt_lengths=lens)))
    for i, p in enumerate(prompts):
        np.testing.assert_array_equal(
            out[i], generate(model, p[None], 5).numpy()[0],
            err_msg=f"row {i}")


def test_left_padded_full_length_row_matches_plain(tiny):
    _, _, model, prompt = tiny
    assert torch.equal(
        generate(model, prompt, 5, prompt_lengths=[prompt.shape[1]] * 2),
        generate(model, prompt, 5))


@pytest.mark.parametrize("lengths,match", [
    ([3], "prompt_lengths"), ([9, 2], "within"), ([0, 2], "within")])
def test_prompt_lengths_validated_like_jax(tiny, lengths, match):
    jmodel, params, model, prompt = tiny
    with pytest.raises(ValueError, match=match):
        jax_generate(jmodel, params, prompt, 4, prompt_lengths=lengths)
    with pytest.raises(ValueError, match=match):
        generate(model, prompt, 4, prompt_lengths=lengths)


@pytest.mark.parametrize("prefill_batch", [1, 2])
@pytest.mark.parametrize("use_kernels", [True, False])
def test_engine_streams_equal_generate(use_kernels, prefill_batch):
    """The port engine's streams equal `generate` per request, greedy and
    sampled, on both lanes: the JAX serving gate's oracle carried over
    to the port's key scheme. The kernel-tiling tiny config (head_dim
    64) lets the kernel lanes take the paged wrappers' plain versions."""
    cfg = LlamaConfig(vocab_size=256, dim=128, n_layers=2, n_heads=2,
                      n_kv_heads=1, hidden_dim=256, max_seq_len=128,
                      remat=False, dtype=torch.float32)
    from ray_lightning_tpu_torch.models.llama import init_weights

    gen = torch.Generator()
    gen.manual_seed(3)
    model = init_weights(cfg, gen, device="cpu")
    rng = np.random.default_rng(80)
    reqs = [Request(rid=f"r{i}",
                    prompt=rng.integers(0, 256, 3 + i % 5).astype(np.int32),
                    max_new_tokens=6,
                    temperature=0.7 if i % 2 else 0.0,
                    top_k=(5 if i % 4 == 1 else None), seed=21 + i)
            for i in range(8)]
    engine = DecodeEngine(model, EngineConfig(
        capacity=4, block_size=8, blocks_per_slot=4, prefill_chunk=4,
        prefill_batch=prefill_batch), use_kernels=use_kernels, device="cpu")
    sched = Scheduler(engine)
    for r in reqs:
        sched.submit(r)
    got = {}
    while sched.busy():
        for c in sched.tick():
            got[c.rid] = c.tokens
    for r in reqs:
        assert got[r.rid] == generate(
            model, r.prompt[None], 6, temperature=r.temperature,
            top_k=r.top_k, seed=r.seed)[0].tolist(), r.rid
