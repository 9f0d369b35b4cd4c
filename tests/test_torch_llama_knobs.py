"""The Llama training path's knobs against the JAX package, on the CPU:
the remat policies "dots" and "attn_out", the fused CE's inline backward
and tied embeddings.

Numpy inputs from a seed, f32 throughout; the JAX side runs as its own
tests run it (flash through its XLA reference on the CPU). Held:

  * every parameter's gradient under "dots" and "attn_out" against
    "nothing"'s and the JAX module's under the same policy, 2e-5 of each
    tensor's largest entry;
  * what the backward runs again under each policy: the flash forward's
    plain version and the QKV projection, ``rltt::qkv_rope`` (counted
    through a dispatch mode, which sees what runs and not what the
    checkpoint's cache hands back); "dots" runs no GEMM more than the unchecked backward; the
    bytes "attn_out" keeps a layer (the selective checkpoint's cache,
    which holds them between forward and backward) against the planner's
    term;
  * the inline-backward CE against the JAX `fused_cross_entropy
    (inline_backward=True)` (tests/test_fused_ce.py `TestInlineBackward`):
    chunk 8, 17 and 4096, a scaled cotangent, no mask with a prime token
    count, the primal-only path, 1e-5 as there; the vocab-parallel
    inline CE over two gloo ranks against the plain CE, 2e-5;
  * a tied model's logits (the f32 product with the embedding), its
    fused and materialized losses and gradients against the JAX tied
    module's, 2e-5; greedy tokens of a tied model, served, token for
    token against JAX `generate`; its parameters, specs and plan without
    a head; and under ``ShardedMesh(tensor=2)`` (the vocab-split
    embedding as the head, with the inline CE and "attn_out") every
    gradient against one process's, 2e-5.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ray_lightning_tpu.models.llama import Llama as JaxLlama
from ray_lightning_tpu.models.llama import LlamaConfig as JaxConfig
from ray_lightning_tpu.models.llama import LlamaModule as JaxLlamaModule
from ray_lightning_tpu.models.llama import generate as jax_generate
from ray_lightning_tpu.ops.fused_ce import (
    fused_cross_entropy as jax_fused_ce,
)
from ray_lightning_tpu_torch.models.llama import (
    Llama,
    LlamaConfig,
    LlamaModule,
    generate,
    llama_param_specs,
    params_from_jax,
    token_loss_sum,
)
from ray_lightning_tpu_torch.ops import remat
from ray_lightning_tpu_torch.ops.fused_ce import (
    fused_cross_entropy,
    fused_cross_entropy_sum,
    inline_cross_entropy,
)
from ray_lightning_tpu_torch.ops.kernels import flash
from ray_lightning_tpu_torch.parallel import plan
from ray_lightning_tpu_torch.parallel.strategy import SingleDevice
from ray_lightning_tpu_torch.runtime.launch import launch
from tests import torch_jobs

TINY = torch_jobs.TINY
T = 180


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _jax_params(jcfg, seed=1):
    return jax.tree.map(np.asarray, JaxLlama(jcfg).init(
        jax.random.key(seed), jnp.zeros((1, 4), jnp.int32))["params"])


def _batch(n=2, s=20, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, TINY["vocab_size"], (n, s + 1)).astype(np.int32)
    mask = (rng.random((n, s)) > 0.2).astype(np.float32)
    return toks, mask


def _port_module(pcfg, params):
    pm = LlamaModule(pcfg)
    pm.device = torch.device("cpu")
    pm.setup()
    pm.model.load_state_dict(params_from_jax(params, pcfg,
                                             dtype=torch.float32))
    pm.params = dict(pm.model.named_parameters())
    return pm


def _port_grads(pcfg, params, toks, mask):
    pm = _port_module(pcfg, params)
    loss = pm.training_step(pm.params, {"tokens": _t(toks),
                                        "mask": _t(mask)}, None)
    loss.backward()
    return loss.item(), {k: p.grad for k, p in pm.params.items()}


def _jax_grads(jcfg, params, toks, mask):
    jm = JaxLlamaModule(jcfg)
    jm.setup()
    batch = {"tokens": jnp.asarray(toks), "mask": jnp.asarray(mask)}
    loss, g = jax.value_and_grad(lambda p: jm._loss(p, *jm._split(batch)))(
        jax.tree.map(jnp.asarray, params))
    return float(loss), g


def _hold(got, want, what):
    assert set(got) == set(want), what
    for k, w in want.items():
        w = w.numpy() if isinstance(w, torch.Tensor) else w
        g = got[k].numpy()
        np.testing.assert_allclose(
            g, w, rtol=2e-5, atol=2e-5 * max(float(np.abs(w).max()), 1e-6),
            err_msg=f"{what}: {k}")


# ---- the remat policies --------------------------------------------------------


@pytest.mark.parametrize("policy", ["dots", "attn_out"])
def test_remat_policy_grads_match_nothing_and_jax(policy):
    kw = dict(fused_ce=True, ce_chunk_tokens=24, remat=True)
    jcfg = JaxConfig(**TINY, dtype=jnp.float32, remat_policy=policy, **kw)
    params = _jax_params(jcfg)
    toks, mask = _batch()
    jl, jg = _jax_grads(jcfg, params, toks, mask)
    pcfg = LlamaConfig(**TINY, dtype=torch.float32, remat_policy=policy,
                       **kw)
    loss, grads = _port_grads(pcfg, params, toks, mask)
    base_loss, base = _port_grads(dataclasses.replace(
        pcfg, remat_policy="nothing"), params, toks, mask)
    assert loss == pytest.approx(base_loss, rel=1e-6)
    assert loss == pytest.approx(jl, rel=1e-5)
    _hold(grads, base, f"{policy} against nothing")
    _hold(grads, params_from_jax(jax.tree.map(np.asarray, jg), pcfg,
                                 dtype=torch.float32), f"{policy} against JAX")


class _Ops(TorchDispatchMode):
    """Counts what runs, by operator and output shape."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        shape = tuple(out.shape) if isinstance(out, torch.Tensor) else None
        self.seen.append((func, shape))
        return out

    def count(self, ops, shape=None):
        return sum(1 for f, s in self.seen
                   if f in ops and (shape is None or s == shape))


def _backward_counts(policy, monkeypatch, remat_on=True):
    """One forward and backward of the tiny model: (plain flash forward
    calls in the backward, QKV projections (``rltt::qkv_rope``, the GEMM
    inside it) in the backward, projections in the backward, the bytes
    each layer's selective checkpoint cached)."""
    dims = dict(TINY, hidden_dim=96)
    cfg = LlamaConfig(**dims, dtype=torch.float32, remat=remat_on,
                      remat_policy=policy, fused_ce=True,
                      ce_chunk_tokens=64)
    params = _jax_params(JaxConfig(**dims, dtype=jnp.float32))
    model = Llama(cfg, device="cpu", param_dtype=torch.float32)
    model.load_state_dict(params_from_jax(params, cfg, dtype=torch.float32))
    model.requires_grad_(True)
    toks, _ = _batch(n=2, s=16)
    calls = {"fwd": 0}
    plain = flash.flash_fwd_plain

    def counted(*a, **k):
        calls["fwd"] += 1
        return plain(*a, **k)

    monkeypatch.setattr(flash, "flash_fwd_plain", counted)
    cached = []
    fn = remat.POLICIES[policy]
    if fn is not None:
        def recording(ctx, func, *args, **kwargs):
            decision = fn(ctx, func, *args, **kwargs)
            if (decision == remat.CheckpointPolicy.MUST_SAVE
                    and not ctx.is_recompute):
                out = ctx.op_output
                outs = out if isinstance(out, tuple) else (out,)
                cached.append(sum(o.nbytes for o in outs))
            return decision
        monkeypatch.setitem(remat.POLICIES, policy, recording)
    loss = model(_t(toks[:, :-1]), targets=_t(toks[:, 1:]).long())
    calls["fwd"] = 0
    with _Ops() as ops:
        loss.backward()
    return (calls["fwd"], ops.count({torch.ops.rltt.qkv_rope.default}),
            ops.count(remat.DOTS), sum(cached) / cfg.n_layers)


@pytest.mark.parametrize("policy,fwd_again,qkv_again", [
    ("nothing", TINY["n_layers"], TINY["n_layers"]),
    ("dots", TINY["n_layers"], 0),
    ("attn_out", 0, 0)])
def test_remat_recompute_counts_and_saved_bytes(policy, fwd_again,
                                                qkv_again, monkeypatch):
    """"nothing" runs each block's flash forward and QKV GEMM again in the
    backward; "dots" runs no GEMM beyond the unchecked backward's (the
    flash forward is no dot: it runs again); "attn_out" runs neither the
    flash forward nor the QKV GEMM again and keeps, a layer, exactly the
    planner's term: q, k, v, O and the f32 lse."""
    fwd, qkv, mms, cached = _backward_counts(policy, monkeypatch)
    assert (fwd, qkv) == (fwd_again, qkv_again)
    _, _, mms_plain, _ = _backward_counts("nothing", monkeypatch,
                                          remat_on=False)
    if policy == "dots":
        assert mms == mms_plain
    else:
        assert mms > mms_plain
    cfg = LlamaConfig(**TINY, dtype=torch.float32, remat_policy=policy)
    B, S = 2, 16
    extra = (plan.llama_activation_bytes(cfg, B, S)
             - plan.llama_activation_bytes(
                 dataclasses.replace(cfg, remat_policy="nothing"), B, S))
    if policy == "attn_out":
        term = B * S * ((2 * cfg.n_heads + 2 * cfg.n_kv_heads)
                        * cfg.head_dim * 4 + cfg.n_heads * 4)
        assert cached == term
        assert abs(extra - 1.5 * cfg.n_layers * term) < 1
    elif policy == "nothing":
        assert cached == 0 and extra == 0


# ---- the inline-backward CE ------------------------------------------------------


def _ce_setup(B=2, S=32, D=16, V=64, seed=0):
    rng = np.random.default_rng(seed)
    hidden = rng.standard_normal((B, S, D)).astype(np.float32)
    w = (rng.standard_normal((D, V)) * 0.1).astype(np.float32)
    targets = rng.integers(0, V, (B, S)).astype(np.int32)
    mask = rng.integers(0, 2, (B, S)).astype(np.int32)
    return hidden, w, targets, mask


def _jax_ce(hidden, w, targets, mask, chunk, scale=1.0, inline=True):
    def f(h, w):
        return scale * jax_fused_ce(h, w, targets, mask, chunk_tokens=chunk,
                                    compute_dtype=jnp.float32,
                                    inline_backward=inline)
    loss, (gh, gw) = jax.value_and_grad(f, argnums=(0, 1))(
        jnp.asarray(hidden), jnp.asarray(w))
    return float(loss), np.asarray(gh), np.asarray(gw).T


def _port_ce(hidden, w, targets, mask, chunk, scale=1.0, inline=True):
    h = _t(hidden).requires_grad_(True)
    wt = _t(w.T).requires_grad_(True)
    loss = scale * fused_cross_entropy(
        h, wt, _t(targets).long(), None if mask is None else _t(mask),
        chunk_tokens=chunk, compute_dtype=torch.float32,
        inline_backward=inline)
    loss.backward()
    return loss.item(), h.grad.numpy(), wt.grad.numpy()


@pytest.mark.parametrize("chunk", [8, 17, 4096])
def test_inline_ce_matches_jax_inline(chunk):
    args = _ce_setup()
    jl, jgh, jgw = _jax_ce(*args, chunk)
    pl, pgh, pgw = _port_ce(*args, chunk)
    _, dgh, dgw = _port_ce(*args, chunk, inline=False)
    assert pl == pytest.approx(jl, rel=1e-5)
    for got, want in ((pgh, jgh), (pgw, jgw), (pgh, dgh), (pgw, dgw)):
        np.testing.assert_allclose(got, want, atol=1e-5)


def test_inline_ce_cotangent_scales_exactly():
    args = _ce_setup()
    _, gh, gw = _port_ce(*args, 16)
    _, sh, sw = _port_ce(*args, 16, scale=3.5)
    _, jsh, jsw = _jax_ce(*args, 16, scale=3.5)
    np.testing.assert_allclose(sh, 3.5 * gh, rtol=1e-6)
    np.testing.assert_allclose(sw, 3.5 * gw, rtol=1e-6)
    np.testing.assert_allclose(sh, jsh, atol=1e-5)
    np.testing.assert_allclose(sw, jsw, atol=1e-5)


def test_inline_ce_no_mask_prime_token_count():
    hidden, w, targets, _ = _ce_setup(B=1, S=31)
    jl, jgh, jgw = _jax_ce(hidden, w, targets, None, 8)
    pl, pgh, pgw = _port_ce(hidden, w, targets, None, 8)
    assert pl == pytest.approx(jl, rel=1e-5)
    np.testing.assert_allclose(pgh, jgh, atol=1e-5)
    np.testing.assert_allclose(pgw, jgw, atol=1e-5)


def test_inline_ce_primal_only_path():
    hidden, w, targets, mask = _ce_setup()
    with torch.no_grad():
        a = fused_cross_entropy(_t(hidden), _t(w.T), _t(targets).long(),
                                _t(mask), 16, torch.float32)
        b = fused_cross_entropy(_t(hidden), _t(w.T), _t(targets).long(),
                                _t(mask), 16, torch.float32,
                                inline_backward=True)
    assert float(b) == pytest.approx(float(a), rel=1e-6)
    jl = float(jax_fused_ce(jnp.asarray(hidden), jnp.asarray(w), targets,
                            mask, chunk_tokens=16, compute_dtype=jnp.float32,
                            inline_backward=True))
    assert float(b) == pytest.approx(jl, rel=1e-5)
    # over a denominator of 1: the default path's sum
    s_inl = inline_cross_entropy(_t(hidden), _t(w.T), _t(targets).long(),
                                 _t(mask), torch.ones(()), 16,
                                 torch.float32)
    s_def, _ = fused_cross_entropy_sum(
        _t(hidden), _t(w.T), _t(targets).long(), _t(mask), 16,
        torch.float32)
    assert float(s_inl) == pytest.approx(float(s_def), rel=1e-6)


def test_vocab_parallel_inline_ce_two_ranks():
    """Two gloo ranks, each its vocabulary half of the head: the inline
    CE's loss, the hidden states' gradient (summed over the ranks) and
    every rank's slice of the head's gradient against the one-card plain
    CE, 2e-5."""
    n, vocab, dim = 24, 64, 16
    loss, count, gh, gw = launch(torch_jobs.vocab_parallel_ce, 2,
                                 device="cpu",
                                 args=(3, n, vocab, dim, 8, True),
                                 timeout=T)[0]
    rng = np.random.default_rng(3)
    h = torch.tensor(rng.standard_normal((2, n // 2, dim)),
                     dtype=torch.float32, requires_grad=True)
    w = torch.tensor(rng.standard_normal((vocab, dim)) / dim ** 0.5,
                     dtype=torch.float32, requires_grad=True)
    t = torch.tensor(rng.integers(0, vocab, (2, n // 2)))
    m = torch.tensor((rng.random((2, n // 2)) > 0.2).astype(np.float32))
    want, want_count = token_loss_sum(h @ w.T, t, m)
    want.backward()
    assert count == float(want_count)
    assert loss == pytest.approx(float(want.detach()), rel=2e-5, abs=2e-5)
    np.testing.assert_allclose(gh, h.grad.numpy(), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(gw, w.grad.numpy(), rtol=2e-5, atol=2e-5)


# ---- tied embeddings -------------------------------------------------------------


@pytest.mark.parametrize("fused,inline", [(False, False), (True, False),
                                          (True, True)])
def test_tied_model_matches_jax(fused, inline):
    kw = dict(tie_embeddings=True, fused_ce=fused, ce_chunk_tokens=16,
              ce_inline_bwd=inline)
    jcfg = JaxConfig(**TINY, dtype=jnp.float32, remat=False, **kw)
    params = _jax_params(jcfg, seed=3)
    assert "lm_head" not in params
    pcfg = LlamaConfig(**TINY, dtype=torch.float32, remat=True, **kw)
    toks, mask = _batch(seed=5)
    # the logits: the f32 product with the embedding table
    model = Llama(pcfg, device="cpu", param_dtype=torch.float32)
    model.load_state_dict(params_from_jax(params, pcfg, dtype=torch.float32))
    assert not hasattr(model, "lm_head") and model.head is model.tok_embed
    with torch.no_grad():
        logits = model(_t(toks[:, :-1])).numpy()
    want = np.asarray(JaxLlama(jcfg).apply({"params": params}, toks[:, :-1]))
    np.testing.assert_allclose(logits, want, rtol=2e-5, atol=2e-5)
    jl, jg = _jax_grads(jcfg, params, toks, mask)
    loss, grads = _port_grads(pcfg, params, toks, mask)
    assert loss == pytest.approx(jl, rel=1e-5)
    _hold(grads, params_from_jax(jax.tree.map(np.asarray, jg), pcfg,
                                 dtype=torch.float32), "tied")


def test_tied_model_serves_greedy_as_jax():
    """A tied model's greedy tokens, through the port's `generate` and its
    paged engine, equal the JAX tied model's `generate` token for token."""
    from ray_lightning_tpu_torch.serve.engine import DecodeEngine, EngineConfig
    from ray_lightning_tpu_torch.serve.scheduler import Request, Scheduler

    kw = dict(vocab_size=256, dim=128, n_layers=2, n_heads=2, n_kv_heads=1,
              hidden_dim=256, max_seq_len=128, tie_embeddings=True)
    jcfg = JaxConfig(**kw, dtype=jnp.float32, use_flash=False)
    params = _jax_params(jcfg, seed=4)
    pcfg = LlamaConfig(**kw, dtype=torch.float32, remat=False)
    model = Llama(pcfg, device="cpu")
    model.load_state_dict(params_from_jax(params, pcfg))
    prompt = np.random.default_rng(6).integers(0, 256, (2, 8)).astype(
        np.int32)
    want = np.asarray(jax_generate(JaxLlama(jcfg), params, prompt, 6))
    np.testing.assert_array_equal(generate(model, prompt, 6).numpy(), want)
    engine = DecodeEngine(model, EngineConfig(
        capacity=2, block_size=8, blocks_per_slot=4, prefill_chunk=4),
        use_kernels=True, device="cpu")
    sched = Scheduler(engine)
    for i in range(2):
        sched.submit(Request(rid=f"r{i}", prompt=prompt[i],
                             max_new_tokens=6))
    got = {}
    while sched.busy():
        for c in sched.tick():
            got[c.rid] = c.tokens
    assert [got["r0"], got["r1"]] == want.tolist()


def test_tied_specs_and_plan_drop_the_head():
    cfg = LlamaConfig.tiny(tie_embeddings=True)
    assert "lm_head" not in llama_param_specs(cfg)
    assert llama_param_specs(cfg)["tok_embed"] == ("tensor", None)
    tied = plan.plan_train_memory(LlamaModule(cfg), SingleDevice(), 1, None)
    untied = plan.plan_train_memory(
        LlamaModule(LlamaConfig.tiny()), SingleDevice(), 1, None)
    head = cfg.vocab_size * cfg.dim * 4
    assert untied.params_bytes_per_device - tied.params_bytes_per_device \
        == head
    # the JAX planner drops the same bytes
    from ray_lightning_tpu.parallel import plan as jplan
    from ray_lightning_tpu.parallel.strategy import SingleDevice as JSingle

    batch = {"tokens": np.zeros((1, 17), np.int32)}
    j = [jplan.plan_train_memory(
        JaxLlamaModule(JaxConfig.tiny(tie_embeddings=t)), JSingle(), 1,
        batch).params_bytes_per_device for t in (True, False)]
    assert j[1] - j[0] == head
    assert tied.params_bytes_per_device == j[0]


@pytest.mark.parametrize("knobs", [
    dict(tie_embeddings=True, ce_inline_bwd=True, remat_policy="attn_out"),
    dict(remat_policy="dots")], ids=["tied_inline_attn_out", "dots"])
def test_tied_inline_attn_out_tensor_parallel(knobs):
    """``ShardedMesh(tensor=2)`` over two gloo ranks with the tied head
    (the vocab-split embedding), the inline CE and "attn_out", and with
    "dots" (whose kept row-parallel GEMM outputs the all-reduce must not
    change): the loss and every gradient against one process's, 2e-5."""
    cfg_kw = dict(fused_ce=True, remat=True, ce_chunk_tokens=16, **knobs)
    params = _jax_params(JaxConfig(**TINY, dtype=jnp.float32,
                                   tie_embeddings=knobs.get(
                                       "tie_embeddings", False)), seed=2)
    toks, mask = _batch(n=4, s=12, seed=7)
    loss, grads, _ = launch(torch_jobs.tp_grads, 2, device="cpu",
                            args=(params, toks, mask, cfg_kw,
                                  dict(tensor=2)), timeout=T)[0]
    single = torch_jobs.llama_module(params, **cfg_kw)
    single.device = torch.device("cpu")
    single.setup()
    with torch.no_grad():
        single.model.load_state_dict(single.params)
    single.params = dict(single.model.named_parameters())
    t = _t(toks)
    want = single.apply(single.params, t[:, :-1], targets=t[:, 1:].long(),
                        mask=_t(mask))
    want.backward()
    assert loss == pytest.approx(float(want), rel=2e-5, abs=2e-5)
    assert ("lm_head" in grads) == (not knobs.get("tie_embeddings"))
    _hold({k: torch.from_numpy(v) for k, v in grads.items()},
          {k: p.grad for k, p in single.params.items()}, "tensor=2")
