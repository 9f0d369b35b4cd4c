"""The sequence axis: ring and Ulysses attention and the Llama's
``seq_parallel`` path against the JAX package (`tests/test_ring_attention.py`'s
cases), on the CPU.

The same seeded numpy inputs go through the JAX functions (the ring on
its virtual-device mesh, dense attention, `jax.vjp` for the gradients)
and through the port over four gloo processes (one group for the whole
file, `tests/torch_axis_jobs.py` `seq_job`): the ring at seq 4, causal
and full, also over the all-to-all route the card's gloo lanes take; GQA
on a data x seq mesh; Ulysses at seq 4 and its indivisible-heads error;
the tiny Llama's loss, every gradient and its logits under
``ShardedMesh(data=2, seq=2)`` in ring and in Ulysses mode, against the
dense JAX model and the JAX seq-parallel model; 2-step fits under
``ShardedMesh(data=2, seq=2)`` and ``ShardedMesh(seq=4)`` (clipped)
against the JAX fit. In one process, the ring's autograd function
through its rotation seam (`parallel.comm.LocalShift`, every rank of a
ring of 4 in turn) against dense attention and `jax.vjp` of the JAX
ring. f32, 2e-5 throughout.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_lightning_tpu import make_mesh
from ray_lightning_tpu.core.callbacks import Callback as JaxCallback
from ray_lightning_tpu.core.trainer import Trainer as JaxTrainer
from ray_lightning_tpu.models.llama import Llama as JaxLlama
from ray_lightning_tpu.models.llama import LlamaConfig as JaxConfig
from ray_lightning_tpu.models.llama import LlamaModule as JaxLlamaModule
from ray_lightning_tpu.ops import dot_product_attention as jax_attention
from ray_lightning_tpu.ops import ring_attention as jax_ring
from ray_lightning_tpu.ops.ring_attention import _accum_block as jax_accum
from ray_lightning_tpu.parallel.strategy import SingleDevice as JaxSingle
from ray_lightning_tpu_torch.models.llama import LlamaConfig
from ray_lightning_tpu_torch.models.llama import (
    params_from_jax as llama_from_jax,
)
from ray_lightning_tpu_torch.ops import dispatch
from ray_lightning_tpu_torch.ops.ring_attention import (
    _accum_block,
    ring_attention_ranks,
    ring_perm,
)
from ray_lightning_tpu_torch.runtime.launch import launch
from tests import torch_axis_jobs

T = 240
TOL = dict(rtol=2e-5, atol=2e-5)
#: the JAX tiny config's widths (`LlamaConfig.tiny`)
TINY = dict(vocab_size=256, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
            hidden_dim=128, max_seq_len=256)
#: name: (port config, ShardedMesh sizes)
LLAMA = {
    "ring": (dict(TINY, seq_parallel=True), dict(data=2, seq=2)),
    "ulysses": (dict(TINY, n_heads=8, n_kv_heads=4, seq_parallel=True,
                     seq_parallel_mode="ulysses"), dict(data=2, seq=2)),
}


def _qkv(B=2, S=32, H=4, Hkv=None, D=8, seed=0):
    rng = np.random.default_rng(seed)
    Hkv = Hkv or H
    return (rng.standard_normal((B, S, H, D)).astype(np.float32),
            rng.standard_normal((B, S, Hkv, D)).astype(np.float32),
            rng.standard_normal((B, S, Hkv, D)).astype(np.float32),
            rng.standard_normal((B, S, H, D)).astype(np.float32))


def _jax_cfg(kw, **extra):
    kw = {k: v for k, v in kw.items()
          if k not in ("seq_parallel", "seq_parallel_mode")}
    return JaxConfig(**kw, use_flash=False, dtype=jnp.float32, remat=False,
                     **extra)


def _jax_params(cfg, seed=1):
    tokens = jnp.zeros((1, 8), jnp.int32)
    return jax.tree.map(np.asarray, jax.jit(JaxLlama(cfg).init)(
        jax.random.key(seed), tokens)["params"])


def _inputs():
    params = {name: _jax_params(_jax_cfg(kw), seed=1 + i)
              for i, (name, (kw, _)) in enumerate(LLAMA.items())}
    rng = np.random.default_rng(7)
    return {
        "mha": _qkv(),
        "gqa": _qkv(B=4, S=16, H=4, Hkv=2, seed=3),
        "params": params,
        "llama": LLAMA,
        "tokens": rng.integers(0, 256, (4, 33)).astype(np.int32),
        "fit_tokens": rng.integers(0, 256, (8, 33)).astype(np.int32),
    }


@pytest.fixture(scope="module")
def run():
    inp = _inputs()
    return inp, launch(torch_axis_jobs.seq_job, 4, device="cpu",
                       args=(inp,), timeout=T)


def _assemble(ranks, key, shape_from, field):
    """The global [B, S, ...] array from every rank's rows and seq chunk
    of ``field``."""
    by_rows = {}
    for r in ranks:
        c = r[key]
        by_rows.setdefault(tuple(c["rows"]), {})[c["seq"]] = c[field]
    blocks = [np.concatenate([parts[i] for i in sorted(parts)], axis=1)
              for _, parts in sorted(by_rows.items())]
    out = np.concatenate(blocks, axis=0)
    assert out.shape[:2] == shape_from.shape[:2]
    return out


def _jax_attention_vjp(q, k, v, g, causal, fn=None):
    fn = fn or (lambda q, k, v: jax_attention(q, k, v, causal=causal))
    out, vjp = jax.vjp(fn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return [np.asarray(a) for a in (out, *vjp(jnp.asarray(g)))]


@pytest.mark.parametrize("case", ["ring_seq4_True", "ring_seq4_False",
                                  "ring_seq4_all_to_all",
                                  "ulysses_seq4_True", "ulysses_seq4_False",
                                  "ring_gqa_data2_seq2"])
def test_sequence_parallel_attention_matches_jax(run, case, devices8):
    inp, ranks = run
    q, k, v, g = inp["gqa" if "gqa" in case else "mha"]
    causal = not case.endswith("False")
    want = _jax_attention_vjp(q, k, v, g, causal)
    got = [_assemble(ranks, case, q, f) for f in ("out", "dq", "dk", "dv")]
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a, b, err_msg=name, **TOL)
    if case.startswith("ring_seq4"):
        # the JAX ring itself, on four virtual devices
        mesh = make_mesh(seq=4, devices=devices8[:4])
        jring = np.asarray(jax_ring(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), mesh, causal=causal))
        np.testing.assert_allclose(got[0], jring, **TOL)


def test_ulysses_rejects_indivisible_heads(run):
    _, ranks = run
    assert ranks[0]["ulysses_error"] is not None
    assert "ring" in ranks[0]["ulysses_error"]
    assert "Hkv/tensor=2, seq=4" in ranks[0]["ulysses_error"]


def _jax_loss_grads(cfg, params, toks):
    jm = JaxLlamaModule(cfg)
    jm.setup()
    i, t, m = jm._split({"tokens": jnp.asarray(toks)})
    loss, grads = jax.value_and_grad(
        lambda p: jm._loss(p, i, t, m))(jax.tree.map(jnp.asarray, params))
    return float(loss), jax.tree.map(np.asarray, grads)


@pytest.mark.parametrize("mode", list(LLAMA))
def test_llama_seq_parallel_matches_dense_and_jax(run, mode, devices8):
    inp, ranks = run
    kw, _ = LLAMA[mode]
    params, toks = inp["params"][mode], inp["tokens"]
    jcfg = _jax_cfg(kw)
    loss, jgrads = _jax_loss_grads(jcfg, params, toks)
    key = f"llama_{mode}"
    assert ranks[0][key]["loss"] == pytest.approx(loss, rel=2e-5, abs=2e-5)
    pcfg = LlamaConfig(**kw, dtype=torch.float32)
    want = {k: v.numpy() for k, v in llama_from_jax(
        jgrads, pcfg, dtype=torch.float32).items()}
    for r in ranks:
        got = r[key]["grads"]
        assert set(got) == set(want)
        for name, g in want.items():
            np.testing.assert_allclose(
                got[name], g, rtol=2e-5,
                atol=2e-5 * float(np.abs(g).max()), err_msg=name)
    logits = _assemble(ranks, key, toks[:, :-1], "logits")
    dense = np.asarray(JaxLlama(jcfg).apply({"params": params},
                                            jnp.asarray(toks[:, :-1])))
    np.testing.assert_allclose(logits, dense, **TOL)
    # the JAX seq-parallel model on its own mesh (its tests' meshes)
    sp_cfg = dataclasses.replace(jcfg, seq_parallel=True,
                                 seq_parallel_mode=mode)
    mesh = (make_mesh(data=2, seq=4, devices=devices8) if mode == "ring"
            else make_mesh(data=2, seq=2, tensor=2, devices=devices8))
    jsp = np.asarray(JaxLlama(sp_cfg, mesh=mesh).apply(
        {"params": params}, jnp.asarray(toks[:, :-1])))
    # the JAX package holds its own seq-parallel model to its dense one at
    # 2e-4 (`tests/test_ring_attention.py`); the port, at 2e-5 of the
    # dense model above, sits within that of it
    np.testing.assert_allclose(logits, jsp, rtol=2e-4, atol=2e-4)


class _Rows(JaxCallback):
    def __init__(self):
        self.rows = []

    def on_train_batch_end(self, trainer, module, metrics, batch_idx):
        self.rows.append((float(metrics["loss"]),
                          float(metrics["grad_norm"])))


def _jax_fit(params, batches, clip=None):
    rec = _Rows()
    jm = JaxLlamaModule(_jax_cfg(LLAMA["ring"][0]), lr=1e-2,
                        warmup_steps=1, total_steps=4)
    jm.params = jax.tree.map(jnp.asarray, params)
    JaxTrainer(strategy=JaxSingle(), callbacks=[rec], max_steps=2,
               log_every_n_steps=1, gradient_clip_val=clip,
               enable_checkpointing=False, enable_progress_bar=False,
               seed=0).fit(jm, [{"tokens": b} for b in batches])
    return rec.rows


@pytest.mark.parametrize("fit", ["fit_data2_seq2", "fit_seq4"])
def test_seq_parallel_fit_matches_jax(run, fit):
    inp, ranks = run
    toks = inp["fit_tokens"]
    if fit == "fit_data2_seq2":
        # each data rank's k-th batch of its half, in rank order
        batches = [toks[[2 * k, 2 * k + 1, 4 + 2 * k, 5 + 2 * k]]
                   for k in range(2)]
        want = _jax_fit(inp["params"]["ring"], batches)
    else:
        want = _jax_fit(inp["params"]["ring"], [toks[:4], toks[4:]],
                        clip=0.5)
    for r in ranks:
        np.testing.assert_allclose(np.asarray(r[fit]), np.asarray(want),
                                   rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_ring_function_through_its_rotation_seam(causal, devices8):
    """The ring's autograd function for a ring of four in one process
    (`ring_attention_ranks` over `LocalShift(4)`, each rank's body in
    turn, the dK/dV accumulators travelling with their blocks): output
    and gradients against dense attention and `jax.vjp` of the JAX ring,
    for the kernel lane (the wrappers, which run the kernels' plain
    versions on CPU tensors) and the plain lane. The JAX ring's gradient (a
    shard_map transpose, ~25 s to compile here) is taken causal only."""
    q, k, v, g = _qkv(B=2, S=32, H=4, Hkv=2, seed=11)
    wants = [_jax_attention_vjp(q, k, v, g, causal)]
    if causal:
        mesh = make_mesh(seq=4, devices=devices8[:4])
        wants.append(_jax_attention_vjp(
            q, k, v, g, causal,
            fn=lambda q, k, v: jax_ring(q, k, v, mesh, causal=causal)))
    for lane in ("kernel", "reference"):
        shards = [[torch.tensor(c).requires_grad_() for c in
                   np.split(a, 4, axis=1)] for a in (q, k, v)]
        with (dispatch.force_reference() if lane == "reference"
              else dispatch.force_kernel()):
            outs = ring_attention_ranks(*shards, causal=causal)
        out = torch.cat(outs, dim=1)
        (out * torch.tensor(g)).sum().backward()
        got = [out.detach().numpy()] + [
            torch.cat([t.grad for t in ts], dim=1).numpy() for ts in shards]
        for want in wants:
            for name, a, b in zip(("out", "dq", "dk", "dv"), got, want):
                np.testing.assert_allclose(a, b, err_msg=f"{lane} {name}",
                                           **TOL)


def test_seq_parallel_config_validation():
    with pytest.raises(ValueError, match="ring' or 'ulysses"):
        LlamaConfig(**TINY, seq_parallel_mode="zigzag")
    with pytest.raises(ValueError, match="mutually exclusive"):
        LlamaConfig(**TINY, seq_parallel=True, pipeline_microbatches=2)


@pytest.mark.parametrize("causal,q_off,kv_off", [(True, 16, 0),
                                                 (True, 16, 16),
                                                 (True, 0, 16),
                                                 (False, 0, 16)])
def test_accum_block_and_ring_perm_equal_jax(causal, q_off, kv_off):
    """`_accum_block`, the JAX per-block online-softmax update, twice in a
    row (the second on running state, GQA) from the same inputs, and the
    ring's schedule."""
    q, k, v, _ = _qkv(B=2, S=16, H=4, Hkv=2, seed=5)
    _, k2, v2, _ = _qkv(B=2, S=16, H=4, Hkv=2, seed=6)
    b, s, h, d = q.shape
    state = (np.zeros((b, h, s, d), np.float32),
             np.full((b, h, s), -np.inf, np.float32),
             np.zeros((b, h, s), np.float32))
    kw = dict(q_off=q_off, kv_off=kv_off, causal=causal, scale=d ** -0.5)
    jst, pst = [jnp.asarray(a) for a in state], [torch.tensor(a)
                                                 for a in state]
    for kb, vb in ((k, v), (k2, v2)):
        jst = jax_accum(jnp.asarray(q), jnp.asarray(kb), jnp.asarray(vb),
                        *jst, **kw)
        pst = _accum_block(torch.tensor(q), torch.tensor(kb),
                           torch.tensor(vb), *pst, **kw)
    for a, e in zip(pst, jst):
        np.testing.assert_allclose(a.numpy(), np.asarray(e), **TOL)
    from ray_lightning_tpu.ops.ring_attention import ring_perm as jax_perm

    assert ring_perm(4) == jax_perm(4)
