"""The PyTorch port's Llama against the JAX package's, on the CPU.

Weights come from the JAX model's own `init` (both `scan_layers`
layouts) and cross through `params_from_jax`; the same numpy pool, block
tables and tokens then go through JAX `Llama.apply` (Pallas kernels in
interpret mode on the paged branches) and the port's `Llama` (its kernel
wrappers' plain versions on CPU tensors). f32, at atol 1e-4."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_lightning_tpu.models.llama import Llama as JaxLlama
from ray_lightning_tpu.models.llama import LlamaConfig as JaxConfig
from ray_lightning_tpu.ops.attention import (
    PagedDecodeView as JaxDecodeView,
    PagedPrefillView as JaxPrefillView,
)
from ray_lightning_tpu_torch.models.llama import (
    Llama,
    LlamaConfig,
    init_weights,
    params_from_jax,
)
from ray_lightning_tpu_torch.ops.attention import (
    PagedDecodeView,
    PagedPrefillView,
)

ATOL = 1e-4
#: (dim, heads, kv heads): the kernel-tiling tiny config of the JAX
#: suite (head_dim 64, GQA 2:1) and a 4:1 GQA twin
WIDTHS = {"h2kv1": (128, 2, 1), "h8kv2": (512, 8, 2)}


def _configs(width, scan_layers):
    dim, h, hkv = WIDTHS[width]
    common = dict(vocab_size=256, dim=dim, n_layers=2, n_heads=h,
                  n_kv_heads=hkv, hidden_dim=256, max_seq_len=128)
    jcfg = JaxConfig(**common, remat=False, dtype=jnp.float32,
                     scan_layers=scan_layers)
    return jcfg, LlamaConfig(**common, dtype=torch.float32)


def _build(width, scan_layers):
    jcfg, pcfg = _configs(width, scan_layers)
    jmodel = JaxLlama(jcfg)
    params = jmodel.init(jax.random.key(1),
                         jnp.zeros((1, 4), jnp.int32))["params"]
    model = Llama(pcfg, device="cpu")
    model.load_state_dict(params_from_jax(
        jax.tree.map(np.asarray, params), pcfg))
    return jcfg, jmodel, params, model


@pytest.mark.parametrize("width,scan_layers,kernel", [
    ("h2kv1", True, True),
    ("h2kv1", False, True),
    ("h2kv1", True, False),
    ("h8kv2", True, True),
])
def test_paged_prefill_then_decode_logits_match_jax(width, scan_layers,
                                                    kernel):
    """One left-padded paged prefill chunk for two group rows, then
    two paged decode steps for the same two slots: logits and the
    written pool agree with JAX at every step."""
    jcfg, jmodel, params, model = _build(width, scan_layers)
    rng = np.random.default_rng(0)
    L, P, N, M, CH = jcfg.n_layers, 8, 9, 4, 8
    hkv, hd = jcfg.n_kv_heads, jcfg.head_dim
    pool = [rng.standard_normal((L, N, P, hkv, hd)).astype(np.float32)
            for _ in range(2)]
    tables = np.array([[3, 7, 1, 0], [2, 5, 8, 0]], np.int32)
    pad = np.array([0, 3], np.int32)
    tokens = rng.integers(0, 256, (2, CH)).astype(np.int32)

    @jax.jit
    def jax_apply(params, toks, cache, pos, pad, view):
        return jmodel.apply({"params": params}, toks, cache=cache, pos=pos,
                            pad=pad, paged=view)

    jcache = tuple(map(jnp.asarray, pool))
    tcache = tuple(torch.from_numpy(p.copy()) for p in pool)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a))

    wpos = np.arange(CH)
    wb, wo = tables[:, wpos // P], np.broadcast_to(wpos % P, (2, CH))
    want, jcache = jax_apply(params, tokens, jcache, 0, pad, JaxPrefillView(
        jnp.asarray(tables), jnp.asarray(wb), jnp.asarray(wo),
        use_pallas=kernel))
    got = model(t(tokens), tcache, 0, pad=t(pad), paged=PagedPrefillView(
        t(tables), t(wb), t(wo), use_kernel=kernel))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    pos = np.array([CH, CH], np.int32)
    for step in range(2):
        toks = rng.integers(0, 256, (2, 1)).astype(np.int32)
        wb = tables[np.arange(2), pos // P]
        wo = pos % P
        want, jcache = jax_apply(
            params, toks, jcache, jnp.asarray(pos), pad, JaxDecodeView(
                jnp.asarray(tables), jnp.asarray(pos + 1), jnp.asarray(wb),
                jnp.asarray(wo), use_pallas=kernel))
        got = model(t(toks), tcache, t(pos), pad=t(pad),
                    paged=PagedDecodeView(t(tables), t(pos + 1), t(wb),
                                          t(wo), use_kernel=kernel))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=ATOL, rtol=0, err_msg=f"step {step}")
        pos = pos + 1
    for mine, theirs in zip(tcache, jcache):
        np.testing.assert_allclose(mine.numpy(), np.asarray(theirs),
                                   atol=ATOL, rtol=0)


def test_dense_cache_path_matches_jax():
    """The reference lanes' path: a dense [B, S_max] cache, a chunk at a
    scalar offset, then single-token decode at per-row positions."""
    jcfg, jmodel, params, model = _build("h2kv1", True)
    rng = np.random.default_rng(1)
    L, S_max = jcfg.n_layers, 32
    shape = (L, 2, S_max, jcfg.n_kv_heads, jcfg.head_dim)
    cache = [rng.standard_normal(shape).astype(np.float32)
             for _ in range(2)]
    tokens = rng.integers(0, 256, (2, 6)).astype(np.int32)

    @jax.jit
    def jax_apply(params, toks, cache, pos):
        return jmodel.apply({"params": params}, toks, cache=cache, pos=pos)

    want, _ = jax_apply(params, tokens, tuple(map(jnp.asarray, cache)),
                        jnp.int32(4))
    tcache = tuple(torch.from_numpy(c.copy()) for c in cache)
    got = model(torch.from_numpy(tokens), tcache, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    # per-row decode: each row is JAX's batch-1 call at its own pos
    pos = np.array([10, 13])
    toks = rng.integers(0, 256, (2, 1)).astype(np.int32)
    got = model(torch.from_numpy(toks), tcache, torch.from_numpy(pos))
    for b in range(2):
        want, _ = jax_apply(
            params, toks[b:b + 1],
            tuple(jnp.asarray(c.numpy()[:, b:b + 1]) for c in tcache),
            jnp.int32(pos[b]))
        np.testing.assert_allclose(got[b].numpy(), np.asarray(want)[0],
                                   atol=ATOL, rtol=0)


def test_params_from_jax_layouts_and_dtypes():
    """Both layer layouts give the same state dict for the same weights:
    transposed kernels, fused column orders kept, gains f32, matmul
    weights in the model dtype."""
    jcfg, _, params, _ = _build("h2kv1", True)
    np_params = jax.tree.map(np.asarray, params)
    unstacked = {k: v for k, v in np_params.items() if k != "layers"}
    for i in range(jcfg.n_layers):
        unstacked[f"layer_{i}"] = jax.tree.map(lambda a, i=i: a[i],
                                               np_params["layers"])
    bf = LlamaConfig(**{**_configs("h2kv1", True)[1].__dict__,
                        "dtype": torch.bfloat16})
    a = params_from_jax(np_params, bf)
    b = params_from_jax(unstacked, bf)
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert a["layers.0.wqkv"].dtype == torch.bfloat16
    assert a["layers.0.attn_norm"].dtype == torch.float32
    np.testing.assert_array_equal(
        a["layers.1.w_gate_up"].float().numpy(),
        torch.tensor(np_params["layers"]["w_gate_up"]["kernel"][1].T)
        .to(torch.bfloat16).float().numpy())


def test_entry_points_need_a_card_unless_cpu():
    cfg = LlamaConfig.tiny(dtype=torch.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        Llama(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_weights(cfg, torch.Generator())
    model = init_weights(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert model.device.type == "cpu"
    assert torch.all(model.final_norm == 1)
    std = model.layers[0].w_down.std().item()
    assert abs(std - cfg.hidden_dim ** -0.5) < 0.2 * cfg.hidden_dim ** -0.5
