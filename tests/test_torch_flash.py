"""The port's flash attention against the JAX Pallas kernels, on the CPU.

The same numpy inputs (from a seed, f32) go through
`flash_attention_pallas` / `_fwd` in interpret mode (under
`force_pallas`, as the JAX suite runs them) and through the port's kernel
wrappers, which run their plain versions on CPU tensors: the forward's
output and logsumexp, and dq, dk, dv from the same cotangent. The shapes
are the JAX suite's flash matrix (tests/test_ops.py): causal and full,
a query shard at an offset, MHA, GQA, and a query block that sees no key
(the l == 0 guard). Tolerance: the JAX suite's own 2e-5, relative to the
largest reference value for the gradients. The CUDA kernels are held
against these plain versions on the card by ``chip_smoke.py``.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_lightning_tpu.ops.dispatch import force_pallas
from ray_lightning_tpu.ops.pallas.flash import _fwd as jax_flash_fwd
from ray_lightning_tpu.ops.pallas.flash import flash_attention_pallas
from ray_lightning_tpu_torch.ops import dispatch
from ray_lightning_tpu_torch.ops.attention import (
    dot_product_attention,
    flash_attention,
    flash_uses_kernel,
)
from ray_lightning_tpu_torch.ops.kernels.flash import (
    flash_attention_kernel,
    flash_bwd_dkv_kernel,
    flash_bwd_dq_kernel,
    flash_bwd_plain,
    flash_delta,
    flash_fwd_kernel,
    flash_fwd_plain,
    flash_shapes_supported,
)

TOL = 2e-5
BLOCK = 128  # the JAX suite's block for these shapes

#: name -> (B, Sq, Sk, H, Hkv, D, causal, q_offset)
CASES = {
    "causal_gqa": (2, 256, 256, 4, 2, 64, True, 0),
    "full_gqa": (2, 256, 256, 4, 2, 64, False, 0),
    "mha": (2, 256, 256, 4, 4, 64, True, 0),
    "gqa4_hd128": (1, 256, 256, 8, 2, 128, True, 0),
    "q_offset": (2, 128, 256, 4, 2, 64, True, 128),
    # the first query block sees no key: zeros and lse = -1e30 (l == 0)
    "empty_rows": (1, 256, 256, 4, 2, 64, True, -128),
}


def _inputs(B, Sq, Sk, H, Hkv, D, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Sq, H, D), dtype=np.float32)
    k = rng.standard_normal((B, Sk, Hkv, D), dtype=np.float32)
    v = rng.standard_normal((B, Sk, Hkv, D), dtype=np.float32)
    do = rng.standard_normal((B, Sq, H, D), dtype=np.float32)
    return q, k, v, do


def _jax_fwd(q, k, v, causal, q_offset):
    """(o [B, Sq, H, D], lse [B, H, Sq]) from the Pallas forward."""
    tr = lambda a: jnp.asarray(a).transpose(0, 2, 1, 3)  # noqa: E731
    with force_pallas():
        o, lse = jax_flash_fwd(tr(q), tr(k), tr(v), q.shape[-1] ** -0.5,
                               causal, q_offset, BLOCK, BLOCK)
    return np.asarray(o).transpose(0, 2, 1, 3), np.asarray(lse)[..., 0]


def _jax_grads(q, k, v, do, causal, q_offset):
    def f(q, k, v):
        return flash_attention_pallas(q, k, v, causal=causal,
                                      q_offset=q_offset, block_q=BLOCK,
                                      block_k=BLOCK)

    with force_pallas():
        _, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        return [np.asarray(g) for g in vjp(jnp.asarray(do))]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close_grad(got, want):
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL * scale)


@pytest.mark.parametrize("name", list(CASES))
def test_forward_and_lse_match_pallas(name):
    B, Sq, Sk, H, Hkv, D, causal, off = CASES[name]
    q, k, v, _ = _inputs(B, Sq, Sk, H, Hkv, D)
    want_o, want_lse = _jax_fwd(q, k, v, causal, off)
    o, lse = flash_fwd_kernel(_t(q), _t(k), _t(v), causal=causal,
                              q_offset=off)
    assert o.shape == (B, Sq, H, D) and lse.shape == (B, H, Sq)
    np.testing.assert_allclose(o.numpy(), want_o, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(lse.numpy(), want_lse, rtol=TOL, atol=TOL)
    if name == "empty_rows":
        assert not o[:, :128].any()
        assert bool((lse[:, :, :128] == -1e30).all())
        assert bool(o[:, 128:].abs().sum(-1).gt(0).all())


@pytest.mark.parametrize("name", list(CASES))
def test_gradients_match_pallas(name):
    """dq, dk, dv through `FlashAttentionFunction` (the plain passes on
    CPU tensors) against the vjp of the Pallas custom-vjp kernel."""
    B, Sq, Sk, H, Hkv, D, causal, off = CASES[name]
    q, k, v, do = _inputs(B, Sq, Sk, H, Hkv, D, seed=1)
    want = _jax_grads(q, k, v, do, causal, off)
    tq, tk, tv = (_t(a).requires_grad_(True) for a in (q, k, v))
    out = flash_attention_kernel(tq, tk, tv, causal=causal, q_offset=off)
    got = torch.autograd.grad(out, (tq, tk, tv), _t(do))
    for g, w in zip(got, want):
        assert g.shape == w.shape
        _close_grad(g.numpy(), w)


@pytest.mark.parametrize("name", ["causal_gqa", "q_offset", "empty_rows"])
def test_two_pass_wrappers_match_whole_backward(name):
    """The pass-1 and pass-2 wrappers from the forward's (o, lse) and the
    torch reduction delta give what `flash_bwd_plain` gives, and match
    the Pallas gradients."""
    B, Sq, Sk, H, Hkv, D, causal, off = CASES[name]
    q, k, v, do = _inputs(B, Sq, Sk, H, Hkv, D, seed=2)
    tq, tk, tv, tdo = map(_t, (q, k, v, do))
    o, lse = flash_fwd_kernel(tq, tk, tv, causal, off)
    delta = flash_delta(o, tdo)
    assert delta.shape == (B, H, Sq)
    dk, dv = flash_bwd_dkv_kernel(tq, tk, tv, tdo, lse, delta, causal, off)
    dq = flash_bwd_dq_kernel(tq, tk, tv, tdo, lse, delta, causal, off)
    whole = flash_bwd_plain(tq, tk, tv, o, lse, tdo, causal, off)
    for a, b in zip((dq, dk, dv), whole):
        assert torch.equal(a, b)
    for g, w in zip((dq, dk, dv), _jax_grads(q, k, v, do, causal, off)):
        _close_grad(g.numpy(), w)


def test_plain_matches_reference_sdpa():
    """The plain forward is the reference SDPA where both apply."""
    q, k, v, _ = _inputs(2, 64, 64, 4, 2, 16)
    tq, tk, tv = map(_t, (q, k, v))
    for causal in (True, False):
        o, _ = flash_fwd_plain(tq, tk, tv, causal=causal)
        ref = dot_product_attention(tq, tk, tv, causal=causal)
        np.testing.assert_allclose(o.numpy(), ref.numpy(), rtol=TOL,
                                   atol=TOL)


def test_shape_gate():
    assert flash_shapes_supported((2, 2048, 32, 128), (2, 2048, 8, 128))
    assert flash_shapes_supported((2, 100, 4, 64), (2, 37, 2, 64))
    assert flash_shapes_supported((1, 1, 4, 128), (1, 1, 4, 128))
    assert not flash_shapes_supported((2, 256, 4, 96), (2, 256, 4, 96))
    assert not flash_shapes_supported((2, 256, 4, 16), (2, 256, 2, 16))
    assert not flash_shapes_supported((2, 256, 3, 64), (2, 256, 2, 64))
    assert not flash_shapes_supported((2, 256, 4, 64), (1, 256, 2, 64))
    assert not flash_shapes_supported((2, 256, 4, 64), (2, 256, 2, 128))


def test_dispatch():
    """The kernels unless masked or the reference is forced; on CUDA a
    refused shape raises instead of taking the reference; on the CPU
    the kernel wrappers' plain versions take any shape."""
    qs, ks = (2, 64, 4, 16), (2, 64, 2, 16)
    assert flash_uses_kernel(qs, ks, "cpu")
    assert not flash_uses_kernel(qs, ks, "cpu", masked=True)
    with dispatch.force_reference():
        assert not flash_uses_kernel(qs, ks, "cpu")
        assert not flash_uses_kernel(qs, ks, "cuda")
        with dispatch.force_kernel():
            assert flash_uses_kernel(qs, ks, "cpu")
    with pytest.raises(ValueError, match="do not take shapes"):
        flash_uses_kernel(qs, ks, "cuda")
    assert flash_uses_kernel((2, 64, 4, 128), (2, 64, 2, 128), "cuda")


def test_flash_attention_routes():
    """`flash_attention` equals the kernel path unmasked, the reference
    with a mask or under force_reference, and launches nothing on CPU."""
    q, k, v, _ = _inputs(2, 64, 64, 4, 2, 16, seed=3)
    tq, tk, tv = map(_t, (q, k, v))
    before = flash_fwd_kernel.launches
    out = flash_attention(tq, tk, tv, causal=True)
    np.testing.assert_allclose(
        out.numpy(), flash_attention_kernel(tq, tk, tv).numpy(), rtol=0,
        atol=0)
    mask = torch.ones(2, 64, dtype=torch.bool)
    mask[0, :8] = False
    masked = flash_attention(tq, tk, tv, causal=True, mask=mask)
    np.testing.assert_allclose(
        masked.numpy(),
        dot_product_attention(tq, tk, tv, causal=True, mask=mask).numpy(),
        rtol=0, atol=0)
    with dispatch.force_reference():
        ref = flash_attention(tq, tk, tv, causal=True)
    np.testing.assert_allclose(ref.numpy(), out.numpy(), rtol=TOL, atol=TOL)
    assert flash_fwd_kernel.launches == before
