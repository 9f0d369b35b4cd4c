"""The PyTorch port's ops against the JAX package's, on the CPU.

The same numpy inputs go through the JAX function (Pallas kernels in
interpret mode, as the JAX suite runs them) and the port's counterpart:
the plain versions that the port's kernel wrappers run on CPU tensors,
and the reference twins. f32 throughout, at the JAX suite's own
tolerance (rtol = atol = 2e-5). The CUDA kernels themselves are
held against these plain versions on the card by ``chip_smoke.py``."""
from __future__ import annotations

import ast
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_lightning_tpu.ops.attention import (
    dot_product_attention as jax_sdpa,
    paged_attention_reference as jax_paged_ref,
    paged_prefill_reference as jax_prefill_ref,
)
from ray_lightning_tpu.ops.pallas.paged_attention import (
    paged_attention_pallas,
)
from ray_lightning_tpu.ops.pallas.paged_prefill import paged_prefill_pallas
from ray_lightning_tpu.ops.pallas.rmsnorm import rms_norm_pallas
from ray_lightning_tpu.ops.rope import (
    apply_rope as jax_apply_rope,
    rope_frequencies as jax_rope_frequencies,
)
from ray_lightning_tpu_torch.ops import dispatch
from ray_lightning_tpu_torch.ops.attention import (
    dot_product_attention,
    paged_attention,
    paged_attention_reference,
    paged_attention_uses_kernel,
    paged_prefill,
    paged_prefill_reference,
    paged_prefill_uses_kernel,
)
from ray_lightning_tpu_torch.ops.kernels.paged_attention import (
    TILE as DECODE_TILE,
    decode_plan,
    decode_ranges,
    paged_attention_kernel,
    paged_shapes_supported,
)
from ray_lightning_tpu_torch.ops.kernels.paged_prefill import (
    TILE as PREFILL_TILE,
    launch_plan as prefill_launch_plan,
    paged_prefill_kernel,
    paged_prefill_shapes_supported,
    q_tile,
    split_plan as prefill_split_plan,
)
from ray_lightning_tpu_torch.ops.kernels import rmsnorm as rms_mod
from ray_lightning_tpu_torch.ops.kernels.rmsnorm import rms_norm_kernel
from ray_lightning_tpu_torch.ops.norms import rms_norm
from ray_lightning_tpu_torch.ops.precision import linear_f32_out
from ray_lightning_tpu_torch.ops.rope import apply_rope, rope_frequencies

TOL = dict(rtol=2e-5, atol=2e-5)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---- paged decode ----------------------------------------------------------


def _decode_case(rng, C, H, hd, Hkv, P, M, N):
    q = rng.standard_normal((C, H, hd)).astype(np.float32)
    pk = rng.standard_normal((N, P, Hkv, hd)).astype(np.float32)
    pv = rng.standard_normal((N, P, Hkv, hd)).astype(np.float32)
    tables = rng.integers(0, N, (C, M)).astype(np.int32)
    lengths = rng.integers(1, M * P + 1, (C,)).astype(np.int32)
    return q, pk, pv, tables, lengths


#: the JAX suite's matrix (tests/test_paged_attention.py) plus 4:1 GQA
DECODE_MATRIX = [
    (4, 4, 64, 2, 8, 3, 10),     # GQA 2:1
    (3, 8, 64, 8, 16, 2, 7),     # MHA, 16-token blocks
    (2, 4, 128, 1, 8, 4, 6),     # MQA, lane-wide head dim
    (5, 6, 64, 2, 8, 1, 4),      # single-block table
    (4, 8, 128, 2, 16, 4, 12),   # GQA 4:1, the 8B head layout
]


def _port_decode(impl, q, pk, pv, tables, lengths, pad=None):
    args = (_t(q), _t(pk), _t(pv), _t(tables), _t(lengths))
    pad = None if pad is None else _t(pad)
    if impl == "kernel":
        return paged_attention_kernel(*args, pad=pad).numpy()
    if impl == "dispatch":
        return paged_attention(*args, pad=pad, use_kernel=True).numpy()
    return paged_attention_reference(*args, pad=pad).numpy()


@pytest.mark.parametrize("impl", ["kernel", "dispatch", "reference"])
@pytest.mark.parametrize("C,H,hd,Hkv,P,M,N", DECODE_MATRIX)
def test_paged_decode_matches_pallas(impl, C, H, hd, Hkv, P, M, N):
    rng = np.random.default_rng(C * 100 + P + H)
    case = _decode_case(rng, C, H, hd, Hkv, P, M, N)
    # the port's reference twin against JAX's, the rest against Pallas
    jax_fn = jax_paged_ref if impl == "reference" else paged_attention_pallas
    want = np.asarray(jax_fn(*map(jnp.asarray, case)))
    np.testing.assert_allclose(_port_decode(impl, *case), want, **TOL)


@pytest.mark.parametrize("impl", ["kernel", "reference"])
def test_paged_decode_pad_masking(impl):
    rng = np.random.default_rng(7)
    case = _decode_case(rng, 4, 4, 64, 2, 8, 3, 9)
    pad = np.array([0, 3, 5, 1], np.int32)
    want = np.asarray(paged_attention_pallas(
        *map(jnp.asarray, case), jnp.asarray(pad)))
    got = _port_decode(impl, *case, pad=pad)
    np.testing.assert_allclose(got, want, **TOL)
    assert not np.allclose(_port_decode(impl, *case), got)


def test_paged_decode_scratch_block_poison_is_masked():
    """Table tails past a slot's length point at scratch block 0;
    poisoning it must not move any visible output."""
    rng = np.random.default_rng(11)
    q, pk, pv, tables, lengths = _decode_case(rng, 3, 4, 64, 2, 8, 4, 8)
    tables[0, 2:] = 0
    lengths[0] = 12
    outs = []
    for fill in (0.0, 1e9):
        k, v = pk.copy(), pv.copy()
        k[0], v[0] = fill, fill
        outs.append(_port_decode("kernel", q, k, v, tables, lengths))
        np.testing.assert_allclose(outs[-1][0], np.asarray(
            paged_attention_pallas(*map(jnp.asarray, (
                q, k, v, tables, lengths))))[0], **TOL)
    np.testing.assert_array_equal(outs[0][0], outs[1][0])


@pytest.mark.parametrize("impl", ["kernel", "reference"])
def test_paged_decode_fully_masked_slot_is_zero(impl):
    rng = np.random.default_rng(13)
    q, pk, pv, tables, lengths = _decode_case(rng, 2, 4, 64, 2, 8, 2, 5)
    lengths[0] = 1
    pad = np.array([5, 0], np.int32)  # pad > length on slot 0
    out = _port_decode(impl, q, pk, pv, tables, lengths, pad)
    assert np.all(out[0] == 0.0) and np.all(np.isfinite(out))


@pytest.mark.parametrize("length,pad,cache,ranges", [
    (4096, 0, 4096, 8),     # the 8B smoke's full slot: 8 runs of 8 tiles
    (1537, 0, 4096, 8),     # 25 tiles: runs of 3 and 4
    (33, 0, 4096, 8),       # one tile: seven empty runs
    (700, 130, 4096, 3),    # pad inside the first run's first tile
    (0, 0, 4096, 4),        # length 0: every run empty
    (50, 60, 4096, 4),      # pad past the length: every run empty
    (5000, 0, 320, 16),     # length past the table, more runs than tiles
])
def test_decode_ranges_cover_the_span(length, pad, cache, ranges):
    """The runs partition the span's tiles in range order, near-equal."""
    runs = decode_ranges(length, pad, cache, ranges)
    assert len(runs) == ranges
    hi = min(length, cache)
    want = (list(range(pad // DECODE_TILE, -(-hi // DECODE_TILE)))
            if hi > pad else [])
    assert [t for lo, end in runs for t in range(lo, end)] == want
    sizes = [end - lo for lo, end in runs]
    assert min(sizes) >= 0 and max(sizes) - min(sizes) <= 1


def _merge(parts):
    """`merge_partials`' arithmetic over (acc, m, l) partials, in order:
    an empty partial (m = -1e30, l = 0) weighs nothing."""
    mx = torch.stack([mp for _, mp, _ in parts]).amax(dim=0)
    acc = sum(torch.exp(mp - mx) * a for a, mp, _ in parts)
    l = sum(torch.exp(mp - mx) * lp for _, mp, lp in parts)
    return acc, mx, l


def _split_merge_decode(q, pk, pv, tables, lengths, pad, ranges, warps=4):
    """The decode kernel's walk in plain f32: each of the ``ranges`` blocks
    of a (slot, KV head) walks the run `decode_ranges` gives it, each of
    its ``warps`` warps the same 16-position quarter of every 64-position
    tile; an unnormalised partial (acc, m, l) per warp with masked scores
    at the -1e30 sentinel and their probabilities zeroed; the warps merged
    in order into the block's partial, the blocks in range order into the
    output (a row that saw nothing writes zeros)."""
    c, h, hd = q.shape
    _, p, hkv, _ = pk.shape
    m = tables.shape[1]
    idx = tables.long()
    k = pk[idx].reshape(c, m * p, hkv, hd)
    v = pv[idx].reshape(c, m * p, hkv, hd)
    s = torch.einsum("cgrd,ckgd->cgrk", q.reshape(c, hkv, h // hkv, hd),
                     k) * hd ** -0.5
    kv_pos = torch.arange(m * p)
    quarter = (kv_pos % DECODE_TILE) // (DECODE_TILE // warps)
    out = []
    for ci in range(c):
        visible = (kv_pos >= pad[ci]) & (kv_pos < lengths[ci])
        blocks = []
        for t_lo, t_hi in decode_ranges(int(lengths[ci]), int(pad[ci]),
                                        m * p, ranges):
            in_run = (kv_pos >= t_lo * DECODE_TILE) & (
                kv_pos < t_hi * DECODE_TILE)
            parts = []
            for w in range(warps):
                vis = visible & in_run & (quarter == w)
                s_w = s[ci].masked_fill(~vis, -1e30)
                mx = s_w.amax(dim=-1, keepdim=True)
                pr = torch.exp(s_w - mx) * vis
                parts.append((torch.einsum("grk,kgd->grd", pr, v[ci]), mx,
                              pr.sum(dim=-1, keepdim=True)))
            blocks.append(_merge(parts))
        acc, _, l = _merge(blocks)
        out.append(torch.where(l == 0, torch.zeros_like(acc),
                               acc / torch.where(l == 0, torch.ones_like(l),
                                                 l)))
    return torch.stack(out).reshape(c, h, hd)


@pytest.mark.parametrize("case", [
    "plan", "empty runs", "pad inside a run", "length 0",
    "more ranges than tiles"])
def test_decode_split_merge_matches_pallas(case):
    """Cutting each slot's visible span into the kernel's runs, each run
    into its warps' quarters, and merging the partials gives the Pallas
    kernel's output: at the plan's R, and at R that leaves runs empty
    (short slots, a slot of length 0, more runs than tiles)."""
    C, H, hd, Hkv, P, M, N = 4, 8, 64, 2, 16, 20, 45
    lengths, pad = [320, 150, 77, 5], [0, 0, 0, 0]
    ranges = decode_plan(C, Hkv, M * P, 132)
    if case == "plan":
        assert ranges == 5  # the table's five tiles
    elif case == "empty runs":
        ranges = 8
    elif case == "pad inside a run":
        lengths, pad, ranges = [320, 300, 200, 100], [7, 70, 130, 99], 3
    elif case == "length 0":
        lengths, ranges = [0, 64, 1, 320], 4
    elif case == "more ranges than tiles":
        lengths, ranges = [320, 40, 65, 128], 16
    rng = np.random.default_rng(19)
    q, pk, pv, tables, _ = _decode_case(rng, C, H, hd, Hkv, P, M, N)
    lengths, pad = np.array(lengths, np.int32), np.array(pad, np.int32)
    want = np.asarray(paged_attention_pallas(
        *map(jnp.asarray, (q, pk, pv, tables, lengths)), jnp.asarray(pad)))
    got = _split_merge_decode(_t(q), _t(pk), _t(pv), _t(tables), _t(lengths),
                              _t(pad), ranges).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    if case == "length 0":
        assert np.all(got[0] == 0.0)


# ---- paged prefill ---------------------------------------------------------


def _prefill_case(rng, B, CH, H, hd, Hkv, P, M, N):
    q = rng.standard_normal((B, CH, H, hd)).astype(np.float32)
    pk = rng.standard_normal((N, P, Hkv, hd)).astype(np.float32)
    pv = rng.standard_normal((N, P, Hkv, hd)).astype(np.float32)
    tables = rng.integers(1, N, (B, M)).astype(np.int32)
    return q, pk, pv, tables


PREFILL_MATRIX = [
    (2, 16, 4, 64, 2, 8, 4, 10, 8),    # GQA 2:1, mid-prompt chunk
    (1, 8, 8, 64, 8, 16, 2, 7, 0),     # MHA, 16-token blocks, chunk 0
    (3, 32, 4, 128, 1, 8, 5, 9, 4),    # MQA, lane-wide head dim
    (2, 12, 4, 64, 2, 8, 4, 9, 16),    # chunk 12: not a power of two
    (1, 16, 8, 128, 2, 16, 3, 6, 16),  # GQA 4:1, the 8B head layout
]


def _port_prefill(impl, q, pk, pv, tables, pos, pad=None):
    args = (_t(q), _t(pk), _t(pv), _t(tables), pos)
    pad = None if pad is None else _t(pad)
    if impl == "kernel":
        return paged_prefill_kernel(*args, pad=pad).numpy()
    if impl == "dispatch":
        return paged_prefill(*args, pad=pad, use_kernel=True).numpy()
    return paged_prefill_reference(*args, pad=pad).numpy()


@pytest.mark.parametrize("impl", ["kernel", "dispatch", "reference"])
@pytest.mark.parametrize("B,CH,H,hd,Hkv,P,M,N,pos", PREFILL_MATRIX)
def test_paged_prefill_matches_pallas(impl, B, CH, H, hd, Hkv, P, M, N,
                                      pos):
    rng = np.random.default_rng(B * 100 + CH + H)
    case = _prefill_case(rng, B, CH, H, hd, Hkv, P, M, N)
    jax_fn = jax_prefill_ref if impl == "reference" else paged_prefill_pallas
    want = np.asarray(jax_fn(*map(jnp.asarray, case), pos))
    np.testing.assert_allclose(_port_prefill(impl, *case, pos), want,
                               **TOL)


@pytest.mark.parametrize("impl", ["kernel", "reference"])
def test_paged_prefill_pad_masking(impl):
    rng = np.random.default_rng(7)
    case = _prefill_case(rng, 3, 16, 4, 64, 2, 8, 4, 9)
    pad = np.array([0, 5, 11], np.int32)
    want = np.asarray(paged_prefill_pallas(
        *map(jnp.asarray, case), 16, pad=jnp.asarray(pad)))
    got = _port_prefill(impl, *case, 16, pad)
    np.testing.assert_allclose(got, want, **TOL)
    assert not np.allclose(_port_prefill(impl, *case, 16), got)


def test_paged_prefill_scratch_block_poison_is_masked():
    rng = np.random.default_rng(11)
    q, pk, pv, tables = _prefill_case(rng, 2, 8, 4, 64, 2, 8, 4, 8)
    tables[:, 2:] = 0  # positions >= 16 are never visible at pos 8
    outs = []
    for fill in (0.0, 1e9):
        k, v = pk.copy(), pv.copy()
        k[0], v[0] = fill, fill
        outs.append(_port_prefill("kernel", q, k, v, tables, 8))
    np.testing.assert_array_equal(outs[0], outs[1])


@pytest.mark.parametrize("impl", ["kernel", "reference"])
def test_paged_prefill_pad_columns_emit_zeros(impl):
    """A row whose pad swallows the window, and pad-column queries
    (q_pos < pad), see nothing and emit zeros, not NaN."""
    rng = np.random.default_rng(13)
    q, pk, pv, tables = _prefill_case(rng, 2, 8, 4, 64, 2, 8, 2, 5)
    pad = np.array([4 + 8, 6], np.int32)
    out = _port_prefill(impl, q, pk, pv, tables, 4, pad)
    want = np.asarray(paged_prefill_pallas(
        *map(jnp.asarray, (q, pk, pv, tables)), 4, pad=jnp.asarray(pad)))
    np.testing.assert_allclose(out, want, **TOL)
    assert np.all(out[0] == 0.0) and np.all(out[1, :2] == 0.0)
    assert np.any(out[1, 2:] != 0.0) and np.all(np.isfinite(out))


@pytest.mark.parametrize("b,hkv,n_q_tiles,n_tiles,want", [
    (1, 8, 8, 64, (8, 8)),     # 8B serving chunk at pos 3968
    (1, 8, 8, 18, (9, 2)),     # at pos 1024
    (1, 8, 8, 2, (1, 2)),      # at pos 0: one range, no merge
    (2, 8, 8, 64, (5, 13)),    # B 2 at pos 3968
    (1, 1, 1, 1, (1, 1)),      # one tile
    (1, 1, 1, 3, (1, 3)),      # more splits wanted than tiles allow
    (3, 2, 2, 37, (13, 3)),    # ragged tail
])
def test_prefill_split_plan(b, hkv, n_q_tiles, n_tiles, want):
    n_split, tps = prefill_split_plan(b, hkv, n_q_tiles, n_tiles, 132)
    assert (n_split, tps) == want
    # the ranges cover every tile, and the last one is not empty
    assert n_split * tps >= n_tiles and (n_split - 1) * tps < n_tiles
    assert tps >= min(2, n_tiles)


def _split_merge_prefill(q, pk, pv, tables, pos, pad, n_split, span):
    """The prefill kernel's split walk in plain f32: one unnormalised
    partial (acc, m, l) per query row and range of ``span`` positions,
    masked scores at the -1e30 sentinel and their probabilities zeroed,
    then `merge_partials`' arithmetic (an empty range weighs nothing, a
    row that saw nothing writes zeros)."""
    b, ch, h, hd = q.shape
    _, p, hkv, _ = pk.shape
    m = tables.shape[1]
    idx = tables.long()
    k = pk[idx].reshape(b, m * p, hkv, hd)
    v = pv[idx].reshape(b, m * p, hkv, hd)
    qg = q.reshape(b, ch, hkv, h // hkv, hd)
    s = torch.einsum("bjgrd,bkgd->bgrjk", qg, k) * hd ** -0.5
    kv_pos = torch.arange(m * p)[None, None, :]
    visible = (kv_pos <= (pos + torch.arange(ch))[None, :, None]) & (
        kv_pos >= pad[:, None, None])
    parts = []
    for sp in range(n_split):
        vis = (visible & (kv_pos >= sp * span)
               & (kv_pos < (sp + 1) * span))[:, None, None]
        s_sp = s.masked_fill(~vis, -1e30)
        mx = s_sp.amax(dim=-1, keepdim=True)
        pr = torch.exp(s_sp - mx) * vis
        parts.append((torch.einsum("bgrjk,bkgd->bgrjd", pr, v), mx,
                      pr.sum(dim=-1, keepdim=True)))
    mx = torch.stack([mp for _, mp, _ in parts]).amax(dim=0)
    acc = sum(torch.exp(mp - mx) * a for a, mp, _ in parts)
    l = sum(torch.exp(mp - mx) * lp for _, mp, lp in parts)
    o = torch.where(l == 0, torch.zeros_like(acc),
                    acc / torch.where(l == 0, torch.ones_like(l), l))
    return o.permute(0, 3, 1, 2, 4).reshape(b, ch, h, hd)


@pytest.mark.parametrize("case", [
    "plan", "one range", "more ranges than positions", "pad covers ranges",
    "pad inside a range"])
def test_prefill_split_merge_matches_pallas(case):
    """Splitting the walk and merging the partials gives the Pallas
    kernel's output: at the kernel's own 64-position tiles and split plan,
    and at shorter ranges that leave whole ranges empty (past the table
    or under the pad)."""
    B, CH, H, hd, Hkv, P, M, N, pos = 2, 16, 8, 64, 2, 16, 20, 45, 250
    pad = np.zeros(B, np.int32)
    n_split, span = 1, M * P
    if case == "plan":
        _, n_split, tps = prefill_launch_plan(B, CH, H, Hkv, M * P, pos, 132)
        span = tps * PREFILL_TILE
        assert n_split > 1
    elif case == "more ranges than positions":
        n_split, span = 12, 32  # ranges 10-11 lie past the table's 320
    elif case == "pad covers ranges":
        n_split, span, pad[:] = 9, 32, (0, 100)  # row 1: ranges 0-2 empty
    elif case == "pad inside a range":
        n_split, span, pad[:] = 6, 48, (7, 60)
    rng = np.random.default_rng(17)
    q, pk, pv, tables = _prefill_case(rng, B, CH, H, hd, Hkv, P, M, N)
    want = np.asarray(paged_prefill_pallas(
        *map(jnp.asarray, (q, pk, pv, tables)), pos, pad=jnp.asarray(pad)))
    got = _split_merge_prefill(_t(q), _t(pk), _t(pv), _t(tables), pos,
                               _t(pad), n_split, span).numpy()
    np.testing.assert_allclose(got, want, **TOL)


# ---- dense SDPA, RMSNorm, RoPE, precision ----------------------------------


@pytest.mark.parametrize("H,Hkv", [(4, 4), (8, 2)])
def test_dot_product_attention_masked_matches_jax(H, Hkv):
    rng = np.random.default_rng(H)
    B, S, K, D = 2, 5, 9, 16
    q = rng.standard_normal((B, S, H, D)).astype(np.float32)
    k = rng.standard_normal((B, K, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, K, Hkv, D)).astype(np.float32)
    mask = rng.random((B, 1, S, K)) < 0.6
    mask[0, 0, 0] = False  # a fully masked row -> zeros on both
    want = np.asarray(jax_sdpa(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), causal=False,
                               mask=jnp.asarray(mask)))
    got = dot_product_attention(_t(q), _t(k), _t(v), causal=False,
                                mask=_t(mask)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    assert np.all(got[0, 0] == 0.0)


@pytest.mark.parametrize("shape", [(4, 64), (2, 3, 128), (128, 256)])
def test_rms_norm_matches_pallas(shape):
    rng = np.random.default_rng(len(shape))
    x = rng.standard_normal(shape).astype(np.float32)
    w = rng.standard_normal(shape[-1]).astype(np.float32)
    want = np.asarray(rms_norm_pallas(jnp.asarray(x), jnp.asarray(w)))
    launches = rms_norm_kernel.launches
    np.testing.assert_allclose(rms_norm(_t(x), _t(w)).numpy(), want, **TOL)
    assert rms_norm_kernel.launches == launches  # CPU: plain version


def test_rope_matches_jax_with_positions_and_pad():
    rng = np.random.default_rng(3)
    B, S, H, D, S_max = 3, 6, 2, 64, 64
    x = rng.standard_normal((B, S, H, D)).astype(np.float32)
    pos, pad = 10, np.array([0, 4, 12], np.int64)
    positions = np.maximum(pos + np.arange(S)[None, :] - pad[:, None], 0)
    jc, js = jax_rope_frequencies(D, S_max)
    want = np.asarray(jax_apply_rope(jnp.asarray(x), jc, js,
                                     positions=jnp.asarray(positions)))
    c, s = rope_frequencies(D, S_max)
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), **TOL)
    got = apply_rope(_t(x), c, s, positions=_t(positions)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    # default positions = arange(S)
    want0 = np.asarray(jax_apply_rope(jnp.asarray(x), jc, js))
    np.testing.assert_allclose(apply_rope(_t(x), c, s).numpy(), want0,
                               **TOL)


def test_linear_f32_out_keeps_f32():
    rng = np.random.default_rng(5)
    x = _t(rng.standard_normal((2, 3, 8)).astype(np.float32))
    w = _t(rng.standard_normal((5, 8)).astype(np.float32))
    out = linear_f32_out(x, w)
    assert out.dtype == torch.float32 and out.shape == (2, 3, 5)
    np.testing.assert_allclose(out.numpy(), (x @ w.T).numpy(), **TOL)


# ---- dispatch, gates, launch counters --------------------------------------


def test_dispatch_policy_is_device_and_context():
    cpu = torch.zeros(1)
    assert not dispatch.use_kernel(cpu)
    assert not dispatch.use_kernel("cpu")
    assert dispatch.use_kernel(torch.device("cuda"))
    with dispatch.force_reference():
        assert not dispatch.use_kernel(torch.device("cuda"))
        with dispatch.force_kernel():
            assert dispatch.use_kernel(torch.device("cuda"))
    q_shape, pool_shape = (4, 32, 128), (65, 16, 8, 128)
    assert paged_attention_uses_kernel(q_shape, pool_shape, device="cuda")
    assert not paged_attention_uses_kernel(q_shape, pool_shape,
                                           device="cpu")
    assert paged_attention_uses_kernel(q_shape, pool_shape, True)
    assert not paged_attention_uses_kernel(q_shape, pool_shape, False,
                                           device="cuda")
    with dispatch.force_reference():
        assert not paged_prefill_uses_kernel((1, 128, 32, 128), pool_shape,
                                             device="cuda")
    # off the card the shape gate wins over an explicit request
    assert not paged_attention_uses_kernel((4, 4, 16), (9, 8, 2, 16), True)
    assert not paged_attention_uses_kernel((4, 4, 16), (9, 8, 2, 16), True,
                                           device="cpu")


@pytest.mark.parametrize("use_kernel", [None, True])
@pytest.mark.parametrize("kind", ["decode", "prefill"])
def test_refused_shape_on_cuda_raises(kind, use_kernel):
    """On the card a kernel that is wanted but refuses the shapes raises;
    the reference runs there only when it is asked for."""
    pool_shape = (9, 8, 2, 16)  # hd 16: no Hopper kernel takes it
    if kind == "decode":
        pred, q_shape = paged_attention_uses_kernel, (4, 4, 16)
    else:
        pred, q_shape = paged_prefill_uses_kernel, (1, 8, 4, 16)
    with pytest.raises(ValueError, match="does not take shapes"):
        pred(q_shape, pool_shape, use_kernel, device="cuda")
    assert not pred(q_shape, pool_shape, False, device="cuda")
    with dispatch.force_reference():
        assert not pred(q_shape, pool_shape, device="cuda")


@pytest.mark.parametrize("q_shape,pool_shape,decode_ok,prefill_ok", [
    ((4, 32, 128), (1025, 16, 8, 128), True, True),    # llama3-8b
    ((4, 2, 64), (9, 8, 1, 64), True, True),           # kernel-tiling tiny
    ((4, 4, 16), (9, 8, 2, 16), False, False),         # hd 16
    ((4, 8, 64), (9, 12, 2, 64), True, True),          # P = 12
    ((4, 3, 64), (9, 8, 2, 64), False, False),         # ragged GQA
    ((4, 32, 64), (9, 8, 1, 64), False, True),         # n_rep 32
    ((4, 16, 64), (9, 8, 1, 64), True, True),          # n_rep 16
    ((4, 128, 64), (9, 8, 1, 64), False, False),       # n_rep 128
    ((4, 8, 64), (9, 8, 2, 128), False, False),        # hd mismatch
])
def test_hopper_shape_gates(q_shape, pool_shape, decode_ok, prefill_ok):
    assert paged_shapes_supported(q_shape, pool_shape) == decode_ok
    c, h, hd = q_shape
    assert paged_prefill_shapes_supported(
        (1, 128, h, hd), pool_shape) == prefill_ok


def test_kernel_tiling_plans():
    # 8B decode: 4 slots x 8 KV heads over 4096 positions on 132 SMs
    assert decode_plan(4, 8, 4096, 132) == 8
    assert decode_plan(1, 1, 48, 132) == 1  # one tile
    r = decode_plan(3, 2, 37 * 16, 132)
    assert r == min(8, -(-37 * 16 // DECODE_TILE))
    assert q_tile(128, 4) == 16 and q_tile(4, 1) == 4 and q_tile(64, 32) == 2


def test_kernel_wrappers_validate_and_count_only_launches():
    """On CPU tensors the wrappers run their plain versions and count no
    launch; the checks a CUDA launch runs first refuse what the kernels
    do not take; with no nvcc the build raises instead of falling back."""
    from ray_lightning_tpu_torch.ops import build
    from ray_lightning_tpu_torch.ops.kernels import paged_attention as pa
    from ray_lightning_tpu_torch.ops.kernels import paged_prefill as pp

    rng = np.random.default_rng(29)
    q, pk, pv, tables, lengths = map(_t, _decode_case(rng, 2, 4, 64, 2, 8,
                                                     2, 5))
    before = (paged_attention_kernel.launches, paged_prefill_kernel.launches)
    paged_attention_kernel(q, pk, pv, tables, lengths)
    paged_prefill_kernel(q[:, None], pk, pv, tables, 0)
    assert (paged_attention_kernel.launches,
            paged_prefill_kernel.launches) == before
    pad = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="bfloat16"):
        pa._check_cuda(q, pk, pv, tables, lengths, pad)
    bf = [t.to(torch.bfloat16) for t in (q, pk, pv)]
    pa._check_cuda(*bf, tables, lengths, pad)
    with pytest.raises(ValueError, match="int32"):
        pa._check_cuda(*bf, tables.long(), lengths, pad)
    with pytest.raises(ValueError, match="contiguous"):
        pp._check_cuda(torch.zeros(2, 4, 2, 64, dtype=torch.bfloat16)
                       .transpose(1, 2), *bf[1:], tables, pad)
    with pytest.raises(ValueError, match="unsupported shapes"):
        pp._check_cuda(bf[0][:, None], *bf[1:], tables[:1], pad)
    if build.shutil.which("nvcc") is None and not os.path.exists(
            "/usr/local/cuda/bin/nvcc"):
        with pytest.raises(RuntimeError, match="nvcc"):
            build.build_all(["paged_attention"])


@pytest.mark.parametrize("x_dtype,w_dtype,d,error", [
    (torch.bfloat16, torch.bfloat16, 4096, None),   # serving gains
    (torch.bfloat16, torch.float32, 4096, None),    # f32 masters
    (torch.float16, torch.float16, 4096, None),
    (torch.float16, torch.float32, 4097, None),     # a D with a scalar tail
    (torch.float32, torch.float32, 100, None),
    (torch.bfloat16, torch.float16, 4096, "weight dtype"),
    (torch.float32, torch.bfloat16, 4096, "weight dtype"),
    (torch.int32, torch.float32, 4096, "unsupported dtype"),
])
def test_rms_norm_wrapper_validates_dtypes(x_dtype, w_dtype, d, error):
    """What `rms_norm_kernel` checks before it launches, on CPU tensors:
    x bf16, f16 or f32, the gain in x's dtype or f32, any D."""
    x = torch.ones(3, d, dtype=x_dtype)
    w = torch.ones(d, dtype=w_dtype)
    if error is None:
        rms_mod._check_cuda(x, w)
    else:
        with pytest.raises(ValueError, match=error):
            rms_mod._check_cuda(x, w)


@pytest.mark.parametrize("case", ["D", "contiguity", "device"])
def test_rms_norm_wrapper_refuses_layouts(case):
    x = torch.ones(4, 64, dtype=torch.bfloat16)
    w = torch.ones(64, dtype=torch.float32)
    if case == "D":
        w, match = torch.ones(63), "does not match"
    elif case == "contiguity":
        x, match = torch.ones(64, 4, dtype=torch.bfloat16).t(), "contiguous"
    else:
        w, match = torch.ones(64, device="meta"), "does not match"
    with pytest.raises(ValueError, match=match):
        rms_mod._check_cuda(x, w)
    before = rms_norm_kernel.launches
    rms_norm_kernel(torch.ones(4, 64), torch.ones(64))  # CPU: plain
    assert rms_norm_kernel.launches == before


# ---- the import rule -------------------------------------------------------


def _port_sources():
    root = os.path.join(REPO, "ray_lightning_tpu_torch")
    for d, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)
    yield os.path.join(REPO, "chip_smoke.py")
    yield os.path.join(REPO, "chip_faults.py")
    yield os.path.join(REPO, "chip_variants.py")
    yield os.path.join(REPO, "scripts", "flash_truth.py")
    yield os.path.join(REPO, "scripts", "first_launch.py")
    yield os.path.join(REPO, "scripts", "ckpt_save_threads.py")
    # the jobs the tests ship to workers
    yield os.path.join(REPO, "tests", "torch_jobs.py")
    yield os.path.join(REPO, "tests", "torch_axis_jobs.py")


def test_port_imports_no_jax():
    banned = ("jax", "jaxlib", "flax", "optax", "ray_lightning_tpu")
    bad = []
    sources = list(_port_sources())
    assert len(sources) > 15
    for path in sources:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            bad += [f"{path}: {n}" for n in names
                    if n.split(".")[0] in banned]
    assert not bad, bad
