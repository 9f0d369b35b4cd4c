"""The port's cost model (`ray_lightning_tpu_torch/analysis/costmodel.py`)
against the JAX package's, fed the same inputs: the ring and hierarchical
algebra on `Topology` objects built from the same field values, the width
table, the paged traffic bytes and `check_permutation`'s verdicts; the
H100 families; and each ``rltt`` operator's Meta shapes against its plain
version's outputs, with its FLOPs as `FlopCounterMode` counts them."""
import math

import numpy as np
import pytest
import torch

from ray_lightning_tpu.analysis import costmodel as jcm
from ray_lightning_tpu.analysis import tracecheck as jtc
from ray_lightning_tpu.ops.pipeline import pipeline_perm as jpipeline_perm
from ray_lightning_tpu.ops.ring_attention import ring_perm as jring_perm
from ray_lightning_tpu_torch.analysis import costmodel as cm
from ray_lightning_tpu_torch.analysis import tracecheck as tc
from ray_lightning_tpu_torch.ops.pipeline import pipeline_perm
from ray_lightning_tpu_torch.ops.ring_attention import ring_perm

FIELDS = dict(name="x", device_kind="NVIDIA H100 80GB HBM3", n_devices=16,
              ici_gbps=450.0, ici_hop_latency_us=1.0, hbm_bytes=79 * 2**30,
              peak_tflops=989.0, n_slices=2, dcn_gbps=50.0,
              dcn_hop_latency_us=5.0)


@pytest.mark.parametrize("kind", ["psum", "all_gather", "reduce_scatter",
                                  "ppermute", "all_to_all"])
@pytest.mark.parametrize("axes,dcn", [({"fsdp": 8}, 1), ({"fsdp": 16}, 2),
                                      ({"data": 2, "fsdp": 8}, 2),
                                      ({"fsdp": 6}, 4), ({"data": 1}, 1)])
def test_collective_cost_equals_jax(kind, axes, dcn):
    """The ring and two-tier algebra, case for case: the same Topology
    fields, the same (kind, payload, group, node span)."""
    mine = cm.Topology(**FIELDS)
    theirs = jcm.Topology(**FIELDS)
    for payload in (0, 1, 1024**2, 3 * 10**9 + 7):
        a = cm.collective_cost(kind, payload, axes, mine, dcn_group=dcn)
        b = jcm.collective_cost(kind, payload, axes, theirs, dcn_group=dcn)
        assert (a.wire_bytes, a.dcn_bytes) == (b.wire_bytes, b.dcn_bytes)
        assert a.time_us == pytest.approx(b.time_us, rel=1e-12)
        assert a.dcn_time_us == pytest.approx(b.dcn_time_us, rel=1e-12)
    # the port's all-reduce name prices as JAX's psum
    if kind == "psum":
        got = cm.collective_cost("all_reduce", 4096, axes, mine,
                                 dcn_group=dcn)
        want = jcm.collective_cost("psum", 4096, axes, theirs,
                                   dcn_group=dcn)
        assert got == cm.CollectiveCost(want.wire_bytes, want.time_us,
                                        want.dcn_bytes, want.dcn_time_us)


def test_h100_families():
    one = cm.parse_topology("h100-8")
    assert (one.n_devices, one.n_slices, one.device_kind) == (
        8, 1, "NVIDIA H100 80GB HBM3")
    from ray_lightning_tpu_torch.parallel.plan import (
        H100_KIND,
        hbm_bytes_for_kind,
    )

    assert cm.H100_KIND == H100_KIND
    assert one.hbm_bytes == hbm_bytes_for_kind(H100_KIND)
    assert one.peak_tflops == 989.0 and one.ici_gbps == 450.0
    two = cm.parse_topology("2xh100-8")
    assert (two.n_devices, two.n_slices, two.devices_per_slice) == (16, 2, 8)
    assert two.dcn_gbps == 50.0 and "InfiniBand" in two.describe()
    with pytest.raises(ValueError, match="at most 8"):
        cm.parse_topology("h100-16")
    with pytest.raises(ValueError, match="unknown topology family"):
        cm.parse_topology("v5p-8")
    cpu = cm.parse_topology("cpu-4", hbm_bytes=1024)
    assert cpu.hbm_bytes == 1024 and cpu.n_devices == 4
    odd = cm.topology_for_kind("research-chip-x1", 4)
    assert odd.ici_gbps == cm.ICI_SPECS["cpu"][1]
    assert cm.MATMUL_EFFICIENCY == pytest.approx(820.6 / 989.0)


def test_widths_and_traffic_equal_jax():
    assert cm.DTYPE_WIDTHS == jcm.DTYPE_WIDTHS
    for dt in (torch.bfloat16, torch.float32, torch.int8, "float16",
               np.dtype("int64")):
        assert cm.dtype_width(dt) == jcm.dtype_width(
            str(dt).replace("torch.", ""))
    for fused in (True, False):
        assert cm.paged_decode_traffic_bytes(1000, 300, fused) == \
            jcm.paged_decode_traffic_bytes(1000, 300, fused)
        assert cm.paged_prefill_traffic_bytes(1000, 300, fused) == \
            jcm.paged_prefill_traffic_bytes(1000, 300, fused)
    # RLT105 and RLT804 read the one table
    from ray_lightning_tpu_torch.analysis import numcheck, plan_checker

    assert plan_checker.dtype_width is cm.dtype_width
    assert numcheck.dtype_width is cm.dtype_width


PERMS = [
    ([], 4), ([(0, 1), (1, 0), (2, 3), (3, 2)], 4), ([(0, 1), (2, 1)], 4),
    ([(0, 1), (0, 2)], 4), ([(0, 9)], 4), ([(0, 1), (1, 2), (2, 0)], 3),
    ([(0, 1), (1, 2)], 4), ([(i, (i + 2) % 6) for i in range(6)], 6),
]


@pytest.mark.parametrize("perm,n", PERMS)
def test_check_permutation_verdicts_equal_jax(perm, n):
    mine = tc.check_permutation(perm, n)
    theirs = jtc.check_permutation(perm, n)
    assert [f.rule for f in mine] == [f.rule for f in theirs]
    for a, b in zip(mine, theirs):
        for key in ("duplicate source", "duplicate destination",
                    "outside the axis", "disjoint cycles"):
            assert (key in a.message) == (key in b.message)


def test_canonical_shift_schedules_are_clean():
    for n in (2, 4, 8):
        assert ring_perm(n) == [tuple(p) for p in jring_perm(n)]
        assert tc.check_permutation(ring_perm(n), n) == []
        assert tc.check_permutation(pipeline_perm(n), n) == []
        assert pipeline_perm(n) == [tuple(p) for p in jpipeline_perm(n)]
    # one trace a stage: stage 0 sends twice, stage 1 receives once
    sends = {0: [("act", 1), ("act", 1)], 1: []}
    recvs = {0: [], 1: [("act", 0)]}
    assert [f.rule for f in tc.check_shift_schedule(sends, recvs)] == [
        "RLT303"]
    recvs[1].append(("act", 0))
    assert tc.check_shift_schedule(sends, recvs) == []


# ---- the rltt operators: Meta shapes, FLOPs ------------------------------


def _randn(*shape, dtype=torch.float32):
    g = torch.Generator().manual_seed(math.prod(shape))
    return torch.randn(shape, generator=g).to(dtype)


def _op_cases():
    from ray_lightning_tpu_torch.ops.kernels import flash as F
    from ray_lightning_tpu_torch.ops.kernels import paged_attention as PA
    from ray_lightning_tpu_torch.ops.kernels import paged_prefill as PP
    from ray_lightning_tpu_torch.ops.kernels import rmsnorm as R

    q, k, v = _randn(2, 16, 4, 64), _randn(2, 16, 2, 64), _randn(2, 16, 2,
                                                                  64)
    o, lse = F.flash_fwd_plain(q, k, v, True, 0, 0.125)
    do = _randn(2, 16, 4, 64)
    delta = F.flash_delta(o, do)
    pool = _randn(9, 8, 2, 64)
    tables = torch.arange(8, dtype=torch.int32).reshape(2, 4) + 1
    lengths = torch.tensor([20, 7], dtype=torch.int32)
    return {
        "flash_fwd": (F.flash_fwd_op, F.flash_fwd_plain,
                      (q, k, v, True, 0, 0.125)),
        "flash_bwd_dkv": (F.flash_bwd_dkv_op, F.flash_bwd_dkv_plain,
                          (q, k, v, do, lse, delta, True, 0, 0.125)),
        "flash_bwd_dq": (F.flash_bwd_dq_op, F.flash_bwd_dq_plain,
                         (q, k, v, do, lse, delta, True, 0, 0.125)),
        "rms_norm": (R.rms_norm_op, R.rms_norm_plain,
                     (_randn(3, 64, dtype=torch.bfloat16), _randn(64),
                      1e-5)),
        "paged_decode": (PA.paged_attention_op, PA.paged_attention_plain,
                         (_randn(2, 4, 64), pool, pool, tables, lengths)),
        "paged_prefill": (PP.paged_prefill_op, PP.paged_prefill_plain,
                          (_randn(2, 8, 4, 64), pool, pool, tables, 4)),
    }


def _meta(x):
    if isinstance(x, torch.Tensor):
        return x.to("meta")
    return x


@pytest.mark.parametrize("name", ["flash_fwd", "flash_bwd_dkv",
                                  "flash_bwd_dq", "rms_norm",
                                  "paged_decode", "paged_prefill"])
def test_operator_meta_shapes_and_cpu_values(name):
    """On the meta device each operator returns its plain version's
    output shapes and dtypes; on CPU tensors it IS its plain version (the
    wrapper's CPU path), bitwise, and counts no launch."""
    op, plain, args = _op_cases()[name]
    want = plain(*args)
    got = op(*args)
    meta = op(*[_meta(a) for a in args])
    want_t = want if isinstance(want, tuple) else (want,)
    for t, g, m in zip(want_t, got if isinstance(got, tuple) else (got,),
                       meta if isinstance(meta, tuple) else (meta,)):
        assert torch.equal(g, t)
        assert (m.device.type, m.shape, m.dtype) == ("meta", t.shape,
                                                      t.dtype)
    from ray_lightning_tpu_torch.ops.kernels import launch_counts

    assert not any(launch_counts().values())


def test_adamw_operator_updates_in_place_as_the_plain_step():
    from ray_lightning_tpu_torch.ops.kernels import adamw as A

    def state():
        shapes = [(8, 4), (4,)]
        return ([_randn(*s) for s in shapes], [_randn(*s) * 0.1
                                                for s in shapes],
                [_randn(*s, dtype=torch.bfloat16) * 0.01 for s in shapes],
                [_randn(*s).abs() * 1e-3 for s in shapes],
                [torch.full((), 2.0) for _ in shapes])

    a, b = state(), state()
    A.adamw_step_plain(*a, torch.tensor(1e-3), None, 0.9, 0.95, 1e-8, 0.1)
    A.adamw_step_op(*b, torch.tensor(1e-3), None, 0.9, 0.95, 1e-8, 0.1)
    for xs, ys in zip(a, b):
        assert all(torch.equal(x, y) for x, y in zip(xs, ys))
    meta = [[t.to("meta") for t in col] for col in state()]
    A.adamw_step_op(*meta, torch.tensor(1e-3, device="meta"), None, 0.9,
                    0.95, 1e-8, 0.1)  # Meta: shapes only, no update


def test_flash_flops_count_as_sdpa():
    """`FlopCounterMode` counts ``rltt::flash_fwd`` as it counts SDPA's
    forward, halved for causal; the backward's two passes sum to SDPA's
    backward."""
    from torch.utils.flop_counter import FlopCounterMode

    from ray_lightning_tpu_torch.ops.kernels import flash as F

    cm._register_flop_formulas()
    q = torch.randn(2, 16, 4, 64, device="meta")
    k = torch.randn(2, 16, 4, 64, device="meta")
    counts = {}
    for causal in (False, True):
        with FlopCounterMode(display=False) as fc:
            F.flash_fwd_op(q, k, k, causal, 0, 0.125)
        counts[causal] = fc.get_total_flops()
    with FlopCounterMode(display=False) as fc:
        torch.nn.functional.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), k.transpose(1, 2))
    assert counts[False] == fc.get_total_flops() == 2 * counts[True]
    lse = torch.randn(2, 4, 16, device="meta")
    bwd = (q, k, k, q, lse, lse, False, 0, 0.125)
    with FlopCounterMode(display=False) as fc:
        F.flash_bwd_dkv_op(*bwd)
        F.flash_bwd_dq_op(*bwd)
    qr, kr, vr = (t.transpose(1, 2).clone().requires_grad_()
                  for t in (q, k, k))
    with FlopCounterMode(display=False) as ref:
        torch.nn.functional.scaled_dot_product_attention(
            qr, kr, vr).sum().backward()
    assert fc.get_total_flops() == ref.get_total_flops() - counts[False]
