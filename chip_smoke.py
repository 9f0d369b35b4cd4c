#!/usr/bin/env python3
"""Drive the PyTorch port (`ray_lightning_tpu_torch`) on one CUDA card.

Phases, each of which raises (and so exits nonzero) on failure:

  1. device  — a CUDA card is required; prints ``nvidia-smi``'s name and
               power limit.
  2. build   — compiles the five CUDA sources of ``ops/csrc`` (one nvcc
               per source, all at once), timed.
  3. kernels — each kernel's wrapper on card tensors at the serving and
               training shapes of Llama-3-8B, in bf16, against its plain
               PyTorch version on the same inputs, plus the masking edge
               cases (for the decode: pads, a slot that sees nothing, a
               poisoned scratch block, two calls that must be bitwise
               equal, one CUDA launch a call; for the prefill: two-row
               chunks whose pad covers whole ranges of its split walk or
               falls inside one, pad columns, a poisoned scratch block);
               the flash forward (O, lse) and both backward passes (dQ;
               dK, dV) at the training shape causal and full, a query
               shard at an offset, MHA, a short sequence, head dim 64,
               and queries that see no key (held to exact zeros);
               RMSNorm at N 4, 128 and 4096, with f32 and bf16 gains and
               at a D with a scalar tail; the RMSNorm gradient. One JSON
               line per timed shape with the kernel's, the plain
               version's and one library call's time (and, for flash,
               the two backward kernels' together), the least time the
               card could take, the max error and the worst share of the
               tolerance used; for the decode and RMSNorm also the host
               microseconds of one wrapper call. Then, untimed, every
               other shape the kernels' gates admit that the serving and
               training shapes do not cover (decode and prefill: hd 64,
               other GQA ratios, block sizes 5 / 24 / 32, lengths 0 and
               1, a ragged chunk; flash: ragged lengths 1000 / 65 / 1
               causal, full and at an offset, B 1, n_rep 2).
  4. serve   — Llama-3-8B at full width (random weights from a seeded
               generator) served by `Scheduler` + `DecodeEngine` through
               the kernel lanes: 8 requests, prompts of 200-1500 tokens,
               32 new tokens each, half greedy and half sampled. Every
               kernel's launch counter is zeroed just before and read
               just after, and must match the count the run implies. The
               greedy half is then served again through the reference
               lanes on the same weights, teacher-forced along the kernel
               lanes' tokens, and the logits of every step are compared.
  5. train   — Llama-3-8B at full width, 4 layers, seq 2048, batch 2
               (random f32 master weights from a seed): 8 AdamW steps
               through `Trainer.fit` with `SingleDevice`, fused CE, block
               remat. The launch counters are zeroed before and read
               after, and must match the counts the run implies; the loss
               must fall. The same 8 steps are then run from the same
               weights through the reference lanes
               (`dispatch.force_reference`), which must launch no kernel,
               and loss and grad_norm are compared at every step.
               Last, the kernel-lanes fit runs once more with its last
               steps under `torch.profiler`.

The line before the last is the kernels' JSON summary; the last line is
``{"ok": true, "device": {...}}``. Run from the repository root:
``python3 chip_smoke.py`` (``--layers N`` cuts the model's depth for a
quicker check of the serve phase). Two other modes build the kernels and
then only measure: ``--train-spread N`` runs phase 5's lane comparison at
seeds 0..N-1 (the spread the train limits are set from), and ``--ab-old
CSRC`` times the decode and RMSNorm (and, as a control on the turns,
the dQ and prefill) in turns with a build of older sources.
``chip_faults.py`` plants known faults in the kernels and runs these same
checks on them; ``chip_variants.py`` times variants of the decode and
RMSNorm sources.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import statistics
import subprocess
import sys
import time

import torch

#: H100 SXM peaks (NVIDIA data sheet) for the least-time bound
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12
#: kernel vs plain version, both bf16 out, held elementwise to
#:   |a - b| <= ATOL_RMS * rms(b's row) + RTOL * |b|
#: where a row is one output vector (hd or D values). The absolute term
#: scales with what is compared: at a 4096-token cache the attention
#: outputs are about 0.026 in size (a softmax over ~n/e keys averages
#: unit-variance values), where a fixed 2e-2 would pass a kernel that
#: adds or drops keys. A sound kernel differs from the plain version by
#: the bf16 rounding of its unnormalised probabilities (taken against a
#: running max, not the row's) and of its output: at 1e-2 * rms its
#: worst element used 0.86 of the allowance, and the faults that
#: chip_faults.py plants use 7 or more of it (PERF.md).
RTOL = 2e-2
ATOL_RMS = 2e-2
#: kernel lanes vs reference lanes at full depth, on the f32 logits of
#: every greedy step (the reference lanes are teacher-forced along the
#: kernel lanes' tokens, so every step is compared). The reference rounds
#: the normalised softmax probabilities to bf16 before the PV product and
#: the kernels round the unnormalised ones; that difference compounds
#: over 32 layers. Bound on max |delta logit| per step, and on the
#: reference's margin for its own argmax over the kernel lanes' token
#: where the two differ. About 1.5x the largest reading of a sound run,
#: 0.105 (PERF.md).
LOGIT_TOL = 0.16
#: flash lse (f32 from identical f32 scores in both versions) is also
#: held to this absolute bound; the two differ by summation order only
LSE_ATOL = 1e-3
#: kernel lanes vs reference lanes in training: per-step bound on
#: |delta loss| and on |delta grad_norm| / grad_norm. The lanes differ in
#: attention (the kernels round unnormalised probabilities and dS to bf16
#: inside tiled sums, the reference its normalised probabilities) and in
#: RMSNorm (kernel vs plain forward). About 1.5x the largest reading of
#: sound kernels over eight weight-and-data seeds (``--train-spread 8``),
#: 1.36e-3 and 8.0e-3 (PERF.md); the planted faults read 9e-3 and 2.7% or
#: more.
TRAIN_LOSS_TOL = 2.1e-3
TRAIN_GNORM_RTOL = 1.2e-2
#: seeds every random input: weights, prompts, tokens, kernel-check tensors
SEED = 0

#: Llama-3-8B's serving shapes: slots, heads, KV heads, head dim, block
#: size, blocks per slot, model width, prefill chunk
C, H, HKV, HD, P, M, D, CH = 4, 32, 8, 128, 16, 256, 4096, 128
#: ragged decode lengths (slot 0 fills its whole table) and the prefill
#: chunk offsets the kernels are checked at
DECODE_LENGTHS = (4096, 1537, 700, 33)
PREFILL_POS = (0, 1024, 3968)
#: two-row prefill chunks (pos, pads): at 3968 row 1's pad covers the
#: first ranges of the split walk whole (they merge as empty partials);
#: at 1024 it falls inside a range
PREFILL_PADS = ((3968, (0, 2100)), (1024, (0, 700)))
#: decode shapes the gate admits beyond the serving one, checked untimed:
#: name -> (H, Hkv, hd, P, M, lengths, pads); each table holds 4096
#: positions or, at P 5, 4100
DECODE_OWED = {
    "hd 64": (H, HKV, 64, P, M, DECODE_LENGTHS, (0, 100, 17, 3)),
    "n_rep 1": (HKV, HKV, HD, P, M, DECODE_LENGTHS, (0, 0, 0, 0)),
    "n_rep 2": (2 * HKV, HKV, HD, P, M, DECODE_LENGTHS, (0, 0, 0, 0)),
    "n_rep 8": (8 * HKV, HKV, HD, P, M, DECODE_LENGTHS, (0, 0, 0, 0)),
    "n_rep 16": (H, 2, HD, P, M, DECODE_LENGTHS, (0, 0, 0, 0)),
    "P 5": (H, HKV, HD, 5, 820, (4100, 1537, 700, 33), (0, 0, 9, 0)),
    "P 32": (H, HKV, HD, 32, 128, DECODE_LENGTHS, (0, 0, 0, 0)),
    "length 1": (H, HKV, HD, P, M, (1, 4096, 2, 1), (0, 4095, 1, 0)),
    "length 0": (H, HKV, HD, P, M, (0, 1537, 0, 33), (0, 0, 0, 0)),
}
#: prefill shapes beyond the serving one, checked untimed: name -> (CH,
#: H, Hkv, hd, P, M, pos, one pad per row)
PREFILL_OWED = {
    "hd 64": (CH, H, HKV, 64, P, M, 1000, (0,)),
    "n_rep 1": (CH, HKV, HKV, HD, P, M, 1000, (0,)),
    "H 24 / Hkv 8": (CH, 24, HKV, HD, P, M, 1000, (0, 300)),
    "P 5": (CH, H, HKV, HD, 5, 820, 3900, (0,)),
    "P 24": (CH, H, HKV, HD, 24, 171, 1000, (0, 50)),
    "P 32": (CH, H, HKV, HD, 32, 128, 3968, (0,)),
    "CH 100": (100, H, HKV, HD, P, M, 1000, (0, 7)),
}
#: a massive activation, as Llama residual streams carry in a few channels:
#: each RMSNorm check row holds it in three columns, so a kernel that drops
#: any vector or scalar holding one from the sum of squares moves the whole
#: row far past the tolerance (a dropped vector of unit-scale values moves
#: the row by ~0.1%, below bf16's rounding)
RMS_SPIKE = 50.0
#: RMSNorm cases (N, D, gain dtype): the serving and training models keep
#: their gains in f32; at D + 1 rows start at every 2-byte offset, so the
#: kernel peels a scalar head and tail
RMS_CASES = ((4, D, torch.float32), (4, D, torch.bfloat16),
             (128, D, torch.float32), (4096, D, torch.float32),
             (4, D + 1, torch.bfloat16), (4096, D + 1, torch.float32))


def prefill_splits(b: int, pos: int) -> int:
    """The ranges the prefill kernel splits a chunk's walk into."""
    from ray_lightning_tpu_torch.ops.kernels import paged_prefill as pp
    from ray_lightning_tpu_torch.ops.kernels.paged_attention import sm_count

    return pp.launch_plan(b, CH, H, HKV, M * P, pos, sm_count(0))[1]


def rms_inputs(gen: torch.Generator, n: int, d: int, wdt):
    """Seeded RMSNorm inputs: x [n, d] bf16 of unit scale with RMS_SPIKE
    in the first, middle and last column, a gain [d] of ``wdt`` near one."""
    x = torch.randn(n, d, generator=gen, device="cuda")
    x[:, [0, d // 2, d - 1]] = RMS_SPIKE
    w = 1 + 0.5 * torch.randn(d, generator=gen, device="cuda")
    return x.to(torch.bfloat16), w.to(wdt)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


# ---- timing ----------------------------------------------------------------


def time_ms(fn, reps: int = 15) -> float:
    """Median device time of ``fn`` in ms, CUDA events around each call.
    The card is first held busy with a sleep kernel so the host enqueues
    the call before it starts (the time is the device's, not Python's),
    and a 64 MiB buffer is rewritten between calls so L2 starts cold,
    as it does for the serving loop's per-layer pools."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(20_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_us(fn, calls: int = 200) -> float:
    """Host microseconds per call of ``fn`` (a kernel wrapper): the card is
    held busy by a sleep kernel, so the calls only enqueue and the time is
    the host's own (checks, allocation, the launch call)."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / calls * 1e6


def kernel_profile(fn, calls: int = 1):
    """{kernel name: {"launches", "ms"}} per call of ``fn`` over ``calls``
    back-to-back calls after a warm-up, from torch.profiler's device
    events: what ``fn`` launches and the kernels' own device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key[:60]: dict(launches=e.count / calls,
                             ms=e.self_device_time_total / 1e3 / calls)
            for e in device_kernels(prof)}


def bound(nbytes: float, flops: float):
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_f = flops / BF16_FLOPS_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


# ---- phase 3: kernels against their plain versions -------------------------


def tolerance_ratio(got: torch.Tensor, want: torch.Tensor, rms_dims=(-1,)):
    """(max |got - want|, the largest share of its allowance any element
    uses) under the RTOL / ATOL_RMS rule; a share above 1 fails. The rms
    is taken over ``rms_dims`` (a row by default). A non-finite output
    uses an infinite share, and so does any error where the plain
    version's rms is zero."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    rms = want.pow(2).mean(dim=rms_dims, keepdim=True).sqrt()
    share = torch.where(err == 0, torch.zeros_like(err),
                        err / (ATOL_RMS * rms + RTOL * want.abs()))
    if not bool(torch.isfinite(got).all()):
        return float("inf"), float("inf")
    return err.max().item(), share.max().item()


def hold(got: torch.Tensor, want: torch.Tensor, what: str, rms_dims=(-1,)):
    """`tolerance_ratio`, raising when the kernel is out of tolerance."""
    err, share = tolerance_ratio(got, want, rms_dims)
    if not share <= 1.0:
        raise AssertionError(f"{what}: max |err| {err:.4g} uses {share:.3g}x "
                             f"the tolerance")
    return err, share


def i32(x):
    return torch.tensor(x, dtype=torch.int32, device="cuda")


class KernelInputs:
    """Seeded bf16 inputs, by default at the serving shapes: one pool of K
    and V whose C slots own distinct blocks in shuffled order (block 0,
    the scratch block, is in no table)."""

    def __init__(self, gen: torch.Generator, h=H, hkv=HKV, hd=HD, p=P, m=M):
        self.gen, self.h, self.hd = gen, h, hd
        nb = 1 + C * m
        self.pool_k = self.randn(nb, p, hkv, hd)
        self.pool_v = self.randn(nb, p, hkv, hd)
        perm = torch.randperm(nb - 1, generator=gen, device="cuda") + 1
        self.tables = perm[:C * m].reshape(C, m).to(torch.int32).contiguous()

    def randn(self, *shape):
        return torch.randn(shape, generator=self.gen,
                           device="cuda").to(torch.bfloat16)

    def decode(self, lengths, pad):
        """Arguments of one decode call over all C slots."""
        return ((self.randn(C, self.h, self.hd), self.pool_k, self.pool_v,
                 self.tables, i32(list(lengths))), dict(pad=i32(list(pad))))

    def prefill(self, pos, pad, ch=CH):
        """Arguments of one prefill chunk over the first len(pad) rows."""
        tab = self.tables[:len(pad)].contiguous()
        return ((self.randn(len(pad), ch, self.h, self.hd), self.pool_k,
                 self.pool_v, tab, pos), dict(pad=i32(list(pad))))


def decode_bytes(lengths, pad, hkv, hd, q_heads, m):
    """Bytes the decode must move: q in and out once, each visible K and
    V row once, the tables, lengths and pads."""
    vis = sum(max(0, l - p) for l, p in zip(lengths, pad))
    return (2 * len(lengths) * q_heads * hd * 2 + vis * hkv * hd * 2 * 2
            + len(lengths) * m * 4 + 2 * len(lengths) * 4), vis


def check_kernels(gen: torch.Generator):
    from ray_lightning_tpu_torch.ops.attention import gather_pages
    from ray_lightning_tpu_torch.ops.kernels.paged_attention import (
        paged_attention_kernel, paged_attention_plain)
    from ray_lightning_tpu_torch.ops.kernels.paged_prefill import (
        paged_prefill_kernel, paged_prefill_plain)
    from ray_lightning_tpu_torch.ops.kernels.rmsnorm import (
        rms_norm_kernel, rms_norm_plain)
    import torch.nn.functional as F

    inp = KernelInputs(gen)
    rows = []

    def record(kernel, shape, err, share, ms, plain_ms, lib_ms, nbytes,
               flops, **extra):
        b_ms, b_by = bound(nbytes, flops)
        row = dict(kernel=kernel, shape=shape, max_abs_err=err,
                   tolerance_share=share, kernel_ms=ms, plain_ms=plain_ms,
                   library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by, **extra)
        print(json.dumps(row), flush=True)
        rows.append(row)

    # -- paged decode: ragged lengths up to 4096 --------------------------
    def decode_case(name, lengths, pad, time_it=True):
        args, kw = inp.decode(lengths, pad)
        got = paged_attention_kernel(*args, **kw)
        err, share = hold(got, paged_attention_plain(*args, **kw),
                          f"paged_decode {name}")
        if not time_it:
            return got
        if not torch.equal(got, paged_attention_kernel(*args, **kw)):
            raise AssertionError("paged_decode: two calls differ")
        launched = kernel_profile(lambda: paged_attention_kernel(*args, **kw))
        if sum(k["launches"] for k in launched.values()) != 1:
            raise AssertionError(f"paged_decode: launches {launched}, not one")
        ms = time_ms(lambda: paged_attention_kernel(*args, **kw))
        plain_ms = time_ms(lambda: paged_attention_plain(*args, **kw),
                           reps=5)
        q, pool_k, pool_v, tables, ln = args
        gk = gather_pages(pool_k, tables).transpose(1, 2)  # [C, Hkv, G, hd]
        gv = gather_pages(pool_v, tables).transpose(1, 2)
        kv_pos = torch.arange(M * P, device="cuda")
        mask = ((kv_pos[None] < ln[:, None])
                & (kv_pos[None] >= kw["pad"][:, None]))[:, None, None, :]
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
            q[:, :, None], gk, gv, attn_mask=mask, enable_gqa=True))
        nbytes, vis = decode_bytes(lengths, pad, HKV, HD, H, M)
        record("paged_decode", dict(C=C, H=H, Hkv=HKV, hd=HD, P=P, M=M,
                                    lengths=list(lengths), pad=list(pad)),
               err, share, ms, plain_ms, lib_ms, nbytes,
               4 * H * HD * vis,
               launches_per_call={k: v["launches"] for k, v in launched.items()},
               host_us=host_us(lambda: paged_attention_kernel(*args, **kw)))
        return got

    decode_case("ragged", DECODE_LENGTHS, [0, 0, 0, 0])
    decode_case("pad", DECODE_LENGTHS, [0, 100, 17, 3], time_it=False)
    # fully masked slot 0 (pad beyond length) writes zeros
    out = decode_case("masked", [5, 64, 64, 64], [9, 0, 0, 0],
                      time_it=False)
    if bool((out[0] != 0).any()):
        raise AssertionError("paged_decode: fully masked slot not zero")
    # scratch block 0 at the table tail, poisoned: no visible change
    tab0 = inp.tables.clone()
    tab0[0, 2:] = 0
    q = inp.randn(C, H, HD)
    ln = i32([20, 64, 64, 64])
    outs = []
    for fill in (0.0, 1e4):
        inp.pool_k[0], inp.pool_v[0] = fill, fill
        outs.append(paged_attention_kernel(q, inp.pool_k, inp.pool_v, tab0,
                                           ln))
    if not torch.equal(outs[0], outs[1]):
        raise AssertionError("paged_decode: scratch poison leaked")

    # -- paged prefill: B = 1, CH = 128 at three depths; two rows with a
    # pad that covers whole ranges of the split walk or falls inside one
    def prefill_case(pos, pad, time_it=True):
        args, kw = inp.prefill(pos, pad)
        got = paged_prefill_kernel(*args, **kw)
        err, share = hold(got, paged_prefill_plain(*args, **kw),
                          f"paged_prefill pos={pos} pad={pad}")
        if not time_it:
            return got
        ms = time_ms(lambda: paged_prefill_kernel(*args, **kw))
        plain_ms = time_ms(lambda: paged_prefill_plain(*args, **kw),
                           reps=5)
        q, pool_k, pool_v, tab, _ = args
        b, pd = len(pad), kw["pad"]
        gk = gather_pages(pool_k, tab).transpose(1, 2)
        gv = gather_pages(pool_v, tab).transpose(1, 2)
        kv_pos = torch.arange(M * P, device="cuda")
        q_pos = pos + torch.arange(CH, device="cuda")
        mask = ((kv_pos[None, :] <= q_pos[:, None])[None]
                & (kv_pos[None, None, :] >= pd[:, None, None]))[:, None]
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
            q.transpose(1, 2), gk, gv, attn_mask=mask, enable_gqa=True))
        seen = sum(max(0, pos + j + 1 - p) for p in pad for j in range(CH))
        vis_kv = sum(max(0, pos + CH - p) for p in pad)
        nbytes = 2 * b * CH * H * HD * 2 + vis_kv * HKV * HD * 4 + b * M * 4
        record("paged_prefill", dict(B=b, CH=CH, H=H, Hkv=HKV, hd=HD, P=P,
                                     M=M, pos=pos, pad=list(pad),
                                     n_split=prefill_splits(b, pos)),
               err, share, ms, plain_ms, lib_ms, nbytes, 4 * H * HD * seen)
        return got

    if prefill_splits(1, 0) != 1:
        raise AssertionError("paged_prefill: pos 0 should walk one range")
    for pos in PREFILL_POS:
        prefill_case(pos, [0])
    for pos, pad in PREFILL_PADS:
        prefill_case(pos, pad)
    out = prefill_case(0, [0, 40], time_it=False)
    if bool((out[1, :40] != 0).any()) or not bool((out[1, 40:] != 0).any()):
        raise AssertionError("paged_prefill: pad-column queries not zero")
    # scratch block 0 named by the table from the block after the chunk's
    # last position, poisoned: its tile is walked but masked, so no
    # visible change
    pos = 1000
    tab0 = inp.tables[:1].clone()
    tab0[0, -(-(pos + CH) // P):] = 0
    q = inp.randn(1, CH, H, HD)
    outs = []
    for fill in (0.0, 1e4):
        inp.pool_k[0], inp.pool_v[0] = fill, fill
        outs.append(paged_prefill_kernel(q, inp.pool_k, inp.pool_v, tab0,
                                         pos))
    hold(outs[0], paged_prefill_plain(q, inp.pool_k, inp.pool_v, tab0, pos),
         "paged_prefill poison")
    if not torch.equal(outs[0], outs[1]):
        raise AssertionError("paged_prefill: scratch poison leaked")
    del inp, outs

    # -- RMSNorm: the serving shapes, the train shape, a scalar tail ------
    for n, d, wdt in RMS_CASES:
        x, w = rms_inputs(gen, n, d, wdt)
        got = rms_norm_kernel(x, w)
        err, share = hold(got, rms_norm_plain(x, w),
                          f"rms_norm N={n} D={d} w {wdt}")
        ms = time_ms(lambda: rms_norm_kernel(x, w))
        plain_ms = time_ms(lambda: rms_norm_plain(x, w))
        wx = w.to(x.dtype)
        lib_ms = time_ms(lambda: F.rms_norm(x, (d,), wx, 1e-5))
        record("rms_norm", dict(N=n, D=d, w=str(wdt).split(".")[-1]), err,
               share, ms, plain_ms, lib_ms,
               2 * n * d * 2 + d * w.element_size(), 4 * n * d,
               host_us=host_us(lambda: rms_norm_kernel(x, w)))
    return rows


def check_owed(gen: torch.Generator):
    """The decode and prefill at every shape of DECODE_OWED and
    PREFILL_OWED against their plain versions, untimed; a slot of
    length 0 must give exact zeros. One JSON line per shape."""
    from ray_lightning_tpu_torch.ops.kernels.paged_attention import (
        paged_attention_kernel, paged_attention_plain)
    from ray_lightning_tpu_torch.ops.kernels.paged_prefill import (
        paged_prefill_kernel, paged_prefill_plain)

    for name, (h, hkv, hd, p, m, lengths, pad) in DECODE_OWED.items():
        args, kw = KernelInputs(gen, h, hkv, hd, p, m).decode(lengths, pad)
        got = paged_attention_kernel(*args, **kw)
        err, share = hold(got, paged_attention_plain(*args, **kw),
                          f"paged_decode {name}")
        empty = [c for c, (l, pd) in enumerate(zip(lengths, pad)) if l <= pd]
        if any(bool((got[c] != 0).any()) for c in empty):
            raise AssertionError(f"paged_decode {name}: empty slot not zero")
        print(json.dumps(dict(check="paged_decode", case=name, H=h, Hkv=hkv,
                              hd=hd, P=p, M=m, lengths=list(lengths),
                              pad=list(pad), max_abs_err=err,
                              tolerance_share=share)), flush=True)
    for name, (ch, h, hkv, hd, p, m, pos, pad) in PREFILL_OWED.items():
        args, kw = KernelInputs(gen, h, hkv, hd, p, m).prefill(pos, pad, ch)
        got = paged_prefill_kernel(*args, **kw)
        err, share = hold(got, paged_prefill_plain(*args, **kw),
                          f"paged_prefill {name}")
        print(json.dumps(dict(check="paged_prefill", case=name, CH=ch,
                              H=h, Hkv=hkv, hd=hd, P=p, M=m, pos=pos,
                              pad=list(pad), max_abs_err=err,
                              tolerance_share=share)), flush=True)
    torch.cuda.empty_cache()


# ---- phase 3b: flash attention and the RMSNorm gradient --------------------

#: Llama-3-8B's training attention: batch, sequence, heads, KV heads, hd
TB, TS, TH, THKV = 2, 2048, 32, 8
#: name -> (B, Sq, Sk, H, Hkv, hd, causal, q_offset); the first is the
#: training step's shape, the summary's. "hd 64" is the other head size
#: the shape gate admits; in "empty rows" the first 64 queries see no key
#: (q_offset -64) and must give O = 0, lse = -1e30 and zero gradients.
FLASH_CASES = {
    "train causal": (TB, TS, TS, TH, THKV, HD, True, 0),
    "train full": (TB, TS, TS, TH, THKV, HD, False, 0),
    "q_offset": (TB, TS // 2, TS, TH, THKV, HD, True, TS // 2),
    "mha": (TB, TS, TS, TH, TH, HD, True, 0),
    "short": (TB, 128, 128, TH, THKV, HD, True, 0),
    "hd 64": (TB, TS, TS, TH, THKV, 64, True, 0),
    "empty rows": (TB, 256, 256, TH, THKV, HD, True, -64),
}
#: flash shapes the gate admits beyond FLASH_CASES, checked untimed (same
#: fields): ragged lengths in the three modes (at an offset: the last
#: half of the sequence's queries), B 1, n_rep 2
FLASH_OWED = {
    **{f"{mode} {n}": (1, sq, n, TH, THKV, HD, mode != "full", n - sq)
       for n in (1000, 65, 1)
       for mode, sq in (("causal", n), ("full", n), ("q_offset", -(-n // 2)))},
    "n_rep 2": (TB, 512, 512, 16, 8, HD, True, 0),
}
#: at Sk = 1 every softmax has one key: P = 1 and dS = P (dP - delta) = 0,
#: so dQ and dK are zero in exact arithmetic and both versions hold only
#: the rounding of dP - delta (two f32 sums of the same products, ~1e-6);
#: there they are held to this absolute bound, not to a share of a zero rms
ZERO_GRAD_ATOL = 1e-4
#: gradients are held with the rms of each head's [S, hd] slab: a
#: gradient row can cancel to zero (dQ of the first query is exactly 0)
#: while its rounding noise does not
SLAB = (1, 3)


def visible_pairs(sq: int, sk: int, causal: bool, q_offset: int) -> int:
    """(query, key) pairs one head attends over."""
    if not causal:
        return sq * sk
    return sum(max(0, min(sk, q_offset + i + 1)) for i in range(sq))


class FlashCase:
    """Seeded bf16 q, k, v, dO for one shape, the kernels' outputs and
    the plain versions' on the same inputs (the backward on the kernel
    forward's lse and delta, so each pass is held on its own)."""

    def __init__(self, gen, B, Sq, Sk, H, Hkv, hd, causal, q_offset):
        from ray_lightning_tpu_torch.ops.kernels import flash as F

        self.F, self.args = F, (causal, q_offset)
        self.shape = (B, Sq, Sk, H, Hkv, hd)
        rn = lambda *s: torch.randn(s, generator=gen,  # noqa: E731
                                    device="cuda").to(torch.bfloat16)
        self.q, self.k, self.v = rn(B, Sq, H, hd), rn(B, Sk, Hkv, hd), \
            rn(B, Sk, Hkv, hd)
        self.do = rn(B, Sq, H, hd)
        self.o, self.lse = F.flash_fwd_kernel(self.q, self.k, self.v,
                                              *self.args)
        self.delta = F.flash_delta(self.o, self.do)

    def fwd(self):
        return self.F.flash_fwd_kernel(self.q, self.k, self.v, *self.args)

    def fwd_plain(self):
        return self.F.flash_fwd_plain(self.q, self.k, self.v, *self.args)

    def bwd_in(self):
        return (self.q, self.k, self.v, self.do, self.lse, self.delta,
                *self.args)

    def dkv(self):
        return self.F.flash_bwd_dkv_kernel(*self.bwd_in())

    def dq(self):
        return self.F.flash_bwd_dq_kernel(*self.bwd_in())

    def dkv_plain(self):
        return self.F.flash_bwd_dkv_plain(*self.bwd_in())

    def dq_plain(self):
        return self.F.flash_bwd_dq_plain(*self.bwd_in())

    def shares(self):
        """{output: (max |err|, share of the tolerance)} of every kernel
        output against its plain version (the caller judges them)."""
        po, plse = self.fwd_plain()
        out = {"o": tolerance_ratio(self.o, po),
               "lse": tolerance_ratio(self.lse, plse)}
        lse_err = (self.lse - plse).abs().max().item()
        out["lse_abs"] = (lse_err, lse_err / LSE_ATOL)
        del po, plse
        dk, dv = self.dkv()
        pdk, pdv = self.dkv_plain()
        out["dk"] = tolerance_ratio(dk, pdk, SLAB)
        out["dv"] = tolerance_ratio(dv, pdv, SLAB)
        del pdk, pdv
        out["dq"] = tolerance_ratio(self.dq(), self.dq_plain(), SLAB)
        torch.cuda.synchronize()
        return out


def sdpa_args(c: FlashCase):
    """The same attention as one `F.scaled_dot_product_attention` call."""
    B, Sq, Sk, H, Hkv, _ = c.shape
    causal, off = c.args
    kw = dict(enable_gqa=Hkv != H)
    if causal and off == 0 and Sq == Sk:
        kw["is_causal"] = True
    elif causal:
        q_pos = off + torch.arange(Sq, device="cuda")[:, None]
        kw["attn_mask"] = q_pos >= torch.arange(Sk, device="cuda")[None]
    return (c.q.transpose(1, 2), c.k.transpose(1, 2),
            c.v.transpose(1, 2)), kw


def check_empty_rows(c: FlashCase):
    """A causal case at a negative q_offset: the first -q_offset queries
    see no key and give O = 0 and lse = -1e30, and their dQ is zero, as
    are dK and dV of the keys no query sees (SDPA gives NaN on such rows,
    so the kernels are held to exact values here)."""
    Sq, off = c.shape[1], c.args[1]
    dk, dv = c.dkv()
    dq = c.dq()
    n = -off
    unseen = max(0, off + Sq)  # keys from here on are seen by no query
    bad = [what for what, ok in (
        ("O", bool((c.o[:, :n] == 0).all())),
        ("lse", bool((c.lse[:, :, :n] == c.F.NEG_INF).all())),
        ("dQ", bool((dq[:, :n] == 0).all())),
        ("dK", bool((dk[:, unseen:] == 0).all())),
        ("dV", bool((dv[:, unseen:] == 0).all()))) if not ok]
    if bad:
        raise AssertionError(f"flash empty rows: {bad} not exact")


def check_flash(gen: torch.Generator):
    """The three flash kernels against their plain versions at every
    shape of FLASH_CASES; one JSON row per (kernel, shape), timed."""
    import torch.nn.functional as F

    rows = []
    for name, (B, Sq, Sk, H, Hkv, hd, causal, off) in FLASH_CASES.items():
        c = FlashCase(gen, B, Sq, Sk, H, Hkv, hd, causal, off)
        shares = c.shares()
        bad = {k: v for k, v in shares.items() if not v[1] <= 1.0}
        if bad:
            raise AssertionError(f"flash {name}: out of tolerance {bad}")
        bwd_pair = time_ms(lambda: (c.dkv(), c.dq()))
        if causal and off < 0:
            check_empty_rows(c)
            lib_fwd = lib_bwd = lib_fb = None  # SDPA: NaN on empty rows
        else:
            (sq, sk, sv), kw = sdpa_args(c)
            lib_fwd = time_ms(lambda: F.scaled_dot_product_attention(
                sq, sk, sv, **kw))
            leaves = [t.detach().requires_grad_(True) for t in (sq, sk, sv)]
            lib_out = F.scaled_dot_product_attention(*leaves, **kw)
            do_t = c.do.transpose(1, 2)
            lib_bwd = time_ms(lambda: torch.autograd.grad(
                lib_out, leaves, do_t, retain_graph=True))

            def lib_both():
                o = F.scaled_dot_product_attention(*leaves, **kw)
                torch.autograd.grad(o, leaves, do_t)

            lib_fb = time_ms(lib_both)
            del lib_out, leaves
        vis = B * H * visible_pairs(Sq, Sk, causal, off)
        q_bytes, kv_bytes, vec = B * Sq * H * hd * 2, B * Sk * Hkv * hd * 2, \
            B * H * Sq * 4
        shape = dict(case=name, B=B, Sq=Sq, Sk=Sk, H=H, Hkv=Hkv, hd=hd,
                     causal=causal, q_offset=off)
        for kernel, fn, plain, lib, nbytes, flops, outs in (
                ("flash_fwd", c.fwd, c.fwd_plain, lib_fwd,
                 2 * q_bytes + 2 * kv_bytes + vec, 4 * vis * hd,
                 ("o", "lse", "lse_abs")),
                ("flash_bwd_dkv", c.dkv, c.dkv_plain, lib_bwd,
                 2 * q_bytes + 4 * kv_bytes + 2 * vec, 8 * vis * hd,
                 ("dk", "dv")),
                ("flash_bwd_dq", c.dq, c.dq_plain, lib_bwd,
                 3 * q_bytes + 2 * kv_bytes + 2 * vec, 6 * vis * hd,
                 ("dq",))):
            b_ms, b_by = bound(nbytes, flops)
            row = dict(kernel=kernel, shape=shape,
                       max_abs_err=max(shares[o][0] for o in outs
                                       if o != "lse_abs"),
                       tolerance_share={o: shares[o][1] for o in outs},
                       kernel_ms=time_ms(fn),
                       plain_ms=time_ms(plain, reps=3),
                       library_ms=lib, bwd_pair_ms=bwd_pair,
                       bound_ms=b_ms, bound_by=b_by)
            if kernel != "flash_fwd":
                row["library_fwd_bwd_ms"] = lib_fb
            print(json.dumps(row), flush=True)
            rows.append(row)
        del c
        torch.cuda.empty_cache()
    return rows


def check_flash_owed(gen: torch.Generator):
    """The three flash kernels against their plain versions at every
    shape of FLASH_OWED, untimed; one JSON line per shape."""
    for name, dims in FLASH_OWED.items():
        shares = FlashCase(gen, *dims).shares()
        zero = ("dq", "dk") if dims[2] == 1 else ()
        bad = {k: v for k, v in shares.items()
               if not (v[0] <= ZERO_GRAD_ATOL if k in zero else v[1] <= 1.0)}
        if bad:
            raise AssertionError(f"flash {name}: out of tolerance {bad}")
        print(json.dumps(dict(check="flash", case=name, shape=dims,
                              max_abs_err={k: v[0] for k, v in shares.items()},
                              tolerance_share={k: v[1] for k, v in
                                               shares.items()})), flush=True)
    torch.cuda.empty_cache()


def check_rms_norm_grad(gen: torch.Generator):
    """On a CUDA tensor `rms_norm` (the CUDA forward) carries a grad_fn,
    and its dx and dw (the ported backward rule) match autograd through
    the plain version on the same inputs."""
    from ray_lightning_tpu_torch.ops.kernels.rmsnorm import (
        rms_norm_kernel, rms_norm_plain)
    from ray_lightning_tpu_torch.ops.norms import rms_norm

    x = torch.randn(TB * TS, D, generator=gen, device="cuda").to(
        torch.bfloat16).requires_grad_(True)
    w = (1 + 0.1 * torch.randn(D, generator=gen, device="cuda")
         ).requires_grad_(True)
    g = torch.randn(TB * TS, D, generator=gen, device="cuda").to(
        torch.bfloat16)
    before = rms_norm_kernel.launches
    y = rms_norm(x, w)
    if y.grad_fn is None or rms_norm_kernel.launches != before + 1:
        raise AssertionError("rms_norm on CUDA: no grad_fn or no launch")
    dx, dw = torch.autograd.grad(y, (x, w), g)
    pdx, pdw = torch.autograd.grad(rms_norm_plain(x, w), (x, w), g)
    err_x, share_x = hold(dx, pdx, "rms_norm dx")
    err_w, share_w = hold(dw, pdw, "rms_norm dw")
    row = dict(check="rms_norm_grad", N=TB * TS, D=D,
               max_abs_err={"dx": err_x, "dw": err_w},
               tolerance_share={"dx": share_x, "dw": share_w})
    print(json.dumps(row), flush=True)


# ---- phase 4: serving at full width ----------------------------------------


class TickProbe:
    """Wraps `DecodeEngine.tick` to count ticks and prefill chunks and
    time each tick (host clock; a tick ends by copying its tokens to the
    host). On the kernel lanes (``forced=None``) it keeps the f32 logits
    every greedy token is taken from, by (rid, step). On the reference
    lanes ``forced`` is the kernel lanes' (logits, tokens): before each
    tick it compares each greedy slot's logits with the kernel lanes' at
    the same step, then sets them to pick the kernel lanes' token, so the
    reference follows the kernel lanes' stream."""

    def __init__(self, engine, sched, forced=None):
        self.engine, self.sched = engine, sched
        self.ticks = self.chunks = 0
        self.tick_s = {"decode": [], "decode+prefill": []}
        self.logits = {}
        self.forced = forced
        self.steps = []  # (rid, step, max |delta|, ref margin, max |ref|)
        self._tick = engine.tick
        engine.tick = self

    def _greedy_decoding(self, decoding):
        for s in map(int, decoding.nonzero()[0]):
            slot = self.sched.slots[s]
            if slot.req.temperature == 0.0:
                yield s, slot.req.rid, len(slot.emitted)

    def __call__(self, tables, pos, decoding, temp, top_k, rngs, prefill,
                 pad=None):
        last = self.engine.last_logits
        for s, rid, t in self._greedy_decoding(decoding):
            if self.forced is None:
                self.logits[(rid, t)] = last[s].clone()
                continue
            k_logits, k_tokens = self.forced
            tok = k_tokens[rid][t]
            ref = last[s]
            self.steps.append((rid, t, (k_logits[(rid, t)] - ref).abs().max(),
                               ref.max() - ref[tok], ref.abs().max()))
            last[s].zero_()
            last[s, tok] = 1.0
        t0 = time.perf_counter()
        out = self._tick(tables, pos, decoding, temp, top_k, rngs,
                         prefill, pad=pad)
        dt = time.perf_counter() - t0
        self.ticks += 1
        chunk = int(prefill[0]) >= 0  # the single-slot prefill lane
        self.tick_s["decode+prefill" if chunk else "decode"].append(dt)
        self.chunks += chunk
        return out


def serve(model, ecfg, use_kernels, forced=None):
    from ray_lightning_tpu_torch.serve.engine import DecodeEngine
    from ray_lightning_tpu_torch.serve.scheduler import Scheduler

    engine = DecodeEngine(model, ecfg, use_kernels=use_kernels)
    engine.warmup()
    sched = Scheduler(engine)
    probe = TickProbe(engine, sched, forced=forced)
    torch.cuda.synchronize()
    return engine, sched, probe


def drain(sched, requests):
    for r in requests:
        sched.submit(r)
    done = {}
    while sched.busy():
        for c in sched.tick():
            done[c.rid] = c
    torch.cuda.synchronize()
    return done


def device_kernels(prof):
    """The profile's device events by name, without the device-side copies
    of user annotations (such as the optimizer's step range), whose time
    is that of the kernels inside them."""
    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def profile_window(sched, reqs):
    """Serve ``reqs`` again under `torch.profiler` and print where the
    device time went: the busy share of the window's wall time and the
    kernels with the most device time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        drain(sched, [dataclasses.replace(r, rid=f"p{r.rid}")
                      for r in reqs])
        wall = time.perf_counter() - t0
    events = device_kernels(prof)
    busy = sum(e.self_device_time_total for e in events) / 1e6
    top = sorted(events, key=lambda e: e.self_device_time_total,
                 reverse=True)[:10]
    print(json.dumps(dict(
        phase="profile", requests=len(reqs), wall_s=wall, device_busy_s=busy,
        device_busy_share=busy / wall,
        top=[dict(name=e.key[:80], ms=e.self_device_time_total / 1e3,
                  calls=e.count) for e in top])), flush=True)


def build_model(seed: int, n_layers: int):
    """Llama-3-8B at full width, ``n_layers`` deep, random bf16 weights
    from a seeded CUDA generator."""
    from ray_lightning_tpu_torch.models.llama import LlamaConfig, init_weights

    cfg = LlamaConfig.llama3_8b(max_seq_len=4096, n_layers=n_layers)
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    model = init_weights(cfg, gen)
    torch.cuda.synchronize()
    log(f"serve: built {cfg.n_layers}-layer Llama-3-8B in "
        f"{time.perf_counter() - t0:.1f}s")
    return model


def engine_config():
    from ray_lightning_tpu_torch.serve.engine import EngineConfig

    return EngineConfig(capacity=4, block_size=16, blocks_per_slot=256,
                        prefill_chunk=128)


def make_requests(vocab_size: int, seed: int):
    """8 requests, prompts of 200-1500 tokens from ``seed``, 32 new
    tokens each; even indices greedy, odd ones sampled (temperature 0.8,
    top-k 50)."""
    from ray_lightning_tpu_torch.serve.scheduler import Request
    import numpy as np

    rng = np.random.default_rng(seed)
    lens = rng.integers(200, 1501, 8)
    return [Request(rid=f"r{i}",
                    prompt=rng.integers(0, vocab_size, n).astype(np.int32),
                    max_new_tokens=32,
                    temperature=0.0 if i % 2 == 0 else 0.8,
                    top_k=None if i % 2 == 0 else 50, seed=seed + i)
            for i, n in enumerate(lens)]


def compare_lanes(model, ecfg, reqs, kernel_probe, kernel_done):
    """Serve the greedy ``reqs`` through the reference lanes, forced
    along the kernel lanes' tokens, and compare the logits of every
    step. Returns the JSON row and the list of what is out of
    tolerance (empty when the lanes agree)."""
    tokens = {r.rid: kernel_done[r.rid].tokens for r in reqs}
    engine, sched, probe = serve(model, ecfg, use_kernels=False,
                                 forced=(kernel_probe.logits, tokens))
    if engine.attention_path != "reference-gather":
        raise AssertionError("reference lanes not selected")
    ref = drain(sched, reqs)
    steps = [(rid, t, *torch.stack(v).tolist())
             for rid, t, *v in probe.steps]
    del engine, sched, probe
    problems = [f"{r.rid}: reference stream {ref[r.rid].tokens} was not "
                f"forced to {tokens[r.rid]}" for r in reqs
                if ref[r.rid].tokens != tokens[r.rid]]
    want_steps = sum(r.max_new_tokens for r in reqs)
    if len(steps) != want_steps:
        problems.append(f"compared {len(steps)} steps, not {want_steps}")
    worst = max(s[2] for s in steps)
    if not worst <= LOGIT_TOL:
        problems.append(f"logits differ by {worst:.4g} > {LOGIT_TOL}")
    differ = [dict(rid=rid, step=t, ref_margin=m)
              for rid, t, _, m, _ in steps if m > 0]
    problems += [f"{d['rid']} step {d['step']}: the reference prefers its "
                 f"own argmax by {d['ref_margin']:.4g} >= {LOGIT_TOL}"
                 for d in differ if not d["ref_margin"] < LOGIT_TOL]
    row = dict(phase="lanes", streams=len(reqs), steps=len(steps),
               logits_max_abs_diff=worst,
               prefill_logits_max_abs_diff=max(s[2] for s in steps
                                               if s[1] == 0),
               logits_max_abs=max(s[4] for s in steps),
               tolerance=LOGIT_TOL, argmax_differs=differ)
    return row, problems


def serve_phase(seed: int, n_layers: int):
    model = build_model(seed, n_layers)
    ecfg = engine_config()
    reqs = make_requests(model.cfg.vocab_size, seed)
    kernels = all_kernels()
    engine, sched, probe = serve(model, ecfg, use_kernels=None)
    if (engine.attention_path, engine.prefill_path) != ("paged-kernel",
                                                        "paged-kernel"):
        raise AssertionError(f"kernel lanes not selected: "
                             f"{engine.attention_path}/{engine.prefill_path}")
    torch.cuda.reset_peak_memory_stats()
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    done = drain(sched, reqs)
    wall = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in kernels}
    want = {k.__name__: 0 for k in kernels}
    want.update(paged_attention_kernel=n_layers * probe.ticks,
                paged_prefill_kernel=n_layers * probe.chunks,
                rms_norm_kernel=(2 * n_layers + 1)
                * (probe.ticks + probe.chunks))
    if launches != want:
        raise AssertionError(f"launch counts {launches} != {want}")
    if sorted(done) != sorted(r.rid for r in reqs):
        raise AssertionError(f"completed {sorted(done)}")
    vocab = model.cfg.vocab_size
    for c in done.values():
        if len(c.tokens) != 32 or not all(0 <= t < vocab for t in c.tokens):
            raise AssertionError(f"{c.rid}: bad tokens {c.tokens}")
    n_tok = sum(len(c.tokens) for c in done.values())
    ttft = sorted(c.ttft_s for c in done.values())
    print(json.dumps(dict(
        phase="serve", layers=n_layers, requests=len(done),
        prompt_tokens=sum(len(r.prompt) for r in reqs), new_tokens=n_tok,
        ticks=probe.ticks, prefill_chunks=probe.chunks,
        wall_s=wall, decode_tokens_per_s=n_tok / wall,
        ttft_p50_s=statistics.median(ttft), ttft_max_s=ttft[-1],
        tpot_p50_s=statistics.median(c.tpot_s for c in done.values()),
        tick_ms_p50={k: statistics.median(v) * 1e3
                     for k, v in probe.tick_s.items() if v},
        tick_count={k: len(v) for k, v in probe.tick_s.items()},
        max_memory_allocated_gib=torch.cuda.max_memory_allocated() / 2**30,
        attention_path=engine.attention_path,
        prefill_path=engine.prefill_path, launches=launches)), flush=True)
    profile_window(sched, reqs[:4])
    del engine, sched

    # -- the greedy half again through the reference lanes ----------------
    greedy = [r for r in reqs if r.temperature == 0.0]
    row, problems = compare_lanes(model, ecfg, greedy, probe, done)
    print(json.dumps(row), flush=True)
    if problems:
        raise AssertionError("kernel vs reference lanes: "
                             + "; ".join(problems))
    return launches


# ---- phase 5: training at full width ----------------------------------------

#: the train phase: depth, optimizer steps, batch, sequence; the tokens
#: are uniform over the first TRAIN_TOKENS ids, so there is something to
#: learn in 8 steps (the model starts uniform over all 128256)
TRAIN_LAYERS, TRAIN_STEPS, TRAIN_TOKENS = 4, 8, 8192


class StepProbe:
    """Per-step host metrics and the host clock at each step's end (the
    metrics fetch at ``log_every_n_steps=1`` synchronises every step)."""

    def __init__(self):
        from ray_lightning_tpu_torch.core.callbacks import Callback

        probe = self

        class _CB(Callback):
            def on_train_batch_end(self, trainer, module, metrics,
                                   batch_idx):
                probe.rows.append((float(metrics["loss"]),
                                   float(metrics["grad_norm"])))
                probe.t.append(time.perf_counter())

        self.rows, self.t, self.callback = [], [], _CB()


def train_once(cfg, tokens, seed: int, callbacks=()):
    """One `Trainer.fit` of `LlamaModule` over ``tokens``; returns the
    StepProbe, the fit's wall time, the peak device memory and the
    parameter count."""
    from ray_lightning_tpu_torch.core.data import DataLoader
    from ray_lightning_tpu_torch.core.trainer import Trainer
    from ray_lightning_tpu_torch.models.llama import LlamaModule
    from ray_lightning_tpu_torch.parallel.strategy import SingleDevice

    probe = StepProbe()
    module = LlamaModule(cfg, lr=3e-4, warmup_steps=2,
                         total_steps=TRAIN_STEPS)
    trainer = Trainer(strategy=SingleDevice(), max_steps=TRAIN_STEPS,
                      log_every_n_steps=1, enable_checkpointing=False,
                      enable_progress_bar=False, seed=seed,
                      callbacks=[probe.callback, *callbacks])
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    probe.t.append(t0)
    trainer.fit(module, DataLoader({"tokens": tokens}, batch_size=TB))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if trainer.global_step != TRAIN_STEPS:
        raise AssertionError(f"fit ran {trainer.global_step} steps")
    n_params = module.num_params()
    del trainer, module
    return probe, wall, torch.cuda.max_memory_allocated(), n_params


def train_inputs(seed: int):
    """The train phase's config and its seeded tokens [steps * B, S + 1]."""
    import numpy as np

    from ray_lightning_tpu_torch.models.llama import LlamaConfig

    cfg = LlamaConfig.llama3_8b(max_seq_len=TS, n_layers=TRAIN_LAYERS)
    tokens = np.random.default_rng(seed).integers(
        0, TRAIN_TOKENS, (TRAIN_STEPS * TB, TS + 1)).astype(np.int64)
    return cfg, tokens


def train_reference(cfg, tokens, seed: int):
    """The fit through the reference lanes, which must launch no kernel."""
    from ray_lightning_tpu_torch.ops import dispatch

    kernels = all_kernels()
    for k in kernels:
        k.launches = 0
    with dispatch.force_reference():
        out = train_once(cfg, tokens, seed)
    launched = {k.__name__: k.launches for k in kernels if k.launches}
    if launched:
        raise AssertionError(f"reference lanes launched {launched}")
    gc.collect()
    torch.cuda.empty_cache()
    return out


def compare_train(rows, ref_rows):
    """(max |delta loss|, max |delta grad_norm| / grad_norm, problems)
    of the kernel lanes' per-step metrics against the reference lanes'."""
    d_loss = max(abs(a[0] - b[0]) for a, b in zip(rows, ref_rows))
    d_gn = max(abs(a[1] - b[1]) / b[1] for a, b in zip(rows, ref_rows))
    problems = []
    if len(rows) != len(ref_rows):
        problems.append(f"{len(rows)} steps against {len(ref_rows)}")
    if not d_loss <= TRAIN_LOSS_TOL:
        problems.append(f"loss differs by {d_loss:.4g} > {TRAIN_LOSS_TOL}")
    if not d_gn <= TRAIN_GNORM_RTOL:
        problems.append(f"grad_norm differs by {d_gn:.4g} (relative) > "
                        f"{TRAIN_GNORM_RTOL}")
    return d_loss, d_gn, problems


def profile_train(cfg, tokens, seed: int, first: int = 3):
    """The kernel-lanes fit again, under `torch.profiler` from step
    ``first`` to its end: the device's busy share of that window's wall
    time and the kernels with the most device time."""
    from torch.profiler import ProfilerActivity, profile

    from ray_lightning_tpu_torch.core.callbacks import Callback

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    window = {}

    class Window(Callback):
        def on_train_batch_start(self, trainer, module, batch, batch_idx):
            if batch_idx == first:
                torch.cuda.synchronize()
                prof.start()
                window["t0"] = time.perf_counter()

    train_once(cfg, tokens, seed, callbacks=[Window()])
    wall = time.perf_counter() - window["t0"]  # the fit ends synchronised
    prof.stop()
    events = device_kernels(prof)
    busy = sum(e.self_device_time_total for e in events) / 1e6
    top = sorted(events, key=lambda e: e.self_device_time_total,
                 reverse=True)[:16]
    steps = TRAIN_STEPS - first
    print(json.dumps(dict(
        phase="train_profile", steps=steps, wall_s=wall,
        device_busy_s=busy, device_busy_share=busy / wall,
        top=[dict(name=e.key[:160], ms_per_step=e.self_device_time_total
                  / 1e3 / steps, calls_per_step=e.count / steps)
             for e in top])), flush=True)
    gc.collect()
    torch.cuda.empty_cache()


def train_phase(seed: int):
    """Returns the kernels' launch counts of the kernel-lanes fit."""
    import numpy as np

    cfg, tokens = train_inputs(seed)
    kernels = all_kernels()
    for k in kernels:
        k.launches = 0
    probe, wall, peak, n_params = train_once(cfg, tokens, seed)
    launches = {k.__name__: k.launches for k in kernels}
    L, n = TRAIN_LAYERS, TRAIN_STEPS
    want = {k.__name__: 0 for k in kernels}
    want.update(flash_fwd_kernel=2 * L * n, flash_bwd_dkv_kernel=L * n,
                flash_bwd_dq_kernel=L * n, rms_norm_kernel=(4 * L + 1) * n)
    if launches != want:
        raise AssertionError(f"train launch counts {launches} != {want}")
    losses = [r[0] for r in probe.rows]
    if not all(map(np.isfinite, losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall: {losses}")
    gc.collect()
    torch.cuda.empty_cache()

    # the same steps from the same weights through the reference lanes
    ref, ref_wall, ref_peak, _ = train_reference(cfg, tokens, seed)
    d_loss, d_gn, problems = compare_train(probe.rows, ref.rows)

    step_s = statistics.median(b - a for a, b in zip(probe.t[2:],
                                                     probe.t[3:]))
    ref_step_s = statistics.median(b - a for a, b in zip(ref.t[2:],
                                                         ref.t[3:]))
    tok = TB * TS
    d, f, v = cfg.dim, cfg.hidden_dim, cfg.vocab_size
    hd, hkv = cfg.head_dim, cfg.n_kv_heads
    per_layer = d * (TH + 2 * hkv) * hd + TH * hd * d + 3 * d * f
    n_matmul = L * per_layer + v * d
    attn = 12 * L * TB * TH * visible_pairs(TS, TS, True, 0) * hd
    flops = 6 * n_matmul * tok + attn
    row = dict(
        phase="train", layers=L, steps=n, batch=TB, seq=TS, params=n_params,
        matmul_params=n_matmul, losses=losses,
        grad_norms=[r[1] for r in probe.rows],
        ref_losses=[r[0] for r in ref.rows],
        ref_grad_norms=[r[1] for r in ref.rows],
        loss_max_abs_diff=d_loss, grad_norm_max_rel_diff=d_gn,
        loss_tol=TRAIN_LOSS_TOL, grad_norm_rtol=TRAIN_GNORM_RTOL,
        fit_wall_s=wall, step_s_p50=step_s, tokens_per_s=tok / step_s,
        flops_per_step=flops, mfu=flops / step_s / BF16_FLOPS_PER_S,
        max_memory_allocated_gib=peak / 2**30, ref_fit_wall_s=ref_wall,
        ref_step_s_p50=ref_step_s,
        ref_max_memory_allocated_gib=ref_peak / 2**30, launches=launches)
    print(json.dumps(row), flush=True)
    if problems:
        raise AssertionError("train kernel vs reference lanes: "
                             + "; ".join(problems))
    profile_train(cfg, tokens, seed)
    return launches


def old_split_plan(c: int, hkv: int, n_tiles: int, sms: int):
    """The parent build's decode plan: (n_split, tiles per split) over
    ``n_tiles`` 16-position tiles, about sixteen one-warp blocks an SM."""
    want = max(1, -(-16 * sms // (c * hkv)))
    n_split = max(1, min(want, n_tiles // 2))
    tps = -(-n_tiles // n_split)
    return -(-n_tiles // tps), tps


def ab_phase(old_csrc: str):
    """Interleaved reading (old, new, new, old) of the paged decode and
    RMSNorm against a build of older sources, on the same inputs in one
    process: ``old_csrc`` is a copy of an older commit's ``ops/csrc``,
    with its ``ops/kernels/rmsnorm_triton.py`` beside it in
    ``../kernels``. The dQ and prefill, whose sources this tree shares
    with its parent, are timed the same way as a control on the turns.
    Old kernels are called as their wrappers called them: the decode
    through ``paged_decode_bf16`` (q, pool_k, pool_v, tables, lengths,
    pad, part_acc, part_ml, out, C, H, Hkv, HD, P, M, n_split, tps,
    scale, stream) with `old_split_plan`'s ranges and its f32 scratch,
    RMSNorm through the Triton source's ``launch``. Also printed: the
    host microseconds of one wrapper call, old and new, and where the
    old and new decode's device time goes, by kernel."""
    import ctypes
    import importlib.util
    import os

    from ray_lightning_tpu_torch.ops import build
    from ray_lightning_tpu_torch.ops.kernels.paged_attention import (
        paged_attention_kernel, sm_count)
    from ray_lightning_tpu_torch.ops.kernels.paged_prefill import (
        launch_plan, paged_prefill_kernel)
    from ray_lightning_tpu_torch.ops.kernels.rmsnorm import rms_norm_kernel

    csrc, out = build.CSRC, build.BUILD
    build.CSRC, build.BUILD = old_csrc, os.path.join(out, "ab_old")
    try:
        build.build_all(["flash_bwd", "paged_prefill", "paged_attention"])
        old_dq = ctypes.CDLL(build._lib_path("flash_bwd")).flash_bwd_dq_bf16
        old_pf = ctypes.CDLL(
            build._lib_path("paged_prefill")).paged_prefill_bf16
        old_pd = ctypes.CDLL(
            build._lib_path("paged_attention")).paged_decode_bf16
    finally:
        build.CSRC, build.BUILD = csrc, out
    spec = importlib.util.spec_from_file_location("old_rmsnorm", os.path.join(
        old_csrc, os.pardir, "kernels", "rmsnorm_triton.py"))
    old_triton = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(old_triton)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    old_dq.argtypes = [vp] * 7 + [ci] * 8 + [ctypes.c_float, vp]
    old_pf.argtypes = [vp] * 8 + [ci] * 11 + [ctypes.c_float, vp]
    old_pd.argtypes = [vp] * 9 + [ci] * 8 + [ctypes.c_float, vp]
    old_dq.restype = old_pf.restype = old_pd.restype = ci

    def turns(what, shape, old_fn, new_fn, host=False):
        t = [time_ms(f) for f in (old_fn, new_fn, new_fn, old_fn)]
        row = dict(ab=what, shape=shape, old_ms=[t[0], t[3]],
                   new_ms=[t[1], t[2]], old_over_new=(t[0] + t[3])
                   / (t[1] + t[2]))
        if host:
            h = [host_us(f) for f in (old_fn, new_fn, new_fn, old_fn)]
            row.update(old_host_us=[h[0], h[3]], new_host_us=[h[1], h[2]])
        print(json.dumps(row), flush=True)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    sms = sm_count(0)

    # -- the decode: the parent's host path and two kernels
    def old_decode(q, pool_k, pool_v, tables, lengths, pad):
        c, h, hd = q.shape
        _, p, hkv, _ = pool_k.shape
        m = tables.shape[1]
        n_split, tps = old_split_plan(c, hkv, -(-m * p // 16), sms)
        part_acc = torch.empty((c, h, n_split, hd), dtype=torch.float32,
                               device=q.device)
        part_ml = torch.empty((c, h, n_split, 2), dtype=torch.float32,
                              device=q.device)
        o = torch.empty_like(q)
        build.check(old_pd(q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(),
                           tables.data_ptr(), lengths.data_ptr(),
                           pad.data_ptr(), part_acc.data_ptr(),
                           part_ml.data_ptr(), o.data_ptr(), c, h, hkv, hd, p,
                           m, n_split, tps, hd ** -0.5,
                           torch.cuda.current_stream(q.device).cuda_stream),
                    "old decode")
        return o

    cases = {"serving": (H, HKV, HD, P, M, DECODE_LENGTHS, (0, 0, 0, 0)),
             **DECODE_OWED}
    for name, (h, hkv, hd, p, m, lengths, pad) in cases.items():
        args, kw = KernelInputs(gen, h, hkv, hd, p, m).decode(lengths, pad)
        hold(old_decode(*args, **kw), paged_attention_kernel(*args, **kw),
             f"old decode {name}")
        turns("paged_decode", dict(case=name),
              lambda: old_decode(*args, **kw),
              lambda: paged_attention_kernel(*args, **kw),
              host=name == "serving")
        if name == "serving":
            print(json.dumps(dict(ab="paged_decode device ms by kernel",
                                  old=kernel_profile(
                                      lambda: old_decode(*args, **kw), 50),
                                  new=kernel_profile(
                                      lambda: paged_attention_kernel(
                                          *args, **kw), 50))), flush=True)
    torch.cuda.empty_cache()

    # -- RMSNorm: the parent's Triton kernel
    def old_rms(x, w):
        o = torch.empty_like(x)
        n = x.numel() // x.shape[-1]
        old_triton.launch(x.view(n, -1), w, o.view(n, -1), 1e-5)
        return o

    for n, d, wdt in RMS_CASES:
        x, w = rms_inputs(gen, n, d, wdt)
        hold(old_rms(x, w), rms_norm_kernel(x, w), f"old rms_norm {n} {d}")
        turns("rms_norm", dict(N=n, D=d, w=str(wdt).split(".")[-1]),
              lambda: old_rms(x, w), lambda: rms_norm_kernel(x, w),
              host=(n, d, wdt) == RMS_CASES[0])

    # -- control: dQ and prefill, unchanged sources
    stream = torch.cuda.current_stream().cuda_stream
    c = FlashCase(gen, *FLASH_CASES["train causal"])
    B, Sq, Sk, H_, Hkv, hd = c.shape
    dq = torch.empty_like(c.q)
    ptrs = [t.data_ptr() for t in (c.q, c.k, c.v, c.do, c.lse, c.delta, dq)]

    def old_dq_fn():
        build.check(old_dq(*ptrs, B, Sq, Sk, H_, Hkv, hd, int(c.args[0]),
                           c.args[1], hd ** -0.5, stream), "old dq")

    old_dq_fn()
    hold(dq, c.dq_plain(), "old dq", SLAB)
    turns("flash_bwd_dq (control)", dict(case="train causal"), old_dq_fn,
          c.dq)
    del c
    torch.cuda.empty_cache()
    inp = KernelInputs(gen)
    pos = PREFILL_POS[-1]
    args, kw = inp.prefill(pos, [0])
    q, pool_k, pool_v, tab, _ = args
    bq, n_split, tps = launch_plan(1, CH, H, HKV, M * P, pos, sms)
    part_acc = torch.empty((1, CH, H, n_split, HD), dtype=torch.float32,
                           device="cuda")
    part_ml = torch.empty((1, CH, H, n_split, 2), dtype=torch.float32,
                          device="cuda")
    o = torch.empty_like(q)
    ptrs = [t.data_ptr() for t in (q, pool_k, pool_v, tab, kw["pad"],
                                   part_acc, part_ml, o)]

    def old_pf_fn():
        build.check(old_pf(*ptrs, 1, CH, H, HKV, HD, P, M, pos, bq, n_split,
                           tps, HD ** -0.5, stream), "old prefill")

    old_pf_fn()
    hold(o, paged_prefill_kernel(*args, **kw), "old prefill")
    turns("paged_prefill (control)", dict(B=1, pos=pos), old_pf_fn,
          lambda: paged_prefill_kernel(*args, **kw))


def train_spread(seeds):
    """The train phase's lane comparison (8 steps through `Trainer.fit`,
    kernel lanes against reference lanes) at each of ``seeds``, which
    draw both the weights and the tokens: the spread of sound kernels'
    readings that TRAIN_LOSS_TOL and TRAIN_GNORM_RTOL are set from."""
    readings = []
    for seed in seeds:
        cfg, tokens = train_inputs(seed)
        probe = train_once(cfg, tokens, seed)[0]
        gc.collect()
        torch.cuda.empty_cache()
        ref = train_reference(cfg, tokens, seed)[0]
        d_loss, d_gn, _ = compare_train(probe.rows, ref.rows)
        row = dict(phase="train_spread", seed=seed, loss_max_abs_diff=d_loss,
                   grad_norm_max_rel_diff=d_gn,
                   losses=[r[0] for r in probe.rows],
                   ref_losses=[r[0] for r in ref.rows])
        print(json.dumps(row), flush=True)
        readings.append(row)
    print(json.dumps(dict(
        phase="train_spread_summary", seeds=list(seeds),
        loss_max_abs_diff=max(r["loss_max_abs_diff"] for r in readings),
        grad_norm_max_rel_diff=max(r["grad_norm_max_rel_diff"]
                                   for r in readings))), flush=True)


#: every CUDA source the kernels are built from
SOURCES = ["paged_attention", "paged_prefill", "flash_fwd", "flash_bwd",
           "rmsnorm"]


def all_kernels():
    """Every kernel wrapper with a launch counter."""
    from ray_lightning_tpu_torch.ops.kernels import flash
    from ray_lightning_tpu_torch.ops.kernels.paged_attention import (
        paged_attention_kernel)
    from ray_lightning_tpu_torch.ops.kernels.paged_prefill import (
        paged_prefill_kernel)
    from ray_lightning_tpu_torch.ops.kernels.rmsnorm import rms_norm_kernel

    return (paged_attention_kernel, paged_prefill_kernel, rms_norm_kernel,
            flash.flash_fwd_kernel, flash.flash_bwd_dkv_kernel,
            flash.flash_bwd_dq_kernel)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--layers", type=int, default=32,
                    help="model depth (32 = the full Llama-3-8B)")
    ap.add_argument("--train-spread", type=int, default=0, metavar="N",
                    help="only build, then run the train lanes' comparison "
                         "at seeds 0..N-1 and print each seed's readings")
    ap.add_argument("--ab-old", metavar="CSRC",
                    help="only build, then time the decode and RMSNorm "
                         "(and the dQ and prefill) in turns with an old "
                         "build of the sources in CSRC")
    args = ap.parse_args()

    # 1. device
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device available")
        return 1
    from ray_lightning_tpu_torch.ops import build

    print(nvidia_smi(), flush=True)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")

    # 2. build
    t0 = time.perf_counter()
    build.build_all(SOURCES)
    for name, text in build.build_logs.items():
        log(f"--- nvcc {name} ---\n{text}")
    print(json.dumps(dict(phase="build", sources=SOURCES,
                          nvcc_s=time.perf_counter() - t0)), flush=True)
    if args.train_spread:
        train_spread(range(args.train_spread))
        return 0
    if args.ab_old:
        ab_phase(args.ab_old)
        return 0

    # 3. kernels against their plain versions
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    rows = check_kernels(gen) + check_flash(gen)
    check_owed(gen)
    check_flash_owed(gen)
    check_rms_norm_grad(gen)

    # 4. serving at full width, through the kernel lanes
    serve_launches = serve_phase(SEED, args.layers)

    # 5. training at full width, 4 layers deep
    gc.collect()
    torch.cuda.empty_cache()
    train_launches = train_phase(SEED)

    # each kernel's launches on the path that runs it (RMSNorm: both)
    launches = {k: serve_launches.get(k, 0) + train_launches[k]
                for k in train_launches}
    meta = {
        "paged_decode": ("paged_attention_kernel", "cuda",
                         "ray_lightning_tpu_torch/ops/csrc/paged_attention.cu",
                         "ray_lightning_tpu/ops/pallas/paged_attention.py:76"),
        "paged_prefill": ("paged_prefill_kernel", "cuda",
                          "ray_lightning_tpu_torch/ops/csrc/paged_prefill.cu",
                          "ray_lightning_tpu/ops/pallas/paged_prefill.py:104"),
        "rms_norm": ("rms_norm_kernel", "cuda",
                     "ray_lightning_tpu_torch/ops/csrc/rmsnorm.cu",
                     "ray_lightning_tpu/ops/pallas/rmsnorm.py:20"),
        "flash_fwd": ("flash_fwd_kernel", "cuda",
                      "ray_lightning_tpu_torch/ops/csrc/flash_fwd.cu",
                      "ray_lightning_tpu/ops/pallas/flash.py:73"),
        "flash_bwd_dkv": ("flash_bwd_dkv_kernel", "cuda",
                          "ray_lightning_tpu_torch/ops/csrc/flash_bwd.cu",
                          "ray_lightning_tpu/ops/pallas/flash.py:166"),
        "flash_bwd_dq": ("flash_bwd_dq_kernel", "cuda",
                         "ray_lightning_tpu_torch/ops/csrc/flash_bwd.cu",
                         "ray_lightning_tpu/ops/pallas/flash.py:221"),
    }
    summary = []
    for name, (fn, route, source, replaces) in meta.items():
        mine = [r for r in rows if r["kernel"] == name]
        # decode ragged; prefill B 1 at 3968; RMSNorm N 4 (the decode's,
        # f32 gains); flash: the training step's shape (the first case)
        main_shape = mine[0] if name != "paged_prefill" else next(
            r for r in mine if r["shape"]["B"] == 1
            and r["shape"]["pos"] == PREFILL_POS[-1])
        summary.append(dict(
            name=name, route=route, source=source, replaces=replaces,
            launches=launches[fn],
            max_abs_err=max(r["max_abs_err"] for r in mine),
            ms=main_shape["kernel_ms"], plain_ms=main_shape["plain_ms"],
            bound_ms=main_shape["bound_ms"],
            bound_by=main_shape["bound_by"],
            library_ms=main_shape["library_ms"]))
    print(json.dumps({"kernels": summary}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
