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
  6. dist    — training across processes on the card (one rank: NCCL
               refuses two ranks on one card): (a) phase 5's fit through
               `fit_distributed(num_processes=1)` under `FSDP` in a worker
               process; (b) the same fit under `DataParallel` in this
               process (a one-rank NCCL group the strategy starts); (c) a
               `fit_distributed` run that saves at step 4
               (`ModelCheckpoint`, 23 GB of f32 weights and AdamW moments)
               and a fresh one resumed from that checkpoint through step
               8, with the bytes and the save, verify and restore
               seconds; (d) the reference's MNIST matrix: fit with
               `EarlyStopping` and `ModelCheckpoint` under `RayXlaPlugin`,
               predict from the best checkpoint in a worker, load it here
               and predict again. Every fit's per-step loss and grad_norm
               must equal phase 5's single-device kernel lane exactly (the
               same kernels at world size 1), and every fit's kernel
               launches (counted in the worker, sent back over the side
               channel) must match the counts its steps imply.
  7. sweep   — `sweep.run` on the card's pool (the probe finds one card,
               so one trial at a time, each in its own process pinned by
               ``CUDA_VISIBLE_DEVICES``): (a) three Llama trials of phase
               5's fit at lr 3e-4, 1e-3 and 0, each validating one
               held-out batch every 2 steps and reporting its loss under
               ASHA (max_t 4, grace 1, factor 2). The lr-3e-4 trial's
               rows must equal phase 5's kernel lane exactly; ASHA must
               stop the lr-0 arm, and every status must equal a replay of
               the recorded reports through a fresh scheduler; each
               trial's launches (counted in its process) must match its
               steps and validation passes; each must see card 0 only,
               and the card as free as the first did. (b) the reference's
               Tune example at one card: three MNIST trials (lr 3e-5, 0,
               1e-4), each a `fit_distributed` worker under
               `RayXlaPlugin(use_gpu=True)` reporting through the trial
               with `TuneReportCheckpointCallback`, under ASHA over the
               epochs: the lr-0 arm must be stopped (the verdict raises
               in its trial's pump), no trial's worker may still run as
               the trial returns, the same checks of card, order, free
               memory and replay as (a); the best checkpoint must
               verify, load on the card with no device given, and give
               the accuracy and validation loss its trial reported,
               where no other report lies within the loss tolerance. One
               JSON line per trial (status, iterations, wall, the start
               split, step time, peak memory, free memory at its start)
               and one per sweep (wall, the report round trip).

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
import functools
import gc
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

import torch

from ray_lightning_tpu_torch.core.callbacks import Callback, ModelCheckpoint
from ray_lightning_tpu_torch.models.llama import LlamaModule

#: wall clock when this module's imports (torch and the port's training
#: modules) ended: the second mark of a sweep trial's start split
IMPORTED_AT = time.time()

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


#: profiler sessions the decode's launch count may take (see decode_case)
PROFILE_SESSIONS = 3


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
        # a profiler session that records no device event at all has
        # lost its events (two of this script's runs on the card did, at
        # this first session of the process; the cause is not known), so
        # it is taken again, and the row says how often; a wrapper that
        # launches nothing still reads {} after the last
        for retakes in range(PROFILE_SESSIONS):
            launched = kernel_profile(
                lambda: paged_attention_kernel(*args, **kw))
            if launched:
                break
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
               profile_retakes=retakes,
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
#: the train phase's peak learning rate (AdamW, warmup 2, cosine)
TRAIN_LR = 3e-4


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


def train_once(cfg, tokens, seed: int, callbacks=(), strategy=None):
    """One `Trainer.fit` of `LlamaModule` over ``tokens`` (``strategy``
    default `SingleDevice()`); returns the StepProbe, the fit's wall
    time, the peak device memory and the parameter count."""
    from ray_lightning_tpu_torch.core.data import DataLoader
    from ray_lightning_tpu_torch.core.trainer import Trainer
    from ray_lightning_tpu_torch.models.llama import LlamaModule
    from ray_lightning_tpu_torch.parallel.strategy import SingleDevice

    probe = StepProbe()
    module = LlamaModule(cfg, lr=TRAIN_LR, warmup_steps=2,
                         total_steps=TRAIN_STEPS)
    trainer = Trainer(strategy=strategy or SingleDevice(),
                      max_steps=TRAIN_STEPS,
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
    """Returns the kernels' launch counts of the kernel-lanes fit and its
    per-step (loss, grad_norm)."""
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
    return launches, probe.rows

# ---- phase 6: training across processes -------------------------------------
#
# The workers of `fit_distributed` import this file by its name
# (`chip_smoke`; the standard pickle sends the factories below by
# reference), so everything they run is defined at module level.

#: the resume leg's first run stops and saves here; the second resumes
RESUME_AT = 4
#: limit of one `fit_distributed` call, in seconds
DIST_TIMEOUT_S = 600
#: where the phase writes its checkpoints (git-ignored; removed after)
DIST_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "rlt_logs", "chip_smoke")


#: what the workers' side-channel callables delivered (in the driver)
RECEIVED = []


def _receive(item) -> None:
    RECEIVED.append(item)


def _to_driver(item) -> None:
    """Rank 0 sends ``item`` to the driver as a callable that the
    driver's pump runs there (the side channel's trampoline)."""
    from ray_lightning_tpu_torch.runtime import session

    if session.get_actor_rank() == 0:
        session.put_queue(functools.partial(_receive, item))


class DistProbe(Callback):
    """Runs in a worker: the per-step (step, loss, grad_norm) and the host
    clock at each step's end (the metrics fetch at ``log_every_n_steps=1``
    synchronises every step), the kernels' launches over the fit (zeroed
    at its start, read at its end) and its peak device memory; rank 0
    sends them to the driver when the fit ends."""

    def on_fit_start(self, trainer, module):
        for k in all_kernels():
            k.launches = 0
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        self.rows, self.t = [], [time.perf_counter()]

    def on_train_batch_end(self, trainer, module, metrics, batch_idx):
        self.rows.append((trainer.global_step, float(metrics["loss"]),
                          float(metrics["grad_norm"])))
        self.t.append(time.perf_counter())

    def on_fit_end(self, trainer, module):
        import torch.distributed as dist

        torch.cuda.synchronize()
        _to_driver(dict(
            kind="fit", rows=self.rows, t=self.t,
            launches={k.__name__: k.launches for k in all_kernels()},
            peak=torch.cuda.max_memory_allocated(),
            strategy=type(trainer.strategy).__name__,
            world=trainer.strategy.world_size,
            backend=dist.get_backend(), device=str(trainer.strategy.device)))


class TimedLlama(LlamaModule):
    """`LlamaModule` that times a resume's restore in the worker: from
    the optimizer's construction, which the trainer runs just before the
    restore, to ``on_load_checkpoint``, which it runs just after."""

    def configure_optimizers(self):
        self._t_restore = time.perf_counter()
        return super().configure_optimizers()

    def on_load_checkpoint(self, checkpoint):
        torch.cuda.synchronize()
        _to_driver(dict(kind="restore",
                        restore_s=time.perf_counter() - self._t_restore))


class TimedCheckpoint(ModelCheckpoint):
    """`ModelCheckpoint` that times each save (DCP write, barrier, digest
    and meta.json) in the worker."""

    def _maybe_save(self, trainer, module, metrics, step_based=False):
        t0 = time.perf_counter()
        super()._maybe_save(trainer, module, metrics, step_based)
        _to_driver(dict(kind="save", step=trainer.global_step,
                        path=self.best_model_path,
                        save_s=time.perf_counter() - t0))


def dist_module(seed: int):
    cfg, _ = train_inputs(seed)
    return TimedLlama(cfg, lr=TRAIN_LR, warmup_steps=2,
                      total_steps=TRAIN_STEPS)


def dist_trainer(strategy: str, max_steps: int, seed: int,
                 ckpt_dir=None):
    from ray_lightning_tpu_torch.core.trainer import Trainer
    from ray_lightning_tpu_torch.parallel.strategy import FSDP, DataParallel

    callbacks = [DistProbe()]
    if ckpt_dir is not None:
        callbacks.append(TimedCheckpoint(dirpath=ckpt_dir,
                                         every_n_train_steps=RESUME_AT,
                                         save_top_k=-1))
    return Trainer(strategy={"fsdp": FSDP, "ddp": DataParallel}[strategy](),
                   max_steps=max_steps, log_every_n_steps=1,
                   enable_checkpointing=False, enable_progress_bar=False,
                   seed=seed, callbacks=callbacks)


def dist_data(seed: int):
    from ray_lightning_tpu_torch.core.data import DataLoader

    _, tokens = train_inputs(seed)
    return DataLoader({"tokens": tokens}, batch_size=TB)


def free_card(what: str) -> None:
    """Release the driver's cached device memory before a worker takes
    the card, and say what is free."""
    gc.collect()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    print(json.dumps(dict(phase="card_memory", before=what,
                          free_gib=free / 2**30, total_gib=total / 2**30,
                          driver_allocated_gib=torch.cuda.memory_allocated()
                          / 2**30)), flush=True)


def run_dist(kind: str, module_factory, trainer_factory, data_factory,
             **kw):
    """One `fit_distributed` / `predict_distributed` on one process (the
    card's machine holds one card; NCCL refuses two ranks on it); returns
    the result and the side channel's items by kind."""
    import chip_smoke as me  # the module the trampoline's items land in
    from ray_lightning_tpu_torch.runtime import fit as fit_mod

    me.RECEIVED.clear()
    t0 = time.perf_counter()
    res = fit_mod.run_distributed(
        kind, module_factory, trainer_factory, data_factory, 1,
        timeout=DIST_TIMEOUT_S, log_dir=os.path.join(DIST_DIR, "workers"),
        return_weights=False, **kw)
    by_kind = {}
    for item in me.RECEIVED:
        by_kind.setdefault(item["kind"], []).append(item)
    return res, by_kind, time.perf_counter() - t0


def expected_launches(steps: int):
    """The kernels' launches of ``steps`` train steps (phase 5's counts)."""
    L = TRAIN_LAYERS
    want = {k.__name__: 0 for k in all_kernels()}
    want.update(flash_fwd_kernel=2 * L * steps,
                flash_bwd_dkv_kernel=L * steps,
                flash_bwd_dq_kernel=L * steps,
                rms_norm_kernel=(4 * L + 1) * steps)
    return want


def same_steps(rows, ref_rows, what: str, problems: list):
    """``rows`` [(loss, grad_norm)] against phase 5's single-device kernel
    lane: the same kernels at world size 1 give the same numbers, so any
    difference is a fault (no tolerance)."""
    d_loss = max(abs(a[0] - b[0]) for a, b in zip(rows, ref_rows))
    d_gn = max(abs(a[1] - b[1]) for a, b in zip(rows, ref_rows))
    if len(rows) != len(ref_rows) or rows != ref_rows:
        problems.append(f"{what}: per-step loss/grad_norm differ from the "
                        f"single-device lane by {d_loss:.3g} / {d_gn:.3g}")
    return d_loss, d_gn


def fit_row(phase: str, probe: dict, wall: float, ref_rows, want,
            problems: list, **extra):
    rows = [(r[1], r[2]) for r in probe["rows"]]
    d_loss, d_gn = same_steps(rows, ref_rows, phase, problems)
    if probe["launches"] != want:
        problems.append(f"{phase}: launches {probe['launches']} != {want}")
    t = probe["t"]
    steps = [b - a for a, b in zip(t[1:], t[2:])]
    row = dict(
        phase=phase, strategy=probe["strategy"], world=probe["world"],
        backend=probe["backend"], device=probe["device"],
        steps=[r[0] for r in probe["rows"]], losses=[r[0] for r in rows],
        grad_norms=[r[1] for r in rows], loss_max_abs_diff=d_loss,
        grad_norm_max_abs_diff=d_gn,
        step_s_p50=statistics.median(steps) if steps else None,
        max_memory_allocated_gib=probe["peak"] / 2**30,
        launches=probe["launches"], call_wall_s=wall, **extra)
    print(json.dumps(row), flush=True)
    return row


def dist_phase(seed: int, ref_rows):
    """Phase 6; returns the kernels' launches over its four fits."""
    import numpy as np

    import chip_smoke as me  # the name the workers import
    from ray_lightning_tpu_torch.checkpoint import verify_checkpoint
    from ray_lightning_tpu_torch.checkpoint.io import compute_state_digest
    from ray_lightning_tpu_torch.parallel.strategy import DataParallel

    problems = []
    total = {k.__name__: 0 for k in all_kernels()}
    P = functools.partial
    shutil.rmtree(DIST_DIR, ignore_errors=True)
    os.makedirs(DIST_DIR)

    # (a) fit_distributed, FSDP, one NCCL rank
    free_card("dist_fsdp")
    _, got, wall = run_dist("fit", P(me.dist_module, seed),
                            P(me.dist_trainer, "fsdp", TRAIN_STEPS, seed),
                            P(me.dist_data, seed))
    fsdp = got["fit"][0]
    fit_row("dist_fsdp", fsdp, wall, ref_rows, expected_launches(TRAIN_STEPS),
            problems)
    if fsdp["backend"] != "nccl":
        problems.append(f"dist_fsdp ran on {fsdp['backend']}")
    for k, v in fsdp["launches"].items():
        total[k] += v

    # (b) DataParallel in this process: a one-rank NCCL group the
    # strategy starts itself
    cfg, tokens = train_inputs(seed)
    for k in all_kernels():
        k.launches = 0
    strategy = DataParallel()
    probe, wall, peak, _ = train_once(cfg, tokens, seed, strategy=strategy)
    import torch.distributed as dist

    backend = dist.get_backend()
    strategy.teardown()
    launches = {k.__name__: k.launches for k in all_kernels()}
    for k, v in launches.items():
        total[k] += v
    fit_row("dist_ddp_in_process", dict(
        rows=[(i + 1, *r) for i, r in enumerate(probe.rows)], t=probe.t,
        launches=launches, peak=peak, strategy="DataParallel", world=1,
        backend=backend, device="cuda:0"), wall, ref_rows,
        expected_launches(TRAIN_STEPS), problems)
    del probe, strategy

    # (c) resume: save at RESUME_AT, resume in a fresh job from it
    free_card("dist_resume")
    ckdir = os.path.join(DIST_DIR, "ckpt")
    disk = shutil.disk_usage(DIST_DIR)
    # the JAX package's own digest knob for 8B-scale checkpoints:
    # (relpath, size) of every file instead of 23 GB of sha256
    env = {"RLT_CKPT_DIGEST": "size"}
    _, got1, wall1 = run_dist("fit", P(me.dist_module, seed),
                              P(me.dist_trainer, "fsdp", RESUME_AT, seed,
                                ckdir), P(me.dist_data, seed), env=env)
    save = got1["save"][0]
    path = save["path"]
    nbytes = sum(os.path.getsize(os.path.join(r, f))
                 for r, _, fs in os.walk(path) for f in fs)
    t0 = time.perf_counter()
    compute_state_digest(path, "size")
    digest_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ok, reason = verify_checkpoint(path)
    verify_s = time.perf_counter() - t0
    if not ok:
        problems.append(f"verify_checkpoint({path}): {reason}")
    _, got2, wall2 = run_dist("fit", P(me.dist_module, seed),
                              P(me.dist_trainer, "fsdp", TRAIN_STEPS, seed),
                              P(me.dist_data, seed), ckpt_path=path, env=env)
    first, resumed = got1["fit"][0], got2["fit"][0]
    if [r[0] for r in resumed["rows"]] != list(
            range(RESUME_AT + 1, TRAIN_STEPS + 1)):
        problems.append(f"resume ran steps {[r[0] for r in resumed['rows']]}")
    fsdp_rows = [(r[1], r[2]) for r in fsdp["rows"]]
    fit_row("dist_resume_first", first, wall1, fsdp_rows[:RESUME_AT],
            expected_launches(RESUME_AT), problems)
    fit_row("dist_resume_second", resumed, wall2, fsdp_rows[RESUME_AT:],
            expected_launches(TRAIN_STEPS - RESUME_AT), problems,
            restore_s=got2["restore"][0]["restore_s"])
    for probe in (first, resumed):
        for k, v in probe["launches"].items():
            total[k] += v
    print(json.dumps(dict(
        phase="dist_checkpoint", path=os.path.relpath(path, DIST_DIR),
        bytes=nbytes, files=sum(len(fs) for _, _, fs in os.walk(path)),
        save_s=save["save_s"], digest_mode="size", digest_s=digest_s,
        verify_s=verify_s,
        verify=reason, restore_s=got2["restore"][0]["restore_s"],
        disk_total_gib=disk.total / 2**30, disk_free_gib=disk.free / 2**30,
        disk_free_after_save_gib=shutil.disk_usage(DIST_DIR).free / 2**30)),
        flush=True)
    shutil.rmtree(ckdir)

    # (d) the reference's matrix: fit, load the best checkpoint, predict
    from ray_lightning_tpu_torch.core.trainer import Trainer
    from ray_lightning_tpu_torch.models.mlp import MNISTClassifier
    from ray_lightning_tpu_torch.parallel.strategy import SingleDevice

    mdir = os.path.join(DIST_DIR, "mnist")
    res, _, wall = run_dist("fit", me.mnist_module,
                            P(me.mnist_trainer, mdir), me.mnist_data)
    best = res.best_model_path
    pred, _, pwall = run_dist("predict", me.mnist_module,
                              P(me.mnist_trainer, None), me.mnist_eval_data,
                              ckpt_path=best)
    # no device given: the port's default, the card
    loaded = MNISTClassifier.load_from_checkpoint(best)
    if next(loaded.model.parameters()).device.type != "cuda":
        problems.append("load_from_checkpoint built the model on "
                        f"{next(loaded.model.parameters()).device}")
    local = Trainer(strategy=SingleDevice(), enable_checkpointing=False,
                    enable_progress_bar=False).predict(
        loaded, me.mnist_eval_data())
    acc = float(np.mean(np.concatenate(local)
                        == me.mnist_eval_data().data["y"]))
    same = all(np.array_equal(a, b) for a, b in zip(pred.predictions, local))
    if not (acc >= 0.5 and same and len(pred.predictions) == len(local)):
        problems.append(f"mnist matrix: accuracy {acc}, reload predictions "
                        f"equal the fit's: {same}")
    print(json.dumps(dict(
        phase="dist_mnist", best_model_path=os.path.relpath(best, DIST_DIR),
        val_accuracy=res.metrics.get("ptl/val_accuracy"), accuracy=acc,
        reload_equals_fit=same, fit_wall_s=wall, predict_wall_s=pwall)),
        flush=True)
    shutil.rmtree(DIST_DIR)
    if problems:
        raise AssertionError("distributed training: " + "; ".join(problems))
    return total


def mnist_module(lr: float = 1e-2):
    from ray_lightning_tpu_torch.models.mlp import MNISTClassifier

    return MNISTClassifier(lr=lr)


def mnist_trainer(ckpt_dir):
    from ray_lightning_tpu_torch.core.callbacks import EarlyStopping
    from ray_lightning_tpu_torch.core.trainer import Trainer
    from ray_lightning_tpu_torch.parallel.strategy import RayXlaPlugin

    callbacks = []
    if ckpt_dir is not None:
        callbacks = [
            EarlyStopping(monitor="ptl/val_accuracy", mode="max",
                          patience=2),
            ModelCheckpoint(dirpath=ckpt_dir, monitor="ptl/val_accuracy",
                            mode="max")]
    return Trainer(strategy=RayXlaPlugin(num_workers=1), max_epochs=3,
                   enable_checkpointing=False, enable_progress_bar=False,
                   callbacks=callbacks, seed=SEED)


def mnist_data():
    from ray_lightning_tpu_torch.core.data import DataLoader
    from ray_lightning_tpu_torch.models.mlp import synthetic_mnist

    data = synthetic_mnist(1024, seed=SEED)
    return (DataLoader(data, batch_size=32, shuffle=True, seed=SEED),
            DataLoader(data, batch_size=32))


def mnist_eval_data():
    from ray_lightning_tpu_torch.core.data import DataLoader
    from ray_lightning_tpu_torch.models.mlp import synthetic_mnist

    return DataLoader(synthetic_mnist(1024, seed=SEED), batch_size=32)


# ---- phase 7: the sweep -----------------------------------------------------
#
# Trial processes import this file by its name (`chip_smoke`), as phase
# 6's workers do: the trainables, callbacks and factories below are
# module level, and the trainables go to `sweep.run` as partials.

#: the Llama trials' learning rates: phase 5's (whose steps the trial
#: must repeat bit for bit), a faster one, and 0, which cannot learn and
#: which ASHA must stop
SWEEP_LRS = (TRAIN_LR, 1e-3, 0.0)
#: a validation pass every SWEEP_VAL_EVERY steps: four reports in 8 steps
SWEEP_VAL_EVERY = 2
SWEEP_ASHA = dict(max_t=4, grace_period=1, reduction_factor=2)
#: the reference's Tune example at one card (BASELINE config 5): the
#: MNIST trials' learning rates and epochs, under ASHA over the epochs.
#: At these rates no two (trial, epoch) reports share a validation loss,
#: so the best checkpoint's reload can tell them apart; the lr-0 arm
#: cannot learn, ASHA must stop it at its first report, and a trial
#: follows it on the card
SWEEP_MNIST_LRS = (3e-5, 0.0, 1e-4)
SWEEP_MNIST_EPOCHS = 2
SWEEP_MNIST_ASHA = dict(max_t=SWEEP_MNIST_EPOCHS, grace_period=1,
                        reduction_factor=2)
#: the best checkpoint's validation loss on reload against its trial's
#: last report, relative; the phase fails unless every other report lies
#: outside it
SWEEP_LOSS_RTOL = 1e-5
#: card memory (GiB) a trial may find taken beyond what the sweep's first
#: trial found: less than one CUDA context, so a process of an earlier
#: trial left on the card shows
SWEEP_FREE_SLACK_GIB = 0.25
#: limit of one trial, in seconds
SWEEP_TRIAL_TIMEOUT_S = 600
#: where the phase keeps its trials (git-ignored; removed after)
SWEEP_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "rlt_sweeps", "chip_smoke")
#: what a trial leaves in its dir: its record, also when the scheduler
#: stops it (a stopped trial returns nothing)
TRIAL_RECORD = "smoke_record.json"


def timed_report(metrics: dict, times: list):
    """A `TuneReportCallback` that appends to ``times`` the seconds of
    each report, from the call to the scheduler's verdict (the duplex
    channel's round trip)."""
    from ray_lightning_tpu_torch.sweep.callbacks import TuneReportCallback

    class TimedReport(TuneReportCallback):
        def _fire(self, trainer, extra=None):
            t0 = time.perf_counter()
            try:
                super()._fire(trainer, extra)
            finally:
                times.append(time.perf_counter() - t0)

    return TimedReport(metrics=metrics)


class WorkerPid(Callback):
    """In a trial's `fit_distributed` worker: leaves the worker's pid in
    the trial dir (``RLT_TRIAL_DIR``, which workers inherit)."""

    def on_fit_start(self, trainer, module):
        d = os.path.join(os.environ["RLT_TRIAL_DIR"], "worker_pids")
        os.makedirs(d, exist_ok=True)
        open(os.path.join(d, str(os.getpid())), "w").close()


def live_worker_pids() -> list:
    """The pids `WorkerPid` left in this trial's dir whose processes are
    still running."""
    from ray_lightning_tpu_torch import sweep

    d = os.path.join(sweep.get_trial_dir(), "worker_pids")
    live = []
    for name in (os.listdir(d) if os.path.isdir(d) else ()):
        try:
            os.kill(int(name), 0)
        except ProcessLookupError:
            continue
        live.append(int(name))
    return live


class SweepProbe(Callback):
    """In a trial: the per-step (loss, grad_norm), the validation passes
    and the wall clock when the model is built (fit start) and when the
    first step ends. Listed before the report callback, so a stop
    verdict at a validation pass comes after it is counted."""

    def __init__(self, record: dict):
        self.record = record
        record.update(rows=[], val_passes=0)

    def on_fit_start(self, trainer, module):
        torch.cuda.synchronize()
        self.record["t_model"] = time.time()

    def on_train_batch_end(self, trainer, module, metrics, batch_idx):
        rows = self.record["rows"]
        rows.append((float(metrics["loss"]), float(metrics["grad_norm"])))
        if len(rows) == 1:
            self.record["t_first_step"] = time.time()

    def on_validation_epoch_end(self, trainer, module, metrics):
        self.record["val_passes"] += 1


def _trial_record() -> dict:
    """A trial's identity and the start of its start split: the wall
    clock of its process's start and of this module's imports, the cards
    it sees, the card memory free before it allocates anything."""
    from ray_lightning_tpu_torch.runtime import session

    free, _ = torch.cuda.mem_get_info()  # the trial's CUDA context
    return dict(t_start=session.get_session().started_at,
                t_imported=IMPORTED_AT,
                cuda_visible_devices=os.environ.get("CUDA_VISIBLE_DEVICES"),
                device_count=torch.cuda.device_count(),
                device_name=torch.cuda.get_device_name(),
                mem_free_gib=free / 2**30)


def _write_record(record: dict) -> None:
    from ray_lightning_tpu_torch import sweep

    record["t_end"] = time.time()
    with open(os.path.join(sweep.get_trial_dir(), TRIAL_RECORD), "w") as f:
        json.dump(record, f)


def llama_trainable(config, seed: int):
    """A trial of (a): phase 5's fit at ``config["lr"]`` in this trial
    process, validating one held-out batch every SWEEP_VAL_EVERY steps
    and reporting its loss. Returns (and leaves in the trial dir) its
    record: rows, launches, peak memory, the start split."""
    import numpy as np

    from ray_lightning_tpu_torch.core.callbacks import (
        MemoryMonitor,
        ThroughputMonitor,
    )
    from ray_lightning_tpu_torch.core.data import DataLoader
    from ray_lightning_tpu_torch.core.trainer import Trainer
    from ray_lightning_tpu_torch.ops import build
    from ray_lightning_tpu_torch.parallel.strategy import SingleDevice

    record = dict(lr=config["lr"], **_trial_record())
    trainer = None
    try:
        for name in ("flash_fwd", "flash_bwd", "rmsnorm"):
            build.load(name)
        record["t_kernels"] = time.time()
        for k in all_kernels():
            k.launches = 0
        torch.cuda.reset_peak_memory_stats()
        cfg, tokens = train_inputs(seed)
        val = np.random.default_rng(seed + 1).integers(
            0, TRAIN_TOKENS, (TB, TS + 1)).astype(np.int64)
        record["report_s"] = []
        trainer = Trainer(
            strategy=SingleDevice(), max_steps=TRAIN_STEPS,
            val_check_interval=SWEEP_VAL_EVERY, log_every_n_steps=1,
            enable_checkpointing=False, enable_progress_bar=False, seed=seed,
            callbacks=[SweepProbe(record), ThroughputMonitor(),
                       MemoryMonitor(log_stats=False),
                       timed_report({"loss": "val_loss"},
                                    record["report_s"])])
        trainer.fit(LlamaModule(cfg, lr=config["lr"], warmup_steps=2,
                                total_steps=TRAIN_STEPS),
                    DataLoader({"tokens": tokens}, batch_size=TB),
                    DataLoader({"tokens": val}, batch_size=TB))
        return record
    finally:
        torch.cuda.synchronize()
        metrics = trainer.callback_metrics if trainer is not None else {}
        record.update(
            launches={k.__name__: k.launches for k in all_kernels()},
            peak=torch.cuda.max_memory_allocated(),
            step_time_s=metrics.get("step_time_s"),
            hbm_peak_bytes=metrics.get("hbm_peak_bytes"))
        _write_record(record)


def sweep_mnist_trainer():
    """The reference example's trainer: `RayXlaPlugin` on the card (one
    NCCL worker), checkpoint-then-report every epoch."""
    from ray_lightning_tpu_torch.core.trainer import Trainer
    from ray_lightning_tpu_torch.parallel.strategy import RayXlaPlugin
    from ray_lightning_tpu_torch.sweep import TuneReportCheckpointCallback

    return Trainer(
        strategy=RayXlaPlugin(num_workers=1, use_gpu=True),
        max_epochs=SWEEP_MNIST_EPOCHS,
        callbacks=[WorkerPid(), TuneReportCheckpointCallback(
            metrics={"loss": "ptl/val_loss", "acc": "ptl/val_accuracy"})],
        enable_checkpointing=False, enable_progress_bar=False, seed=SEED)


def mnist_trainable(config):
    """A trial of (b): the MNIST fit through `fit_distributed` in one
    worker of its own; the worker's reports reach the sweep through this
    process's pump. A stop verdict raises in that pump, and the worker
    group must be down when it reaches here: the record lists the
    trial's workers still running as it returns."""
    import chip_smoke as me  # the name this trial's worker imports
    from ray_lightning_tpu_torch import sweep
    from ray_lightning_tpu_torch.runtime import fit_distributed

    record = dict(lr=config["lr"], **_trial_record())
    try:
        t0 = time.time()
        res = fit_distributed(
            functools.partial(me.mnist_module, config["lr"]),
            me.sweep_mnist_trainer, me.mnist_data, 1,
            return_weights=False, timeout=DIST_TIMEOUT_S,
            log_dir=os.path.join(sweep.get_trial_dir(), "workers"))
        record.update(fit_call_s=time.time() - t0,
                      val_accuracy=res.metrics["ptl/val_accuracy"])
        return record
    finally:
        record["workers_alive"] = live_worker_pids()
        _write_record(record)


def trial_line(sweep_name: str, t, record: dict, **extra) -> dict:
    """One JSON line of a trial: status, iterations, wall and start
    split."""
    row = dict(
        phase="sweep_trial", sweep=sweep_name, trial=t.trial_id,
        lr=t.config["lr"], status=t.status, iterations=t.iterations,
        losses=[h["loss"] for h in t.history],
        trial_wall_s=record["t_end"] - record["t_start"],
        imports_s=record["t_imported"] - record["t_start"],
        mem_free_gib_at_start=record["mem_free_gib"],
        cuda_visible_devices=record["cuda_visible_devices"],
        device_count=record["device_count"], **extra)
    print(json.dumps(row), flush=True)
    return row


def sweep_phase(seed: int, ref_rows):
    """Phase 7; returns the kernels' launches over the Llama trials."""
    import numpy as np

    import chip_smoke as me  # the name the trial processes import
    from ray_lightning_tpu_torch import sweep
    from ray_lightning_tpu_torch.checkpoint import verify_checkpoint
    from ray_lightning_tpu_torch.core.trainer import Trainer
    from ray_lightning_tpu_torch.models.mlp import MNISTClassifier
    from ray_lightning_tpu_torch.parallel.strategy import SingleDevice
    from ray_lightning_tpu_torch.sweep.analysis import Trial

    problems = []
    total = {k.__name__: 0 for k in all_kernels()}
    card = torch.cuda.get_device_name(0)
    shutil.rmtree(SWEEP_DIR, ignore_errors=True)

    def records(analysis):
        out = []
        for t in analysis.trials:
            with open(os.path.join(t.trial_dir, TRIAL_RECORD)) as f:
                out.append(json.load(f))
        return out

    def check_trials(analysis, recs, asha: dict):
        """What every trial of a sweep on the one card must show: card 0
        only; one trial after another (the runner saw their reports in
        trial order); the card as free at each start as at the first;
        the status and reports a replay of the histories through a fresh
        ASHA gives; the lr-0 arm, which cannot learn, stopped before
        ``max_t``."""
        replay = sweep.ASHAScheduler(metric="loss", mode="min", **asha)
        for i, (t, rec) in enumerate(zip(analysis.trials, recs)):
            if (rec["cuda_visible_devices"], rec["device_count"],
                    rec["device_name"]) != ("0", 1, card):
                problems.append(
                    f"{t.trial_id} saw CUDA_VISIBLE_DEVICES="
                    f"{rec['cuda_visible_devices']}, {rec['device_count']} "
                    f"card(s) ({rec['device_name']})")
            if i and rec["t_start"] < recs[i - 1]["t_end"]:
                problems.append(f"{t.trial_id} started before "
                                f"{analysis.trials[i - 1].trial_id} ended")
            if i and (rec["mem_free_gib"]
                      < recs[0]["mem_free_gib"] - SWEEP_FREE_SLACK_GIB):
                problems.append(
                    f"{t.trial_id} found {rec['mem_free_gib']:.3f} GiB "
                    f"free, {recs[0]['mem_free_gib']:.3f} before the first "
                    "trial")
            status, seen = Trial.DONE, 0
            for seen, h in enumerate(t.history, start=1):
                if replay.on_result(t.trial_id, seen, h["loss"]) == "stop":
                    status = Trial.STOPPED
                    break
            if (status, seen) != (t.status, t.iterations):
                problems.append(f"{t.trial_id}: {t.status} after "
                                f"{t.iterations} reports; the replay says "
                                f"{status} after {seen}")
        arm = next(t for t in analysis.trials if t.config["lr"] == 0.0)
        if not (arm.status == Trial.STOPPED
                and arm.iterations < asha["max_t"]):
            problems.append(f"the lr-0 arm ended {arm.status} after "
                            f"{arm.iterations} reports")

    # (a) Llama-3-8B trials, one card, so one at a time
    free_card("sweep_llama")
    t0 = time.perf_counter()
    llama = sweep.run(
        functools.partial(me.llama_trainable, seed=seed),
        config={"lr": sweep.grid_search(list(SWEEP_LRS))}, metric="loss",
        mode="min", scheduler=sweep.ASHAScheduler(**SWEEP_ASHA),
        executor="process", resources_per_trial=sweep.GpuResources(gpus=1),
        storage_dir=os.path.join(SWEEP_DIR, "llama"),
        trial_timeout=SWEEP_TRIAL_TIMEOUT_S)
    llama_wall = time.perf_counter() - t0
    recs = records(llama)
    check_trials(llama, recs, SWEEP_ASHA)
    L = TRAIN_LAYERS
    round_trips = []
    for t, rec in zip(llama.trials, recs):
        steps = len(rec["rows"])
        passes = steps // SWEEP_VAL_EVERY
        if (t.iterations, rec["val_passes"]) != (passes, passes):
            problems.append(f"{t.trial_id}: {steps} steps, "
                            f"{rec['val_passes']} validation passes, "
                            f"{t.iterations} reports")
        want = expected_launches(steps)
        want["flash_fwd_kernel"] += L * passes
        want["rms_norm_kernel"] += (2 * L + 1) * passes
        if rec["launches"] != want:
            problems.append(f"{t.trial_id}: launches {rec['launches']} "
                            f"!= {want}")
        for k, v in rec["launches"].items():
            total[k] += v
        rows = [tuple(r) for r in rec["rows"]]
        same = None
        if t.config["lr"] == TRAIN_LR:
            same = rows == ref_rows[:steps]
            if not same:
                problems.append(f"{t.trial_id} (lr {TRAIN_LR}): rows differ "
                                "from phase 5's kernel lane")
        round_trips += rec["report_s"]
        trial_line(
            "llama", t, rec, steps=steps, val_passes=rec["val_passes"],
            kernels_s=rec["t_kernels"] - rec["t_imported"],
            model_s=rec["t_model"] - rec["t_kernels"],
            first_step_s=rec["t_first_step"] - rec["t_model"],
            step_ms_mean=(rec["step_time_s"] * 1e3
                          if rec["step_time_s"] else None),
            peak_gib=rec["peak"] / 2**30,
            hbm_peak_gib=(rec["hbm_peak_bytes"] / 2**30
                          if rec["hbm_peak_bytes"] else None),
            report_ms=[s * 1e3 for s in rec["report_s"]],
            rows_equal_phase5=same, launches=rec["launches"])
    print(json.dumps(dict(
        phase="sweep", sweep="llama", trials=len(llama.trials),
        wall_s=llama_wall, best_config=llama.best_config,
        statuses=[t.status for t in llama.trials],
        report_round_trip_ms_p50=statistics.median(round_trips) * 1e3,
        report_round_trip_ms_max=max(round_trips) * 1e3,
        reports=len(round_trips))), flush=True)

    # (b) the reference's Tune example: sweep driver -> trial process ->
    # fit_distributed worker (NCCL), checkpoint-then-report every epoch,
    # under ASHA: the stopped arm's verdict raises in its trial's pump,
    # which must take its worker off the card before the next trial
    free_card("sweep_mnist")
    t0 = time.perf_counter()
    mnist = sweep.run(
        me.mnist_trainable,
        config={"lr": sweep.grid_search(list(SWEEP_MNIST_LRS))},
        metric="loss", mode="min",
        scheduler=sweep.ASHAScheduler(**SWEEP_MNIST_ASHA),
        executor="process", resources_per_trial=sweep.GpuResources(gpus=1),
        storage_dir=os.path.join(SWEEP_DIR, "mnist"),
        trial_timeout=SWEEP_TRIAL_TIMEOUT_S)
    mnist_wall = time.perf_counter() - t0
    recs = records(mnist)
    check_trials(mnist, recs, SWEEP_MNIST_ASHA)
    for t, rec in zip(mnist.trials, recs):
        if (len(t.checkpoints) != t.iterations
                or (t.status == Trial.DONE
                    and t.iterations != SWEEP_MNIST_EPOCHS)):
            problems.append(f"{t.trial_id}: {t.status}, {t.iterations} "
                            f"reports, {len(t.checkpoints)} checkpoints")
        if rec["workers_alive"]:
            problems.append(f"{t.trial_id}: worker(s) "
                            f"{rec['workers_alive']} still ran as the trial "
                            "returned")
        trial_line("mnist", t, rec, fit_call_s=rec.get("fit_call_s"),
                   accs=[h["acc"] for h in t.history],
                   checkpoints=len(t.checkpoints),
                   workers_alive_at_return=rec["workers_alive"])
    best_trial = mnist.best_trial
    best = mnist.best_checkpoint
    ok, reason = verify_checkpoint(best)
    if not ok:
        problems.append(f"verify_checkpoint({best}): {reason}")
    # no device given: the port's default, the card
    loaded = MNISTClassifier.load_from_checkpoint(best)
    device = next(loaded.model.parameters()).device
    if device.type != "cuda":
        problems.append(f"load_from_checkpoint built the model on {device}")
    evaluator = Trainer(strategy=SingleDevice(), enable_checkpointing=False,
                        enable_progress_bar=False)
    preds = np.concatenate(evaluator.predict(loaded, me.mnist_eval_data()))
    acc = float(np.mean(preds == me.mnist_eval_data().data["y"]))
    loss = float(evaluator.validate(loaded, me.mnist_data()[1])[
        "ptl/val_loss"])
    reported = best_trial.last_result
    tol = SWEEP_LOSS_RTOL * abs(reported["loss"])
    if acc != reported["acc"] or abs(loss - reported["loss"]) > tol:
        problems.append(f"the best checkpoint gives accuracy {acc}, loss "
                        f"{loss}; its trial reported {reported['acc']}, "
                        f"{reported['loss']} (loss to {tol})")
    # the reload check must be able to fail: no other report of the
    # sweep (another trial, an earlier epoch) lies inside its tolerance
    others = [h["loss"] for t in mnist.trials
              for h in (t.history[:-1] if t is best_trial else t.history)]
    gap = min(abs(v - reported["loss"]) for v in others)
    if gap <= tol:
        problems.append(f"another report's loss lies {gap} from the best "
                        f"one's, inside the reload tolerance {tol}")
    print(json.dumps(dict(
        phase="sweep", sweep="mnist", trials=len(mnist.trials),
        wall_s=mnist_wall, best_config=mnist.best_config,
        statuses=[t.status for t in mnist.trials],
        best_checkpoint=os.path.relpath(best, SWEEP_DIR),
        reload_device=str(device), reload_accuracy=acc,
        reported_accuracy=reported["acc"], reload_loss=loss,
        reported_loss=reported["loss"], loss_tolerance=tol,
        nearest_other_loss_gap=gap)), flush=True)
    del loaded
    shutil.rmtree(SWEEP_DIR)
    if problems:
        raise AssertionError("sweep: " + "; ".join(problems))
    return total


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
    train_launches, train_rows = train_phase(SEED)

    # 6. training across processes: fit_distributed under FSDP,
    # DataParallel in this process, a checkpoint and its resume, and the
    # MNIST train/load/predict matrix
    dist_launches = dist_phase(SEED, train_rows)

    # 7. the sweep: Llama-3-8B trials under ASHA, each in its own process
    # on the card, and the reference's Tune example over fit_distributed
    sweep_launches = sweep_phase(SEED, train_rows)

    # each kernel's launches on the paths that run it
    launches = {k: serve_launches.get(k, 0) + train_launches[k]
                + dist_launches[k] + sweep_launches[k]
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
