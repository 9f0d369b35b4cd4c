#!/usr/bin/env python3
"""Drive the PyTorch port (`ray_lightning_tpu_torch`) on one CUDA card.

Phases, each of which raises (and so exits nonzero) on failure:

  1. device  — a CUDA card is required; prints ``nvidia-smi``'s name and
               power limit.
  2. build   — compiles the CUDA kernels from ``ops/csrc`` (one nvcc per
               source, all at once) and the Triton RMSNorm, timed.
  3. kernels — each kernel's wrapper on card tensors at the serving
               shapes of Llama-3-8B, in bf16, against its plain PyTorch
               version on the same inputs, plus the masking edge cases;
               one JSON line per shape with the kernel's, the plain
               version's and one library call's time, the least time
               the card could take, the max error and the worst share
               of the tolerance used.
  4. serve   — Llama-3-8B at full width (random weights from a seeded
               generator) served by `Scheduler` + `DecodeEngine` through
               the kernel lanes: 8 requests, prompts of 200-1500 tokens,
               32 new tokens each, half greedy and half sampled. Every
               kernel's launch counter is zeroed just before and read
               just after, and must match the count the run implies. The
               greedy half is then served again through the reference
               lanes on the same weights, teacher-forced along the kernel
               lanes' tokens, and the logits of every step are compared.

The line before the last is the kernels' JSON summary; the last line is
``{"ok": true, "device": {...}}``. Run from the repository root:
``python3 chip_smoke.py`` (``--layers N`` cuts the model's depth for a
quicker check). ``chip_faults.py`` plants known faults in the kernels and
runs these same checks on them.
"""
from __future__ import annotations

import argparse
import dataclasses
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
#: seeds every random input: weights, prompts, kernel-check tensors
SEED = 0

#: Llama-3-8B's serving shapes: slots, heads, KV heads, head dim, block
#: size, blocks per slot, model width, prefill chunk
C, H, HKV, HD, P, M, D, CH = 4, 32, 8, 128, 16, 256, 4096, 128
#: ragged decode lengths (slot 0 fills its whole table) and the prefill
#: chunk offsets the kernels are checked at
DECODE_LENGTHS = (4096, 1537, 700, 33)
PREFILL_POS = (0, 1024, 3968)


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


def bound(nbytes: float, flops: float):
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_f = flops / BF16_FLOPS_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


# ---- phase 3: kernels against their plain versions -------------------------


def tolerance_ratio(got: torch.Tensor, want: torch.Tensor):
    """(max |got - want|, the largest share of its allowance any element
    uses) under the RTOL / ATOL_RMS rule; a share above 1 fails. A
    non-finite output uses an infinite share, and so does any error on
    a row the plain version leaves all zeros."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    rms = want.pow(2).mean(dim=-1, keepdim=True).sqrt()
    share = torch.where(err == 0, torch.zeros_like(err),
                        err / (ATOL_RMS * rms + RTOL * want.abs()))
    if not bool(torch.isfinite(got).all()):
        return float("inf"), float("inf")
    return err.max().item(), share.max().item()


def hold(got: torch.Tensor, want: torch.Tensor, what: str):
    """`tolerance_ratio`, raising when the kernel is out of tolerance."""
    err, share = tolerance_ratio(got, want)
    if not share <= 1.0:
        raise AssertionError(f"{what}: max |err| {err:.4g} uses {share:.3g}x "
                             f"the tolerance")
    return err, share


def i32(x):
    return torch.tensor(x, dtype=torch.int32, device="cuda")


class KernelInputs:
    """Seeded bf16 inputs at the serving shapes: one pool of K and V
    whose slots own distinct blocks in shuffled order (block 0, the
    scratch block, is in no table)."""

    def __init__(self, gen: torch.Generator):
        self.gen = gen
        nb = 1 + C * M
        self.pool_k = self.randn(nb, P, HKV, HD)
        self.pool_v = self.randn(nb, P, HKV, HD)
        perm = torch.randperm(nb - 1, generator=gen, device="cuda") + 1
        self.tables = perm[:C * M].reshape(C, M).to(torch.int32).contiguous()

    def randn(self, *shape):
        return torch.randn(shape, generator=self.gen,
                           device="cuda").to(torch.bfloat16)

    def decode(self, lengths, pad):
        """Arguments of one decode call over all C slots."""
        return ((self.randn(C, H, HD), self.pool_k, self.pool_v,
                 self.tables, i32(list(lengths))), dict(pad=i32(list(pad))))

    def prefill(self, pos, pad):
        """Arguments of one prefill chunk over the first len(pad) rows."""
        tab = self.tables[:len(pad)].contiguous()
        return ((self.randn(len(pad), CH, H, HD), self.pool_k, self.pool_v,
                 tab, pos), dict(pad=i32(list(pad))))


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
               flops):
        b_ms, b_by = bound(nbytes, flops)
        row = dict(kernel=kernel, shape=shape, max_abs_err=err,
                   tolerance_share=share, kernel_ms=ms, plain_ms=plain_ms,
                   library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by)
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
        vis = sum(max(0, l - p) for l, p in zip(lengths, pad))
        nbytes = (2 * C * H * HD * 2 + vis * HKV * HD * 2 * 2
                  + C * M * 4 + 2 * C * 4)
        record("paged_decode", dict(C=C, H=H, Hkv=HKV, hd=HD, P=P, M=M,
                                    lengths=list(lengths), pad=list(pad)),
               err, share, ms, plain_ms, lib_ms, nbytes,
               4 * H * HD * vis)
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

    # -- paged prefill: B = 1, CH = 128 at three depths -------------------
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
                                     M=M, pos=pos, pad=list(pad)),
               err, share, ms, plain_ms, lib_ms, nbytes, 4 * H * HD * seen)
        return got

    for pos in PREFILL_POS:
        prefill_case(pos, [0])
    out = prefill_case(0, [0, 40], time_it=False)
    if bool((out[1, :40] != 0).any()) or not bool((out[1, 40:] != 0).any()):
        raise AssertionError("paged_prefill: pad-column queries not zero")

    # -- RMSNorm ----------------------------------------------------------
    w = torch.randn(D, generator=gen, device="cuda")
    for n in (128, 4):  # the last shape (decode's) is the summary's
        x = inp.randn(n, D)
        got = rms_norm_kernel(x, w)
        err, share = hold(got, rms_norm_plain(x, w), f"rms_norm N={n}")
        ms = time_ms(lambda: rms_norm_kernel(x, w))
        plain_ms = time_ms(lambda: rms_norm_plain(x, w))
        wb = w.to(torch.bfloat16)
        lib_ms = time_ms(lambda: F.rms_norm(x, (D,), wb, 1e-5))
        record("rms_norm", dict(N=n, D=D), err, share, ms, plain_ms,
               lib_ms, 2 * n * D * 2 + D * 4, 4 * n * D)
    return rows


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
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
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
    from ray_lightning_tpu_torch.ops.kernels.paged_attention import (
        paged_attention_kernel)
    from ray_lightning_tpu_torch.ops.kernels.paged_prefill import (
        paged_prefill_kernel)
    from ray_lightning_tpu_torch.ops.kernels.rmsnorm import rms_norm_kernel

    model = build_model(seed, n_layers)
    ecfg = engine_config()
    reqs = make_requests(model.cfg.vocab_size, seed)
    kernels = (paged_attention_kernel, paged_prefill_kernel,
               rms_norm_kernel)
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
    want = {"paged_attention_kernel": n_layers * probe.ticks,
            "paged_prefill_kernel": n_layers * probe.chunks,
            "rms_norm_kernel": (2 * n_layers + 1)
            * (probe.ticks + probe.chunks)}
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


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--layers", type=int, default=32,
                    help="model depth (32 = the full Llama-3-8B)")
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
    build.build_all(["paged_attention", "paged_prefill"])
    for name, text in build.build_logs.items():
        log(f"--- nvcc {name} ---\n{text}")
    nvcc_s = time.perf_counter() - t0
    from ray_lightning_tpu_torch.ops.kernels.rmsnorm import rms_norm_kernel

    t0 = time.perf_counter()
    x = torch.ones(2, 4096, dtype=torch.bfloat16, device="cuda")
    rms_norm_kernel(x, torch.ones(4096, device="cuda"))
    torch.cuda.synchronize()
    print(json.dumps(dict(phase="build", nvcc_s=nvcc_s,
                          triton_s=time.perf_counter() - t0)), flush=True)

    # 3. kernels against their plain versions
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    rows = check_kernels(gen)

    # 4. serving at full width, through the kernel lanes
    launches = serve_phase(SEED, args.layers)

    meta = {
        "paged_decode": ("paged_attention_kernel", "cuda",
                         "ray_lightning_tpu_torch/ops/csrc/paged_attention.cu",
                         "ray_lightning_tpu/ops/pallas/paged_attention.py:76"),
        "paged_prefill": ("paged_prefill_kernel", "cuda",
                          "ray_lightning_tpu_torch/ops/csrc/paged_prefill.cu",
                          "ray_lightning_tpu/ops/pallas/paged_prefill.py:104"),
        "rms_norm": ("rms_norm_kernel", "triton",
                     "ray_lightning_tpu_torch/ops/kernels/rmsnorm_triton.py",
                     "ray_lightning_tpu/ops/pallas/rmsnorm.py:20"),
    }
    summary = []
    for name, (fn, route, source, replaces) in meta.items():
        mine = [r for r in rows if r["kernel"] == name]
        main_shape = mine[-1]  # decode ragged; prefill at 3968; N=4
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
