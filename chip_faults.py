#!/usr/bin/env python3
"""Plant known faults in the CUDA kernels and report which of
`chip_smoke.py`'s checks reject them.

Each fault is one textual change to one kernel source. It is made in a
copy of ``ray_lightning_tpu_torch/ops/csrc`` under
``ray_lightning_tpu_torch/ops/build/planted/<fault>/`` (git-ignored) and
built from there; the sources themselves are never touched. A sound
control (the sources as they are) runs first, then each fault. A paged or
RMSNorm (serving) fault goes through the serving checks:

  kernels — the kernel against its plain version on chip_smoke's inputs,
            per decode slot (lengths 4096 / 1537 / 700 / 33), per prefill
            case (offsets 0 / 1024 / 3968, and the two-row chunks with a
            pad) and per RMSNorm case (chip_smoke's RMS_CASES): the share
            of chip_smoke's tolerance that the worst element uses (above
            1 rejects), beside its share of a flat |err| <= 2e-2 +
            2e-2 |b|.
  lanes   — the greedy half of chip_smoke's requests served through the
            kernel lanes built from those sources, then chip_smoke's
            teacher-forced comparison with the reference lanes.

A flash (training) fault goes through the training checks:

  kernels — every output of the three flash kernels (O, lse; dK, dV; dQ)
            against its plain version at chip_smoke's flash shapes, the
            training shape first: the worst share of the tolerance.
  lanes   — chip_smoke's 8-step `Trainer.fit` through the kernels built
            from those sources, its per-step loss and grad_norm against
            the reference lanes' (run once, they use no kernel).

A mask that admits one position past the slot's length changes nothing
at length 4096: the slot's table ends there. A dQ that reads KV head
``h % Hkv``, or a dK/dV that walks only the first query head of its GQA
group, is right for MHA, where the group is one head. The prefill's
merge of split partials (``paged_common.cuh``) is its own; the prefill at
position 0 walks one range and launches no merge. The decode merges its
ranges inside a cluster: at length 33 the one tile is the last range's,
so a merge that drops the last range drops the whole slot. The serving
model's RMSNorm gains are all one, so a kernel that ignores the gain
shows only in the kernel check, whose gains are random.

Prints one JSON line per run, then a summary line; exits 0 when the
control passes both checks and the kernel check rejects every fault.
Run from the repository root: ``python3 chip_faults.py`` (about five
minutes on one H100, with the full 32-layer model for serving).

``--bert`` runs phase 16's checks instead, on the flash faults that
BERT-base's attention (bidirectional, MHA, head dim 64) can show and on
three small ones (O or dV scaled by 1.01; one (head, batch row) block of
384 skipping its last KV tile in dQ):

  kernels — the three flash kernels at ``BERT_FLASH_CASES`` and FLASH_OWED's
            "bert S 512": the worst share of the tolerance.
  lanes   — 16 (b)'s BERT-base fit through the kernels built from those
            sources against the reference lane's rows, each gap of
            `chip_smoke.compare_bert` beside its limit.

At S 128 the forward walks one KV tile, so a missing rescale shows only
at S 512. It exits 0 when the control passes both checks and the kernel
check rejects every fault taken from FAULTS; the small ones are reported
(about two minutes on one H100).

``--axes`` runs phase 17's flash checks instead, on every flash fault of
FAULTS and the three small ones:

  kernels — the three flash kernels at ``FLASH_OWED_17`` (the ring's
            blocks, Ulysses' heads), held as phase 3 holds those rows:
            O and lse by `chip_smoke.tolerance_ratio`, the gradients by
            `chip_smoke.truth_ratio` (an f64 reference); beside it the
            gradients' share under `tolerance_ratio` alone (the rule of
            every other flash row).
  ring    — 17 (b)'s ring at B 1, S 8192, H 32, Hkv 8, hd 128, causal,
            its two ranks driven in this process (`ring_attention_ranks`
            over a `LocalShift`): O, dQ, dK and dV of the kernel lane
            against the plain-version lane by `truth_ratio`, as 17 (b)
            holds them, beside `tolerance_ratio`; and each lane's largest
            and rms error against the f64 reference.

It exits 0 when the control passes both checks and the kernel check
rejects every fault taken from FAULTS (about five minutes on one H100).
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import shutil
import sys

import torch

import chip_smoke as smoke

#: fault -> (source file, text, the text planted in its place)
FAULTS = {
    "decode_mask_off_by_one": (
        "paged_attention.cu", "w.hi[h2] = hi;", "w.hi[h2] = hi + 1;"),
    "decode_last_tile_skipped": (
        "paged_attention.cu", "n_tiles = run.y - run.x;",
        "n_tiles = run.y - run.x - 1;"),
    "decode_merge_drops_last_range": (
        "paged_attention.cu", "      if (s < R) {", "      if (s < R - 1) {"),
    "decode_range_plan_uncovers_a_tile": (
        "paged_attention.cu", "(hi + kTile - 1) / kTile - t0",
        "hi / kTile - t0"),
    "prefill_mask_off_by_one": (
        "paged_prefill.cu", "min(kv_limit, pos + j + 1)",
        "min(kv_limit, pos + j + 2)"),
    "prefill_last_tile_skipped": (
        "paged_prefill.cu", "(hi_max + C::kN - 1) / C::kN);",
        "(hi_max + C::kN - 1) / C::kN - 1);"),
    "prefill_wrong_pool_block": (
        "paged_prefill.cu", "(int64_t)trow[kv / P] * P + kv % P",
        "(int64_t)trow[t * C::kN / P] * P + kv % P"),
    "prefill_merge_drops_last_split": (
        "paged_common.cuh", "for (int s = 0; s < n_split; ++s) {",
        "for (int s = 0; s < n_split - 1; ++s) {"),
    "rms_sumsq_misses_scalar_tail": (
        "rmsnorm.cu", "for (int j = tail + t; j < D; j += G) {  // the scalar tail",
        "for (int j = D + t; j < D; j += G) {  // the scalar tail"),
    "rms_sumsq_misses_last_vector": (
        "rmsnorm.cu", "if (t + k * G < nvec) ss += xv[k].sumsq();",
        "if (t + k * G < nvec - 1) ss += xv[k].sumsq();"),
    "rms_w_ignored_on_one_vector": (
        "rmsnorm.cu", "to_f(xv[k].v[e]) * rstd * to_f(wv[k].v[e])",
        "to_f(xv[k].v[e]) * rstd * (i == 0 ? 1.f : to_f(wv[k].v[e]))"),
    "flash_fwd_mask_off_by_one": (
        "flash_fwd.cu", "min(Sk, q_offset + qi[h2] + 1) : Sk;",
        "min(Sk, q_offset + qi[h2] + 2) : Sk;"),
    "flash_fwd_last_tile_skipped": (
        "flash_fwd.cu", "const int n_tiles = kv_tiles_seen<",
        "const int n_tiles = -1 + kv_tiles_seen<"),
    "flash_fwd_no_rescale": (
        "flash_fwd.cu", "acc[i] *= corr[(i >> 1) & 1];", "acc[i] *= 1.f;"),
    "flash_dkv_no_delta": (
        "flash_bwd.cu", "dpt[i] = st[i] * (dpt[i] - sd[col]) * scale;",
        "dpt[i] = st[i] * dpt[i] * scale;"),
    "flash_dkv_last_q_tile_skipped": (
        "flash_bwd.cu", "const int per_head = nq - qt_lo;",
        "const int per_head = nq - qt_lo - 1;"),
    "flash_dkv_first_head_only": (
        "flash_bwd.cu", "const int n_items = n_rep * per_head;",
        "const int n_items = per_head;"),
    "flash_dq_kv_head_mod": (
        "flash_bwd.cu", "const int kvh = h / (H / Hkv);",
        "const int kvh = h % Hkv;"),
    "flash_dq_last_tile_skipped": (
        "flash_bwd.cu", "const int n_tiles = kv_tiles_seen<",
        "const int n_tiles = -1 + kv_tiles_seen<"),
    "flash_dq_no_delta": (
        "flash_bwd.cu", "dp[i] = sc[i] * (dp[i] - row_delta[e >> 1]) * scale;",
        "dp[i] = sc[i] * dp[i] * scale;"),
}
#: ``--bert``: the faults of FAULTS that BERT's attention can show
BERT_FAULTS = ("flash_fwd_last_tile_skipped", "flash_fwd_no_rescale",
               "flash_dkv_no_delta", "flash_dkv_last_q_tile_skipped",
               "flash_dq_last_tile_skipped", "flash_dq_no_delta")
#: ``--bert``: faults within the elementwise tolerance (a 1% scale) or
#: confined to one (head, batch row) block of BERT's 384 in dQ
SMALL_FAULTS = {
    "flash_fwd_o_scaled_1.01": (
        "flash_fwd.cu", "const float inv = l[h2] == 0.f ? 0.f : 1.f / l[h2];",
        "const float inv = l[h2] == 0.f ? 0.f : 1.01f / l[h2];"),
    "flash_dv_scaled_1.01": (
        "flash_bwd.cu",
        "pack2(dv_acc[4 * j + 2 * h2], dv_acc[4 * j + 2 * h2 + 1]);",
        "pack2(1.01f * dv_acc[4 * j + 2 * h2], "
        "1.01f * dv_acc[4 * j + 2 * h2 + 1]);"),
    "flash_dq_one_block_last_tile_skipped": (
        "flash_bwd.cu", "const int n_tiles = kv_tiles_seen<",
        "const int n_tiles = -(h == 0 && b == 0) + kv_tiles_seen<"),
}
#: every kernel source, built together from the sources or a planted copy
SOURCES = smoke.SOURCES
#: ``--bert``: the sources BERT's fit launches
BERT_SOURCES = ["flash_fwd", "flash_bwd"]
#: ``--bert``: the flash shapes of phase 16
BERT_CASES = {**smoke.BERT_FLASH_CASES,
              "bert S 512": smoke.FLASH_OWED["bert S 512"]}
#: the flat tolerance, |err| <= FLAT + FLAT |b|, shown for comparison
FLAT = 2e-2
#: ``--axes``: the flash faults of FAULTS (every one shows at the ring's
#: shapes: causal and full blocks, GQA)
AXES_FAULTS = tuple(f for f in FAULTS if f.startswith("flash"))


def use_sources(fault, sources=SOURCES):
    """Build ``sources`` from the kernel sources (``fault`` None) or from
    a copy with ``fault`` planted, and make the wrappers load those
    builds."""
    from ray_lightning_tpu_torch.ops import build

    csrc = os.path.join(os.path.dirname(build.__file__), "csrc")
    out = os.path.join(os.path.dirname(build.__file__), "build")
    if fault is not None:
        out = os.path.join(out, "planted", fault)
        planted = os.path.join(out, "csrc")
        shutil.rmtree(planted, ignore_errors=True)
        shutil.copytree(csrc, planted)
        src, text, new = {**FAULTS, **SMALL_FAULTS}[fault]
        path = os.path.join(planted, src)
        with open(path) as f:
            code = f.read()
        if code.count(text) != 1:
            raise RuntimeError(f"{fault}: {text!r} is not in {src} once")
        with open(path, "w") as f:
            f.write(code.replace(text, new))
        csrc = planted
    build.CSRC, build.BUILD = csrc, out
    build._libs.clear()  # the wrappers' next call loads the new builds
    build.build_all(sources)


def flat_share(got, want) -> float:
    got, want = got.float(), want.float()
    if not bool(torch.isfinite(got).all()):
        return float("inf")
    return ((got - want).abs() / (FLAT + FLAT * want.abs())).max().item()


class KernelCases:
    """chip_smoke's decode, prefill and RMSNorm inputs and their plain
    outputs."""

    def __init__(self):
        from ray_lightning_tpu_torch.ops.kernels.paged_attention import (
            paged_attention_plain)
        from ray_lightning_tpu_torch.ops.kernels.paged_prefill import (
            paged_prefill_plain)

        gen = torch.Generator(device="cuda")
        gen.manual_seed(smoke.SEED)
        inp = smoke.KernelInputs(gen)
        self.decode = inp.decode(smoke.DECODE_LENGTHS, [0] * smoke.C)
        self.decode_want = paged_attention_plain(*self.decode[0],
                                                 **self.decode[1])
        self.prefill_cases = [(pos, (0,)) for pos in smoke.PREFILL_POS] + \
            list(smoke.PREFILL_PADS)
        self.prefill = [inp.prefill(pos, list(pad))
                        for pos, pad in self.prefill_cases]
        self.prefill_want = [paged_prefill_plain(*a, **kw)
                             for a, kw in self.prefill]
        from ray_lightning_tpu_torch.ops.kernels.rmsnorm import (
            rms_norm_plain)

        self.rms = []
        for n, d, wdt in smoke.RMS_CASES:
            x, w = smoke.rms_inputs(gen, n, d, wdt)
            self.rms.append((f"rms_norm N={n} D={d} w={wdt}".replace(
                "torch.", ""), x, w, rms_norm_plain(x, w)))

    def shares(self):
        """{shape: (share of chip_smoke's tolerance, flat share)}"""
        from ray_lightning_tpu_torch.ops.kernels.paged_attention import (
            paged_attention_kernel)
        from ray_lightning_tpu_torch.ops.kernels.paged_prefill import (
            paged_prefill_kernel)
        from ray_lightning_tpu_torch.ops.kernels.rmsnorm import (
            rms_norm_kernel)

        out = {}
        got = paged_attention_kernel(*self.decode[0], **self.decode[1])
        for c, length in enumerate(smoke.DECODE_LENGTHS):
            want = self.decode_want[c]
            out[f"decode length={length}"] = (
                smoke.tolerance_ratio(got[c], want)[1],
                flat_share(got[c], want))
        for (pos, pad), (a, kw), want in zip(self.prefill_cases, self.prefill,
                                             self.prefill_want):
            got = paged_prefill_kernel(*a, **kw)
            name = f"prefill pos={pos}" + (f" pad={list(pad)}" if any(pad)
                                           else "")
            out[name] = (smoke.tolerance_ratio(got, want)[1],
                         flat_share(got, want))
        for name, x, w, want in self.rms:
            got = rms_norm_kernel(x, w)
            out[name] = (smoke.tolerance_ratio(got, want)[1],
                         flat_share(got, want))
        return out


def lanes(model, reqs):
    """chip_smoke's lanes comparison over ``reqs`` (greedy), served
    through the kernel lanes as they are built now."""
    ecfg = smoke.engine_config()
    engine, sched, probe = smoke.serve(model, ecfg, use_kernels=None)
    done = smoke.drain(sched, reqs)
    del engine, sched
    return smoke.compare_lanes(model, ecfg, reqs, probe, done)


def flash_shares(cases=None):
    """{"<case> <output>": share of chip_smoke's tolerance} of the three
    flash kernels as they are built now, at ``cases`` (chip_smoke's
    flash shapes by default)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(smoke.SEED)
    out = {}
    for name, dims in (cases or smoke.FLASH_CASES).items():
        shares = smoke.FlashCase(gen, *dims).shares()
        out.update({f"{name} {k}": v[1] for k, v in shares.items()})
        torch.cuda.empty_cache()
    return out


def serve_run(fault, cases, model, greedy):
    shares = cases.shares()
    row = dict(fault=fault or "none",
               kernel_share={k: v[0] for k, v in shares.items()},
               flat_share={k: v[1] for k, v in shares.items()})
    row["kernel_rejects"] = [k for k, v in shares.items()
                             if not v[0] <= 1.0]
    row["flat_rejects"] = [k for k, v in shares.items()
                           if not v[1] <= 1.0]
    lane_row, problems = lanes(model, greedy)
    row["lanes"] = {k: v for k, v in lane_row.items()
                    if k != "argmax_differs"}
    row["lanes"]["argmax_differs"] = len(lane_row["argmax_differs"])
    row["lanes_rejects"] = bool(problems)
    row["lanes_problems"] = problems[:3]
    return row


def train_run(fault, ref_rows):
    shares = flash_shares()
    row = dict(fault=fault or "none", kernel_share=shares)
    row["kernel_rejects"] = [k for k, v in shares.items()
                             if not v <= 1.0]
    cfg, tokens = smoke.train_inputs(smoke.SEED)
    probe = smoke.train_once(cfg, tokens, smoke.SEED)[0]
    d_loss, d_gn, problems = smoke.compare_train(probe.rows, ref_rows)
    row["lanes"] = dict(losses=[r[0] for r in probe.rows],
                        loss_max_abs_diff=d_loss,
                        grad_norm_max_rel_diff=d_gn)
    row["lanes_rejects"] = bool(problems)
    row["lanes_problems"] = problems[:3]
    gc.collect()
    torch.cuda.empty_cache()
    return row


def bert_run(fault, ref_rows):
    """One ``--bert`` run: the flash kernels as built now at BERT_CASES,
    and 16 (b)'s kernel-lane fit against ``ref_rows``."""
    shares = flash_shares(BERT_CASES)
    row = dict(fault=fault or "none", kernel_share=shares)
    row["kernel_rejects"] = [k for k, v in shares.items()
                             if not v <= 1.0]
    cfg, data = smoke.bert_inputs(smoke.SEED)
    probe = smoke.bert_fit(cfg, data, smoke.SEED)[0]
    gaps, problems = smoke.compare_bert(probe.rows, ref_rows)
    row["lanes"] = dict(losses=[r[0] for r in probe.rows],
                        grad_norms=[r[1] for r in probe.rows],
                        **{k: v[0] for k, v in gaps.items()})
    row["lanes_rejects"] = [k for k, (got, tol) in gaps.items()
                            if not got <= tol]
    row["lanes_problems"] = problems
    return row


def bert_main() -> int:
    from ray_lightning_tpu_torch.ops import dispatch

    use_sources(None, BERT_SOURCES)
    cfg, data = smoke.bert_inputs(smoke.SEED)
    with dispatch.force_reference():
        ref_rows = smoke.bert_fit(cfg, data, smoke.SEED)[0].rows
    rows = {}
    for fault in [None, *BERT_FAULTS, *SMALL_FAULTS]:
        if fault is not None:
            use_sources(fault, BERT_SOURCES)
        row = bert_run(fault, ref_rows)
        print(json.dumps(row), flush=True)
        rows[row["fault"]] = row
    control = rows.pop("none")
    control_passes = not (control["kernel_rejects"]
                          or control["lanes_rejects"])
    ok = control_passes and all(rows[f]["kernel_rejects"]
                                for f in BERT_FAULTS)
    print(json.dumps(dict(
        control_passes=control_passes,
        kernel_check_rejects={k: bool(v["kernel_rejects"])
                              for k, v in rows.items()},
        lanes_check_rejects={k: v["lanes_rejects"] for k, v in rows.items()},
        ok=ok)), flush=True)
    return 0 if ok else 1


def axes_flash_shares():
    """{"<case> <output>": (share by phase 3's rule, share by
    `tolerance_ratio` alone)} of the flash kernels as built now at
    FLASH_OWED_17; the gradients' two rules differ, O's and lse's not."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(smoke.SEED)
    out = {}
    for name, dims in smoke.FLASH_OWED_17.items():
        case = smoke.FlashCase(gen, *dims)
        held = case.shares(truth=True)
        strict = case.shares()
        out.update({f"{name} {k}": (v[1], strict[k][1])
                    for k, v in held.items()})
        del case
        torch.cuda.empty_cache()
    return out


class RingCase:
    """17 (b)'s inputs, the f64 reference and the plain-version lane
    (the wrappers' plain versions under `force_reference`: no kernel, so
    the same for every fault), per rank."""

    def __init__(self):
        gen = torch.Generator(device="cuda")
        gen.manual_seed(smoke.SEED)
        B, S, H, Hkv, hd = smoke.RING_B, smoke.RING_S, smoke.TH, \
            smoke.THKV, smoke.HD
        rn = lambda *s: torch.randn(s, generator=gen,  # noqa: E731
                                    device="cuda").to(torch.bfloat16)
        self.q, self.k, self.v = rn(B, S, H, hd), rn(B, S, Hkv, hd), \
            rn(B, S, Hkv, hd)
        self.do = rn(B, S, H, hd)
        self.n = smoke.AXES_RANKS
        ref = smoke.f64_attention(self.q, self.k, self.v, self.do, True)
        self.ref = {k: self.chunks(t) for k, t in ref.items()}
        del ref
        torch.cuda.empty_cache()
        self.plain = self.run(reference=True)

    def chunks(self, t) -> list:
        cut = t.shape[1] // self.n
        return [t[:, r * cut:(r + 1) * cut].contiguous()
                for r in range(self.n)]

    def run(self, reference=False) -> dict:
        """{output: per-rank tensors} of the ring, both ranks here."""
        import contextlib

        from ray_lightning_tpu_torch.ops import dispatch
        from ray_lightning_tpu_torch.ops.ring_attention import (
            ring_attention_ranks)

        qs, ks, vs = ([c.requires_grad_() for c in self.chunks(t)]
                      for t in (self.q, self.k, self.v))
        ctx = (dispatch.force_reference() if reference
               else contextlib.nullcontext())
        with ctx:
            outs = ring_attention_ranks(qs, ks, vs, causal=True)
            torch.autograd.backward(outs, self.chunks(self.do))
        return {"o": [o.detach() for o in outs],
                "dq": [t.grad for t in qs], "dk": [t.grad for t in ks],
                "dv": [t.grad for t in vs]}

    def shares(self) -> dict:
        """{output: readings} of the kernel lane as built now: its share
        by 17 (b)'s rule (`truth_ratio`) and by `tolerance_ratio`, the
        worst rank's, and each lane's largest and rms error against the
        f64 reference."""
        got = self.run()
        out = {}
        for name in ("o", "dq", "dk", "dv"):
            dims = (-1,) if name == "o" else smoke.SLAB
            row = dict(rule_share=0.0, tolerance_share=0.0,
                       kernel_vs_f64_max=0.0, plain_vs_f64_max=0.0,
                       kernel_vs_f64_rms=0.0, plain_vs_f64_rms=0.0)
            for a, b, t in zip(got[name], self.plain[name], self.ref[name]):
                row["rule_share"] = max(row["rule_share"],
                                        smoke.truth_ratio(a, b, t, dims)[1])
                row["tolerance_share"] = max(
                    row["tolerance_share"],
                    smoke.tolerance_ratio(a, b, dims)[1])
                for lane, x in (("kernel", a), ("plain", b)):
                    e = x.double() - t
                    row[f"{lane}_vs_f64_max"] = max(
                        row[f"{lane}_vs_f64_max"], e.abs().max().item())
                    row[f"{lane}_vs_f64_rms"] = max(
                        row[f"{lane}_vs_f64_rms"],
                        e.pow(2).mean().sqrt().item())
            out[name] = row
        del got
        torch.cuda.empty_cache()
        return out


def axes_main() -> int:
    use_sources(None, BERT_SOURCES)
    ring = RingCase()
    rows = {}
    for fault in [None, *AXES_FAULTS, *SMALL_FAULTS]:
        if fault is not None:
            use_sources(fault, BERT_SOURCES)
        shares = axes_flash_shares()
        ring_shares = ring.shares()
        row = dict(fault=fault or "none",
                   kernel_share={k: v[0] for k, v in shares.items()},
                   strict_share={k: v[1] for k, v in shares.items()},
                   ring=ring_shares)
        row["kernel_rejects"] = [k for k, v in shares.items()
                                 if not v[0] <= 1.0]
        row["strict_rejects"] = [k for k, v in shares.items()
                                 if not v[1] <= 1.0]
        row["ring_rejects"] = [k for k, v in ring_shares.items()
                               if not v["rule_share"] <= 1.0]
        row["ring_strict_rejects"] = [k for k, v in ring_shares.items()
                                      if not v["tolerance_share"] <= 1.0]
        print(json.dumps(row), flush=True)
        rows[row["fault"]] = row
        gc.collect()
        torch.cuda.empty_cache()
    control = rows.pop("none")
    control_passes = not (control["kernel_rejects"]
                          or control["ring_rejects"])
    ok = control_passes and all(rows[f]["kernel_rejects"]
                                for f in AXES_FAULTS)
    print(json.dumps(dict(
        control_passes=control_passes,
        kernel_check_rejects={k: bool(v["kernel_rejects"])
                              for k, v in rows.items()},
        strict_rule_rejects={k: bool(v["strict_rejects"])
                             for k, v in rows.items()},
        ring_check_rejects={k: bool(v["ring_rejects"])
                            for k, v in rows.items()},
        ring_strict_rejects={k: bool(v["ring_strict_rejects"])
                             for k, v in rows.items()},
        ok=ok)), flush=True)
    return 0 if ok else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--bert", action="store_true",
                    help="only the flash faults through phase 16's checks "
                         "(BERT-base's shapes and its fit)")
    ap.add_argument("--axes", action="store_true",
                    help="only the flash faults through phase 17's checks "
                         "(the ring's and Ulysses' flash shapes and the "
                         "ring's lanes)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        smoke.log("chip_faults: no CUDA device available")
        return 1
    print(smoke.nvidia_smi(), flush=True)
    if args.bert:
        return bert_main()
    if args.axes:
        return axes_main()
    use_sources(None)
    cases = KernelCases()
    model = smoke.build_model(smoke.SEED, 32)
    greedy = [r for r in smoke.make_requests(model.cfg.vocab_size,
                                             smoke.SEED)
              if r.temperature == 0.0]
    cfg, tokens = smoke.train_inputs(smoke.SEED)
    ref_rows = smoke.train_reference(cfg, tokens, smoke.SEED)[0].rows
    verdicts = {}
    for fault in [None, *FAULTS]:
        if fault is not None:
            use_sources(fault)
        runs = []
        if fault is None or not fault.startswith("flash"):
            runs.append(serve_run(fault, cases, model, greedy))
        if fault is None or fault.startswith("flash"):
            runs.append(train_run(fault, ref_rows))
        for row in runs:
            print(json.dumps(row), flush=True)
        verdicts[fault or "none"] = dict(
            kernel_rejects=any(r["kernel_rejects"] for r in runs),
            flat_rejects=any(r.get("flat_rejects") for r in runs),
            lanes_rejects=any(r["lanes_rejects"] for r in runs))
    control = verdicts.pop("none")
    control_passes = not (control["kernel_rejects"]
                          or control["lanes_rejects"])
    ok = control_passes and all(v["kernel_rejects"]
                                for v in verdicts.values())
    print(json.dumps(dict(
        control_passes=control_passes,
        kernel_check_rejects={k: v["kernel_rejects"]
                              for k, v in verdicts.items()},
        flat_tolerance_rejects={k: v["flat_rejects"]
                                for k, v in verdicts.items()
                                if not k.startswith("flash")},
        lanes_check_rejects={k: v["lanes_rejects"]
                             for k, v in verdicts.items()},
        ok=ok)), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
