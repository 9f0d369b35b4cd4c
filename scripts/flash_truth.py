"""The flash backward kernels and their plain versions against an f64
reference, on the card.

For each seed and shape (phase 17's ring block at Llama-3-8B's width and
the training step's), the dQ and dK of the hand-written kernels and of
their plain versions (`chip_smoke.FlashCase`, the same seeded bf16
inputs) are held against dQ and dK computed in f64 from the same inputs
(`chip_smoke.f64_attention`): each one's largest and rms error; the largest
share of `chip_smoke`'s tolerance the kernel uses against its plain
version (the rms over each head's slab, `SLAB`), the row where it falls
and the three values there; and the share under `chip_smoke.truth_ratio`,
the rule phase 17's flash rows are held to. One JSON line a (seed,
shape).

Run from the repo root on a machine with the card:
    python3 scripts/flash_truth.py [--seeds 4] [--only "ring block causal"]
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, default=4)
    ap.add_argument("--only", choices=["ring block causal", "train causal"],
                    help="one shape alone")
    args = ap.parse_args()
    from ray_lightning_tpu_torch.ops import build

    build.build_all(["flash_fwd", "flash_bwd"])
    gen = torch.Generator(device="cuda")
    shapes = {"ring block causal": cs.FLASH_OWED_17["ring block causal"],
              "train causal": cs.FLASH_CASES["train causal"]}
    if args.only:
        shapes = {args.only: shapes[args.only]}
    for seed in range(args.seeds):
        gen.manual_seed(seed)
        for name, dims in shapes.items():
            case = cs.FlashCase(gen, *dims)
            ref = cs.f64_attention(case.q, case.k, case.v, case.do,
                                   *case.args)
            got = {"dk": case.dkv()[0], "dq": case.dq()}
            plain = {"dk": case.dkv_plain()[0], "dq": case.dq_plain()}
            out = {"seed": seed, "case": name, "shape": dims}
            for nm in ("dq", "dk"):
                a, b, t = got[nm], plain[nm], ref[nm]
                err = (a.float() - b.float()).abs()
                rms = b.float().pow(2).mean(dim=cs.SLAB, keepdim=True).sqrt()
                share = err / (cs.ATOL_RMS * rms + cs.RTOL * b.float().abs())
                at = tuple(torch.nonzero(share == share.max())[0].tolist())
                out[nm] = dict(
                    slab_share=share.max().item(), row=at[1],
                    truth_rule_share=cs.truth_ratio(a, b, t)[1],
                    at_kernel=a[at].item(), at_plain=b[at].item(),
                    at_f64=t[at].item(),
                    kernel_vs_f64_max=(a.double() - t).abs().max().item(),
                    plain_vs_f64_max=(b.double() - t).abs().max().item(),
                    kernel_vs_f64_rms=(a.double() - t).pow(2).mean()
                    .sqrt().item(),
                    plain_vs_f64_rms=(b.double() - t).pow(2).mean()
                    .sqrt().item())
            print(json.dumps(out), flush=True)
            del case, ref, got, plain
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
