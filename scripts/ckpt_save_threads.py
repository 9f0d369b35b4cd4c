"""How long a blocking save of ``chip_smoke.py`` 6 (c)'s checkpoint takes
from one writer thread and from the writer threads `checkpoint.io` gives it.

Builds on the card a state of 6 (c)'s step-4 checkpoint's shapes: the
parameters of Llama-3-8B at full width and 4 layers and their two AdamW
moments, all f32 (23.08 GB), values drawn from a seed. Saves it twice
into a git-ignored directory and removes each copy after its save:

  one_thread — ``dcp.save(state, checkpoint_id=...)``, DCP's default
               writer (one thread, one file a rank);
  port       — ``checkpoint.io.save_checkpoint``, the port's blocking
               save, with 6 (c)'s ``RLT_CKPT_DIGEST=size``.

The one-thread save runs first, so whatever the first write leaves the
disk to do falls on the port's save. Two saves of this size write about
43 GiB, under the 45 GiB a command may write on the card's machine, so
the pair is not repeated within one run. Prints one JSON line: the card's
name and power limit, the writer threads, and each save's bytes, files
and seconds.

Run from the repo root on a machine with the card:
    python3 scripts/ckpt_save_threads.py
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

#: where the copies go (git-ignored)
OUT = os.path.join(ROOT, "rlt_logs", "ckpt_save_threads")


def build_state(layers: int, seed: int):
    """6 (c)'s checkpoint's shapes on the card: {"params", "opt_state",
    "step"}, f32 weights and AdamW moments."""
    import torch

    from ray_lightning_tpu_torch.models.llama import Llama, LlamaConfig

    cfg = LlamaConfig.llama3_8b(max_seq_len=2048, n_layers=layers)
    shapes = {n: tuple(p.shape) for n, p in Llama(
        cfg, device=torch.device("meta"),
        param_dtype=torch.float32).named_parameters()}
    gen = torch.Generator("cuda").manual_seed(seed)

    def draw(shape):
        return torch.randn(shape, generator=gen, device="cuda")

    params = {n: draw(s) for n, s in shapes.items()}
    opt = {n: {"exp_avg": draw(s), "exp_avg_sq": draw(s).abs(),
               "step": torch.tensor(4.0)} for n, s in shapes.items()}
    torch.cuda.synchronize()
    return {"params": params, "opt_state": opt, "step": 4}


def files_and_bytes(state_dir: str):
    names = [f for f in os.listdir(state_dir) if f.endswith(".distcp")]
    return len(names), sum(os.path.getsize(os.path.join(state_dir, f))
                           for f in names)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch
    import torch.distributed.checkpoint as dcp

    from ray_lightning_tpu_torch.checkpoint import io as ckpt_io

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    os.environ["RLT_CKPT_DIGEST"] = "size"
    state = build_state(args.layers, args.seed)
    out = dict(card=card, layers=args.layers,
               state_bytes=ckpt_io._local_bytes(state),
               port_threads=ckpt_io._write_threads(state))
    shutil.rmtree(OUT, ignore_errors=True)
    for name in ("one_thread", "port"):
        path = os.path.join(OUT, name)
        t0 = time.perf_counter()
        if name == "one_thread":
            dcp.save(state, checkpoint_id=os.path.join(path, "state"))
        else:
            ckpt_io.save_checkpoint(path, state)
        out[f"{name}_s"] = time.perf_counter() - t0
        out[f"{name}_files"], out[f"{name}_bytes"] = files_and_bytes(
            os.path.join(path, "state"))
        shutil.rmtree(path)
        os.sync()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
