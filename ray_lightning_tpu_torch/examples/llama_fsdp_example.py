"""Llama-3-style pretraining under FSDP (twin of
`examples/llama_fsdp_example.py`): the same flags, on the card.

A world of one (``--data``, ``--fsdp``, ``--tensor`` and ``--pipe`` all
1, as on a machine with one card) fits in this process under `ShardedMesh`; a larger
one runs one process per rank through `fit_distributed` (NCCL on the
cards, gloo with ``--device cpu``). The tokens are synthetic (numpy, from
a seed): swap in a real tokenized dataset in production.

Run:
    python -m ray_lightning_tpu_torch.examples.llama_fsdp_example \\
        --smoke-test --device cpu
    # one H100
    python -m ray_lightning_tpu_torch.examples.llama_fsdp_example \\
        --model 1b --seq-len 2048 --batch-size 2 --mu-bf16 \\
        --remat-policy attn_out --ce-inline-bwd --fused-ce on
    # Llama-3-8B: its f32 weights, gradients and moments take about 112 GB
    # with the bf16 first moment, more than one card holds
    python -m ray_lightning_tpu_torch.examples.llama_fsdp_example \\
        --model 8b --fsdp 4 --seq-len 2048 --batch-size 2 --mu-bf16 \\
        --remat-policy attn_out --ce-inline-bwd
    python -m ray_lightning_tpu_torch.examples.llama_fsdp_example \\
        --model 1b --fsdp 4 --data 2

It prints the JAX example's summary line, then one JSON line with the
same readings.
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import math
import os

import numpy as np


def synthetic_tokens(vocab_size: int, n_seqs: int, seq_len: int,
                     seed: int = 0) -> dict:
    """A synthetic corpus [n_seqs, seq_len + 1] of token ids (the JAX
    example's)."""
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(
        0, vocab_size, (n_seqs, seq_len + 1)).astype(np.int32)}


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--model", choices=["tiny", "1b", "8b"], default="1b")
    p.add_argument("--data", type=int, default=1,
                   help="data-parallel degree")
    p.add_argument("--fsdp", type=int, default=0,
                   help="fsdp degree (default: all remaining devices)")
    p.add_argument("--tensor", type=int, default=1,
                   help="tensor-parallel degree")
    p.add_argument("--pipe", type=int, default=1,
                   help="pipeline stages (GPipe over the pipe mesh axis)")
    p.add_argument("--microbatches", type=int, default=4,
                   help="pipeline microbatches per step (with --pipe > 1)")
    p.add_argument("--seq-len", type=int, default=2048)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--max-steps", type=int, default=50)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--no-remat", action="store_true",
                   help="disable the blocks' checkpoint (more memory, no "
                        "backward recompute)")
    p.add_argument("--remat-policy", choices=["nothing", "dots", "attn_out"],
                   default="nothing",
                   help="what the per-layer checkpoint saves: nothing / "
                        "the projection GEMMs' outputs / the attention "
                        "residuals")
    p.add_argument("--no-scan-layers", action="store_true",
                   help="changes nothing: the port runs its layers as a "
                        "Python loop (the JAX flag unrolls a lax.scan)")
    p.add_argument("--fused-ce", choices=["auto", "on", "off"],
                   default="auto",
                   help="chunked lm_head+CE; auto = on for vocab >= 64k")
    p.add_argument("--ce-inline-bwd", action="store_true",
                   help="compute the CE's gradients inside its forward "
                        "chunk loop (no logits tile built twice; +D x V "
                        "residual)")
    p.add_argument("--mu-bf16", action="store_true",
                   help="store Adam's first moment in bf16 (-25%% "
                        "optimizer memory)")
    p.add_argument("--tie-embeddings", action="store_true",
                   help="the embedding is the output head too")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where to train (default the card)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--smoke-test", action="store_true",
                   help="the tiny config, 4 steps of batch 4, sequences "
                        "of at most 128 tokens")
    return p


def model_config(args):
    """The run's `LlamaConfig` from the flags."""
    import torch

    from ray_lightning_tpu_torch.models.llama import LlamaConfig

    if args.smoke_test or args.model == "tiny":
        cfg = LlamaConfig.tiny()
    elif args.model == "1b":
        cfg = LlamaConfig(vocab_size=32768, dim=2048, n_layers=16,
                          n_heads=16, n_kv_heads=8, hidden_dim=5632,
                          max_seq_len=args.seq_len)
    else:
        cfg = LlamaConfig.llama3_8b(max_seq_len=args.seq_len)
    # the CPU computes in f32 (the JAX example's precision="f32" off the
    # TPU); the card in bf16
    return dataclasses.replace(
        cfg, dtype=torch.float32 if args.device == "cpu" else torch.bfloat16,
        remat=not args.no_remat, remat_policy=args.remat_policy,
        fused_ce={"auto": None, "on": True, "off": False}[args.fused_ce],
        ce_inline_bwd=args.ce_inline_bwd,
        tie_embeddings=args.tie_embeddings,
        pipeline_microbatches=args.microbatches if args.pipe > 1 else 0)


def make_module(args):
    import torch

    from ray_lightning_tpu_torch.models.llama import LlamaModule

    return LlamaModule(model_config(args), lr=args.lr,
                       warmup_steps=min(10, max(1, args.max_steps // 2)),
                       total_steps=args.max_steps,
                       mu_dtype=torch.bfloat16 if args.mu_bf16 else None)


def make_trainer(args, sizes: dict):
    from ray_lightning_tpu_torch.core.callbacks import ThroughputMonitor
    from ray_lightning_tpu_torch.core.trainer import Trainer
    from ray_lightning_tpu_torch.parallel.strategy import ShardedMesh

    return Trainer(
        strategy=ShardedMesh(**sizes, device=args.device),
        max_epochs=10_000,  # bounded by max_steps
        max_steps=args.max_steps,
        callbacks=[ThroughputMonitor()],
        enable_checkpointing=not args.smoke_test,
        enable_progress_bar=not args.smoke_test,
        log_every_n_steps=1 if args.smoke_test else 5, seed=args.seed,
        default_root_dir=os.path.join(os.getcwd(), "llama_fsdp"))


def make_data(args):
    from ray_lightning_tpu_torch.core.data import DataLoader

    cfg = model_config(args)
    data = synthetic_tokens(cfg.vocab_size,
                            n_seqs=max(64, 4 * args.batch_size),
                            seq_len=min(args.seq_len, cfg.max_seq_len),
                            seed=args.seed)
    return DataLoader(data, batch_size=args.batch_size, shuffle=True,
                      drop_last=True, seed=args.seed)


def main(argv=None) -> int:
    p = parser()
    args = p.parse_args(argv)
    if args.no_scan_layers and args.pipe > 1:
        p.error("--no-scan-layers conflicts with --pipe > 1 (the pipeline "
                "stage-splits the scanned layer stack)")
    if args.smoke_test:
        args.seq_len = min(args.seq_len, 128)
        args.batch_size = 4
        args.max_steps = 4
    if args.device == "cuda":
        import torch

        n_dev = torch.cuda.device_count()
        if n_dev == 0:
            p.error("no CUDA device: pass --device cpu")
    else:
        n_dev = 1
    fsdp = args.fsdp or max(1, n_dev // (args.data * args.tensor
                                         * args.pipe))
    sizes = dict(data=args.data, fsdp=fsdp, tensor=args.tensor,
                 pipe=args.pipe)
    world = math.prod(sizes.values())
    seq_len = min(args.seq_len, model_config(args).max_seq_len)
    if world == 1:
        module, trainer = make_module(args), make_trainer(args, sizes)
        trainer.fit(module, make_data(args))
        metrics = dict(trainer.callback_metrics)
        opt = trainer.state.optimizer
        mu = str(next(iter(opt.state.values()))["exp_avg"].dtype)
    else:
        # the workers import the factories by this module's name, also
        # when it runs as __main__
        from ray_lightning_tpu_torch.examples import llama_fsdp_example as me
        from ray_lightning_tpu_torch.runtime.fit import fit_distributed

        res = fit_distributed(
            functools.partial(me.make_module, args),
            functools.partial(me.make_trainer, args, sizes),
            functools.partial(me.make_data, args), world,
            device=args.device if args.device == "cpu" else None,
            return_weights=False)
        metrics, mu = res.metrics, None
    loss = float(metrics["loss"])
    step_s = float(metrics["step_time_s"])
    tok_s = args.batch_size * seq_len / step_s
    print(f"mesh={sizes} loss={loss:.4f} step_time={step_s * 1e3:.1f}ms "
          f"tokens/sec={tok_s:,.0f}")
    print(json.dumps(dict(mesh=sizes, world=world, device=args.device,
                          steps=args.max_steps, loss=loss,
                          step_time_s=step_s, tokens_per_s=tok_s,
                          exp_avg_dtype=mu,
                          remat_policy=args.remat_policy,
                          ce_inline_bwd=args.ce_inline_bwd,
                          tie_embeddings=args.tie_embeddings)))
    return 0 if np.isfinite(loss) else 1


if __name__ == "__main__":
    raise SystemExit(main())
