"""BERT sequence-classification fine-tune (twin of
`examples/bert_finetune_example.py`; BASELINE config 3, "BERT-base
fine-tune").

BERT-base from seeded random weights (or the tiny config in a smoke
test, flash off, as in JAX) on a synthetic sentiment-shaped set: a few
polarity tokens whose kind decides the label. Nothing is downloaded:
load pretrained weights with `models.bert_classifier_params_from_hf`
where a `transformers` checkpoint is at hand. One worker trains in this
process (`DataParallel` over a one-rank group); ``--num-workers N > 1``
runs N processes through `fit_distributed`. The batches carry the JAX
example's all-ones ``attention_mask``, so attention takes the dense
path (without a mask it would run the flash kernels). The card
computes in bf16, the CPU in f32.

Run:
    python -m ray_lightning_tpu_torch.examples.bert_finetune_example \\
        --smoke-test --device cpu
    python -m ray_lightning_tpu_torch.examples.bert_finetune_example \\
        --max-epochs 3

It prints one JSON line of readings, then the JAX example's line,
``val_acc=...``.
"""
from __future__ import annotations

import argparse
import functools
import json
import os

import numpy as np


def synthetic_sst(n: int, seq: int, vocab: int, seed: int = 0):
    """The JAX example's set: 2-5 polarity tokens (3 positive, 4
    negative) at random positions decide the label, so the model must
    attend over the whole row; ``[CLS]`` (1) first."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 2, n).astype(np.int32)
    ids = rng.integers(10, vocab, (n, seq)).astype(np.int32)
    pos_tok, neg_tok = 3, 4
    for i in range(n):
        k = rng.integers(2, 6)
        slots = rng.choice(seq - 1, size=k, replace=False) + 1
        ids[i, slots] = pos_tok if y[i] else neg_tok
    ids[:, 0] = 1
    return {"input_ids": ids,
            "attention_mask": np.ones((n, seq), np.int32),
            "labels": y}


def model_config(args):
    import torch

    from ray_lightning_tpu_torch.models.bert import BertConfig

    dtype = torch.float32 if args.device == "cpu" else torch.bfloat16
    if args.smoke_test:
        return BertConfig.tiny(use_flash=False, dropout=0.0, dtype=dtype)
    return BertConfig.base(max_seq_len=args.seq_len, dtype=dtype)


def make_module(args, steps):
    from ray_lightning_tpu_torch.models.bert import BertClassifierModule

    return BertClassifierModule(model_config(args), num_classes=2,
                                lr=args.lr, warmup_steps=max(1, steps // 20),
                                total_steps=max(steps, 2))


def make_trainer(args, device):
    from ray_lightning_tpu_torch.core.trainer import Trainer
    from ray_lightning_tpu_torch.parallel.strategy import DataParallel

    return Trainer(
        strategy=DataParallel(device=device),
        max_epochs=args.max_epochs,
        default_root_dir=os.path.join(os.getcwd(), "bert_finetune"),
        enable_checkpointing=not args.smoke_test,
        enable_progress_bar=False,
        log_every_n_steps=10)


def make_data(args):
    from ray_lightning_tpu_torch.core.data import DataLoader

    n = 512 if args.smoke_test else 8192
    data = synthetic_sst(n, args.seq_len, model_config(args).vocab_size)
    split = int(0.9 * n)
    train = {k: v[:split] for k, v in data.items()}
    val = {k: v[split:] for k, v in data.items()}
    return (DataLoader(train, batch_size=args.batch_size, shuffle=True,
                       drop_last=True),
            DataLoader(val, batch_size=args.batch_size, drop_last=True))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--num-workers", type=int, default=None,
                   help="data-parallel processes (default: one, in this "
                        "process)")
    p.add_argument("--max-epochs", type=int, default=3)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--seq-len", type=int, default=128)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where to train (default the card)")
    p.add_argument("--smoke-test", action="store_true",
                   help="the tiny config, 512 rows of 32 tokens, 3 epochs "
                        "of batch 32")
    args = p.parse_args(argv)
    if args.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            p.error("no CUDA device: pass --device cpu")
    if args.smoke_test:
        args.max_epochs, args.batch_size, args.seq_len = 3, 32, 32
    n = 512 if args.smoke_test else 8192
    workers = args.num_workers or 1
    steps = args.max_epochs * (int(0.9 * n) // args.batch_size)
    device = None if args.device == "cuda" else args.device
    if workers > 1:
        # --batch-size is the global batch, split over the workers
        args.batch_size //= workers
        from ray_lightning_tpu_torch.examples import (
            bert_finetune_example as me,
        )
        from ray_lightning_tpu_torch.runtime.fit import fit_distributed

        m = fit_distributed(
            functools.partial(me.make_module, args, steps),
            functools.partial(me.make_trainer, args, device),
            functools.partial(me.make_data, args), workers, device=device,
            return_weights=False).metrics
    else:
        trainer = make_trainer(args, args.device)
        trainer.fit(make_module(args, steps), *make_data(args))
        m = trainer.callback_metrics
    loss, acc = float(m["loss"]), float(m["val_acc"])
    print(json.dumps(dict(device=args.device, workers=workers, steps=steps,
                          loss=loss, val_acc=acc)))
    print(f"val_acc={acc:.4f}")
    return 0 if np.isfinite(loss) else 1


if __name__ == "__main__":
    raise SystemExit(main())
