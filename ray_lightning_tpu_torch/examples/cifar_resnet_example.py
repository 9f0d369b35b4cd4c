"""ResNet on CIFAR-10-shaped data with data-parallel training (twin of
`examples/cifar_resnet_example.py`; BASELINE config 2, "ResNet-50 /
CIFAR-10, 8-worker data-parallel").

One worker trains in this process (`DataParallel` over a one-rank
group); ``--num-workers N > 1`` runs N processes through
`fit_distributed`. ``--prefetch`` assembles the training batches on the
native batcher's threads (`DataLoader(prefetch=True)`). The images are a
separable synthetic stand-in (32x32x3, NHWC, 10 classes, from a seed):
nothing is downloaded. The card computes in bf16, the CPU in f32.

Run:
    python -m ray_lightning_tpu_torch.examples.cifar_resnet_example \\
        --smoke-test --device cpu --prefetch
    python -m ray_lightning_tpu_torch.examples.cifar_resnet_example \\
        --variant resnet50 --batch-size 256 --prefetch

It prints one JSON line of readings, then the JAX example's line,
``val_acc=... examples/sec=...``.
"""
from __future__ import annotations

import argparse
import functools
import json
import os

import numpy as np


def load_cifar(smoke: bool = False):
    """(train, val) dicts of the JAX example's synthetic CIFAR stand-in:
    a class-dependent colour per image plus noise; 512 images in a smoke
    test, else 8192; a 90/10 split."""
    rng = np.random.default_rng(0)
    n = 512 if smoke else 8192
    y = rng.integers(0, 10, n).astype(np.int32)
    base = rng.standard_normal((10, 1, 1, 3)).astype(np.float32) * 3
    x = base[y] + 0.3 * rng.standard_normal((n, 32, 32, 3)).astype(
        np.float32)
    split = int(0.9 * n)
    return ({"x": x[:split], "y": y[:split]},
            {"x": x[split:], "y": y[split:]})


def make_module(args, steps):
    import torch

    from ray_lightning_tpu_torch.models.resnet import ResNetModule

    return ResNetModule(
        variant=args.variant, num_classes=10, lr=args.lr,
        total_steps=max(steps, 2),
        dtype=torch.float32 if args.device == "cpu" else torch.bfloat16)


def make_trainer(args, device):
    from ray_lightning_tpu_torch.core.callbacks import ThroughputMonitor
    from ray_lightning_tpu_torch.core.trainer import Trainer
    from ray_lightning_tpu_torch.parallel.strategy import DataParallel

    return Trainer(
        strategy=DataParallel(device=device),
        max_epochs=args.max_epochs,
        callbacks=[ThroughputMonitor()],
        default_root_dir=os.path.join(os.getcwd(), "cifar_resnet"),
        enable_checkpointing=not args.smoke_test,
        enable_progress_bar=False,
        log_every_n_steps=10)


def make_data(args):
    from ray_lightning_tpu_torch.core.data import DataLoader

    train, val = load_cifar(args.smoke_test)
    return (DataLoader(train, batch_size=args.batch_size, shuffle=True,
                       drop_last=True, prefetch=args.prefetch),
            DataLoader(val, batch_size=min(args.batch_size, len(val["y"])),
                       drop_last=True))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--variant", default="resnet18",
                   choices=["resnet18", "resnet34", "resnet50"])
    p.add_argument("--num-workers", type=int, default=None,
                   help="data-parallel processes (default: one, in this "
                        "process)")
    p.add_argument("--max-epochs", type=int, default=10)
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--lr", type=float, default=0.1)
    p.add_argument("--prefetch", action="store_true",
                   help="assemble batches on the native C++ batcher")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where to train (default the card)")
    p.add_argument("--smoke-test", action="store_true",
                   help="512 images, 2 epochs of batch 64")
    args = p.parse_args(argv)
    if args.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            p.error("no CUDA device: pass --device cpu")
    if args.smoke_test:
        args.max_epochs, args.batch_size, args.lr = 2, 64, 0.05
    train_rows = int(0.9 * (512 if args.smoke_test else 8192))
    workers = args.num_workers or 1
    steps = args.max_epochs * (train_rows // args.batch_size)
    device = None if args.device == "cuda" else args.device
    native = None
    if workers > 1:
        # --batch-size is the global batch, split over the workers
        args.batch_size //= workers
        from ray_lightning_tpu_torch.examples import cifar_resnet_example as me
        from ray_lightning_tpu_torch.runtime.fit import fit_distributed

        res = fit_distributed(
            functools.partial(me.make_module, args, steps),
            functools.partial(me.make_trainer, args, device),
            functools.partial(me.make_data, args), workers, device=device,
            return_weights=False)
        m = res.metrics
    else:
        trainer = make_trainer(args, args.device)
        train, val = make_data(args)
        trainer.fit(make_module(args, steps), train, val)
        m = trainer.callback_metrics
        native = train.native and train._batcher.batches
    loss, acc = float(m["loss"]), float(m["val_acc"])
    rate = float(m.get("examples_per_sec", 0))
    print(json.dumps(dict(variant=args.variant, device=args.device,
                          workers=workers, steps=steps, loss=loss,
                          val_acc=acc, examples_per_sec=rate,
                          prefetch=args.prefetch,
                          # batches the native batcher made here
                          native_batches=native)))
    print(f"val_acc={acc:.4f} examples/sec={rate:,.0f}")
    return 0 if np.isfinite(loss) else 1


if __name__ == "__main__":
    raise SystemExit(main())
