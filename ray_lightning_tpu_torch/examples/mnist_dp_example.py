"""MNIST end-to-end with the DataParallel strategy: plain training and a
sweep (twin of `examples/mnist_dp_example.py`).

The reference's examples/ray_ddp_example.py: an MLP classifier trained
under the data-parallel plugin, an optional Tune sweep, ``--smoke-test``
for CI. One worker trains in this process (`DataParallel` over a
one-rank group); ``--num-workers N > 1`` runs N processes through
`fit_distributed` (NCCL on the cards, gloo with ``--device cpu``). The
data is a separable synthetic stand-in for MNIST (784 features, 10
classes, from a seed): nothing is downloaded.

Run:
    python -m ray_lightning_tpu_torch.examples.mnist_dp_example \\
        --smoke-test --device cpu
    python -m ray_lightning_tpu_torch.examples.mnist_dp_example \\
        --num-workers 4 --max-epochs 5
    python -m ray_lightning_tpu_torch.examples.mnist_dp_example \\
        --tune --num-samples 4

It ends with the JAX example's line, ``final val accuracy: ...`` (or,
with ``--tune``, ``Best hyperparameters: ...``).
"""
from __future__ import annotations

import argparse
import functools
import os

import numpy as np


def load_mnist(smoke: bool = False):
    """(train, val) dicts of a separable synthetic MNIST stand-in, the JAX
    example's fallback: class centres in 784 dimensions plus unit noise;
    2048 rows in a smoke test, else 16384; a 90/10 split."""
    rng = np.random.default_rng(0)
    n = 2048 if smoke else 16384
    y = rng.integers(0, 10, size=n).astype(np.int32)
    centers = rng.standard_normal((10, 784)).astype(np.float32) * 2.0
    x = centers[y] + rng.standard_normal((n, 784)).astype(np.float32)
    split = int(0.9 * n)
    return ({"x": x[:split], "y": y[:split]},
            {"x": x[split:], "y": y[split:]})


def make_module(config):
    """The JAX example's MLP (784 -> hidden1 -> hidden2 -> 10, ReLU, Adam
    at ``config["lr"]``), logging ``ptl/train_loss``, ``ptl/val_loss`` and
    ``ptl/val_accuracy``."""
    from ray_lightning_tpu_torch.models.mlp import MLPClassifier

    return MLPClassifier(features=(config["hidden1"], config["hidden2"]),
                         num_classes=10, lr=config["lr"], in_features=784)


def make_trainer(max_epochs, smoke, device, root_dir=None, report=False):
    """The run's `Trainer` under `DataParallel`; ``report`` attaches the
    sweep's `TuneReportCallback` (built where the trainer is, so also
    inside a `fit_distributed` worker)."""
    from ray_lightning_tpu_torch import sweep
    from ray_lightning_tpu_torch.core.trainer import Trainer
    from ray_lightning_tpu_torch.parallel.strategy import DataParallel

    callbacks = ([sweep.TuneReportCallback(
        metrics={"loss": "ptl/val_loss", "acc": "ptl/val_accuracy"})]
        if report else None)
    return Trainer(
        strategy=DataParallel(device=device),
        max_epochs=max_epochs,
        limit_train_batches=8 if smoke else None,
        callbacks=callbacks,
        default_root_dir=root_dir or os.path.join(os.getcwd(), "mnist_dp"),
        enable_progress_bar=False,
        log_every_n_steps=10)


def make_data(batch_size, smoke):
    from ray_lightning_tpu_torch.core.data import DataLoader

    train, val = load_mnist(smoke)
    return (DataLoader(train, batch_size=batch_size, shuffle=True,
                       drop_last=True),
            DataLoader(val, batch_size=batch_size, drop_last=True))


def train_mnist(config, num_workers, max_epochs, smoke, device,
                root_dir=None, report=False):
    """One training run; prints and returns the final validation
    accuracy."""
    if num_workers > 1:
        from ray_lightning_tpu_torch.examples import mnist_dp_example as me
        from ray_lightning_tpu_torch.runtime.fit import fit_distributed

        # the workers import the factories by this module's name, also
        # when it runs as __main__
        res = fit_distributed(
            functools.partial(me.make_module, config),
            functools.partial(me.make_trainer, max_epochs, smoke,
                              None if device == "cuda" else device,
                              root_dir, report),
            # the config's batch is the global one, split over the workers
            functools.partial(me.make_data,
                              config["batch_size"] // num_workers, smoke),
            num_workers, device=None if device == "cuda" else device,
            return_weights=False)
        metrics = res.metrics
    else:
        trainer = make_trainer(max_epochs, smoke, device, root_dir, report)
        trainer.fit(make_module(config),
                    *make_data(config["batch_size"], smoke))
        metrics = trainer.callback_metrics
    acc = float(metrics["ptl/val_accuracy"])
    print(f"final val accuracy: {acc:.4f}", flush=True)
    return acc


def trainable(config, num_workers, max_epochs, smoke, device):
    """A sweep trial: one run reporting its validation loss and accuracy
    (module level, so a process trial can import it)."""
    from ray_lightning_tpu_torch import sweep

    train_mnist(config, num_workers, max_epochs, smoke, device,
                root_dir=sweep.get_trial_dir(), report=True)


def tune_mnist(num_workers, num_samples, max_epochs, smoke, device):
    """The sweep (reference examples/ray_ddp_example.py:79-116): trials
    inline in a smoke test, else a process each on its own cards."""
    from ray_lightning_tpu_torch import sweep
    from ray_lightning_tpu_torch.examples import mnist_dp_example as me

    analysis = sweep.run(
        functools.partial(me.trainable, num_workers=num_workers,
                          max_epochs=max_epochs, smoke=smoke, device=device),
        config={
            "lr": sweep.loguniform(1e-4, 1e-1),
            "hidden1": sweep.choice([64, 128]),
            "hidden2": sweep.choice([128, 256]),
            "batch_size": sweep.choice([64, 128]),
        },
        num_samples=num_samples, metric="loss", mode="min",
        executor="inline" if smoke else "process",
        resources_per_trial=sweep.GpuResources(gpus=num_workers),
        total_gpus=num_workers if device == "cpu" else None,
        storage_dir=os.path.join(os.getcwd(), "rlt_sweeps"),
        name="tune_mnist")
    print("Best hyperparameters:", analysis.best_config, flush=True)
    return analysis


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--num-workers", type=int, default=None,
                   help="data-parallel processes (default: one, in this "
                        "process)")
    p.add_argument("--max-epochs", type=int, default=3)
    p.add_argument("--tune", action="store_true", help="run the HPO sweep")
    p.add_argument("--num-samples", type=int, default=4)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where to train (default the card)")
    p.add_argument("--smoke-test", action="store_true",
                   help="2048 rows, one epoch of 8 batches; two sweep "
                        "trials run inline")
    args = p.parse_args(argv)
    if args.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            p.error("no CUDA device: pass --device cpu")
    if args.smoke_test:
        args.max_epochs = 1
        if args.tune:
            args.num_samples = min(args.num_samples, 2)
    workers = args.num_workers or 1
    if args.tune:
        tune_mnist(workers, args.num_samples, args.max_epochs,
                   args.smoke_test, args.device)
    else:
        config = {"lr": 1e-3, "hidden1": 128, "hidden2": 256,
                  "batch_size": 128}
        train_mnist(config, workers, args.max_epochs, args.smoke_test,
                    args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
