"""HPO sweep with checkpointing and ASHA early termination (twin of
`examples/mnist_sweep_example.py`).

The reference's examples/ray_ddp_tune.py: a Tune sweep over data-parallel
trials with `TuneReportCheckpointCallback`. Each trial reserves
``--gpus-per-trial`` cards (`GpuResources(gpus=)`, the JAX example's
``TpuResources(chips=)``), ASHA's stop verdict unwinds the trial, and
checkpoints are written in the trial's directory with only their paths
reported. Trials run in a process each, pinned to their cards, or
inline in this process in a smoke test. The data is the MNIST example's
synthetic stand-in.

Run:
    python -m ray_lightning_tpu_torch.examples.mnist_sweep_example \\
        --smoke-test --device cpu
    python -m ray_lightning_tpu_torch.examples.mnist_sweep_example \\
        --num-samples 8 --gpus-per-trial 1

It ends with the JAX example's lines: ``Best hyperparameters: ...``,
``Best checkpoint: ...`` and one row per trial.
"""
from __future__ import annotations

import argparse
import functools
import os


def trainable(config, gpus_per_trial, max_epochs, smoke, device):
    """One trial: the MNIST example's model under `DataParallel`,
    reporting its validation loss and accuracy with a checkpoint each
    epoch (module level, so a process trial can import it)."""
    from ray_lightning_tpu_torch import sweep
    from ray_lightning_tpu_torch.core.data import DataLoader
    from ray_lightning_tpu_torch.core.trainer import Trainer
    from ray_lightning_tpu_torch.examples.mnist_dp_example import (
        load_mnist,
        make_module,
    )
    from ray_lightning_tpu_torch.parallel.strategy import DataParallel

    train, val = load_mnist(smoke)
    trainer = Trainer(
        strategy=DataParallel(num_workers=gpus_per_trial, device=device),
        max_epochs=max_epochs,
        limit_train_batches=8 if smoke else None,
        callbacks=[sweep.TuneReportCheckpointCallback(
            metrics={"loss": "ptl/val_loss", "acc": "ptl/val_accuracy"})],
        default_root_dir=sweep.get_trial_dir(),
        enable_checkpointing=False,
        enable_progress_bar=False)
    trainer.fit(
        make_module(config),
        DataLoader(train, batch_size=config["batch_size"], shuffle=True,
                   drop_last=True),
        DataLoader(val, batch_size=config["batch_size"], drop_last=True))


def tune_mnist_asha(num_samples, gpus_per_trial, max_epochs, smoke,
                    device):
    from ray_lightning_tpu_torch import sweep
    from ray_lightning_tpu_torch.examples import mnist_sweep_example as me

    analysis = sweep.run(
        functools.partial(me.trainable, gpus_per_trial=gpus_per_trial,
                          max_epochs=max_epochs, smoke=smoke, device=device),
        config={
            "lr": sweep.loguniform(1e-4, 1e-1),
            "hidden1": sweep.choice([64, 128]),
            "hidden2": sweep.choice([128, 256]),
            "batch_size": sweep.choice([64, 128]),
        },
        num_samples=num_samples, metric="loss", mode="min",
        scheduler=sweep.ASHAScheduler(max_t=max_epochs, grace_period=1,
                                      reduction_factor=2),
        executor="inline" if smoke else "process",
        resources_per_trial=sweep.GpuResources(gpus=gpus_per_trial),
        total_gpus=gpus_per_trial if device == "cpu" else None,
        storage_dir=os.path.join(os.getcwd(), "rlt_sweeps"),
        name="tune_mnist_asha")
    print("Best hyperparameters:", analysis.best_config)
    print("Best checkpoint:", analysis.best_checkpoint)
    for row in analysis.dataframe():
        print(row)
    return analysis


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--num-samples", type=int, default=4)
    p.add_argument("--gpus-per-trial", type=int, default=1)
    p.add_argument("--max-epochs", type=int, default=4)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where the trials train (default the cards)")
    p.add_argument("--smoke-test", action="store_true",
                   help="two trials of two short epochs, inline")
    args = p.parse_args(argv)
    if args.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            p.error("no CUDA device: pass --device cpu")
    if args.smoke_test:
        args.num_samples, args.max_epochs = 2, 2
    tune_mnist_asha(args.num_samples, args.gpus_per_trial, args.max_epochs,
                    args.smoke_test, args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
