"""Jobs and factories that the port's multi-process tests ship to worker
processes. Workers import this module by name (the standard pickle sends
functions by reference), so it imports no JAX and nothing of the JAX
package: a worker stays as light as its job.
"""
from __future__ import annotations

import os
import time

import numpy as np

from ray_lightning_tpu_torch.core.callbacks import Callback

#: the tiny Llama config shared with the JAX side of the tests
TINY = dict(vocab_size=256, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
            hidden_dim=128, max_seq_len=64)


# ---- runtime jobs ------------------------------------------------------------


def rank_and_world():
    from ray_lightning_tpu_torch.runtime import session

    return session.get_actor_rank(), session.get_world_size()


def read_env(key):
    return os.environ.get(key)


def write_marker(path, text):
    """Runs where it is called: in a worker as a job, in the driver as a
    side-channel item."""
    with open(path, "a") as f:
        f.write(f"{text} {os.getpid()}\n")


def queue_marker(path):
    """Puts a callable on the side channel; the driver runs it."""
    import functools

    from ray_lightning_tpu_torch.runtime import session

    rank = session.get_actor_rank()
    session.put_queue(functools.partial(write_marker, path, f"rank{rank}"))
    session.put_queue({"rank": rank, "pid": os.getpid()})
    return os.getpid()


def fail_on(rank_to_fail):
    from ray_lightning_tpu_torch.runtime import session

    if session.get_actor_rank() == rank_to_fail:
        raise ValueError(f"boom from rank {rank_to_fail}")
    time.sleep(30)
    return "survived"


def sleep_for(seconds):
    time.sleep(seconds)
    return seconds


def my_pid():
    return os.getpid()


def all_reduce_rank():
    """A collective over the launch's process group: the sum of ranks."""
    import torch
    import torch.distributed as dist

    t = torch.tensor([float(dist.get_rank())])
    dist.all_reduce(t)
    return dist.get_rank(), dist.get_world_size(), float(t)


# ---- Llama fit ---------------------------------------------------------------


class StepRows(Callback):
    """Sends rank 0's per-step (step, loss, grad_norm) over the side
    channel."""

    def on_train_batch_end(self, trainer, module, metrics, batch_idx):
        from ray_lightning_tpu_torch.runtime import session

        if session.get_actor_rank() == 0:
            session.put_queue(("row", trainer.global_step,
                               float(metrics["loss"]),
                               float(metrics["grad_norm"])))


class StepRecorder(Callback):
    """Per-step (loss, grad_norm) of a fit in this process."""

    def __init__(self):
        self.rows = []

    def on_train_batch_end(self, trainer, module, metrics, batch_idx):
        self.rows.append((float(metrics["loss"]),
                          float(metrics["grad_norm"])))


def tokens(n, s, seed=0, vocab=256):
    """[n, s + 1] seeded token ids."""
    return np.random.default_rng(seed).integers(0, vocab, (n, s + 1))


def llama_module(params_np=None, lr=1e-2, warmup_steps=1, total_steps=4,
                 **cfg_kw):
    import torch

    from ray_lightning_tpu_torch.models.llama import (
        LlamaConfig,
        LlamaModule,
        params_from_jax,
    )

    cfg = LlamaConfig(**TINY, dtype=torch.float32, **cfg_kw)
    m = LlamaModule(cfg, lr=lr, warmup_steps=warmup_steps,
                    total_steps=total_steps)
    if params_np is not None:
        m.params = params_from_jax(params_np, cfg, dtype=torch.float32)
    return m


def make_strategy(name):
    from ray_lightning_tpu_torch.parallel.strategy import (
        FSDP,
        DataParallel,
        SingleDevice,
    )

    return {"ddp": DataParallel, "fsdp": FSDP,
            "single": SingleDevice}[name](device="cpu")


def trainer(strategy="ddp", max_steps=4, clip=None, ckpt_dir=None,
            every_n_train_steps=None):
    """A Llama trainer that reports rank 0's steps over the side channel,
    with a step-cadence `ModelCheckpoint` into ``ckpt_dir`` if given."""
    from ray_lightning_tpu_torch.core.callbacks import ModelCheckpoint
    from ray_lightning_tpu_torch.core.trainer import Trainer

    callbacks = [StepRows()]
    if ckpt_dir is not None:
        callbacks.append(ModelCheckpoint(
            dirpath=ckpt_dir, every_n_train_steps=every_n_train_steps,
            save_top_k=-1))
    return Trainer(strategy=make_strategy(strategy), max_steps=max_steps,
                   gradient_clip_val=clip, log_every_n_steps=1,
                   enable_checkpointing=False, enable_progress_bar=False,
                   callbacks=callbacks, seed=0)


def llama_data(toks, mask=None, batch_size=2):
    from ray_lightning_tpu_torch.core.data import DataLoader

    data = {"tokens": toks}
    if mask is not None:
        data["mask"] = mask
    return DataLoader(data, batch_size=batch_size)


# ---- the MNIST classifier matrix ----------------------------------------------


def mnist_module(lr=1e-2):
    from ray_lightning_tpu_torch.models.mlp import MNISTClassifier

    return MNISTClassifier(lr=lr, layer_1=32, layer_2=32)


def mnist_trainer(ckpt_dir=None):
    """`RayXlaPlugin` on the CPU; with ``ckpt_dir``, `EarlyStopping` and a
    `ModelCheckpoint` monitoring the validation accuracy."""
    from ray_lightning_tpu_torch.core.callbacks import (
        EarlyStopping,
        ModelCheckpoint,
    )
    from ray_lightning_tpu_torch.core.trainer import Trainer
    from ray_lightning_tpu_torch.parallel.strategy import RayXlaPlugin

    callbacks = []
    if ckpt_dir is not None:
        callbacks = [ModelCheckpoint(dirpath=ckpt_dir,
                                     monitor="ptl/val_accuracy", mode="max"),
                     EarlyStopping(monitor="ptl/val_accuracy", mode="max",
                                   patience=2)]
    return Trainer(strategy=RayXlaPlugin(device="cpu"), max_epochs=2,
                   enable_progress_bar=False, enable_checkpointing=False,
                   callbacks=callbacks, seed=0)


def mnist_data():
    """(shuffled train, unshuffled val) loaders over `synthetic_mnist`."""
    from ray_lightning_tpu_torch.core.data import DataLoader
    from ray_lightning_tpu_torch.models.mlp import synthetic_mnist

    data = synthetic_mnist(256)
    return (DataLoader(data, batch_size=16, shuffle=True, seed=0),
            DataLoader(data, batch_size=16))


def mnist_eval_data():
    from ray_lightning_tpu_torch.core.data import DataLoader
    from ray_lightning_tpu_torch.models.mlp import synthetic_mnist

    return DataLoader(synthetic_mnist(256), batch_size=16)
