"""Cross-host launch: one driver places one worker a host over a
pluggable transport and runs ONE data-parallel fit across all of them
(twin of `examples/pod_launch_example.py`).

The reference's signature capability: workers placed on cluster nodes
with their environment bootstrapped and their ranks resolved (reference
ray_ddp.py:106-164). Here placement is a transport
(`runtime/transport.py`): `SSHTransport` on real hosts,
`LoopbackTransport` to drive the same bootstrap and rendezvous on one
machine.

Run, over ssh to hosts with a card each:
    python -m ray_lightning_tpu_torch.examples.pod_launch_example \\
        --hosts 10.0.0.2 10.0.0.3 --remote-python python3

Locally (two fake hosts, gloo on the CPU, the whole remote code path):
    python -m ray_lightning_tpu_torch.examples.pod_launch_example \\
        --smoke-test --device cpu

It ends with the JAX example's line, ``pod launch round-trip OK``.
"""
from __future__ import annotations

import argparse
import functools

import numpy as np


def make_module():
    from ray_lightning_tpu_torch.models.mlp import MLPClassifier

    return MLPClassifier(features=(64,), num_classes=4, lr=5e-2,
                         in_features=16)


def make_trainer(device=None):
    from ray_lightning_tpu_torch.core.trainer import Trainer
    from ray_lightning_tpu_torch.parallel.strategy import DataParallel

    return Trainer(strategy=DataParallel(device=device), max_epochs=2,
                   enable_progress_bar=False, enable_checkpointing=False,
                   seed=0)


def make_data():
    from ray_lightning_tpu_torch.core.data import DataLoader

    rng = np.random.default_rng(0)
    centers = rng.normal(size=(4, 16)) * 3
    y = rng.integers(0, 4, size=512)
    x = (centers[y] + rng.normal(size=(512, 16)) * 0.1).astype(np.float32)
    # no shard arguments: the launcher forces per-host sharding onto
    # every loader (the reference's injected DistributedSampler)
    train = DataLoader({"x": x, "y": y}, batch_size=32, shuffle=True)
    val = DataLoader({"x": x, "y": y}, batch_size=32)
    return train, val


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--hosts", nargs="+", default=None,
                   help="host addresses, one worker a host")
    p.add_argument("--remote-python", default="python3")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="the workers' device (default a card each)")
    p.add_argument("--smoke-test", action="store_true",
                   help="two fake hosts on this machine")
    args = p.parse_args(argv)

    from ray_lightning_tpu_torch.examples import pod_launch_example as me
    from ray_lightning_tpu_torch.runtime import (
        LoopbackTransport,
        SSHTransport,
        fit_distributed,
    )

    if args.smoke_test:
        hosts = ["fake-host-a", "fake-host-b"]
        transport = LoopbackTransport()
    else:
        if not args.hosts:
            p.error("--hosts is required without --smoke-test")
        hosts = args.hosts
        transport = SSHTransport(remote_python=args.remote_python)
    device = None if args.device == "cuda" else args.device
    # the workers import the factories by this module's name, also when
    # it runs as __main__
    result = fit_distributed(
        me.make_module, functools.partial(me.make_trainer, device),
        me.make_data, num_processes=len(hosts), hosts=hosts,
        transport=transport, timeout=600, device=device,
        return_weights=False)
    acc = result.metrics.get("ptl/val_accuracy")
    print(f"workers={len(hosts)} hosts={hosts}")
    print(f"final metrics: {result.metrics}")
    if acc is None or not float(acc) > 0.9:
        print(f"validation accuracy {acc}, wanted > 0.9")
        return 1
    print("pod launch round-trip OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
