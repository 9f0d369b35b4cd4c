"""Single-controller launch of a multi-process program (twin of
`ray_lightning_tpu/runtime/launch.py`).

The driver ships ONE job to N worker processes; each joins a
`torch.distributed` process group at a rendezvous the driver picked
(the reference's MASTER_ADDR/PORT dance, ray_ddp.py:152-156, where the
JAX package calls ``jax.distributed.initialize``), then runs the job.
One process drives one device: ``cuda:<rank>`` over NCCL on the card,
or the CPU over gloo with ``device="cpu"`` (the JAX package's
``launch_cpu_spmd``), which gives real multi-process collectives on any
box. The driver keeps the futures/queue view through `WorkerGroup`.
"""
from __future__ import annotations

import datetime
import logging
import os
from typing import Any, Callable, Dict, List, Optional, Sequence

from ray_lightning_tpu_torch.runtime.group import WorkerGroup
from ray_lightning_tpu_torch.runtime.transport import Transport
from ray_lightning_tpu_torch.utils.dist import find_free_port

log = logging.getLogger(__name__)

#: how long a collective may wait for its peers before the process
#: group gives up (the driver's ``timeout`` usually fires first)
PG_TIMEOUT_S = 600


def _spmd_main(fn: Callable, args: tuple, kwargs: dict, num_processes: int,
               init_method: str, device: Optional[str], rank: int,
               rank_args: tuple = ()):
    """Body run by every worker: bind the rank's device, join the process
    group, run ``fn``. Shared prefix first, per-rank suffix last, as
    `WorkerGroup.run`'s ship-once split wants."""
    import torch
    import torch.distributed as dist

    from ray_lightning_tpu_torch.utils.devices import (
        LOCAL_RANK_ENV,
        rank_device,
    )

    os.environ[LOCAL_RANK_ENV] = str(rank)
    os.environ["RANK"] = str(rank)
    os.environ["WORLD_SIZE"] = str(num_processes)
    dev = rank_device(device, rank, num_processes)
    kw = {}
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        kw["device_id"] = dev
    dist.init_process_group(
        "nccl" if dev.type == "cuda" else "gloo", init_method=init_method,
        rank=rank, world_size=num_processes,
        timeout=datetime.timedelta(seconds=PG_TIMEOUT_S), **kw)
    result = fn(*args, *rank_args, **kwargs)
    # success path only: on an exception the peers may be inside a
    # collective, and the driver tears the failed group down instead
    dist.destroy_process_group()
    return result


def launch(fn: Callable, num_processes: int, *, args: tuple = (),
           kwargs: Optional[dict] = None, device: Optional[str] = None,
           env: Optional[Dict[str, str]] = None,
           init_hook: Optional[Callable[[], None]] = None,
           on_queue_item: Optional[Callable[[int, Any], None]] = None,
           per_rank_args: Optional[Sequence[tuple]] = None,
           log_dir: Optional[str] = None, timeout: Optional[float] = None,
           transport: Optional[Transport] = None) -> List[Any]:
    """Run ``fn`` in ``num_processes`` processes joined in one process
    group; returns the per-rank results in rank order (rank 0's is the
    conventional carrier of results).

    ``device``: None is the card (one per process; more processes than
    cards raise "num_workers > devices" before any worker starts),
    ``"cpu"`` the CPU over gloo. ``fn`` runs after
    ``init_process_group``. ``timeout`` bounds the whole run."""
    from ray_lightning_tpu_torch.utils.devices import rank_device

    rank_device(device, 0, num_processes)
    group = WorkerGroup(num_workers=num_processes, env=env,
                        init_hook=init_hook, log_dir=log_dir,
                        transport=transport)
    group.start()
    ok = False
    try:
        init_method = f"tcp://127.0.0.1:{find_free_port()}"
        shared = (fn, tuple(args), dict(kwargs or {}), num_processes,
                  init_method, device)
        rank_extras = [
            (r, tuple(per_rank_args[r]) if per_rank_args else ())
            for r in range(num_processes)]
        out = group.run(_spmd_main, shared_args=shared,
                        per_rank_args=rank_extras,
                        on_queue_item=on_queue_item, timeout=timeout)
        ok = True
        return out
    finally:
        # a failed run leaves its peers blocked in collectives: kill them
        # after a short grace instead of waiting out the usual one
        group.shutdown(timeout=10.0 if ok else 2.0)
