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

The rendezvous is a ``TCPStore`` that rank 0 opens before the job on a
port its own bind picks (no port is probed free and bound later, which
another process can take in between), at its advertised address:
loopback for local workers, its channel's address (``RLT_NODE_IP`` when
set) across hosts; the reference's MASTER_ADDR/PORT. Across hosts each
worker drives the card of its LOCAL rank, its index among the ranks of
its host, and the cards are counted on each host, not on the driver's.
"""
from __future__ import annotations

import datetime
import logging
import os
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from ray_lightning_tpu_torch.runtime.group import WorkerGroup
from ray_lightning_tpu_torch.runtime.transport import Transport

log = logging.getLogger(__name__)

#: how long a collective may wait for its peers before the process
#: group gives up (the driver's ``timeout`` usually fires first)
PG_TIMEOUT_S = 600


#: rank 0's rendezvous store, held in its worker process from
#: `_open_store` to the end of `_spmd_main`
_STORE = None


def _open_store(num_processes: int) -> int:
    """Runs on worker 0 before the job: the rendezvous store's server on a
    port of its own bind; returns the port (the reference probed
    MASTER_PORT on worker 0, ray_ddp.py:154-156)."""
    import torch.distributed as dist

    global _STORE
    _STORE = dist.TCPStore(
        "0.0.0.0", 0, num_processes, is_master=True,
        timeout=datetime.timedelta(seconds=PG_TIMEOUT_S),
        wait_for_workers=False)
    return _STORE.port


def local_ranks(num_processes: int,
                hosts: Optional[Sequence[str]]) -> List[Tuple[int, int]]:
    """(local rank, processes on that host) of each rank: rank ``r`` runs
    on ``hosts[r % len(hosts)]``, as `WorkerGroup` places it; without
    hosts every rank is on this machine."""
    if not hosts:
        return [(r, num_processes) for r in range(num_processes)]
    h = len(hosts)
    return [(r // h, len(range(r % h, num_processes, h)))
            for r in range(num_processes)]


def join_group(backend: str, rank: int, num_processes: int,
               rendezvous: Tuple[str, int], **kw) -> None:
    """Join the default process group at rank 0's store (`_open_store`,
    run first in worker 0 of the same group)."""
    import torch.distributed as dist

    host, port = rendezvous
    timeout = datetime.timedelta(seconds=PG_TIMEOUT_S)
    store = _STORE if rank == 0 else dist.TCPStore(
        host, port, num_processes, is_master=False, timeout=timeout)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=num_processes, timeout=timeout, **kw)


def _spmd_main(fn: Callable, args: tuple, kwargs: dict, num_processes: int,
               rendezvous: Tuple[str, int], device: Optional[str], rank: int,
               rank_args: tuple, local: Tuple[int, int]):
    """Body run by every worker: bind the rank's device, join the process
    group at rank 0's store, run ``fn``. Shared prefix first, per-rank
    suffix last, as `WorkerGroup.run`'s ship-once split wants. ``local``
    is (local rank, processes on this host)."""
    global _STORE
    import torch
    import torch.distributed as dist

    from ray_lightning_tpu_torch.utils.devices import (
        LOCAL_RANK_ENV,
        rank_device,
    )

    local_rank, local_world = local
    host, port = rendezvous
    os.environ[LOCAL_RANK_ENV] = str(local_rank)
    os.environ["RANK"] = str(rank)
    os.environ["WORLD_SIZE"] = str(num_processes)
    os.environ["MASTER_ADDR"], os.environ["MASTER_PORT"] = host, str(port)
    # one card a process, counted on this host
    dev = rank_device(device, local_rank, local_world)
    kw = {}
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        kw["device_id"] = dev
    join_group("nccl" if dev.type == "cuda" else "gloo", rank,
               num_processes, rendezvous, **kw)
    result = fn(*args, *rank_args, **kwargs)
    # success path only: on an exception the peers may be inside a
    # collective, and the driver tears the failed group down instead
    dist.destroy_process_group()
    _STORE = None
    return result


def launch(fn: Callable, num_processes: int, *, args: tuple = (),
           kwargs: Optional[dict] = None, device: Optional[str] = None,
           env: Optional[Dict[str, str]] = None,
           init_hook: Optional[Callable[[], None]] = None,
           on_queue_item: Optional[Callable[[int, Any], None]] = None,
           per_rank_args: Optional[Sequence[tuple]] = None,
           log_dir: Optional[str] = None, timeout: Optional[float] = None,
           hosts: Optional[Sequence[str]] = None,
           transport: Optional[Transport] = None,
           watchdog: Optional[Callable[[], None]] = None) -> List[Any]:
    """Run ``fn`` in ``num_processes`` processes joined in one process
    group; returns the per-rank results in rank order (rank 0's is the
    conventional carrier of results).

    ``device``: None is the card (one per process; more processes than
    cards raise "num_workers > devices", before any worker starts when
    they share the driver's machine, in the worker of a remote host),
    ``"cpu"`` the CPU over gloo. ``hosts`` and a remote ``transport``
    place rank ``r`` on ``hosts[r % len(hosts)]``. ``fn`` runs after
    ``init_process_group``. ``timeout`` bounds the whole run;
    ``watchdog`` runs in the driver's pump (`WorkerGroup.wait`)."""
    if not hosts:
        from ray_lightning_tpu_torch.utils.devices import rank_device

        rank_device(device, 0, num_processes)
    group = WorkerGroup(num_workers=num_processes, env=env,
                        init_hook=init_hook, log_dir=log_dir,
                        hosts=hosts, transport=transport)
    group.start()
    ok = False
    try:
        # rank 0 serves the rendezvous at its advertised address
        host0 = (group.executors[0].get_node_ip() if group.is_remote
                 else "127.0.0.1")
        rendezvous = (host0, group.run_single(0, _open_store, num_processes,
                                              timeout=60))
        log.info("rendezvous at %s:%d (worker 0)", *rendezvous)
        shared = (fn, tuple(args), dict(kwargs or {}), num_processes,
                  rendezvous, device)
        locals_ = local_ranks(num_processes, hosts)
        rank_extras = [
            (r, tuple(per_rank_args[r]) if per_rank_args else (),
             locals_[r])
            for r in range(num_processes)]
        out = group.run(_spmd_main, shared_args=shared,
                        per_rank_args=rank_extras,
                        on_queue_item=on_queue_item, timeout=timeout,
                        watchdog=watchdog)
        ok = True
        return out
    finally:
        # a failed run leaves its peers blocked in collectives: kill them
        # after a short grace instead of waiting out the usual one
        group.shutdown(timeout=10.0 if ok else 2.0)
