"""Runtime (twin of `ray_lightning_tpu/runtime/`): worker launch, env
bootstrap, job shipping, result futures, the side-channel queue, and the
process group every worker joins.

Replaces the reference's use of Ray core (actors, object store, queue
actor, reference ray_ddp.py:17-39,106-213, util.py:22-109,
session.py:1-63) with subprocesses, ``multiprocessing.connection`` and
the standard pickle, and its MASTER_ADDR/PORT rendezvous
(ray_ddp.py:152-156) with ``torch.distributed.init_process_group``.
Importing it imports no torch: a worker pays for torch only when its job
needs it.
"""
from ray_lightning_tpu_torch.runtime.fit import (
    FitResult,
    fit_distributed,
    predict_distributed,
    run_distributed,
    test_distributed,
    validate_distributed,
)
from ray_lightning_tpu_torch.runtime.group import (
    TpuExecutor,
    WorkerError,
    WorkerGroup,
    routable_ip,
)
from ray_lightning_tpu_torch.runtime.launch import launch
from ray_lightning_tpu_torch.runtime.session import (
    get_actor_rank,
    get_session,
    get_world_size,
    init_session,
    is_session_enabled,
    put_queue,
    reset_session,
)
from ray_lightning_tpu_torch.runtime.transport import (
    LocalTransport,
    LoopbackTransport,
    SSHTransport,
    Transport,
)
from ray_lightning_tpu_torch.utils.dist import find_free_port
from ray_lightning_tpu_torch._lazy import lazy_exports

__all__ = [
    "FitResult", "fit_distributed", "run_distributed",
    "validate_distributed", "test_distributed", "predict_distributed",
    "TpuExecutor", "WorkerError", "WorkerGroup", "find_free_port",
    "routable_ip", "launch", "LocalTransport", "LoopbackTransport",
    "SSHTransport", "Transport", "get_actor_rank", "get_session",
    "get_world_size", "init_session", "is_session_enabled", "put_queue",
    "reset_session",
]

__getattr__, __dir__ = lazy_exports(__name__, {}, {
    "launch_cpu_spmd": "JAX CPU SPMD (jax.distributed over virtual CPU "
                       "devices); the port's analog is launch(..., "
                       "device='cpu'), processes joined over gloo"})
