"""ray_lightning_tpu_torch: the PyTorch + CUDA port of ray_lightning_tpu.

The JAX package (`ray_lightning_tpu`) stays the reference; this package
grows beside it slice by slice: serving (`serve.scheduler.Scheduler` ->
`serve.engine.DecodeEngine` -> `models.llama.Llama` over the block-paged
KV pool), training on one card (`core.trainer.Trainer`, with the hot
loop of `pipeline`), training across processes and hosts
(`runtime.fit.fit_distributed` under `parallel.strategy.DataParallel` /
`FSDP`, with `checkpoint.io`; ``hosts=`` with `runtime.SSHTransport`),
the sweep (`sweep.run`), its supervision (`resilience`, with the elastic
world-size ladder of `elastic`), telemetry, and the closed-loop serving
autoscaler (`autoscale`) under trace-driven load (`loadgen`).
The hand-written Hopper kernels live in `ops/kernels/` and `ops/csrc/`.

The top level mirrors the JAX package's ``__all__`` name for name, so a
script switches packages with its import line::

    import ray_lightning_tpu_torch as rlt
    rlt.Trainer(strategy=rlt.FSDP()).fit(module, loader)

A JAX name the port does not have raises `NotPortedError` naming its
ROADMAP item or its reason. Entry points run on the CUDA card unless the
caller passes ``device="cpu"``; on the CPU every kernel wrapper runs its
plain PyTorch version. Importing the package imports nothing else (no
torch): every name resolves on first use, and worker processes of
`runtime/` import only what their job needs.
"""
from ray_lightning_tpu_torch._lazy import NotPortedError, lazy_exports

__version__ = "0.1.0"

_NAMES = {
    "TpuModule": "core.module",
    "Trainer": "core.trainer",
    "TrainState": "core.state",
    "DataLoader": "core.data",
    "DataModule": "core.data",
    **{n: "core.callbacks" for n in (
        "Callback", "EarlyStopping", "ModelCheckpoint", "ProgressLogger",
        "MemoryMonitor", "ThroughputMonitor")},
    **{n: "parallel.strategy" for n in (
        "Strategy", "DataParallel", "FSDP", "ShardedMesh", "SingleDevice",
        "RayXlaPlugin")},
    "MeshSpec": "parallel.mesh",
    "make_mesh": "parallel.mesh",
    "WorkerError": "runtime.group",
    "WorkerGroup": "runtime.group",
    "launch": "runtime.launch",
    "seed_everything": "utils.seeding",
    "sweep": "sweep:",
    "pipeline": "pipeline:",
    "DevicePrefetcher": "pipeline.prefetch",
    **{n: "resilience" for n in (
        "GuardCallback", "GuardConfig", "ResilienceConfig", "RetryPolicy",
        "SupervisedResult", "fit_supervised", "supervise")},
    "telemetry": "telemetry:",
    "TelemetryConfig": "telemetry",
    "ProfileConfig": "telemetry",
    "resolve_device": "utils.devices",
    "elastic": "elastic:",
    "ElasticBudget": "elastic.budget",
    "reshard_restore": "elastic.reshard",
}

#: JAX names the port leaves out, and why
_MISSING = {
    "launch_cpu_spmd": "JAX CPU SPMD (jax.distributed over virtual CPU "
                       "devices); the port's analog is launch(..., "
                       "device='cpu'), processes joined over gloo",
    "simulate_cpu_devices": "JAX-only (XLA's virtual CPU devices); the "
                            "port runs one process a device, on gloo "
                            "for the CPU",
}

__all__ = [*_NAMES, "__version__"]

__getattr__, __dir__ = lazy_exports(__name__, _NAMES, _MISSING)
