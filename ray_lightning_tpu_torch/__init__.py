"""ray_lightning_tpu_torch: the PyTorch + CUDA port of ray_lightning_tpu.

The JAX package (`ray_lightning_tpu`) stays the reference; this package
grows beside it slice by slice: serving (`serve.scheduler.Scheduler` ->
`serve.engine.DecodeEngine` -> `models.llama.Llama` over the block-paged
KV pool), training on one card (`core.trainer.Trainer`), and training
across processes (`runtime.fit.fit_distributed` under
`parallel.strategy.DataParallel` / `FSDP`, with `checkpoint.io`). The
hand-written Hopper kernels live in `ops/kernels/` and `ops/csrc/`.

Entry points run on the CUDA card unless the caller passes
``device="cpu"``; on the CPU every kernel wrapper runs its plain PyTorch
version. Importing the package imports nothing else: worker processes
of `runtime/` import only what their job needs.
"""

__all__ = ["resolve_device"]


def __getattr__(name):
    if name == "resolve_device":
        from ray_lightning_tpu_torch.utils.devices import resolve_device

        return resolve_device
    raise AttributeError(name)
