"""ray_lightning_tpu_torch: the PyTorch + CUDA port of ray_lightning_tpu.

The JAX package (`ray_lightning_tpu`) stays the reference; this package
grows beside it slice by slice. The first slice is the serving path:
`serve.scheduler.Scheduler` -> `serve.engine.DecodeEngine` ->
`models.llama.Llama` over the block-paged KV pool, with hand-written
Hopper kernels for paged decode attention, paged prefill attention and
RMSNorm (`ops/kernels/`, `ops/csrc/`).

Entry points run on the CUDA card unless the caller passes
``device="cpu"``; on the CPU every kernel wrapper runs its plain PyTorch
version.
"""
from ray_lightning_tpu_torch.utils.devices import resolve_device

__all__ = ["resolve_device"]
