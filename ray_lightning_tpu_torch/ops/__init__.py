"""Compute ops (twin of `ray_lightning_tpu/ops/`): attention, norms,
rotary embeddings, the fused cross-entropy, the ring and Ulysses
sequence-parallel attention and the GPipe pipeline; their hand-written CUDA
kernels live in `ops/kernels/` and `ops/csrc/`. Names resolve on first
use."""
import sys
import types

from ray_lightning_tpu_torch._lazy import lazy_exports

_NAMES = {
    "dot_product_attention": "attention",
    "flash_attention": "attention",
    "make_causal_mask": "attention",
    "fused_cross_entropy": "fused_ce",
    "rms_norm": "norms",
    "apply_rope": "rope",
    "rope_frequencies": "rope",
    "ring_attention": "ring_attention",
    "ring_attention_local": "ring_attention",
    "ulysses_attention": "ulysses",
    "ulysses_attention_local": "ulysses",
    "gpipe_apply": "pipeline",
    "pipeline_param_spec": "pipeline",
}
_MISSING: dict = {}

__all__ = list(_NAMES)

__getattr__, __dir__ = lazy_exports(__name__, _NAMES, _MISSING)


class _Ops(types.ModuleType):
    """This package, whose name ``ring_attention`` is the function (as
    in JAX, which imports it eagerly) though a submodule of that name
    exists: the import system's binding of the submodule onto the
    package, when something imports it first, is not kept."""

    def __setattr__(self, name, value):
        if name == "ring_attention" and isinstance(value, types.ModuleType):
            return
        super().__setattr__(name, value)


sys.modules[__name__].__class__ = _Ops
