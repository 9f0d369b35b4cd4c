"""Compute ops (twin of `ray_lightning_tpu/ops/`): attention, norms,
rotary embeddings, the fused cross-entropy; their hand-written CUDA
kernels live in `ops/kernels/` and `ops/csrc/`. Names resolve on first
use."""
from ray_lightning_tpu_torch._lazy import lazy_exports

_NAMES = {
    "dot_product_attention": "attention",
    "flash_attention": "attention",
    "make_causal_mask": "attention",
    "fused_cross_entropy": "fused_ce",
    "rms_norm": "norms",
    "apply_rope": "rope",
    "rope_frequencies": "rope",
}
_MISSING = {n: "ROADMAP Queue 1 item 13 (ring, Ulysses and pipeline "
               "collectives)" for n in (
    "ulysses_attention", "ulysses_attention_local", "ring_attention",
    "ring_attention_local", "gpipe_apply", "pipeline_param_spec")}

__all__ = list(_NAMES)

__getattr__, __dir__ = lazy_exports(__name__, _NAMES, _MISSING)
