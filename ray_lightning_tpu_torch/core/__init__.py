"""Training core (twin of `ray_lightning_tpu/core/`): the module, the
trainer and its state, data loading and callbacks. Names resolve on
first use."""
from ray_lightning_tpu_torch._lazy import lazy_exports

_NAMES = {
    "TpuModule": "module",
    "Trainer": "trainer",
    "TrainState": "state",
    "DataLoader": "data",
    "DataModule": "data",
    **{n: "text" for n in (
        "chunk_tokens", "pack_sequences", "tokenize_and_pack")},
    **{n: "callbacks" for n in (
        "Callback", "EarlyStopping", "ModelCheckpoint", "ProgressLogger",
        "MemoryMonitor", "ThroughputMonitor")},
}
__all__ = list(_NAMES)

__getattr__, __dir__ = lazy_exports(__name__, _NAMES)
