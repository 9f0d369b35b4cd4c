"""Checkpoint I/O (twin of `ray_lightning_tpu/checkpoint/`), on
`torch.distributed.checkpoint`."""
from ray_lightning_tpu_torch.checkpoint.io import (
    latest_checkpoint,
    load_checkpoint,
    restore_checkpoint,
    save_checkpoint,
    sharding_provenance,
    verify_checkpoint,
    wait_for_checkpoints,
)

__all__ = ["save_checkpoint", "load_checkpoint", "latest_checkpoint",
           "restore_checkpoint", "sharding_provenance",
           "verify_checkpoint", "wait_for_checkpoints"]
