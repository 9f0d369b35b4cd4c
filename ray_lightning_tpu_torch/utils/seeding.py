"""Deterministic seeding (twin of `ray_lightning_tpu/utils/seeding.py`).

One seed drives python's `random`, numpy and torch's default generators,
and is exported for worker processes; the trainer derives its parameter
initialisation and per-step generators from it.
"""
from __future__ import annotations

import os
import random
from typing import Optional

import numpy as np
import torch

GLOBAL_SEED_ENV = "RLT_GLOBAL_SEED"


def seed_everything(seed: Optional[int] = None) -> int:
    """Seed python/numpy/torch and export the seed for worker processes.
    Returns the seed actually used (the env var's, or 0 if unset)."""
    if seed is None:
        seed = int(os.environ.get(GLOBAL_SEED_ENV, 0))
    os.environ[GLOBAL_SEED_ENV] = str(seed)
    random.seed(seed)
    np.random.seed(seed % (2**32))
    torch.manual_seed(seed)
    return seed
