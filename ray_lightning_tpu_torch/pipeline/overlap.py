"""Measured evidence that the prefetch overlap works (twin of
`ray_lightning_tpu/pipeline/overlap.py`).

PyTorch enqueues CUDA work asynchronously, so a slow loader is hidden as
long as nothing synchronises; but every real loop synchronises (metric
logging, validation, checkpoints). Once a step's output is fetched, the
host serialises loader and fetch each step and the device starves for
the loader's time. This harness builds that case on purpose: a metric
fetch every step (``log_every_n_steps=1``) and a `ThrottledLoader`
whose delay a batch is calibrated to a share of the measured step time
(the gain is at most (step + delay) / step, reached only if the
pipeline really overlaps), then compares steps/s with the prefetcher
off and on.

The same harness reports the warm start: the calibration fit's
``compile_time_s`` is the process's first (cold) warm-up, a later fit's
the warm one.

On the CPU the model is the JAX harness's (batch 128, 256 -> 512 -> 512
-> 2). On a card that model takes a fraction of the loader's 2 ms floor
a step, and a loader slower than the step leaves nothing to prefetch
ahead; so there the hidden layers are 12288 wide (batch 512), a step of
several ms of matmuls against a 512 KB batch.
"""
from __future__ import annotations

import time
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ray_lightning_tpu_torch.core.callbacks import Callback
from ray_lightning_tpu_torch.core.module import TpuModule


class _OverlapModel(TpuModule):
    """Two hidden ReLU layers and a 2-way head under Adam: the JAX
    harness's model."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.dim, self.hidden = dim, hidden

    def configure_model(self):
        return nn.Sequential(nn.Linear(self.dim, self.hidden), nn.ReLU(),
                             nn.Linear(self.hidden, self.hidden), nn.ReLU(),
                             nn.Linear(self.hidden, 2))

    def configure_optimizers(self):
        return torch.optim.Adam(self.model.parameters(), lr=1e-3)

    def training_step(self, params, batch, rng):
        return F.cross_entropy(self.model(batch["x"]), batch["y"].long())


class _StepSpan(Callback):
    """Wall time across the timed steps only: the warm-up, the state's
    build and the first batch's pipeline fill are left out, so the ratio
    is the steady state's."""

    def __init__(self):
        self.first: Optional[float] = None
        self.last: Optional[float] = None
        self.steps = 0

    def on_train_batch_end(self, trainer, module, metrics, batch_idx):
        now = time.perf_counter()
        if self.first is None:
            self.first = now
        self.last = now
        self.steps += 1

    @property
    def steps_per_sec(self) -> float:
        if self.first is None or self.steps < 2:
            return 0.0
        return (self.steps - 1) / max(self.last - self.first, 1e-9)


def _one_fit(data: Dict[str, np.ndarray], *, batch: int, steps: int,
             delay_s: float, prefetch: int, dim: int, hidden: int,
             device: Any, seed: int = 0) -> tuple:
    from ray_lightning_tpu_torch.core.data import DataLoader, ThrottledLoader
    from ray_lightning_tpu_torch.core.trainer import Trainer
    from ray_lightning_tpu_torch.parallel.strategy import SingleDevice

    span = _StepSpan()
    loader: Any = DataLoader(data, batch_size=batch)
    if delay_s > 0:
        loader = ThrottledLoader(loader, delay_s)
    trainer = Trainer(
        strategy=SingleDevice(device=device),
        max_epochs=1_000_000,  # max_steps ends the fit
        max_steps=steps,
        log_every_n_steps=1,   # the per-step sync every real loop has
        enable_checkpointing=False,
        enable_progress_bar=False,
        seed=seed,
        prefetch_to_device=prefetch,
        callbacks=[span],
    )
    trainer.fit(_OverlapModel(dim, hidden), loader)
    return span, trainer


#: the calibrated loader delay's share of the measured step
DELAY_SHARE = 0.6
#: (batch, dim, hidden) of the harness's model by device type
SIZES = {"cpu": (128, 256, 512), "cuda": (512, 256, 12288)}


def measure_prefetch_overlap(
    steps: int = 40,
    depth: int = 2,
    batch: Optional[int] = None,
    dim: Optional[int] = None,
    hidden: Optional[int] = None,
    delay_s: Optional[float] = None,
    cache_dir: Optional[str] = None,
    device: Any = None,
) -> Dict[str, Any]:
    """Calibrate, then run the synchronous and the prefetched fit; one
    flat dict for a JSON line (the JAX keys).

    ``batch``, ``dim`` and ``hidden`` default to the device's `SIZES`.
    ``delay_s=None`` sets the loader's delay to `DELAY_SHARE` of the
    measured step time, clamped to [2 ms, 100 ms]. ``cache_dir`` builds and loads the
    kernel libraries there for these fits and restores the previous
    directory after. ``device``: None is the card.
    """
    from ray_lightning_tpu_torch.pipeline.compile_cache import (
        active_cache_dir,
        enable_persistent_cache,
    )
    from ray_lightning_tpu_torch.utils.devices import resolve_device

    sizes = SIZES[resolve_device(device).type]
    batch, dim, hidden = (given if given is not None else default
                          for given, default in zip((batch, dim, hidden),
                                                    sizes))

    previous = active_cache_dir()
    if cache_dir is not None:
        enable_persistent_cache(cache_dir)
    n = batch * (steps + depth + 4)
    rng = np.random.default_rng(0)
    data = {
        "x": rng.standard_normal((n, dim), dtype=np.float32),
        "y": rng.integers(0, 2, n).astype(np.int64),
    }
    common = dict(batch=batch, steps=steps, dim=dim, hidden=hidden,
                  device=device)
    try:
        # calibration: no delay, no prefetch; it measures the step and
        # pays the process's cold warm-up
        cal_span, cal_trainer = _one_fit(data, delay_s=0.0, prefetch=0,
                                         **common)
        step_s = ((1.0 / cal_span.steps_per_sec)
                  if cal_span.steps_per_sec else 0.01)
        if delay_s is None:
            # BELOW the step, so the producer keeps ahead and the
            # occupancy the smoke gates on is not a coin flip. Lower
            # than the JAX harness's 0.85: the producer thread shares the
            # GIL with the step's Python, so its wake-ups lag (at 0.85 an
            # H100's loop overlapped 1.96x with every batch landing just
            # after the step asked: occupancy 0)
            delay_s = min(max(DELAY_SHARE * step_s, 0.002), 0.1)
        sync_span, _ = _one_fit(data, delay_s=delay_s, prefetch=0,
                                **common)
        pre_span, pre_trainer = _one_fit(data, delay_s=delay_s,
                                         prefetch=depth, **common)
    finally:
        if cache_dir is not None:
            enable_persistent_cache(previous)
    sync_sps = sync_span.steps_per_sec
    pre_sps = pre_span.steps_per_sec
    m = pre_trainer.callback_metrics
    return {
        "metric": "prefetch_overlap_speedup",
        "value": round(pre_sps / sync_sps, 3) if sync_sps else 0.0,
        "unit": "x",
        "steps": steps,
        "prefetch_depth": depth,
        "loader_delay_ms": round(delay_s * 1e3, 2),
        "calibrated_step_ms": round(step_s * 1e3, 2),
        "steps_per_sec_sync": round(sync_sps, 2),
        "steps_per_sec_prefetch": round(pre_sps, 2),
        "pipeline_occupancy": round(
            float(m.get("prefetch_occupancy", 0.0)), 3),
        "prefetch_wait_s": round(float(m.get("prefetch_wait_s", 0.0)), 4),
        # the calibration fit paid the process's first warm-up; the
        # prefetched fit's found everything loaded
        "compile_cold_s": round(float(cal_trainer.callback_metrics.get(
            "compile_time_s", 0.0)), 4),
        "compile_warm_s": round(float(m.get("compile_time_s", 0.0)), 4),
        "compile_cache_dir": cache_dir or previous,
        "device": str(pre_trainer.strategy.device),
        "model": {"batch": batch, "dim": dim, "hidden": hidden},
    }
