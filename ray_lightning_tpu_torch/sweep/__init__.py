"""HPO sweep layer (twin of `ray_lightning_tpu/sweep/`): the reference's
Ray Tune integration (reference tune.py + examples/ray_ddp_tune.py) with
trials placed on CUDA cards.

Surface:
    analysis = sweep.run(trainable, config={...}, num_samples=8,
                         metric="val_loss", mode="min",
                         scheduler=sweep.ASHAScheduler(),
                         resources_per_trial=sweep.GpuResources(gpus=1))
    analysis.best_config / analysis.best_checkpoint

Inside a trainable: ``sweep.report(loss=...)`` directly, or attach
``TuneReportCallback`` / ``TuneReportCheckpointCallback`` to the Trainer.
"""
from ray_lightning_tpu_torch.sweep.analysis import ExperimentAnalysis, Trial
from ray_lightning_tpu_torch.sweep.callbacks import (
    TuneReportCallback,
    TuneReportCheckpointCallback,
)
from ray_lightning_tpu_torch.sweep.resources import GpuResources, ResourcePool
from ray_lightning_tpu_torch.sweep.schedulers import (
    ASHAScheduler,
    FIFOScheduler,
    MedianStoppingRule,
    TrialScheduler,
)
from ray_lightning_tpu_torch.sweep.session import (
    TrialStopped,
    get_checkpoint,
    get_trial_dir,
    get_trial_hosts,
    get_trial_id,
    is_trial_session_enabled,
    report,
)
from ray_lightning_tpu_torch.sweep.space import (
    choice,
    expand,
    grid_search,
    loguniform,
    randint,
    uniform,
)
from ray_lightning_tpu_torch.sweep.tuner import SweepError, run
from ray_lightning_tpu_torch._lazy import lazy_exports

__all__ = [
    "run",
    "SweepError",
    "ExperimentAnalysis",
    "Trial",
    "TuneReportCallback",
    "TuneReportCheckpointCallback",
    "GpuResources",
    "ResourcePool",
    "TrialScheduler",
    "FIFOScheduler",
    "ASHAScheduler",
    "MedianStoppingRule",
    "report",
    "get_trial_id",
    "get_trial_dir",
    "get_checkpoint",
    "get_trial_hosts",
    "is_trial_session_enabled",
    "TrialStopped",
    "choice",
    "uniform",
    "loguniform",
    "randint",
    "grid_search",
    "expand",
]

__getattr__, __dir__ = lazy_exports(__name__, {}, {
    "TpuResources": "the port's block is GpuResources(gpus=, hosts=, "
                    "cpus=): it counts CUDA cards and hands out their "
                    "indices, where TpuResources(chips=, hosts=, cpus=) "
                    "counts TPU chips; chips= has no meaning here"})
