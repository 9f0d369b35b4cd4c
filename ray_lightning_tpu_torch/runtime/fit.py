"""Distributed jobs: the state round-trip over the runtime (twin of
`ray_lightning_tpu/runtime/fit.py`).

Rebuild of the reference's core protocol (reference ray_ddp.py:143-199):
the driver ships a job to N workers, the workers run one `Trainer` entry
point jointly (`fit | validate | test | predict`), and rank 0's metrics,
`best_model_path`, checkpoint path, weights or predictions come back and
are patched into the driver's objects.

As in the JAX package, the workers get the module's FACTORY, not a live
trainer; the weights come back as a full state dict on the host only
when asked (``return_weights``), else as a checkpoint path — an 8B model
never funnels through a driver pickle. The factories travel by the
standard `pickle` (by reference: module-level callables,
`functools.partial`, instances of module-level classes).
"""
from __future__ import annotations

import dataclasses
import logging
import os
from typing import Any, Callable, Dict, List, Optional

from ray_lightning_tpu_torch.runtime.launch import launch
from ray_lightning_tpu_torch.runtime.transport import Transport

log = logging.getLogger(__name__)

_KINDS = ("fit", "validate", "test", "predict")


@dataclasses.dataclass
class FitResult:
    """What comes back from rank 0 (the reference's tuple at
    ray_ddp.py:186, as a type)."""

    metrics: Dict[str, Any]
    best_model_path: Optional[str]
    state_dict: Optional[Dict[str, Any]]  # host tensors, or None
    checkpoint_path: Optional[str]
    predictions: Optional[List[Any]] = None  # kind="predict" only


def _job_remote(kind: str, module_factory: Callable[[], Any],
                trainer_factory: Callable[[], Any],
                data_factory: Callable[[], Any], return_weights: bool,
                final_ckpt_dir: Optional[str], ckpt_path: Optional[str]):
    """Runs in EVERY worker after the process group is up (the analog of
    train_remote, reference ray_ddp.py:217-246)."""
    import numpy as np
    import torch.distributed as dist

    from ray_lightning_tpu_torch.core.data import DataModule, ensure_sharded

    module = module_factory()
    trainer = trainer_factory()
    data = data_factory()
    rank, world = dist.get_rank(), dist.get_world_size()

    if isinstance(data, DataModule):
        data.setup()
        if kind == "fit":
            data = (data.train_dataloader(), data.val_dataloader())
        else:
            data = {"validate": data.val_dataloader,
                    "test": data.test_dataloader,
                    "predict": data.predict_dataloader}[kind]()

    if kind != "fit":
        data = ensure_sharded(data, world, rank, stage=kind)
        if ckpt_path is not None:
            # the weights from a checkpoint, read whole on every rank
            # (the small-model path; a fit resumes through the sharded
            # restore instead)
            from ray_lightning_tpu_torch.checkpoint import load_checkpoint

            ckpt = load_checkpoint(ckpt_path)
            module.params = ckpt["params"]
            module.on_load_checkpoint(ckpt)
        runner = {"validate": trainer.validate, "test": trainer.test,
                  "predict": trainer.predict}[kind]
        out = runner(module, data)
        if kind == "predict":
            # the global batch is rank 0's rows, then rank 1's, ...
            gathered = [None] * world if rank == 0 else None
            dist.gather_object(out, gathered, dst=0)
            if rank != 0:
                return None
            preds = [np.concatenate([g[b] for g in gathered])
                     for b in range(len(out))]
            return FitResult(metrics=dict(trainer.callback_metrics),
                             best_model_path=None, state_dict=None,
                             checkpoint_path=None, predictions=preds)
        if rank != 0:
            return None
        return FitResult(metrics=dict(out), best_model_path=None,
                         state_dict=None, checkpoint_path=None)

    if not isinstance(data, tuple):
        data = (data, None)
    train_data, val_data = data
    # the reference's forcing guarantee (ray_ddp.py:293-303): shard
    # arguments are injected, unshardable inputs are an error
    train_data = ensure_sharded(train_data, world, rank, stage="train")
    val_data = ensure_sharded(val_data, world, rank, stage="val")
    trainer.fit(module, train_data, val_data, ckpt_path=ckpt_path)

    out_ckpt = None
    if final_ckpt_dir is not None:
        out_ckpt = trainer.save_checkpoint(
            os.path.join(final_ckpt_dir, "final"))
    state_dict = None
    if return_weights:
        from torch.distributed.checkpoint.state_dict import (
            StateDictOptions,
            get_model_state_dict,
        )

        # collective: every rank gives its shards, rank 0 gets the whole
        full = get_model_state_dict(module.model, options=StateDictOptions(
            full_state_dict=True, cpu_offload=True))
        if rank == 0:
            state_dict = full
    best = None
    if trainer.checkpoint_callback is not None:
        best = trainer.checkpoint_callback.best_model_path
    if rank == 0:
        return FitResult(metrics=dict(trainer.callback_metrics),
                         best_model_path=best, state_dict=state_dict,
                         checkpoint_path=out_ckpt)
    return None


def run_distributed(kind: str, module_factory: Callable[[], Any],
                    trainer_factory: Callable[[], Any],
                    data_factory: Callable[[], Any], num_processes: int, *,
                    module: Optional[Any] = None,
                    ckpt_path: Optional[str] = None,
                    device: Optional[str] = None,
                    env: Optional[Dict[str, str]] = None,
                    init_hook: Optional[Callable[[], None]] = None,
                    on_queue_item: Optional[Callable[[int, Any], None]] = None,
                    return_weights: bool = True,
                    final_ckpt_dir: Optional[str] = None,
                    timeout: Optional[float] = None,
                    log_dir: Optional[str] = None,
                    transport: Optional[Transport] = None,
                    watchdog: Optional[Callable[[], None]] = None,
                    resilience: Optional[Any] = None) -> FitResult:
    """Run one Trainer job (`fit|validate|test|predict`) in
    ``num_processes`` processes; return rank 0's results.

    For fit, ``data_factory`` returns a train loader or a (train, val)
    tuple; for the eval kinds that kind's loader. ``ckpt_path`` resumes a
    fit, or supplies the weights of an eval-family job. ``device``:
    None is the card (one per process), ``"cpu"`` the CPU over gloo.
    With ``module`` and returned weights, the driver's module holds the
    trained weights afterwards (reference ray_ddp.py:190).

    ``resilience=ResilienceConfig(...)`` runs the job under the
    supervisor (`resilience.supervisor`): a killed, preempted or hung
    worker restarts the group, which resumes from the latest valid
    checkpoint instead of losing the run. Returns the final FitResult;
    call `supervise` directly for the restart ledger. ``watchdog`` runs
    about once a second in the driver's pump (the stall monitor's
    hook)."""
    if kind not in _KINDS:
        raise ValueError(f"kind must be one of {_KINDS}, got {kind!r}")
    if resilience is not None:
        # lazy: the supervisor imports this module
        from ray_lightning_tpu_torch.resilience.supervisor import supervise

        supervised = supervise(
            kind, module_factory, trainer_factory, data_factory,
            num_processes, resilience=resilience, watchdog=watchdog,
            module=module, ckpt_path=ckpt_path, device=device, env=env,
            init_hook=init_hook, on_queue_item=on_queue_item,
            return_weights=return_weights, final_ckpt_dir=final_ckpt_dir,
            timeout=timeout, log_dir=log_dir, transport=transport)
        if supervised.restarts or supervised.preemptions:
            log.info("supervised %s finished after %d restart(s) / %d "
                     "preemption resume(s)", kind, supervised.restarts,
                     supervised.preemptions)
        return supervised.result
    if module is not None and module.device is None:
        from ray_lightning_tpu_torch.utils.devices import resolve_device

        # the driver's module takes the job's device (the card unless
        # device="cpu"), not wherever configure_model would build it
        module.device = resolve_device(device)
    results: List[Any] = launch(
        _job_remote, num_processes,
        args=(kind, module_factory, trainer_factory, data_factory,
              return_weights, final_ckpt_dir, ckpt_path),
        device=device, env=env, init_hook=init_hook,
        on_queue_item=on_queue_item, timeout=timeout, log_dir=log_dir,
        transport=transport, watchdog=watchdog)
    result = results[0]
    if not isinstance(result, FitResult):
        raise TypeError(f"rank 0 returned {type(result)}; expected "
                        "FitResult")
    if kind == "fit" and module is not None and result.state_dict is not None:
        import torch

        module.setup()
        with torch.no_grad():
            module.model.load_state_dict(result.state_dict, strict=True)
        module.params = dict(module.model.named_parameters())
    return result


def fit_distributed(module_factory, trainer_factory, data_factory,
                    num_processes: int, **kw) -> FitResult:
    """Distributed ``Trainer.fit`` round-trip (reference
    ray_ddp.py:143-199). See `run_distributed`."""
    return run_distributed("fit", module_factory, trainer_factory,
                           data_factory, num_processes, **kw)


def validate_distributed(module_factory, trainer_factory, data_factory,
                         num_processes: int, **kw) -> FitResult:
    """Distributed ``Trainer.validate``; metrics return from rank 0."""
    return run_distributed("validate", module_factory, trainer_factory,
                           data_factory, num_processes, **kw)


def test_distributed(module_factory, trainer_factory, data_factory,
                     num_processes: int, **kw) -> FitResult:
    """Distributed ``Trainer.test``; metrics return from rank 0."""
    return run_distributed("test", module_factory, trainer_factory,
                           data_factory, num_processes, **kw)


def predict_distributed(module_factory, trainer_factory, data_factory,
                        num_processes: int, **kw) -> FitResult:
    """Distributed ``Trainer.predict``; the predictions of every rank,
    batch by batch in rank order, return from rank 0."""
    return run_distributed("predict", module_factory, trainer_factory,
                           data_factory, num_processes, **kw)
