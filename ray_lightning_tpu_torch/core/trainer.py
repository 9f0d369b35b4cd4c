"""Trainer: owns the train/eval loops (twin of
`ray_lightning_tpu/core/trainer.py`).

The JAX trainer compiles one program per step (`value_and_grad` plus the
optax update under `jit`, the state donated). PyTorch runs eagerly, so a
step here is the module's loss, its backward, the global-norm clip and
the optimizer and schedule updates, issued in order on the device:

  * gradients are averaged over ``accumulate_grad_batches`` microbatches
    (the batch's leading axis is split, as the JAX scan does);
  * ``gradient_clip_val`` clips by global norm before the update, exactly
    as ``optax.clip_by_global_norm`` (no epsilon);
  * the step's metrics carry ``loss`` and ``grad_norm`` (of the unclipped
    gradients) and stay on the device; they are fetched to the host only
    every ``log_every_n_steps`` and at the end of an epoch.

Knobs whose machinery is not ported yet raise `NotImplementedError` when
set, naming the ROADMAP item: ``guard``, ``telemetry``, ``profile``,
``profiler_dir``, ``compile_cache_dir``, ``enable_checkpointing=True``
(the default, as in JAX: callers in this slice pass False) and
``ckpt_path``.
"""
from __future__ import annotations

import itertools
import logging
from typing import Any, Dict, Iterable, List, Optional

import numpy as np
import torch

from ray_lightning_tpu_torch.core.callbacks import Callback, ProgressLogger
from ray_lightning_tpu_torch.core.data import DataModule
from ray_lightning_tpu_torch.core.module import TpuModule
from ray_lightning_tpu_torch.core.state import TrainState
from ray_lightning_tpu_torch.parallel.strategy import SingleDevice, Strategy
from ray_lightning_tpu_torch.utils.seeding import seed_everything

log = logging.getLogger(__name__)

#: knob -> the ROADMAP item that brings its machinery
_NOT_PORTED = {
    "guard": "Queue 1 item 10 (resilience/guard.py)",
    "telemetry": "Queue 1 item 11 (telemetry/)",
    "profile": "Queue 1 item 11 (telemetry/profiler.py)",
    "profiler_dir": "Queue 1 item 11 (telemetry/profiler.py)",
    "compile_cache_dir": "Queue 1 item 7 (pipeline/compile_cache.py)",
    "enable_checkpointing": "Queue 1 item 5 (checkpoint/io.py)",
}


def _not_ported(knob: str) -> NotImplementedError:
    return NotImplementedError(
        f"Trainer({knob}=...) is not ported yet (ROADMAP "
        f"{_NOT_PORTED[knob]})")


class Trainer:
    def __init__(
        self,
        strategy: Optional[Strategy] = None,
        max_epochs: int = 1,
        max_steps: int = -1,
        callbacks: Optional[List[Callback]] = None,
        limit_train_batches: Optional[int] = None,
        limit_val_batches: Optional[int] = None,
        limit_test_batches: Optional[int] = None,
        check_val_every_n_epoch: int = 1,
        val_check_interval: Optional[int] = None,
        log_every_n_steps: int = 50,
        accumulate_grad_batches: int = 1,
        gradient_clip_val: Optional[float] = None,
        precision: str = "f32",  # "f32" | "bf16" (cast float inputs)
        seed: Optional[int] = None,
        default_root_dir: Optional[str] = None,
        enable_checkpointing: bool = True,
        enable_progress_bar: bool = True,
        profiler_dir: Optional[str] = None,
        num_sanity_val_steps: int = 0,
        prefetch_to_device: int = 2,
        warm_start: bool = True,
        compile_cache_dir: Optional[str] = None,
        guard: Any = None,
        telemetry: Any = None,
        profile: Any = None,
    ):
        for knob, value in (("guard", guard), ("telemetry", telemetry),
                            ("profile", profile),
                            ("profiler_dir", profiler_dir),
                            ("compile_cache_dir", compile_cache_dir),
                            ("enable_checkpointing", enable_checkpointing)):
            if value:
                raise _not_ported(knob)
        if precision not in ("f32", "bf16"):
            raise ValueError(f"precision must be 'f32' or 'bf16', got "
                             f"{precision!r}")
        self.strategy = strategy or SingleDevice()
        self.max_epochs = max_epochs
        self.max_steps = max_steps
        self.limit_train_batches = limit_train_batches
        self.limit_val_batches = limit_val_batches
        self.limit_test_batches = limit_test_batches
        self.check_val_every_n_epoch = max(1, check_val_every_n_epoch)
        self.val_check_interval = val_check_interval
        self.log_every_n_steps = log_every_n_steps
        self.accumulate_grad_batches = max(1, accumulate_grad_batches)
        self.gradient_clip_val = gradient_clip_val
        self.precision = precision
        self.seed = seed
        self.default_root_dir = default_root_dir
        self.num_sanity_val_steps = num_sanity_val_steps
        # Eager PyTorch has no ahead-of-time step to warm, so warm_start
        # changes nothing here; the device-prefetch stage that
        # prefetch_to_device sizes comes with Queue 1 item 7. Both are
        # accepted so JAX callers run unchanged.
        self.prefetch_to_device = max(0, prefetch_to_device)
        self.warm_start = warm_start

        self.callbacks: List[Callback] = list(callbacks or [])
        if enable_progress_bar and not any(
                isinstance(c, ProgressLogger) for c in self.callbacks):
            self.callbacks.append(ProgressLogger(log_every_n_steps))

        self.state: Optional[TrainState] = None
        self.module: Optional[TpuModule] = None
        self.callback_metrics: Dict[str, Any] = {}
        self.current_epoch = 0
        self.global_step = 0
        self.should_stop = False
        self.has_validation = False
        self._last_val_step = -1
        self.last_batch_size: Optional[int] = None
        self._seed = 0
        self.is_fitted = False

    # ------------------------------------------------------------------ fit

    def fit(
        self,
        module: TpuModule,
        train_dataloaders: Optional[Iterable] = None,
        val_dataloaders: Optional[Iterable] = None,
        datamodule: Optional[DataModule] = None,
        ckpt_path: Optional[str] = None,
    ) -> Dict[str, Any]:
        if ckpt_path:
            raise NotImplementedError(
                "fit(ckpt_path=...) is not ported yet (ROADMAP Queue 1 "
                "item 5, checkpoint/io.py)")
        self._seed = seed_everything(self.seed)
        self.module = module
        module.trainer = self
        self.strategy.setup(module)
        module.setup()

        if datamodule is not None:
            datamodule.setup()
            train_dataloaders = datamodule.train_dataloader()
            val_dataloaders = val_dataloaders or datamodule.val_dataloader()
        if train_dataloaders is None:
            raise ValueError("fit() needs train_dataloaders or a datamodule")
        self.has_validation = val_dataloaders is not None
        example_batch, train_dataloaders = self._peek(train_dataloaders)
        self.state = self._init_state(module, example_batch)

        module.on_fit_start(self)
        self._invoke("on_fit_start")
        try:
            if self.num_sanity_val_steps and self.has_validation:
                self._run_eval_epoch(val_dataloaders, module.validation_step,
                                     limit=self.num_sanity_val_steps,
                                     sanity=True)
            self._fit_loop(train_dataloaders, val_dataloaders)
        except BaseException as exc:  # surface to callbacks, then re-raise
            self._invoke("on_exception", exc)
            raise
        finally:
            # the caller's module holds the trained weights (JAX :291)
            if self.state is not None:
                module.params = self.state.params
        module.on_fit_end(self)
        self._invoke("on_fit_end")
        self.is_fitted = True
        return dict(self.callback_metrics)

    def _fit_loop(self, train_loader, val_loader) -> None:
        for epoch in range(self.current_epoch, self.max_epochs):
            self.current_epoch = epoch
            if hasattr(train_loader, "set_epoch"):
                train_loader.set_epoch(epoch)
            self.module.on_train_epoch_start(self)
            self._invoke("on_train_epoch_start")
            self._run_train_epoch(train_loader, val_loader)
            if (self.has_validation
                    and (epoch + 1) % self.check_val_every_n_epoch == 0
                    # mid-epoch interval may have just validated this step
                    and self.global_step != self._last_val_step):
                self._validate_now(val_loader)
            self.module.on_train_epoch_end(self)
            self._invoke("on_train_epoch_end")
            if self.should_stop or self._hit_max_steps():
                break

    def _run_train_epoch(self, loader, val_loader=None) -> None:
        pending: Dict[str, Any] = {}
        for batch_idx, batch in enumerate(loader):
            if (self.limit_train_batches is not None
                    and batch_idx >= self.limit_train_batches):
                break
            self.last_batch_size = _leading_dim(batch)
            device_batch = self._place_train_batch(batch)
            device_batch = self._invoke_batch_start(device_batch, batch_idx)
            metrics = self._train_step(device_batch)
            self.global_step += 1
            pending = metrics
            # lazy metric fetch: a host sync only on the logging cadence
            if self.global_step % max(1, self.log_every_n_steps) == 0:
                pending = _to_host(metrics)
                self.callback_metrics.update(pending)
            self._invoke("on_train_batch_end", pending, batch_idx)
            if (self.val_check_interval and self.has_validation
                    and val_loader is not None
                    and self.global_step % self.val_check_interval == 0):
                self._validate_now(val_loader)
            if self.should_stop or self._hit_max_steps():
                break
        if pending:
            self.callback_metrics.update(_to_host(pending))

    def _validate_now(self, val_loader) -> None:
        metrics = self._run_eval_epoch(val_loader,
                                       self.module.validation_step,
                                       limit=self.limit_val_batches)
        self._last_val_step = self.global_step
        self.callback_metrics.update(metrics)
        self.module.on_validation_epoch_end(self, metrics)
        self._invoke("on_validation_epoch_end", metrics)

    # ------------------------------------------------------------ the step

    def _train_step(self, batch) -> Dict[str, torch.Tensor]:
        """One optimizer update (twin of `_make_train_step`'s step)."""
        state = self.state
        params = self.module.params
        rng = self._rng(state.step)
        accum = self.accumulate_grad_batches
        if accum == 1:
            loss, metrics = self._loss(params, batch, rng)
            loss.backward()
        else:
            losses, parts = [], []
            for i in range(accum):
                micro = _tree_map(lambda x, i=i: x[i], batch)
                l_i, m_i = self._loss(params, micro, self._rng(state.step, i))
                l_i.backward()
                losses.append(l_i.detach())
                parts.append(m_i)
            for p in params.values():
                if p.grad is not None:
                    p.grad.div_(accum)
            loss = torch.stack(losses).mean()
            metrics = {k: torch.stack([torch.as_tensor(m[k]) for m in parts])
                       .float().mean() for k in parts[0]}
        trainable = [p for p in params.values() if p.requires_grad]
        for p in trainable:
            # a parameter the loss never reached still takes the
            # optimizer's update (weight decay), as with optax's zero grad
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in trainable]
        grad_norm = global_norm(grads)
        if self.gradient_clip_val:
            clip_by_global_norm_(grads, grad_norm, self.gradient_clip_val)
        state.optimizer.step()
        if state.scheduler is not None:
            state.scheduler.step()
        state.optimizer.zero_grad(set_to_none=True)
        state.step += 1
        return {"loss": loss.detach(), "grad_norm": grad_norm, **metrics}

    def _loss(self, params, batch, rng):
        out = self.module.training_step(params, batch, rng)
        loss, metrics = out if isinstance(out, tuple) else (out, {})
        return loss, {**metrics, **self.module.pop_logged()}

    def _rng(self, step: int, micro: int = 0) -> torch.Generator:
        """The step's generator (the twin of `fold_in(base_rng, step)`)."""
        gen = torch.Generator(device=self.strategy.device)
        gen.manual_seed(hash((self._seed, step, micro)) & (2**63 - 1))
        return gen

    # ------------------------------------------------------------- eval

    def _run_eval_epoch(self, loader, step_fn, limit: Optional[int] = None,
                        sanity: bool = False) -> Dict[str, float]:
        """Batch-size-weighted sums accumulate on the device and are
        fetched with one host sync at the end."""
        if hasattr(loader, "set_epoch"):
            loader.set_epoch(self.current_epoch)
        totals: Dict[str, torch.Tensor] = {}
        weights = 0.0
        params = self.module.params
        with torch.no_grad():
            for batch_idx, batch in enumerate(loader):
                if limit is not None and batch_idx >= limit:
                    break
                bs = _leading_dim(batch) or 1
                metrics = step_fn(params, self._place(batch))
                metrics = {} if metrics is None else metrics
                if not isinstance(metrics, dict):
                    metrics = {"val_loss": metrics}
                metrics = {**metrics, **self.module.pop_logged()}
                for k, v in metrics.items():
                    scaled = torch.as_tensor(v).float() * bs
                    totals[k] = totals[k] + scaled if k in totals else scaled
                weights += bs
        if sanity or weights == 0:
            return {}
        host = _to_host(totals)
        return {k: float(v) / weights for k, v in host.items()}

    def validate(self, module: Optional[TpuModule] = None, dataloaders=None,
                 datamodule: Optional[DataModule] = None) -> Dict[str, float]:
        return self._evaluate(module, dataloaders, datamodule, "val")

    def test(self, module: Optional[TpuModule] = None, dataloaders=None,
             datamodule: Optional[DataModule] = None) -> Dict[str, float]:
        return self._evaluate(module, dataloaders, datamodule, "test")

    def _evaluate(self, module, dataloaders, datamodule, stage):
        module = self._attach(module)
        if datamodule is not None:
            datamodule.setup()
            dataloaders = (datamodule.val_dataloader() if stage == "val"
                           else datamodule.test_dataloader())
        dataloaders = self._ensure_state(module, dataloaders)
        step_fn = module.validation_step if stage == "val" else \
            module.test_step
        limit = self.limit_val_batches if stage == "val" else \
            self.limit_test_batches
        metrics = self._run_eval_epoch(dataloaders, step_fn, limit=limit)
        self.callback_metrics.update(metrics)
        return metrics

    def predict(self, module: Optional[TpuModule] = None, dataloaders=None,
                datamodule: Optional[DataModule] = None) -> List[Any]:
        module = self._attach(module)
        if datamodule is not None:
            datamodule.setup()
            dataloaders = datamodule.predict_dataloader()
        dataloaders = self._ensure_state(module, dataloaders)
        outs = []
        with torch.no_grad():
            for batch in dataloaders:
                out = module.predict_step(module.params, self._place(batch))
                outs.append(_tree_map(_host_array, out))
        return outs

    def save_checkpoint(self, path: str, block: bool = True) -> str:
        raise NotImplementedError(
            "save_checkpoint is not ported yet (ROADMAP Queue 1 item 5, "
            "checkpoint/io.py)")

    # ------------------------------------------------------------ plumbing

    def _attach(self, module: Optional[TpuModule]) -> TpuModule:
        module = module or self.module
        if module is None:
            raise ValueError("no module; pass one or fit first")
        if module is not self.module:
            self.state = None
        self.module = module
        module.trainer = self
        if self.strategy.device is None:
            self.strategy.setup(module)
        else:
            self.strategy.bind_module(module)
        module.setup()
        return module

    def _ensure_state(self, module: TpuModule, loader):
        """Eval-only state; returns the loader to iterate (a peeked
        one-shot iterator comes back re-stitched)."""
        if self.state is not None:
            return loader
        if module.params is None:
            if loader is None:
                raise ValueError(
                    "module has no params and no data to init from")
            batch, loader = self._peek(loader)
            self._seed = seed_everything(self.seed)
            module.init_params(self._init_generator(), self._place(batch))
        else:
            self._load_params(module)
        module.params = dict(module.model.named_parameters())
        self.state = TrainState(step=0, model=module.model)
        return loader

    def _init_state(self, module: TpuModule, example_batch) -> TrainState:
        if module.params is not None:
            # pre-loaded weights (e.g. params_from_jax)
            self._load_params(module)
        else:
            module.init_params(self._init_generator(),
                               self._place(example_batch))
        module.params = dict(module.model.named_parameters())
        out = module.configure_optimizers()
        opt, sched = out if isinstance(out, tuple) else (out, None)
        return TrainState(step=0, model=module.model, optimizer=opt,
                          scheduler=sched)

    def _load_params(self, module: TpuModule) -> None:
        own = dict(module.model.named_parameters())
        if module.params is own or all(
                module.params.get(k) is v for k, v in own.items()):
            return
        with torch.no_grad():
            module.model.load_state_dict(module.params, strict=True)
        module.params = dict(module.model.named_parameters())

    def _init_generator(self) -> torch.Generator:
        """The parameter-initialisation stream, apart from the steps'."""
        gen = torch.Generator(device=self.strategy.device)
        gen.manual_seed(self._seed)
        return gen

    def _place(self, batch):
        batch = self.strategy.shard_batch(batch)
        if self.precision == "bf16":
            batch = _tree_map(
                lambda x: x.to(torch.bfloat16) if x.is_floating_point()
                else x, batch)
        return batch

    def _place_train_batch(self, batch):
        accum = self.accumulate_grad_batches
        if accum > 1:
            def split(x):
                x = np.asarray(x)
                if x.shape[0] % accum != 0:
                    raise ValueError(
                        f"batch dim {x.shape[0]} not divisible by "
                        f"accumulate_grad_batches={accum}")
                return x.reshape((accum, x.shape[0] // accum) + x.shape[1:])

            batch = _tree_map(split, batch)
        return self._place(batch)

    def _peek(self, loader):
        """Batch 0 without losing it; one-shot iterators are re-stitched
        (they support one epoch only)."""
        it = iter(loader)
        try:
            first = next(it)
        except StopIteration:
            raise ValueError(
                "the dataloader yielded no batches. With drop_last=True "
                "(the static-shape default) this happens when the dataset "
                "holds fewer rows than batch_size.") from None
        if it is loader:
            if self.max_epochs > 1:
                log.warning("train data is a one-shot iterator; it will be "
                            "exhausted after one epoch")
            return first, itertools.chain([first], it)
        return first, loader

    def _hit_max_steps(self) -> bool:
        return self.max_steps > 0 and self.global_step >= self.max_steps

    def _invoke(self, hook: str, *args) -> None:
        for cb in self.callbacks:
            getattr(cb, hook)(self, self.module, *args)

    def _invoke_batch_start(self, batch, batch_idx: int):
        """on_train_batch_start; a callback returning non-None replaces
        the batch."""
        for cb in self.callbacks:
            out = cb.on_train_batch_start(self, self.module, batch,
                                          batch_idx)
            if out is not None:
                batch = out
        return batch


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in f32
    (`optax.global_norm`)."""
    if not tensors:
        return torch.zeros(())
    norms = torch._foreach_norm([t.float() if t.dtype != torch.float32
                                 else t for t in tensors])
    return torch.linalg.vector_norm(torch.stack(norms))


def clip_by_global_norm_(grads, norm: torch.Tensor, max_norm: float) -> None:
    """`optax.clip_by_global_norm` in place: unchanged when the norm is
    below ``max_norm``, else scaled by max_norm / norm."""
    factor = torch.where(norm < max_norm, torch.ones_like(norm),
                         max_norm / norm)
    torch._foreach_mul_(grads, factor)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _host_array(x):
    if not isinstance(x, torch.Tensor):
        return x
    x = x.detach().cpu()
    # numpy has no bfloat16: such a metric or output arrives as f32
    return (x.float() if x.dtype == torch.bfloat16 else x).numpy()


def _to_host(tree: Dict[str, Any]) -> Dict[str, Any]:
    out = {}
    for k, v in tree.items():
        a = np.asarray(_host_array(v))
        out[k] = float(a) if a.ndim == 0 else a
    return out


def _leading_dim(batch) -> Optional[int]:
    leaves = batch.values() if isinstance(batch, dict) else (
        batch if isinstance(batch, (tuple, list)) else [batch])
    for leaf in leaves:
        shape = getattr(leaf, "shape", None)
        return int(shape[0]) if shape else None
    return None


__all__ = ["Trainer", "global_norm", "clip_by_global_norm_"]
