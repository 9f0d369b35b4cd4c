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
    every ``log_every_n_steps`` and at the end of an epoch, averaged over
    the data-parallel ranks first, so every rank holds the JAX trainer's
    global values and takes the same callback decisions.

The strategy wraps the model (DDP, FSDP2) after its weights are in and
before ``configure_optimizers``, so the optimizer holds the wrapped
parameters. Checkpoints (`save_checkpoint`, ``fit(ckpt_path=)``,
`ModelCheckpoint`) resume as the JAX trainer does: one saved inside an
epoch replays the rest of that epoch, one saved at its end starts the
next.

``guard=GuardConfig(...)`` (or True) arms the trainguard
(`resilience.guard`): each step's loss and grad_norm are checked on the
device, an anomalous update is skipped by the optimizer's ``found_inf``
flag (a fused optimizer; `DeviceLambdaLR` for a schedule), and the
counters ride the step's metrics.

``telemetry=True`` (a directory string, or a `TelemetryConfig`) arms the
host-side span recorder (`telemetry.spans`): the step's dispatch, the
cadenced metric fetch, validation, the blocking part of a checkpoint
save and each step's host wall, flushed to per-rank JSONL with a goodput
ledger on ``flush_every_n_steps`` and at fit end. It reads no device
value, so a fit with it on launches the same kernels and takes the same
host syncs as one with it off. ``profile=ProfileConfig(...)`` captures a
`torch.profiler` trace of a step window, on a marker file or on SIGUSR1;
``profiler_dir=`` captures the whole fit loop.

The hot loop (`pipeline/`): ``prefetch_to_device=N`` (2 by default)
places the next N batches on a producer thread, their copies on a side
CUDA stream, while the step runs (`DevicePrefetcher`; 0 places each
batch inline); ``warm_start=True`` (the default) runs one forward and
backward of the first batch under a ``compile`` span before the loop, so
a fresh process's one-time costs are paid and reported there
(``compile_time_s``) and not in the first step; ``compile_cache_dir``
is where the kernel libraries are built and loaded
(`enable_persistent_cache`). Neither knob changes a bit of the result.
"""
from __future__ import annotations

import contextlib
import inspect
import itertools
import logging
import os
import time
from typing import Any, Dict, Iterable, List, Optional

import numpy as np
import torch

from ray_lightning_tpu_torch.checkpoint.io import wait_for_checkpoints
from ray_lightning_tpu_torch.core.callbacks import (
    Callback,
    ModelCheckpoint,
    ProgressLogger,
)
from ray_lightning_tpu_torch.core.data import DataModule
from ray_lightning_tpu_torch.core.module import TpuModule
from ray_lightning_tpu_torch.core.state import TrainState
from ray_lightning_tpu_torch.parallel.mesh import process_index
from ray_lightning_tpu_torch.parallel.strategy import SingleDevice, Strategy
from ray_lightning_tpu_torch.pipeline.compile_cache import (
    WarmStep,
    enable_persistent_cache,
)
from ray_lightning_tpu_torch.pipeline.prefetch import (
    DevicePrefetcher,
    prefetch_to_device,
)
from ray_lightning_tpu_torch.telemetry import TelemetryConfig
from ray_lightning_tpu_torch.telemetry import goodput as _goodput
from ray_lightning_tpu_torch.telemetry.profiler import (
    Capture,
    ProfileConfig,
    ProfilerController,
)
from ray_lightning_tpu_torch.telemetry.spans import (
    NULL_RECORDER,
    PH_CKPT,
    PH_DISPATCH,
    PH_EVAL,
    PH_METRICS,
    PH_RESHARD,
    PH_STEP,
    TelemetryRecorder,
)
from ray_lightning_tpu_torch.utils.dist import (  # noqa: F401 (re-exported)
    clip_by_global_norm_,
    global_norm,
)
from ray_lightning_tpu_torch.utils.seeding import seed_everything

log = logging.getLogger(__name__)


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
        self.default_root_dir = default_root_dir or os.path.join(
            os.getcwd(), "rlt_logs")
        self.num_sanity_val_steps = num_sanity_val_steps
        #: batches placed ahead of the step on a producer thread (0: the
        #: synchronous path); the hot loop's overlap (pipeline/prefetch.py)
        self.prefetch_to_device = max(0, prefetch_to_device)
        #: one forward and backward before the loop, under a compile span
        #: (pipeline/compile_cache.py `WarmStep`)
        self.warm_start = warm_start
        #: the kernel libraries' build directory (None: the package's)
        self.compile_cache_dir = compile_cache_dir
        #: trainguard config (resilience/guard.py); normalized at fit
        self.guard = guard
        #: rollback marker of a trainguard rollback (set by the
        #: supervisor): the resume skips the poisoned window
        self.resume_skip_past: Optional[Dict[str, Any]] = None
        #: telemetry (telemetry/): True, a directory or a TelemetryConfig
        #: arms the span recorder; normalized at fit
        self.telemetry = telemetry
        #: on-demand torch.profiler capture (telemetry/profiler.py)
        self.profile = profile
        #: a torch.profiler trace of the whole fit loop, written here
        self.profiler_dir = profiler_dir
        self.telemetry_recorder = NULL_RECORDER
        self._profiler: Optional[ProfilerController] = None
        #: the record of the whole-fit capture (profiler_dir=)
        self.fit_capture: Optional[Dict[str, Any]] = None
        self._telemetry_flush_every = 50
        self._fit_start_perf: Optional[float] = None
        self._fit_start_step = 0
        self._launch_s = 0.0

        self.callbacks: List[Callback] = list(callbacks or [])
        if enable_checkpointing and not any(
                isinstance(c, ModelCheckpoint) for c in self.callbacks):
            self.callbacks.append(ModelCheckpoint())
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
        # mid-epoch bookkeeping for checkpoint/resume: whether we are
        # inside a partially consumed train epoch, how many batches of it
        # ran, and how many to skip after a mid-epoch resume
        self._mid_epoch = False
        self._epoch_batches_done = 0
        self._resume_skip_batches = 0
        #: the move summary of the last cross-mesh restore
        #: (`elastic.reshard.validate_reshard`; None when the resume
        #: stayed on its mesh)
        self.last_reshard: Optional[Dict[str, Any]] = None
        self.last_batch_size: Optional[int] = None
        self._seed = 0
        self.is_fitted = False
        #: how the fit built and initialised the weights: "meta" (built on
        #: the meta device, wrapped, each rank's shards filled leaf by
        #: leaf) or "eager" (built whole on the device), and why eager
        self.init_path: Optional[str] = None
        self.init_path_reason: Optional[str] = None
        #: the card's peak allocation read right after the weights' init
        #: (None off the card)
        self.init_peak_bytes: Optional[int] = None

    # ------------------------------------------------------------------ fit

    @property
    def checkpoint_callback(self) -> Optional[ModelCheckpoint]:
        for c in self.callbacks:
            if isinstance(c, ModelCheckpoint):
                return c
        return None

    def fit(
        self,
        module: TpuModule,
        train_dataloaders: Optional[Iterable] = None,
        val_dataloaders: Optional[Iterable] = None,
        datamodule: Optional[DataModule] = None,
        ckpt_path: Optional[str] = None,
    ) -> Dict[str, Any]:
        self._seed = seed_everything(self.seed)
        self.module = module
        module.trainer = self
        if self.guard:
            from ray_lightning_tpu_torch.resilience.guard import (
                GuardCallback,
                GuardConfig,
            )

            self.guard = GuardConfig.coerce(self.guard)
            if not any(isinstance(c, GuardCallback) for c in self.callbacks):
                self.callbacks.append(GuardCallback(self.guard))
        self.strategy.setup(module)
        self._build_model(module)
        self._setup_telemetry()

        if datamodule is not None:
            datamodule.setup()
            train_dataloaders = datamodule.train_dataloader()
            val_dataloaders = val_dataloaders or datamodule.val_dataloader()
        if train_dataloaders is None:
            raise ValueError("fit() needs train_dataloaders or a datamodule")
        self.has_validation = val_dataloaders is not None
        example_batch, train_dataloaders = self._peek(train_dataloaders)
        if self.compile_cache_dir:
            # before any kernel loads: a restarted worker finds its
            # libraries there and builds nothing
            enable_persistent_cache(self.compile_cache_dir)
        self.state = self._init_state(module, example_batch, ckpt_path)
        self._fit_start_perf = time.perf_counter()
        self._fit_start_step = self.global_step

        module.on_fit_start(self)
        self._invoke("on_fit_start")
        fit_error: Optional[BaseException] = None
        try:
            # after on_fit_start: the heartbeat runs, so the warm-up
            # reports itself as a live "compile" phase
            if self.warm_start:
                self._warm_start_train_step(example_batch)
            if self.num_sanity_val_steps and self.has_validation:
                self._run_eval_epoch(val_dataloaders, module.validation_step,
                                     limit=self.num_sanity_val_steps,
                                     sanity=True)
            with (_ProfilerCtx(self) if self.profiler_dir
                  else contextlib.nullcontext()):
                self._fit_loop(train_dataloaders, val_dataloaders)
        except BaseException as exc:  # surface to callbacks, then re-raise
            fit_error = exc
            self._invoke("on_exception", exc)
            raise
        finally:
            # join in-flight async checkpoint writes; a deferred write
            # error must not displace a training exception, but on the
            # success path it IS the failure (best_model_path must never
            # point at an unfinalized checkpoint)
            try:
                wait_for_checkpoints()
            except Exception:  # noqa: BLE001
                if fit_error is None:
                    raise
                log.exception("async checkpoint write failed")
            # the caller's module holds the trained weights (JAX :291)
            if self.state is not None:
                module.params = self.state.params
            if self._profiler is not None:
                self._profiler.close()
            self._finalize_telemetry(completed=fit_error is None)
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
        # mid-epoch resume: fast-forward past the batches the checkpoint
        # had consumed (loaders reshuffle per epoch from their seed, so
        # the offsets are stable)
        skip = self._resume_skip_batches
        self._resume_skip_batches = 0
        self._mid_epoch = True
        self._epoch_batches_done = skip
        it = iter(loader)
        for _ in range(skip):
            if next(it, None) is None:
                break
        completed = False
        rec = self.telemetry_recorder
        # the placement runs up to `prefetch_to_device` batches ahead on a
        # producer thread; the skip above already advanced the iterator,
        # so a mid-epoch resume places no batch it drops, and the order is
        # the iterator's
        stream = self._prefetch(it, self._place_train_batch)
        # each step's host wall runs from the last batch end (the epoch's
        # start for its first step) to its own
        t_prev = time.perf_counter()
        try:
            for batch_idx, (bs, device_batch) in enumerate(stream,
                                                           start=skip):
                if (self.limit_train_batches is not None
                        and self._epoch_batches_done
                        >= self.limit_train_batches):
                    # the limit defines the epoch's length: completion
                    completed = True
                    break
                self.last_batch_size = bs
                device_batch = self._invoke_batch_start(device_batch,
                                                        batch_idx)
                rec.set_step(self.global_step)
                # the enqueue of the step's kernels: PyTorch returns
                # before the device runs them
                with rec.span(PH_DISPATCH, step=self.global_step):
                    metrics = self._train_step(device_batch)
                self.global_step += 1
                self._epoch_batches_done += 1
                if rec.enabled:
                    t_now = time.perf_counter()
                    rec.record(PH_STEP, t_prev, t_now - t_prev,
                               step=self.global_step)
                    t_prev = t_now
                pending = metrics
                # lazy metric fetch: a host sync only on the log cadence
                if self.global_step % max(1, self.log_every_n_steps) == 0:
                    with rec.span(PH_METRICS, step=self.global_step):
                        pending = self._host_metrics(metrics)
                    self.callback_metrics.update(pending)
                if self._profiler is not None:
                    # after the fetch: on its cadence the device has
                    # drained, so a window opens between steps
                    self._profiler.on_step(self.global_step)
                # the span file and the goodput ledger on their own
                # cadence, so a killed worker leaves an almost-current
                # account
                if (rec.enabled and self.global_step
                        % self._telemetry_flush_every == 0):
                    rec.flush()
                    self._write_telemetry_ledger(completed=False)
                self._invoke("on_train_batch_end", pending, batch_idx)
                if (self.val_check_interval and self.has_validation
                        and val_loader is not None
                        and self.global_step % self.val_check_interval
                        == 0):
                    self._validate_now(val_loader)
                if self.should_stop or self._hit_max_steps():
                    break
            else:
                completed = True
        finally:
            # any exit mid-epoch (max_steps, early stop, a preemption
            # drain raising out of a callback) joins the producer
            if isinstance(stream, DevicePrefetcher):
                stream.close()
                self.callback_metrics.update(stream.stats.to_metrics())
        if completed:
            # every batch of this epoch ran: later saves (epoch-end
            # validation, on_train_epoch_end) resume at the NEXT epoch
            self._mid_epoch = False
        if pending:
            self.callback_metrics.update(self._host_metrics(pending))

    def _host_metrics(self, metrics: Dict[str, Any]) -> Dict[str, Any]:
        """Device metrics averaged over the data-parallel ranks, on the
        host (host values pass through)."""
        if any(isinstance(v, torch.Tensor) for v in metrics.values()):
            metrics = self.strategy.reduce_mean(metrics)
        return _to_host(metrics)

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
        self.strategy.finish_grads([(n, p.grad) for n, p in params.items()
                                    if p.requires_grad])
        grads = [p.grad for p in trainable]
        grad_norm = self.strategy.global_norm(grads)
        if self.gradient_clip_val:
            clip_by_global_norm_(self.strategy.local_tensors(grads),
                                 grad_norm, self.gradient_clip_val)
        guard_metrics = {}
        if self.guard and self.guard.enabled:
            from ray_lightning_tpu_torch.resilience.guard import apply_guard

            # decided on the loss of every data-parallel rank together,
            # so every rank skips the same updates
            loss_all = self.strategy.reduce_mean({"loss": loss.detach()})
            bad, state.updates, state.guard, guard_metrics = apply_guard(
                self.guard, state.guard, state.updates, loss_all["loss"],
                grad_norm)
            # the fused optimizer's skip flag: an anomalous update leaves
            # the params, the state and the step counts as they were,
            # and DeviceLambdaLR reads it to hold its position
            state.optimizer.found_inf = bad.to(torch.float32)
        state.optimizer.step()
        if state.scheduler is not None:
            state.scheduler.step()
        state.optimizer.zero_grad(set_to_none=True)
        state.step += 1
        return {"loss": loss.detach(), "grad_norm": grad_norm, **metrics,
                **guard_metrics}

    def _loss(self, params, batch, rng):
        out = self.module.training_step(params, batch, rng)
        loss, metrics = out if isinstance(out, tuple) else (out, {})
        return loss, {**metrics, **self.module.pop_logged()}

    def _rng(self, step: int, micro: int = 0) -> torch.Generator:
        """The step's generator (the twin of `fold_in(base_rng, step)`)."""
        gen = torch.Generator(device=self.strategy.device)
        gen.manual_seed(hash((self._seed, step, micro)) & (2**63 - 1))
        return gen

    def _warm_start_train_step(self, example_batch) -> None:
        """The warm start (twin of JAX `_warm_start_train_step`): a fresh
        process's one-time costs of a step, paid here under a compile
        span and reported as ``compile_time_s`` instead of inside the
        first step. A failing warm-up raises."""
        _, device_batch = self._place_train_batch(example_batch)
        warm = WarmStep(self._train_step, warm_up=self._warm_up,
                        label="train_step", recorder=self.telemetry_recorder)
        self.callback_metrics.update(warm.warm(device_batch).to_metrics())

    def _warm_up(self, batch) -> None:
        """One forward and backward of (the first microbatch of) ``batch``
        through the step's own dispatch, the gradients' global norm, and
        for a fused optimizer one step with its ``found_inf`` skip flag
        set (the trainguard's skip: parameters, moments and step counts
        stay as they were), which builds the optimizer's state and pays
        its first step's one-time costs (under FSDP, the DTensor
        dispatch's first sight of each shape: seconds). The gradients
        are then dropped. The schedule, the guard, the step counters and
        the random streams (the global ones are forked) are untouched, so
        the fit that follows is bitwise the fit without it."""
        micro = batch
        if self.accumulate_grad_batches > 1:
            micro = _tree_map(lambda x: x[0], batch)
        dev = self.strategy.device
        params = self.module.params
        with torch.random.fork_rng(
                devices=[dev] if dev.type == "cuda" else []):
            loss, _ = self._loss(params, micro, self._rng(self.state.step))
            loss.backward()
        trainable = [p for p in params.values() if p.requires_grad]
        for p in trainable:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        # the gradients are dropped: their reductions are not needed
        self.strategy.finish_grads([(n, p.grad) for n, p in params.items()
                                    if p.requires_grad], reduce=False)
        self.strategy.global_norm([p.grad for p in trainable])
        opt = self.state.optimizer
        if opt is not None and _skips_on_found_inf(opt):
            had = "found_inf" in vars(opt)
            saved = vars(opt).get("found_inf")
            opt.found_inf = torch.ones((), dtype=torch.float32, device=dev)
            try:
                opt.step()
            finally:
                if had:
                    opt.found_inf = saved
                else:
                    del opt.found_inf
        for p in params.values():
            p.grad = None

    # ------------------------------------------------------------- eval

    def _run_eval_epoch(self, loader, step_fn, limit: Optional[int] = None,
                        sanity: bool = False) -> Dict[str, float]:
        with self.telemetry_recorder.span(PH_EVAL):
            return self._eval_epoch(loader, step_fn, limit, sanity)

    def _eval_epoch(self, loader, step_fn, limit: Optional[int],
                    sanity: bool) -> Dict[str, float]:
        """Batch-size-weighted sums accumulate on the device and are
        fetched with one host sync at the end."""
        if hasattr(loader, "set_epoch"):
            loader.set_epoch(self.current_epoch)
        totals: Dict[str, torch.Tensor] = {}
        weights = 0.0
        params = self.module.params
        stream = self._prefetch(loader, self._place_eval_batch)
        try:
            with torch.no_grad():
                for batch_idx, (bs, device_batch) in enumerate(stream):
                    if limit is not None and batch_idx >= limit:
                        break
                    metrics = step_fn(params, device_batch)
                    metrics = {} if metrics is None else metrics
                    if not isinstance(metrics, dict):
                        metrics = {"val_loss": metrics}
                    metrics = {**metrics, **self.module.pop_logged()}
                    for k, v in metrics.items():
                        scaled = torch.as_tensor(v).float() * bs
                        totals[k] = (totals[k] + scaled if k in totals
                                     else scaled)
                    weights += bs
        finally:
            if isinstance(stream, DevicePrefetcher):
                stream.close()
        if sanity or weights == 0:
            return {}
        # batch-size-weighted sums over every data-parallel rank
        keys = sorted(totals)
        sums = self.strategy.reduce_sum(torch.stack(
            [totals[k] for k in keys] + [torch.tensor(
                weights, dtype=torch.float32,
                device=totals[keys[0]].device)]))
        host = _host_array(sums)
        return {k: float(v) / float(host[-1]) for k, v in zip(keys, host)}

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
        """The model, optimizer and schedule state (DCP, each rank its
        own shards; every rank must call this) and the trainer's place in
        the run (meta.json)."""
        from ray_lightning_tpu_torch.checkpoint.io import (
            io_stats,
            save_checkpoint,
            sharding_provenance,
        )

        state = self.state
        if state is None:
            raise RuntimeError("nothing to save; fit first")
        meta = {
            "epoch": self.current_epoch,
            "global_step": self.global_step,
            # a mid-epoch save records the batch offset, so resume
            # replays the REST of the epoch instead of skipping it
            "mid_epoch": self._mid_epoch,
            "epoch_batch": self._epoch_batches_done,
            "module_class": type(self.module).__name__,
            "hparams": self.module.hparams,
        }
        # trainguard blessing: the anomaly-free-window verdict, so a
        # corruption rollback can target the last GOOD restore point
        # (latest_checkpoint(good_only=True)); guard off => blessed. The
        # counters' fetch is save-cadenced host work.
        blessed = True
        if self.guard and state.guard is not None:
            from ray_lightning_tpu_torch.resilience.guard import bless_verdict

            g = state.guard
            updates = int(state.updates)
            blessed = bless_verdict(self.guard, g, updates)
            meta["guard"] = {"skipped_steps": int(g.skipped),
                             "streak": int(g.streak),
                             "last_anomaly": int(g.last_anomaly),
                             "updates": updates}
        meta["blessed"] = blessed
        if state.optimizer is not None:
            params, opt_state = self.strategy.state_dicts(self.module.model,
                                                          state.optimizer)
        else:
            params, opt_state = state.model.state_dict(), {}
        checkpoint = {"params": params, "opt_state": opt_state,
                      "step": state.step}
        if state.scheduler is not None:
            checkpoint["scheduler"] = state.scheduler.state_dict()
        meta.update(sharding_provenance(self.strategy.mesh, state.params))
        self.module.on_save_checkpoint(checkpoint)
        self._invoke("on_save_checkpoint", checkpoint)
        # what the training thread paid: the whole write when blocking,
        # the snapshot and any wait on an earlier write when not
        with self.telemetry_recorder.span(PH_CKPT, meta={"path": path}):
            out = save_checkpoint(path, checkpoint, meta, block=block)
        self.callback_metrics.update(io_stats())
        return out

    def _restore(self, ckpt_path: str, state: TrainState) -> None:
        """Load a checkpoint into the freshly built state, in place."""
        from ray_lightning_tpu_torch.checkpoint.io import (
            read_meta,
            restore_checkpoint,
        )

        meta = read_meta(ckpt_path)
        if not meta:
            raise FileNotFoundError(
                f"no checkpoint at {ckpt_path!r} (no meta.json)")
        model = self.module.model
        params, opt_state = self.strategy.restore_target(model,
                                                         state.optimizer)
        target = {"params": params, "step": 0, "opt_state": opt_state}
        if state.scheduler is not None:
            target["scheduler"] = state.scheduler.state_dict()
        move = self.last_reshard = self._reshard_move(meta)
        if move is not None:
            # a cross-topology restore: the checkpoint was written on
            # ANOTHER mesh. The move is validated against its provenance
            # and the load is accounted as a `reshard` span (goodput's
            # reshard_s), so an elastic shrink or grow shows in `report`.
            # DCP reads each rank's pieces of the global tensors, and
            # the canonical rows go back through load_state_dicts
            log.warning(
                "resharding restore: checkpoint %s written on mesh %s, "
                "restoring onto %s", ckpt_path, move["from_mesh"],
                move["to_mesh"])
            with self.telemetry_recorder.span(PH_RESHARD, meta=move):
                restored = restore_checkpoint(ckpt_path, target)
        else:
            restored = restore_checkpoint(ckpt_path, target)
        self.strategy.load_state_dicts(model, state.optimizer,
                                       restored["params"],
                                       restored["opt_state"])
        if state.scheduler is not None:
            state.scheduler.load_state_dict(restored["scheduler"])
        state.step = int(restored["step"])
        if "guard" in meta:
            # the trainguard's count of the updates it kept
            state.updates = int(meta["guard"]["updates"])
        saved_epoch = int(meta.get("epoch", -1))
        if meta.get("mid_epoch", False):
            # taken inside a partially trained epoch: resume the SAME
            # epoch, skipping the consumed batches
            self.current_epoch = max(0, saved_epoch)
            self._resume_skip_batches = int(meta.get("epoch_batch", 0))
        else:
            self.current_epoch = saved_epoch + 1
        self.global_step = int(meta.get("global_step", 0))
        self.module.on_load_checkpoint(restored)
        self._invoke("on_load_checkpoint", restored)

    def _reshard_move(self, meta: Dict[str, Any]) -> Optional[Dict[str, Any]]:
        """When the checkpoint's recorded writing mesh differs from this
        strategy's mesh (axes of size 1 aside; no mesh is one device),
        validate the cross-topology move (`elastic.reshard`) and return
        its summary; None for a same-mesh restore. A checkpoint whose
        move is ILLEGAL raises `ReshardError` here, with the axis named,
        instead of failing inside DCP.

        A checkpoint with no ``mesh_spec`` stamp also returns None: its
        writing mesh is unknowable, so a cross-mesh resume can neither
        be detected nor validated. DCP fills whatever layout this run
        built, and a warning marks the blind spot. The elastic
        supervisor refuses to RESIZE onto such a checkpoint outright
        (`_begin_reshard`)."""
        src = meta.get("mesh_spec")
        cur = {str(k): int(v) for k, v in self.strategy.mesh_shape.items()}
        if not src:
            if meta and self.strategy.mesh is not None:
                log.warning(
                    "checkpoint carries no sharding provenance: restoring "
                    "WITHOUT cross-mesh validation — if the writing mesh "
                    "differed from %s this restore reshards silently; "
                    "re-save once to stamp provenance", cur)
            return None
        src = {str(k): int(v) for k, v in src.items()}
        if {k: v for k, v in src.items() if v > 1} == \
                {k: v for k, v in cur.items() if v > 1}:
            return None
        from ray_lightning_tpu_torch.elastic.reshard import validate_reshard

        return validate_reshard(meta, cur)

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
        if self.state is None and module.model is not None:
            # a module built elsewhere (load_from_checkpoint) moves to
            # this trainer's device
            module.model.to(self.strategy.device)
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
        self._wrap(module)
        self.state = TrainState(step=0, model=self.strategy.unwrap(
            module.model))
        return loader

    def _meta_refusal(self, module: TpuModule) -> Optional[str]:
        """Why the fit cannot build ``module`` on the meta device (None:
        it can)."""
        if not self.strategy.meta_init:
            return f"{type(self.strategy).__name__} holds whole weights"
        if module.params is not None:
            return "the module's weights are given"
        if module.model is not None:
            return "the module's model was built before the fit"
        if type(module).configure_model is TpuModule.configure_model:
            return f"{type(module).__name__} has no configure_model"
        if "place" not in inspect.signature(module.init_params).parameters:
            return (f"{type(module).__name__}.init_params takes no place= "
                    "(it fills whole weights in place)")
        return None

    def _build_model(self, module: TpuModule) -> None:
        """Build the module's model: on the meta device when the strategy
        shards it and the module can fill shards (`_init_state` wraps it
        and fills each rank's part), else eagerly on the device. The path
        and the reason for an eager build are recorded."""
        why = self._meta_refusal(module)
        if why is None:
            real = module.device
            module.device = torch.device("meta")
            try:
                module.setup()
            finally:
                module.device = real
            self.init_path, self.init_path_reason = "meta", None
        else:
            module.setup()
            self.init_path, self.init_path_reason = "eager", why

    def _init_state(self, module: TpuModule, example_batch,
                    ckpt_path: Optional[str] = None) -> TrainState:
        if module.params is not None:
            # pre-loaded weights (e.g. params_from_jax)
            self._load_params(module)
            self._wrap(module)
        elif self.init_path == "meta":
            # wrapped on the meta device, then each rank's shards filled
            # from the full values drawn leaf by leaf: no rank holds the
            # whole model
            self._wrap(module)
            module.model.to_empty(device=self.strategy.device)
            module.init_params(self._init_generator(),
                               self._place(example_batch),
                               place=self.strategy.place_full_value)
            module.params = dict(
                self.strategy.unwrap(module.model).named_parameters())
        else:
            module.init_params(self._init_generator(),
                               self._place(example_batch))
            self._wrap(module)
        if self.strategy.device.type == "cuda":
            self.init_peak_bytes = torch.cuda.max_memory_allocated(
                self.strategy.device)
        out = module.configure_optimizers()
        opt, sched = out if isinstance(out, tuple) else (out, None)
        state = TrainState(step=0, model=self.strategy.unwrap(module.model),
                           optimizer=opt, scheduler=sched)
        if ckpt_path:
            self._restore(ckpt_path, state)
        # outside the restore branch: a rollback that found no blessed
        # checkpoint resumes from scratch and must still skip the
        # poisoned window instead of replaying it
        self._apply_rollback_skip()
        if self.guard:
            from ray_lightning_tpu_torch.resilience.guard import (
                check_guardable,
                init_guard_state,
            )

            if self.guard.enabled:
                check_guardable(opt, sched)
            # fresh guard scalars even after a restore: the EMA re-warms
            # in warmup_steps rather than resume a pre-anomaly EMA
            device = self.strategy.device
            state.guard = init_guard_state(device)
            # filled on the device: a tensor copied from a host scalar
            # costs a synchronising copy
            state.updates = torch.full(
                (), state.step if state.updates is None else state.updates,
                dtype=torch.int32, device=device)
        return state

    def _apply_rollback_skip(self) -> None:
        """After a trainguard rollback (``resume_skip_past``, set by the
        supervisor from the rollback marker): the restore point is the
        last BLESSED checkpoint, behind the detection step, so the data
        order advances past the poisoned window instead of replaying it.
        Also for a resume from scratch (no blessed checkpoint): the
        epoch's clean prefix goes with the window, and suspect data is
        never trained again."""
        rsp = self.resume_skip_past
        if not rsp or int(rsp.get("detected_step", -1)) <= self.global_step:
            return  # a stale marker of an older incident
        if int(rsp.get("epoch", -1)) != self.current_epoch:
            log.warning(
                "trainguard rollback: the poisoned window spans an epoch "
                "boundary (detected in epoch %s, resuming epoch %d); "
                "replaying instead of skipping", rsp.get("epoch"),
                self.current_epoch)
            return
        target = int(rsp.get("epoch_batch", 0))
        if target > self._resume_skip_batches:
            log.warning(
                "trainguard rollback: epoch %d resumes at batch %d "
                "(instead of %d), past the poisoned window",
                self.current_epoch, target, self._resume_skip_batches)
            self._resume_skip_batches = target

    def _wrap(self, module: TpuModule) -> None:
        """The strategy's wrapper around the model, after its weights
        are in and before the optimizer sees its parameters."""
        module.model = self.strategy.wrap_model(module.model)
        module.params = dict(
            self.strategy.unwrap(module.model).named_parameters())

    def _load_params(self, module: TpuModule) -> None:
        own = dict(self.strategy.unwrap(module.model).named_parameters())
        if module.params is own or all(
                module.params.get(k) is v for k, v in own.items()):
            return
        with torch.no_grad():
            self.strategy.unwrap(module.model).load_state_dict(
                module.params, strict=True)
        module.params = dict(
            self.strategy.unwrap(module.model).named_parameters())

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

    def _prefetch(self, loader, place_fn):
        """``loader``'s batches placed by ``place_fn``, up to
        `prefetch_to_device` ahead on a producer thread."""
        return prefetch_to_device(loader, place_fn,
                                  depth=self.prefetch_to_device,
                                  recorder=self.telemetry_recorder,
                                  device=self.strategy.device)

    def _place_eval_batch(self, batch):
        """Host batch -> (leading dim, placed batch)."""
        return _leading_dim(batch) or 1, self._place(batch)

    def _place_train_batch(self, batch):
        """Host batch -> (leading dim, placed batch, split into the
        accumulation's microbatches): the prefetcher's producer stage."""
        bs = _leading_dim(batch)
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
        return bs, self._place(batch)

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

    # ------------------------------------------------------------ telemetry

    def _setup_telemetry(self) -> None:
        """The span recorder and the profiler controller of this fit.
        Host bookkeeping only: nothing here reaches the step."""
        self.telemetry = TelemetryConfig.coerce(self.telemetry)
        rank = process_index()
        if self.telemetry is not None:
            self.telemetry_recorder = TelemetryRecorder(
                directory=self.telemetry.resolved_dir(
                    self.default_root_dir),
                rank=rank, ring_size=self.telemetry.ring_size)
            self._telemetry_flush_every = max(
                1, self.telemetry.flush_every_n_steps)
            self._launch_s = _launch_seconds()
        self.profile = ProfileConfig.coerce(self.profile)
        if self.profile is not None:
            self._profiler = ProfilerController(
                self.profile, rank=rank,
                on_card=self.strategy.device.type == "cuda")

    def _write_telemetry_ledger(self, completed: bool) -> None:
        """Refresh this rank's goodput ledger (telemetry/goodput.py):
        cadenced and final, an atomic replace, so a SIGKILL'd attempt
        still leaves an almost-current account for the driver."""
        rec = self.telemetry_recorder
        if not rec.enabled or rec.directory is None \
                or self._fit_start_perf is None:
            return
        ledger = _goodput.worker_ledger(
            rec, time.perf_counter() - self._fit_start_perf,
            rank=rec.rank, start_step=self._fit_start_step,
            end_step=self.global_step, launch_s=self._launch_s,
            completed=completed)
        _goodput.write_ledger(rec.directory, ledger, uid=rec.uid)

    def _finalize_telemetry(self, completed: bool) -> None:
        rec = self.telemetry_recorder
        if not rec.enabled:
            return
        totals = rec.phase_totals()
        wall = (time.perf_counter() - self._fit_start_perf
                if self._fit_start_perf is not None else 0.0)
        stalls = sum(totals.get(p, 0.0) for p in
                     ("compile", "data_wait", "ckpt_stall", "eval",
                      "metrics_fetch"))
        self.callback_metrics.update({
            "telemetry_compile_s": totals.get("compile", 0.0),
            "telemetry_data_wait_s": totals.get("data_wait", 0.0),
            "telemetry_ckpt_stall_s": totals.get("ckpt_stall", 0.0),
            "telemetry_eval_s": totals.get("eval", 0.0),
            "telemetry_spans_dropped": float(rec.dropped),
            "goodput_fraction": (max(0.0, wall - stalls) / wall
                                 if wall > 0 else 0.0),
        })
        self._write_telemetry_ledger(completed=completed)
        rec.close()

    def _invoke_batch_start(self, batch, batch_idx: int):
        """on_train_batch_start; a callback returning non-None replaces
        the batch."""
        for cb in self.callbacks:
            out = cb.on_train_batch_start(self, self.module, batch,
                                          batch_idx)
            if out is not None:
                batch = out
        return batch


def _skips_on_found_inf(optimizer) -> bool:
    """A fused torch optimizer, whose step with ``found_inf`` set leaves
    the parameters, its state and its step counts as they were."""
    return (getattr(optimizer, "_step_supports_amp_scaling", False)
            and all(g.get("fused") for g in optimizer.param_groups))


def _launch_seconds() -> float:
    """Worker process start to fit start (imports, CUDA and the process
    group, the kernels' build): the goodput launch bucket. Zero outside
    a runtime worker: a local fit has no spawn cost worth charging."""
    from ray_lightning_tpu_torch.runtime import session

    s = session.get_session()
    started = s.started_at if s is not None else None
    return max(0.0, time.time() - started) if started else 0.0


class _ProfilerCtx:
    """A torch.profiler capture of the whole fit loop into
    ``trainer.profiler_dir``; its record lands in ``trainer.fit_capture``.
    A capture on a card that recorded no device event is logged as a
    failed capture."""

    def __init__(self, trainer: "Trainer"):
        self.trainer = trainer
        self.capture = Capture(
            trainer.profiler_dir, f"rank{process_index()}.{os.getpid()}.fit",
            trainer.strategy.device.type == "cuda")

    def __enter__(self):
        self.capture.start()
        return self

    def __exit__(self, *exc):
        record = self.capture.stop()
        self.trainer.fit_capture = record
        if record["empty"] or record["lost_kernel_events"]:
            log.error("profiler: the whole-fit capture on the card lost "
                      "device events (%s of its kernels; none recorded: "
                      "%s); %s is a FAILED capture",
                      record["lost_kernel_events"], record["empty"],
                      record["trace"])
        return False


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
    """Metrics on the host as floats (arrays for the rest). The scalars
    of each device cross in ONE copy, so a fetch costs one sync however
    many metrics the step carries (the trainguard adds five); f64
    holds every f32, bf16 and int32 value exactly."""
    scalars: Dict[Any, List[str]] = {}
    for k, v in tree.items():
        if isinstance(v, torch.Tensor) and v.dim() == 0:
            scalars.setdefault(v.device, []).append(k)
    fetched: Dict[str, float] = {}
    for device, keys in scalars.items():
        stacked = torch.stack([tree[k].detach().to(torch.float64)
                               for k in keys])
        _wait_for(device)
        fetched.update(zip(keys, stacked.cpu().tolist()))
    out = {}
    for k, v in tree.items():
        if k in fetched:
            out[k] = fetched[k]
            continue
        a = np.asarray(_host_array(v))
        out[k] = float(a) if a.ndim == 0 else a
    return out


def _wait_for(device: torch.device) -> None:
    """Wait for the card's work so far with the interpreter lock
    released (an event's synchronize lets go of it). The copy to the
    host that follows then finds the card idle: a copy that waits itself
    holds the lock through the step's device time, and the prefetcher's
    producer thread could not place the next batch meanwhile (on an H100
    its occupancy read 0 with, 0.975 without)."""
    if device.type == "cuda":
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(device))
        done.synchronize()


def _leading_dim(batch) -> Optional[int]:
    leaves = batch.values() if isinstance(batch, dict) else (
        batch if isinstance(batch, (tuple, list)) else [batch])
    for leaf in leaves:
        shape = getattr(leaf, "shape", None)
        return int(shape[0]) if shape else None
    return None


__all__ = ["Trainer", "global_norm", "clip_by_global_norm_"]
