"""TpuModule — the Lightning-style user-facing model protocol (twin of
`ray_lightning_tpu/core/module.py`; the class keeps its name so modules
move between the packages unchanged in shape).

The hooks keep the JAX signatures: ``training_step(params, batch, rng)``,
``validation_step(params, batch)``, ``predict_step(params, batch)``.
What differs is where the weights live: in the `nn.Module` that
`configure_model` returns, built on ``self.device`` (bound by the
strategy before `setup`). ``params`` is that module's parameter dict
(name -> tensor), and `apply` runs the module with it. After a fit,
``module.params`` holds the trained weights.
"""
from __future__ import annotations

import inspect
from typing import Any, Dict, Optional, Tuple, Union

import torch
from torch import nn

Metrics = Dict[str, torch.Tensor]
StepOutput = Union[torch.Tensor, Tuple[torch.Tensor, Metrics]]


class TpuModule:
    """Subclass and implement the `configure_*` / `*_step` hooks.

    Required:
        configure_model()       -> an nn.Module built on ``self.device``
        configure_optimizers()  -> a torch optimizer over the model's
                                   parameters, or (optimizer, lr scheduler)
        training_step(params, batch, rng) -> loss | (loss, metrics)

    Optional:
        validation_step(params, batch) -> metrics dict
        test_step(params, batch)       -> metrics dict (defaults to validation_step)
        predict_step(params, batch)    -> predictions
        init_params(generator, batch)  -> params (default: the model's own
                                          initialisation, reseeded)
        on_fit_start/on_fit_end(trainer)
        on_train_epoch_start/on_train_epoch_end(trainer)
        on_validation_epoch_end(trainer, metrics)
        on_save_checkpoint(checkpoint) / on_load_checkpoint(checkpoint)
    """

    def __init__(self) -> None:
        self.model: Optional[nn.Module] = None  # set by configure_model()
        self.params: Optional[Dict[str, torch.Tensor]] = None
        self.trainer = None        # backref set by Trainer during fit
        self.device: Optional[torch.device] = None  # bound by the strategy
        self.hparams: Dict[str, Any] = {}
        self._logged: Dict[str, torch.Tensor] = {}

    # ---- required hooks --------------------------------------------------

    def configure_model(self) -> Optional[nn.Module]:
        return None

    def configure_optimizers(self):
        return torch.optim.Adam(self.model.parameters(), lr=1e-3)

    def training_step(self, params, batch, rng) -> StepOutput:
        raise NotImplementedError

    # ---- optional hooks --------------------------------------------------

    def validation_step(self, params, batch) -> Metrics:
        raise NotImplementedError

    def test_step(self, params, batch) -> Metrics:
        return self.validation_step(params, batch)

    def predict_step(self, params, batch):
        raise NotImplementedError

    def on_fit_start(self, trainer) -> None: ...
    def on_fit_end(self, trainer) -> None: ...
    def on_train_epoch_start(self, trainer) -> None: ...
    def on_train_epoch_end(self, trainer) -> None: ...
    def on_validation_epoch_end(self, trainer, metrics: Metrics) -> None: ...
    def on_save_checkpoint(self, checkpoint: dict) -> None: ...
    def on_load_checkpoint(self, checkpoint: dict) -> None: ...

    # ---- provided machinery ---------------------------------------------

    def setup(self) -> None:
        """Idempotently build the inner model on ``self.device``."""
        if self.model is None:
            model = self.configure_model()
            if model is not None and self.device is not None:
                model = model.to(self.device)
            self.model = model

    def init_params(self, generator: torch.Generator, batch=None
                    ) -> Dict[str, torch.Tensor]:
        """Initialise the model's weights in place and return them. The
        default reruns each submodule's own ``reset_parameters`` under
        ``generator``'s seed; models with their own scheme override."""
        if self.model is None:
            raise NotImplementedError(
                "Provide configure_model() or override init_params().")
        torch.manual_seed(generator.initial_seed())
        for m in self.model.modules():
            if hasattr(m, "reset_parameters"):
                m.reset_parameters()
        return dict(self.model.named_parameters())

    def audit_step(self, strategy, example_batch, *, topology="h100-8",
                   **kw):
        """tracecheck this module's real train step under ``strategy`` on
        ``topology`` (see `Strategy.audit_step`); the strategy is
        consumed, and a live real process group refuses the trace."""
        return strategy.audit_step(self, example_batch, topology=topology,
                                   **kw)

    def apply(self, params, *args, **kwargs):
        """Run the inner model. ``params`` is the model's own parameter
        dict (``self.params``, as the trainer passes it): the weights live
        in the model, and a checkpointed block recomputes with them, so
        other weights are loaded into the model rather than passed."""
        if self.model is None:
            raise RuntimeError(
                f"{type(self).__name__}.model is not built. If setup() "
                "has not run yet, call it (Trainer.fit does); if it has, "
                "configure_model() returned None — implement it (or "
                "override apply()).")
        if params is not None and params is not self.params:
            raise ValueError("apply() runs the model's own parameters "
                             "(self.params); load other weights into it")
        return self.model(*args, **kwargs)

    def log(self, name: str, value) -> None:
        """Record a metric from inside a step (Lightning's self.log); it
        lands in `trainer.callback_metrics` on the logging cadence."""
        if isinstance(value, torch.Tensor):
            value = value.detach()
        self._logged[name] = value

    def log_dict(self, metrics: Dict[str, Any]) -> None:
        for k, v in metrics.items():
            self.log(k, v)

    def pop_logged(self) -> Dict[str, torch.Tensor]:
        out, self._logged = self._logged, {}
        return out

    def num_params(self) -> int:
        assert self.params is not None, "no params; fit or init first"
        return sum(p.numel() for p in self.params.values())

    def save_hyperparameters(self, **kwargs) -> None:
        """Record ctor kwargs. With no kwargs, captures the caller's (the
        subclass __init__'s) local arguments by inspection."""
        if not kwargs:
            frame = inspect.currentframe().f_back
            kwargs = {
                k: v for k, v in frame.f_locals.items()
                if k not in ("self", "__class__") and not k.startswith("_")
            }
        self.hparams.update(kwargs)

    @classmethod
    def load_from_checkpoint(cls, path: str, device=None,
                             **override_hparams) -> "TpuModule":
        """Rebuild a module from a checkpoint directory: the hparams from
        its meta.json (overridden by ``override_hparams``), then the
        weights read into the model, built on ``device`` (None: the CUDA
        card, raising without one; ``"cpu"`` for the CPU). Parity:
        `Model.load_from_checkpoint(best_model_path)` in the reference
        tests (tests/utils.py:184-189)."""
        from ray_lightning_tpu_torch.checkpoint import load_checkpoint
        from ray_lightning_tpu_torch.utils.devices import resolve_device

        ckpt = load_checkpoint(path)
        hparams = dict(ckpt.get("hparams") or {})
        hparams.update(override_hparams)
        module = cls(**hparams)
        module.device = resolve_device(device)
        module.setup()
        with torch.no_grad():
            module.model.load_state_dict(ckpt["params"], strict=True)
        module.params = dict(module.model.named_parameters())
        module.on_load_checkpoint(ckpt)
        return module

    def __call__(self, *args, **kwargs):
        if self.params is None:
            raise RuntimeError(
                "Module has no params; fit or load a checkpoint.")
        return self.apply(self.params, *args, **kwargs)
