"""Closed-loop serving autoscale (twin of `ray_lightning_tpu/autoscale/`):
a pure decision core (`policy`), the capacity oracle shared with the
elastic training ladder (`capacity`), the actuator driving the
`ServeDriver` scaling seams with an append-only decision ledger
(`controller`), and the deterministic scripted-load harness (`sim`).
Names resolve on first use."""
from ray_lightning_tpu_torch._lazy import lazy_exports

_NAMES = {
    **{n: "capacity" for n in (
        "CapacityAnswer", "CapacityOracle", "default_oracle",
        "spawn_probe")},
    **{n: "controller" for n in (
        "AutoscaleController", "ControllerConfig", "read_ledger")},
    **{n: "policy" for n in (
        "Decision", "PolicyConfig", "PolicyState", "decide")},
    "ScriptedLoad": "sim",
    "run_scripted": "sim",
}

__all__ = sorted(_NAMES)

__getattr__, __dir__ = lazy_exports(__name__, _NAMES)
