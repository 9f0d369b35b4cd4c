"""The plan checker (twin of `ray_lightning_tpu/analysis/plan_checker.py`):
proves a module's sharding plan WELL-FORMED before any card time is
spent, on the meta device over a shape-only mesh.

`parallel/plan.py` proves a plan *fits* (bytes against the card); this
module proves the plan *means what its author thinks*: every axis name
exists, every sharded dimension divides, no axis is used twice, the
optimizer state does not silently widen. The meta device plays the part
`jax.eval_shape` plays in JAX: the model is built with shapes and dtypes
and no storage, and the strategy is laid on a shape-only mesh
(`Strategy.shape_only`), so a CPU box can check a 4096-card plan.

`parallel/strategy.py` calls `spec_findings` on every composed spec and
raises on an error, so the same rules guard the live Trainer path.

RLT106 (donation) has no torch counterpart: a torch step updates
parameters and optimizer state in place, with no donated buffers to
alias. `check_donation` says so, and `check_plan` reports the rule as
not checked (`PlanReport.not_checked`).

Imports torch only inside `check_plan`.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

from ray_lightning_tpu_torch.analysis.costmodel import dtype_width
from ray_lightning_tpu_torch.analysis.findings import NOT_FLAGGED, Finding

__all__ = [
    "spec_entries", "spec_findings", "check_param_specs",
    "check_opt_state_dtypes", "check_donation", "check_plan", "PlanReport",
    "optimizer_state_leaves",
]


def spec_entries(spec) -> List[Tuple[int, Tuple[str, ...]]]:
    """Flatten a spec (a tuple of per-dimension entries: None, an axis
    name, or a tuple of axis names) into (dim_index, axis_names) pairs;
    unsharded dims yield empty tuples."""
    out: List[Tuple[int, Tuple[str, ...]]] = []
    for i, entry in enumerate(tuple(spec)):
        if entry is None:
            out.append((i, ()))
        elif isinstance(entry, (tuple, list)):
            out.append((i, tuple(entry)))
        else:
            out.append((i, (entry,)))
    return out


def spec_findings(
    spec,
    shape: Sequence[int],
    mesh_sizes: Mapping[str, int],
    *,
    path: str = "<leaf>",
) -> List[Finding]:
    """Validate ONE spec against one leaf shape and a mesh: unknown axes
    (RLT101), duplicate axes (RLT103), rank overflow (RLT104), uneven
    shard dims (RLT102)."""
    findings: List[Finding] = []
    entries = spec_entries(spec)
    seen: Dict[str, int] = {}
    for i, names in entries:
        for ax in names:
            if ax not in mesh_sizes:
                findings.append(Finding(
                    "RLT101",
                    f"spec for {path} names mesh axis {ax!r} which does "
                    f"not exist (mesh axes: {sorted(mesh_sizes)}); the "
                    "composition logic would silently drop it and "
                    "replicate the leaf", symbol=path))
            if ax in seen:
                findings.append(Finding(
                    "RLT103",
                    f"spec for {path} uses mesh axis {ax!r} on dims "
                    f"{seen[ax]} and {i}; an axis can shard at most one "
                    "dim", symbol=path))
            seen.setdefault(ax, i)
    rank = len(shape)
    if len(entries) > rank:
        findings.append(Finding(
            "RLT104",
            f"spec for {path} has {len(entries)} entries but the leaf "
            f"has rank {rank} (shape {tuple(shape)})", symbol=path))
        return findings
    for i, names in entries:
        divisor = math.prod(mesh_sizes.get(ax, 1) for ax in names)
        if divisor > 1 and shape[i] % divisor != 0:
            findings.append(Finding(
                "RLT102",
                f"dim {i} of {path} (size {shape[i]}, shape "
                f"{tuple(shape)}) cannot be partitioned evenly by "
                f"{'x'.join(names)} (={divisor})", symbol=path))
    return findings


def check_param_specs(
    specs: Optional[Mapping[str, Any]],
    named_params: Mapping[str, Any],
    mesh_sizes: Mapping[str, int],
) -> List[Finding]:
    """Validate a module's raw `param_specs()` overlay against its
    (meta) parameters: per-spec structural rules plus stale paths that
    match no parameter (RLT107)."""
    findings: List[Finding] = []
    for path, spec in (specs or {}).items():
        leaf = named_params.get(path)
        if leaf is None:
            findings.append(Finding(
                "RLT107",
                f"param_specs path {path!r} matches no parameter "
                "(renamed layer? the spec silently does nothing). "
                f"Nearest params: {_nearest(path, named_params)}",
                symbol=path))
            continue
        findings.extend(spec_findings(
            spec, tuple(getattr(leaf, "shape", ())), mesh_sizes, path=path))
    return findings


def _nearest(path: str, named_params: Mapping[str, Any], k: int = 3) -> str:
    tail = path.replace(".", "/").split("/")[-1]
    hits = [p for p in named_params
            if p.replace(".", "/").split("/")[-1] == tail][:k]
    return ", ".join(hits) if hits else "(none share the leaf name)"


def check_opt_state_dtypes(named_params: Mapping[str, Any],
                           named_opt: Mapping[str, Any]) -> List[Finding]:
    """Dtype-widening hazards: an optimizer-state leaf stored WIDER than
    the parameter it tracks (matched by the longest ``/``-separated path
    suffix that names a parameter of the same shape) silently multiplies
    optimizer memory — e.g. f32 Adam moments over bf16 parameters are 2x
    the bytes the author likely budgeted."""
    findings: List[Finding] = []
    for opath, oleaf in named_opt.items():
        oshape = getattr(oleaf, "shape", None)
        odtype = getattr(oleaf, "dtype", None)
        if oshape is None or odtype is None:
            continue
        parts = opath.split("/")
        match = None
        for i in range(len(parts)):
            cand = "/".join(parts[i:])
            leaf = named_params.get(cand)
            if leaf is not None and tuple(getattr(leaf, "shape", ())) == \
                    tuple(oshape):
                match = (cand, leaf)
                break
        if match is None:
            continue
        ppath, pleaf = match
        p_size = dtype_width(getattr(pleaf, "dtype", None))
        o_size = dtype_width(odtype)
        if p_size and o_size and o_size > p_size:
            findings.append(Finding(
                "RLT105",
                f"optimizer state {opath} is {odtype} but its param "
                f"{ppath} is {pleaf.dtype}: the state is "
                f"{o_size / p_size:g}x wider than the weights it "
                "tracks (check the moments' dtypes against the memory "
                "plan)", symbol=opath))
    return findings


def check_donation(*_args, **_kwargs) -> str:
    """RLT106 has no torch counterpart: a torch step updates parameters
    and optimizer state in place, so no donated buffer needs an output
    to alias. Returns why (the JAX function returns findings); the
    arguments of the JAX signature are accepted and not read."""
    return NOT_FLAGGED["RLT106"]


class PlanReport(list):
    """`check_plan`'s findings (a list of `Finding`) and the rules it did
    not check, with why (``not_checked``: rule id -> reason)."""

    def __init__(self, findings=(), not_checked: Optional[Dict[str, str]]
                 = None):
        super().__init__(findings)
        self.not_checked: Dict[str, str] = dict(not_checked or {})

    def format(self) -> str:
        lines = [f.format() for f in self]
        lines += [f"not checked {rid}: {why}"
                  for rid, why in sorted(self.not_checked.items())]
        return "\n".join(lines)


def optimizer_state_leaves(optimizer, named_params: Mapping[str, Any]
                           ) -> Optional[Dict[str, Any]]:
    """``"<state key>/<param name>"`` -> a meta tensor of the shape and
    dtype ``optimizer`` keeps for that parameter after its first step
    (the state model `parallel.plan.optimizer_state_bytes` counts): Adam
    and AdamW keep ``exp_avg`` and ``exp_avg_sq`` (and ``max_exp_avg_sq``
    with amsgrad) in the parameter's dtype; `core.optim.MuAdamW` keeps
    ``exp_avg`` in its ``mu_dtype`` and ``exp_avg_sq`` in f32. None for
    another optimizer (its state is not modelled)."""
    import torch

    from ray_lightning_tpu_torch.core.optim import MuAdamW

    if not isinstance(optimizer, (MuAdamW, torch.optim.Adam,
                                  torch.optim.AdamW)):
        return None
    names = {id(p): n for n, p in named_params.items()}
    out: Dict[str, Any] = {}
    for group in optimizer.param_groups:
        for p in group["params"]:
            name = names.get(id(p))
            if name is None:
                continue
            if isinstance(optimizer, MuAdamW):
                dtypes = {"exp_avg": optimizer.mu_dtype,
                          "exp_avg_sq": torch.float32}
            else:
                keys = ["exp_avg", "exp_avg_sq"] + (
                    ["max_exp_avg_sq"] if group.get("amsgrad") else [])
                dtypes = {k: p.dtype for k in keys}
            for key, dt in dtypes.items():
                out[f"{key}/{name}"] = torch.empty(
                    p.shape, dtype=dt, device="meta")
    return out


def check_plan(
    module,
    strategy,
    n_devices: int,
    example_batch: Any = None,
) -> PlanReport:
    """Full plan audit for ``module`` trained under ``strategy`` on
    ``n_devices`` — the well-formedness sibling of
    `parallel.plan.plan_train_memory` (the same build: the model on the
    meta device, the strategy on a shape-only mesh; like the planner, it
    consumes the strategy and the module — pass fresh ones).

    Returns a `PlanReport`: findings from the module's raw param_specs
    overlay (RLT101/102/103/104/107), the strategy-composed specs
    (RLT102) and the optimizer-state dtypes (RLT105); RLT106 is reported
    as not checked (`check_donation`). ``example_batch`` is accepted for
    the JAX signature (the port's shapes do not depend on it). The
    module's own shape checks for an axis (``check_tensor_parallel``)
    are the strategy's, at setup, and do not run here: this reports what
    the specs say."""
    import torch

    del example_batch
    strategy.shape_only(n_devices, module)
    mesh_sizes = strategy.spec.sizes()
    module.device = torch.device("meta")
    module.setup()
    named = dict(module.model.named_parameters())
    report = PlanReport(not_checked={"RLT106": check_donation()})

    raw = module.param_specs() if hasattr(module, "param_specs") else None
    report.extend(check_param_specs(raw, named, mesh_sizes))

    # composed through the strategy's real path; structural ERRORS the
    # raw pass already reported raise there — collect, don't die
    compose = getattr(strategy, "leaf_spec", strategy.param_spec)
    for path, p in named.items():
        try:
            spec = compose(path, tuple(p.shape))
        except ValueError:
            if any(f.severity == "error" for f in report):
                return report
            raise  # not a defect the raw pass explained — surface it
        report.extend(spec_findings(spec, tuple(p.shape), mesh_sizes,
                                    path=path))

    # the optimizer over the meta parameters (a tensor lr on the host)
    module.device = torch.device("cpu")
    out = module.configure_optimizers()
    opt = out[0] if isinstance(out, tuple) else out
    leaves = optimizer_state_leaves(opt, named)
    if leaves is None:
        report.not_checked["RLT105"] = (
            f"the state of {type(opt).__name__} is not modelled (Adam, "
            "AdamW and MuAdamW are)")
    else:
        report.extend(check_opt_state_dtypes(named, leaves))
    return report
