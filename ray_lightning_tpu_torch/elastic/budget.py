"""Elastic supervision budgets (twin of `ray_lightning_tpu/elastic/budget.py`:
the same ladder, the same batch plans): which world sizes a job may
legally run at, and what each size does to the batch plan.

The resilience supervisor used to know exactly one world size: lose a
host past the retry budget and the run died with capacity idling. An
`ElasticBudget` gives it a ladder instead (docs/ELASTIC.md "elastic
supervision"): on a failure the supervisor may move DOWN the ladder
(reshard the latest valid checkpoint onto the largest legal survivor
mesh and resume smaller) and back UP when capacity returns — each rung
validated by the same divisibility machinery the pre-flight plan
checker uses (`MeshSpec.resolve` + `plan.dp_degree`), never by
guesswork.

Legality of a world size ``w``:

  * ``min_world <= w <= max_world`` (max defaults to the launch size);
  * ``w % divisible_by == 0``;
  * the job's mesh template resolves at ``w`` — ``spec_for(w)`` must
    not raise (default template: all-data, which any w satisfies; pass
    the job's real template, e.g. ``lambda w: MeshSpec(fsdp=w)`` or a
    fixed-tensor shape ``lambda w: MeshSpec(data=-1, tensor=4)``, to
    get real divisibility checking);
  * when ``global_batch`` is set, it must shard at ``w``:
    ``global_batch % dp_degree(spec) == 0``.

The batch story is reported HONESTLY (`batch_plan`): shrinking dp
shrinks the global batch unless gradient accumulation makes up the
difference — the plan names the accumulation factor that would preserve
it (`Trainer(accumulate_grad_batches=...)`) and whether it is whole;
the supervisor records the plan in its reshard ledger either way, so a
silently changed effective batch can never masquerade as a seamless
resume.

Capacity comes from the SHARED oracle (`autoscale/capacity.py`,
docs/AUTOSCALE.md) — the same truth the serving autoscaler's clamp
reads: `RLT_CAPACITY` env override, probe file, optional WorkerGroup
spawn probe, with the resolved-max fallback LABELED ``assumed`` so the
supervisor can record the honesty gap in the reshard ledger when a
grow is refused (the old silent assume-restored default is retired).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional

from ray_lightning_tpu_torch.parallel.mesh import MeshSpec
from ray_lightning_tpu_torch.parallel.plan import dp_degree

__all__ = ["ElasticBudget"]


def _default_spec(world: int) -> MeshSpec:
    return MeshSpec(data=world)


def _resolve(spec_for: Callable[[int], MeshSpec], world: int) -> MeshSpec:
    """``spec_for(world)`` resolved at ``world`` (every axis builds)."""
    return spec_for(world).resolve(world)


@dataclasses.dataclass
class ElasticBudget:
    """The supervisor's world-size ladder. See module docstring."""

    min_world: int = 1
    #: None: the launch world size (the supervisor fills it in)
    max_world: Optional[int] = None
    #: candidate worlds must be multiples of this (e.g. hosts come in
    #: groups of 4 chips)
    divisible_by: int = 1
    #: the job's mesh template at a given world — legality is "this
    #: resolves" (MeshSpec.resolve raises on bad divisibility, exactly
    #: like the pre-flight plan checker)
    spec_for: Callable[[int], MeshSpec] = _default_spec
    #: global batch (rows/step) for the divisibility leg + batch_plan
    global_batch: Optional[int] = None
    #: how many topology changes (shrinks + grows) the run may perform
    max_reshards: int = 4
    #: legacy capacity hook: () -> currently available world size.
    #: Takes precedence over the oracle when set (back-compat).
    capacity_fn: Optional[Callable[[], int]] = None
    #: the capacity oracle (autoscale/capacity.py) — the SAME truth the
    #: serving autoscale controller consults: RLT_CAPACITY env
    #: override, probe file, optional WorkerGroup spawn probe. None =
    #: the process-wide default oracle (env + file). When NO source
    #: answers, the oracle falls back to the resolved max but LABELS
    #: it (source="assumed") — the supervisor records that label in
    #: the reshard ledger on a refused grow, so an assumption can
    #: never masquerade as a measurement (the retired silent
    #: assume-restored default).
    oracle: Optional[Any] = None

    def resolved_max(self, launch_world: int) -> int:
        return self.max_world if self.max_world is not None \
            else launch_world

    def legal(self, world: int, launch_world: Optional[int] = None) -> bool:
        """Is ``world`` a legal rung of the ladder?"""
        if world < max(1, self.min_world):
            return False
        if launch_world is not None and world > self.resolved_max(
                launch_world):
            return False
        if self.divisible_by > 1 and world % self.divisible_by:
            return False
        try:
            spec = _resolve(self.spec_for, world)
        except (ValueError, ZeroDivisionError):
            return False
        if self.global_batch is not None:
            if self.global_batch % dp_degree(spec):
                return False
        return True

    def legal_worlds(self, launch_world: int) -> List[int]:
        """Every legal rung from min_world to the resolved max,
        ascending."""
        hi = self.resolved_max(launch_world)
        return [w for w in range(max(1, self.min_world), hi + 1)
                if self.legal(w, launch_world)]

    def largest_legal(self, available: int,
                      launch_world: int) -> Optional[int]:
        """The largest legal world size <= ``available`` (the survivor
        count / reported capacity); None when even min_world does not
        fit — the run has no rung left and must fail."""
        hi = min(available, self.resolved_max(launch_world))
        for w in range(hi, max(1, self.min_world) - 1, -1):
            if self.legal(w, launch_world):
                return w
        return None

    def capacity_answer(self, launch_world: int):
        """The capacity oracle's full answer (worlds + source +
        detail) — what the supervisor stamps into the reshard ledger
        when a grow is refused. Resolution: the legacy ``capacity_fn``
        when set, else the configured/shared `CapacityOracle`
        (env -> probe file -> optional spawn probe), else the resolved
        max LABELED ``source="assumed"``."""
        from ray_lightning_tpu_torch.autoscale.capacity import (
            CapacityAnswer, default_oracle,
        )

        if self.capacity_fn is not None:
            try:
                return CapacityAnswer(max(0, int(self.capacity_fn())),
                                      "capacity_fn")
            except Exception as exc:  # noqa: BLE001 — a broken oracle
                # must not kill the supervisor; nothing came back
                return CapacityAnswer(
                    0, "capacity_fn",
                    f"oracle raised {type(exc).__name__}: "
                    f"{str(exc)[:200]}")
        oracle = self.oracle if self.oracle is not None \
            else default_oracle()
        return oracle.query(assume=self.resolved_max(launch_world))

    def capacity(self, launch_world: int) -> int:
        """Currently available world size per `capacity_answer`. The
        built-in chain always answers (the assume= fallback is the
        labeled resolved max); the None guard exists only for a
        user-supplied ``oracle`` whose query() ignores ``assume`` —
        such an oracle's silence reads as the historical
        assumed-restored value, never as zero."""
        worlds = self.capacity_answer(launch_world).worlds
        return worlds if worlds is not None \
            else self.resolved_max(launch_world)

    def batch_plan(self, old_world: int, new_world: int) -> Dict[str, Any]:
        """The honest batch story of a world change. When the global
        batch is known: the accumulation factor that would preserve it
        (whole factors only — `Trainer(accumulate_grad_batches=k)`) or
        the re-planned global batch otherwise, stated as such."""
        plan: Dict[str, Any] = {
            "old_world": int(old_world),
            "new_world": int(new_world),
        }
        try:
            old_dp = dp_degree(_resolve(self.spec_for, old_world))
            new_dp = dp_degree(_resolve(self.spec_for, new_world))
        except (ValueError, ZeroDivisionError):
            plan["note"] = "mesh template did not resolve; batch story unknown"
            return plan
        plan["old_dp"] = old_dp
        plan["new_dp"] = new_dp
        if old_dp == new_dp:
            plan["global_batch_preserved"] = True
            return plan
        if old_dp % new_dp == 0:
            k = old_dp // new_dp
            plan["grad_accum_to_preserve"] = k
            plan["global_batch_preserved"] = False
            plan["note"] = (
                f"dp degree {old_dp} -> {new_dp}: per-step global batch "
                f"scales by {new_dp}/{old_dp} unless the trainer runs "
                f"accumulate_grad_batches={k}")
        else:
            plan["global_batch_preserved"] = False
            plan["note"] = (
                f"dp degree {old_dp} -> {new_dp}: no whole accumulation "
                "factor preserves the global batch — it is re-planned "
                f"to {new_dp}/{old_dp} of the original")
        if self.global_batch is not None:
            plan["old_global_batch"] = int(self.global_batch)
            plan["replanned_global_batch"] = int(
                self.global_batch * new_dp / old_dp)
        return plan
