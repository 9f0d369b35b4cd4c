"""trainguard: in-step numerics guard, SDC detection, rollback-to-good
(twin of `ray_lightning_tpu/resilience/guard.py`).

Three tiers, as in the JAX package:

  tier 1  detection and skip on the device. The step already computes
          ``loss`` and ``grad_norm``; the guard adds a finiteness check
          and a loss-spike test against an EMA (five device scalars,
          `GuardState`). The JAX step discards an anomalous update with a
          tree-select. Here the decision is handed to the optimizer as
          its ``found_inf`` tensor, the skip flag torch's fused
          optimizers honour on the device (the one `GradScaler` sets):
          the params, every state tensor and the step counts that bias
          correction reads stay as they were, and a `DeviceLambdaLR`
          schedule holds its position the same way. Nothing is read on
          the host: the flag and the counters ride the step's metrics,
          which the trainer fetches on its logging cadence anyway.
  tier 2  escalation and rollback. `GuardCallback` reads the counters
          when they are on the host anyway and, when K anomalous steps
          land inside the window, writes a rollback marker and raises
          `TrainingAnomalyError`. The supervisor classifies it
          CORRUPTION, resumes from the last BLESSED checkpoint (the
          trainer stamps an anomaly-free-window verdict into each
          checkpoint's meta) and advances the data order past the
          poisoned window.
  tier 3  SDC probe. At a cadence each rank digests its OWN parameter
          bytes (each leaf reinterpreted at its own width, a wraparound
          sum mod 2^32: exact and order-independent, so equal to the JAX
          digest of the same bytes) and the digests are all-gathered:
          one small collective per probe, nothing per step. Ranks that
          hold identical bytes by construction (DataParallel replicas)
          must agree; a minority digest names the divergent rank, which
          the rollback marker quarantines.
"""
from __future__ import annotations

import dataclasses
import json
import logging
import os
import time
from collections import Counter
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import torch

from ray_lightning_tpu_torch.core.callbacks import Callback

log = logging.getLogger(__name__)

#: rollback marker, written beside the supervisor's checkpoints on
#: escalation; the supervisor reads it to pick the rollback target and
#: the relaunched worker to advance the data order. A marker applies
#: only while its detected_step is ahead of the restored step.
ROLLBACK_MARKER = ".trainguard_rollback.json"

#: quarantine ledger the supervisor keeps next to the marker: ranks
#: whose hardware produced a divergent parameter fingerprint
QUARANTINE_FILE = ".quarantine.json"


# --------------------------------------------------------------- config


@dataclasses.dataclass
class GuardConfig:
    """Knobs for the three tiers: "a NaN or a 10x loss spike is an
    anomaly; a handful in quick succession is corruption"."""

    #: tier 1 master switch
    enabled: bool = True
    #: loss > spike_factor * EMA + spike_margin => anomaly
    spike_factor: float = 10.0
    spike_margin: float = 1.0
    ema_decay: float = 0.9
    #: anomaly-free steps the EMA observes before the spike test arms
    #: (the finiteness checks are armed from step 0)
    warmup_steps: int = 5
    #: tier 2: escalate when >= escalate_after anomalies land within the
    #: trailing escalate_window steps (read at the metric fetch cadence)
    escalate_after: int = 4
    escalate_window: int = 16
    #: a checkpoint is blessed iff no anomaly occurred within this many
    #: updates before the save and no streak is active
    bless_clean_steps: int = 4
    #: tier 3: run the SDC fingerprint probe every N steps (0 disables)
    sdc_every_n_steps: int = 0

    @classmethod
    def coerce(cls, value) -> "GuardConfig":
        if value is True:
            return cls()
        if isinstance(value, cls):
            return value
        if isinstance(value, dict):
            return cls(**value)
        raise TypeError(f"cannot build GuardConfig from {value!r}")


# --------------------------------------------------------------- tier 1


@dataclasses.dataclass
class GuardState:
    """The guard's device scalars: the EMA of finite losses (f32), the
    finite losses it has seen, the updates skipped, the current streak
    and the update index of the last anomaly (-1 for none), all i32."""

    ema: torch.Tensor
    seen: torch.Tensor
    skipped: torch.Tensor
    streak: torch.Tensor
    last_anomaly: torch.Tensor


def init_guard_state(device=None) -> GuardState:
    def i32(v):
        return torch.full((), v, dtype=torch.int32, device=device)

    return GuardState(ema=torch.zeros((), dtype=torch.float32,
                                      device=device),
                      seen=i32(0), skipped=i32(0), streak=i32(0),
                      last_anomaly=i32(-1))


def apply_guard(cfg: GuardConfig, guard: GuardState, step: torch.Tensor,
                loss: torch.Tensor, grad_norm: torch.Tensor):
    """The tier-1 decision, on the device (the JAX `apply_guard` without
    its tree-select, which the optimizer's ``found_inf`` skip replaces).

    ``step`` is the device count of updates applied so far. Returns
    ``(bad, new_step, new_guard, metrics)``: ``bad`` a bool scalar, the
    count advanced only when the update is kept, and the flag and
    counters as metric scalars. No host reads."""
    loss32 = loss.detach().float()
    gn32 = grad_norm.detach().float()
    finite = torch.isfinite(loss32) & torch.isfinite(gn32)
    warmed = guard.seen >= cfg.warmup_steps
    spike = warmed & (loss32 > cfg.spike_factor * guard.ema
                      + cfg.spike_margin)
    bad = ~finite | spike
    badi = bad.to(torch.int32)
    ema = torch.where(
        bad, guard.ema,
        torch.where(guard.seen == 0, loss32,
                    cfg.ema_decay * guard.ema
                    + (1.0 - cfg.ema_decay) * loss32))
    new_guard = GuardState(
        ema=ema,
        seen=guard.seen + 1 - badi,
        skipped=guard.skipped + badi,
        streak=torch.where(bad, guard.streak + 1,
                           torch.zeros_like(guard.streak)),
        last_anomaly=torch.where(bad, step.to(torch.int32),
                                 guard.last_anomaly),
    )
    new_step = step + 1 - badi.to(step.dtype)
    metrics = {
        "guard_anomaly": badi,
        "guard_skipped_steps": new_guard.skipped,
        "guard_streak": new_guard.streak,
        "guard_last_anomaly": new_guard.last_anomaly,
        "guard_loss_ema": ema,
    }
    return bad, new_step, new_guard, metrics


def bless_verdict(cfg: GuardConfig, guard_host, update_step: int) -> bool:
    """The anomaly-free-window verdict stamped into checkpoint meta
    (``blessed``): no active streak and the last anomaly at least
    ``bless_clean_steps`` updates behind the save."""
    streak = int(guard_host.streak)
    last = int(guard_host.last_anomaly)
    return streak == 0 and (last < 0
                            or update_step - last >= cfg.bless_clean_steps)


def check_guardable(optimizer, scheduler) -> None:
    """Raise ValueError unless the guard can hold back a skipped update
    of this optimizer and schedule on the device: a fused torch
    optimizer (its ``found_inf`` skip leaves params, state and step
    counts as they were) and no schedule or a `DeviceLambdaLR`."""
    from ray_lightning_tpu_torch.core.schedule import DeviceLambdaLR

    if optimizer is None:
        return
    if not (getattr(optimizer, "_step_supports_amp_scaling", False)
            and all(g.get("fused") for g in optimizer.param_groups)):
        raise ValueError(
            f"Trainer(guard=...) needs a fused optimizer: "
            f"{type(optimizer).__name__} without fused=True keeps its step "
            "counts on the host, so a skipped update could not leave them "
            "as they were without a host sync; construct it with "
            "fused=True (Adam, AdamW, SGD, Adagrad)")
    if scheduler is not None and not isinstance(scheduler, DeviceLambdaLR):
        raise ValueError(
            f"Trainer(guard=...) cannot hold back {type(scheduler).__name__}:"
            " a host-side LR scheduler advances on every update, skipped or"
            " not; use ray_lightning_tpu_torch.core.schedule.DeviceLambdaLR"
            " (a tensor lr and a schedule position on the device)")


# ------------------------------------------------------------ exceptions


class TrainingAnomalyError(RuntimeError):
    """Tier-2 escalation: K anomalous steps inside the window. The NAME
    is part of the protocol: it reaches the driver inside the worker
    traceback and `policy.classify_failure` keys on it (CORRUPTION)."""

    def __init__(self, detected_step: int, count: int, window: int,
                 last_good_step: int):
        self.detected_step = detected_step
        self.last_good_step = last_good_step
        super().__init__(
            f"training anomaly escalation: {count} anomalous step(s) "
            f"within the last {window} steps (detected at step "
            f"{detected_step}; last known-good step {last_good_step}) — "
            "rolling back to the last blessed checkpoint")


class SDCDetectedError(TrainingAnomalyError):
    """Tier-3 verdict: parameter fingerprints diverged across replicas,
    silent data corruption on the named rank(s)."""

    def __init__(self, suspect_ranks: Sequence[int], detected_step: int,
                 last_good_step: int, digests: Sequence[int] = ()):
        self.suspect_ranks = list(suspect_ranks)
        self.detected_step = detected_step
        self.last_good_step = last_good_step
        self.digests = list(digests)
        who = (f"rank(s) {self.suspect_ranks}" if self.suspect_ranks
               else "an unattributable replica (no majority)")
        RuntimeError.__init__(
            self,
            f"silent data corruption detected at step {detected_step}: "
            f"parameter fingerprints diverged across replicas — {who}; "
            f"last probe-verified step {last_good_step}. Rolling back "
            "to the last blessed checkpoint and quarantining the host")


# -------------------------------------------------------- rollback marker


def write_rollback_marker(dirpath: str, payload: Dict[str, Any]) -> None:
    """Atomic (tmp + os.replace), rank 0 only, as checkpoint meta.json:
    the worker-to-driver record that survives the process teardown."""
    from ray_lightning_tpu_torch.checkpoint.io import _rank

    if _rank() != 0:
        return
    os.makedirs(dirpath, exist_ok=True)
    path = os.path.join(dirpath, ROLLBACK_MARKER)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(payload, f)
    os.replace(tmp, path)


def read_rollback_marker(dirpath: str) -> Optional[Dict[str, Any]]:
    path = os.path.join(dirpath, ROLLBACK_MARKER)
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


# --------------------------------------------------------------- tier 3

_MASK32 = 0xFFFFFFFF


def _leaf_digest(x: torch.Tensor) -> torch.Tensor:
    """Wraparound sum mod 2^32 of one leaf's bits, each element read at
    its own width as an unsigned integer (the JAX bitcast), int64 on the
    leaf's device. Every stored bit reaches the sum, so one flipped bit
    always changes it; 64-bit words count as their two 32-bit halves.
    Int64 accumulation is exact for any leaf under 2^31 elements."""
    x = x.detach()
    width = x.element_size()
    if x.dtype == torch.bool:
        u = x.to(torch.int64)
    elif width == 8:
        w = x.view(torch.int64)
        return ((w & _MASK32).sum() + ((w >> 32) & _MASK32).sum()) & _MASK32
    elif width == 4:
        # a signed sum differs from the unsigned one by multiples of 2^32
        return x.view(torch.int32).sum(dtype=torch.int64) & _MASK32
    else:
        # 8- and 16-bit words: zero-extended, as the JAX uint32 cast
        u = x.view({1: torch.uint8, 2: torch.int16}[width])
        u = u.to(torch.int32) & ((1 << (8 * width)) - 1)
    return u.sum(dtype=torch.int64) & _MASK32


def _leaves(tree) -> List[torch.Tensor]:
    """Leaves in the JAX package's flatten order: dict keys sorted."""
    if isinstance(tree, Mapping):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in _leaves(v)]
    return [tree]


def _tree_digest(tree) -> torch.Tensor:
    """The JAX `_tree_digest`: each leaf's digest times ``2i + 1`` (so
    two leaves swapping contents change it), summed mod 2^32."""
    total = torch.zeros((), dtype=torch.int64)
    for i, leaf in enumerate(_leaves(tree)):
        d = _leaf_digest(leaf)
        total = (total.to(d.device) + d * (2 * i + 1)) & _MASK32
    return total


def replica_groups(param_specs: Mapping[str, Sequence],
                   mesh_shape: Mapping[str, int]) -> List[List[int]]:
    """Groups of ranks (row-major over ``mesh_shape``) that hold
    bit-identical parameter bytes by construction: ranks whose
    coordinates agree on every axis some parameter is sharded over.
    ``param_specs`` maps each parameter to its per-dimension axis (None:
    unsharded; `checkpoint.io.sharding_provenance`'s ``param_specs``).
    DataParallel gives one group of every rank; FSDP gives singletons,
    which are dropped (no redundancy to cross-check)."""
    sharded_axes: set = set()
    for spec in param_specs.values():
        for dim in spec or ():
            if dim is None:
                continue
            sharded_axes.update(dim if isinstance(dim, (list, tuple))
                                else (dim,))
    axes = list(mesh_shape)
    sizes = [int(mesh_shape[a]) for a in axes]
    n = 1
    for s in sizes:
        n *= s
    groups: Dict[Tuple, List[int]] = {}
    for i in range(n):
        coords, rest = [], i
        for s in reversed(sizes):
            coords.append(rest % s)
            rest //= s
        coords.reverse()
        key = tuple(c for a, c in zip(axes, coords) if a in sharded_axes)
        groups.setdefault(key, []).append(i)
    return [g for g in groups.values() if len(g) >= 2]


def diagnose_digests(digests: Sequence[int],
                     groups: Sequence[Sequence[int]]
                     ) -> Tuple[List[int], bool]:
    """Compare the fingerprints within each replica group. Returns
    ``(suspect_indices, comparable)``: a majority vote flags the
    minority; a group with no strict majority flags every member (with
    two replicas a mismatch cannot name the liar). ``comparable`` is
    False when no group had redundancy to check."""
    suspects: set = set()
    comparable = False
    for g in groups:
        vals = [int(digests[i]) for i in g]
        counts = Counter(vals)
        comparable = True
        if len(counts) == 1:
            continue
        top, topn = counts.most_common(1)[0]
        if 2 * topn > len(g):
            suspects |= {i for i in g if int(digests[i]) != top}
        else:
            suspects |= set(g)
    return sorted(suspects), comparable


def local_digest(params: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """This rank's fingerprint of its OWN bytes (a DTensor's local
    shard, not the global tensor)."""
    return _tree_digest({n: p.to_local() if hasattr(p, "to_local") else p
                         for n, p in params.items()})


def probe_digests(params: Mapping[str, torch.Tensor]) -> List[int]:
    """Every rank's `local_digest`, gathered in rank order (one small
    collective; a lone process gives its own)."""
    import torch.distributed as dist

    mine = local_digest(params).reshape(1)
    if not (dist.is_available() and dist.is_initialized()) \
            or dist.get_world_size() == 1:
        return [int(mine)]
    out = [torch.zeros_like(mine) for _ in range(dist.get_world_size())]
    dist.all_gather(out, mine)
    return [int(t) for t in out]


# -------------------------------------------------------- GuardCallback


class GuardCallback(Callback):
    """Tiers 2 and 3, on the host. Reads the tier-1 counters only when
    the trainer has fetched them (the log cadence), so escalation costs
    no host sync; the SDC probe runs under its own ``step % N == 0``
    cadence."""

    def __init__(self, cfg: GuardConfig, marker_dir: Optional[str] = None):
        self.cfg = GuardConfig.coerce(cfg)
        self.marker_dir = marker_dir
        self._hist: List[Tuple[int, float]] = []   # (global_step, skipped)
        self._base = 0.0           # skipped count that aged out
        self._last_good = 0
        self._probe_groups: Optional[List[List[int]]] = None
        self._probes_run = 0
        self._probe_ok_step = 0
        self._rollbacks_prior = 0

    def _dir(self, trainer) -> str:
        return self.marker_dir or trainer.default_root_dir

    def on_fit_start(self, trainer, module) -> None:
        self._hist = []
        self._base = 0.0
        self._last_good = trainer.global_step
        self._probe_ok_step = trainer.global_step
        if self.cfg.sdc_every_n_steps:
            # retention floor input (core/callbacks.py _prune): with the
            # probe armed, the rollback target must sit at or below the
            # last probe-VERIFIED step. The restore point counts as
            # verified (it passed its digest check on load).
            trainer._guard_probe_ok_step = trainer.global_step
        marker = read_rollback_marker(self._dir(trainer))
        self._rollbacks_prior = int((marker or {}).get(
            "rollbacks_performed", 0))
        trainer.callback_metrics["guard_rollbacks"] = float(
            self._rollbacks_prior)
        trainer.callback_metrics.setdefault("guard_sdc_probes", 0.0)

    def on_train_batch_end(self, trainer, module, metrics, batch_idx) -> None:
        step = trainer.global_step
        skipped = metrics.get("guard_skipped_steps") if isinstance(
            metrics, dict) else None
        if skipped is not None and _is_host_value(skipped):
            streak = metrics.get("guard_streak")
            self._note(trainer, step, float(skipped),
                       float(streak) if streak is not None
                       and _is_host_value(streak) else 0.0)
        if (self.cfg.sdc_every_n_steps
                and step % self.cfg.sdc_every_n_steps == 0):
            self._run_probe(trainer)

    # -- tier 2: escalation ------------------------------------------------

    def _note(self, trainer, step: int, skipped: float,
              streak: float = 0.0) -> None:
        prev_step = self._hist[-1][0] if self._hist else None
        if self._hist and skipped <= self._hist[-1][1]:
            # no new anomaly since the previous observation
            self._last_good = step
        elif not self._hist and skipped <= 0:
            self._last_good = step
        self._hist.append((step, skipped))
        horizon = step - self.cfg.escalate_window
        while self._hist and self._hist[0][0] < horizon:
            self._base = max(self._base, self._hist.pop(0)[1])
        # The windowed count holds only when observations are at least
        # window-dense: with a fetch cadence longer than the window, a
        # skipped-count delta spans the whole gap. The streak counter is
        # exact per step whenever it is read, so K CONSECUTIVE anomalies
        # always escalate.
        dense = prev_step is not None and prev_step >= horizon
        in_window = skipped - self._base
        if (dense and in_window >= self.cfg.escalate_after) \
                or streak >= self.cfg.escalate_after:
            self._escalate(trainer, step, int(max(in_window, streak)))

    def _escalate(self, trainer, step: int, count: int) -> None:
        err = TrainingAnomalyError(step, count, self.cfg.escalate_window,
                                   self._last_good)
        write_rollback_marker(self._dir(trainer), {
            "kind": "anomaly-streak",
            "detected_step": step,
            "last_good_step": self._last_good,
            "epoch": trainer.current_epoch,
            "epoch_batch": trainer._epoch_batches_done,
            "anomalies_in_window": count,
            "quarantine": [],
            "rollbacks_performed": self._rollbacks_prior,
            "at": time.time(),
        })
        log.error("trainguard: %s", err)
        raise err

    # -- tier 3: SDC probe -------------------------------------------------

    def _run_probe(self, trainer) -> None:
        module = trainer.module
        if module is None or module.params is None:
            return
        mesh = trainer.strategy.mesh
        if self._probe_groups is None:
            from ray_lightning_tpu_torch.checkpoint.io import (
                sharding_provenance,
            )
            from ray_lightning_tpu_torch.parallel.mesh import mesh_sizes

            prov = sharding_provenance(mesh, module.params)
            self._probe_groups = replica_groups(
                prov.get("param_specs", {}),
                mesh_sizes(mesh) if mesh is not None else {})
            if not self._probe_groups:
                log.info("trainguard: no replicated parameter bytes on "
                         "this mesh; the SDC probe records fingerprints "
                         "but cannot cross-check them")
        digests = probe_digests(module.params)
        self._probes_run += 1
        trainer.callback_metrics["guard_sdc_probes"] = float(
            self._probes_run)
        suspects, comparable = diagnose_digests(digests, self._probe_groups)
        if not comparable or not suspects:
            self._probe_ok_step = trainer.global_step
            trainer._guard_probe_ok_step = trainer.global_step
            return
        # one device a process: a suspect index is its rank
        ranks = [] if len(suspects) >= len(digests) else list(suspects)
        err = SDCDetectedError(ranks, trainer.global_step,
                               self._probe_ok_step, digests=digests)
        write_rollback_marker(self._dir(trainer), {
            "kind": "sdc",
            "detected_step": trainer.global_step,
            "last_good_step": self._probe_ok_step,
            "epoch": trainer.current_epoch,
            "epoch_batch": trainer._epoch_batches_done,
            "quarantine": ranks,
            "digests": digests,
            "rollbacks_performed": self._rollbacks_prior,
            "at": time.time(),
        })
        log.error("trainguard: %s", err)
        raise err


def _is_host_value(v) -> bool:
    """True when the metric is on the host already (the trainer fetched
    it on the log cadence); a device tensor is left alone, since reading
    it would add the per-step sync this design exists to avoid."""
    return isinstance(v, (bool, int, float))
