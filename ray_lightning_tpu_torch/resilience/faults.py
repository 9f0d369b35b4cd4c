"""Deterministic fault injection (twin of
`ray_lightning_tpu/resilience/faults.py`): every recovery path can be
proven on the CPU, and the same plan runs on the card.

A fault plan is a spec string (env ``RLT_FAULTS`` or
``ResilienceConfig.faults``), semicolon-separated::

    kill:rank=1,step=3            SIGKILL the worker (a vanished host)
    preempt:rank=0,step=2         SIGTERM self (a preemption notice)
    raise:rank=0,step=2           raise RuntimeError (a FATAL user bug)
    exit:rank=1,step=3,rc=7       os._exit(rc) (a crashed runtime)
    hang:rank=1,step=3,secs=600   stop stepping AND stop heartbeating
                                  (exercises the stall watchdog)
    corrupt_latest:rank=0,step=3,dir=/ckpts
                                  flip bytes in the newest checkpoint's
                                  state (latest_checkpoint must skip it)
    nan_loss:rank=0,step=3,count=1
                                  poison the batch about to become step
                                  3 (NaN into element 0 of each float
                                  leaf) for ``count`` consecutive steps;
                                  the trainguard must skip them
    grad_blowup:rank=0,step=3,scale=1e18,count=1
                                  scale the batch's float leaves so the
                                  loss and gradients blow up
    bitflip_param:rank=1,step=3,bit=12,leaf=0,element=0
                                  flip ONE bit of one element of this
                                  rank's local parameter bytes (under
                                  FSDP2 the DTensor's local shard): a
                                  silent corruption only the
                                  trainguard's fingerprint probe sees

``rank=*`` matches every rank. Each fault fires ONCE per plan across
restarts: a marker file is written under ``RLT_FAULT_STATE_DIR`` BEFORE
the fault fires (a kill cannot lose it), so the restarted run sails past
the step that killed its predecessor. Without a state dir, once-ness is
per process. The JAX spec's ``device=`` argument of ``bitflip_param`` is
accepted and ignored: a port process drives one device.
"""
from __future__ import annotations

import dataclasses
import logging
import os
import signal
import time
from typing import Dict, List, Optional

from ray_lightning_tpu_torch.core.callbacks import Callback

log = logging.getLogger(__name__)

FAULTS_ENV = "RLT_FAULTS"
FAULT_STATE_ENV = "RLT_FAULT_STATE_DIR"

_KINDS = ("kill", "preempt", "raise", "exit", "hang", "corrupt_latest",
          "nan_loss", "grad_blowup", "bitflip_param")

#: kinds that poison the BATCH before the step runs (through the
#: trainer's on_train_batch_start replacement seam); the others fire at
#: the batch-end boundary. ``step=k`` for these means "the batch that
#: would become global step k", so the anomaly lands at step k.
_BATCH_START_KINDS = ("nan_loss", "grad_blowup")


@dataclasses.dataclass(frozen=True)
class Fault:
    kind: str
    rank: Optional[int]          # None = every rank ("*")
    step: int                    # fires when global_step >= step
    args: Dict[str, str] = dataclasses.field(default_factory=dict)
    index: int = 0               # position in the plan (the marker key)

    def marker(self, rank: int) -> str:
        # per-RANK once-ness: a rank=* fault (the all-hosts SIGTERM of a
        # preemption) must fire on every matching rank, or one rank
        # drains through a collective emergency save the others never
        # join
        return f"fault-{self.index}-{self.kind}-step{self.step}-r{rank}"

    def matches(self, rank: int, step: int) -> bool:
        return (self.rank is None or self.rank == rank) and step >= self.step


def parse_faults(spec: Optional[str]) -> List[Fault]:
    """Parse a plan spec; a typo raises ValueError naming the clause,
    so a mistyped injection fails loudly instead of testing nothing."""
    faults: List[Fault] = []
    for i, clause in enumerate(c.strip() for c in (spec or "").split(";")):
        if not clause:
            continue
        kind, _, rest = clause.partition(":")
        kind = kind.strip()
        if kind not in _KINDS:
            raise ValueError(
                f"unknown fault kind {kind!r} in {clause!r} "
                f"(known: {', '.join(_KINDS)})")
        args: Dict[str, str] = {}
        for pair in filter(None, (p.strip() for p in rest.split(","))):
            k, sep, v = pair.partition("=")
            if not sep:
                raise ValueError(f"malformed fault arg {pair!r} in {clause!r}")
            args[k.strip()] = v.strip()
        rank_s = args.pop("rank", "*")
        rank = None if rank_s == "*" else int(rank_s)
        step = int(args.pop("step", "1"))
        faults.append(Fault(kind, rank, step, args, index=i))
    return faults


def corrupt_checkpoint(path: str) -> bool:
    """Flip 64 bytes mid-way through the largest file under ``path``
    (in the DCP layout, a ``.distcp`` data file): a garbled write the
    digest in meta.json must catch. meta.json is left alone, so the
    checkpoint looks finished but damaged. True when something was
    corrupted."""
    biggest, size = None, -1
    for root, _, files in os.walk(path):
        for f in files:
            if f == "meta.json":
                continue
            p = os.path.join(root, f)
            try:
                s = os.path.getsize(p)
            except OSError:
                continue
            if s > size:
                biggest, size = p, s
    if biggest is None or size <= 0:
        return False
    with open(biggest, "r+b") as fh:
        fh.seek(size // 2)
        chunk = fh.read(64) or b"\x00"
        fh.seek(size // 2)
        fh.write(bytes(b ^ 0xFF for b in chunk))
    log.warning("fault injection: corrupted %s (%d bytes at offset %d)",
                biggest, len(chunk), size // 2)
    return True


def _poison_batch(batch, kind: str, scale: float):
    """nan_loss / grad_blowup: each float leaf of this rank's batch gets
    a NaN in element 0 (nan_loss) or is scaled (grad_blowup). The
    trainguard decides on the loss averaged over the data-parallel
    ranks, so one poisoned rank poisons the step on every rank alike."""
    import torch

    from ray_lightning_tpu_torch.core.trainer import _tree_map

    def mutate(x):
        if not (isinstance(x, torch.Tensor) and x.is_floating_point()
                and x.numel()):
            return x
        if kind == "nan_loss":
            x = x.clone()
            x.view(-1)[0] = float("nan")
            return x
        return x * scale

    return _tree_map(mutate, batch)


def _flip_bit(t, element: int, bit: int) -> bool:
    """XOR one bit of one element of ``t`` in place, at the element's
    own width."""
    import torch

    view_dtype = {1: torch.uint8, 2: torch.int16, 4: torch.int32,
                  8: torch.int64}.get(t.element_size())
    if view_dtype is None or t.numel() == 0 or t.dtype == torch.bool:
        return False
    nbits = 8 * t.element_size()
    mask = 1 << (bit % nbits)
    if view_dtype.is_signed and mask >= 1 << (nbits - 1):
        mask -= 1 << nbits  # the sign bit, as the signed view holds it
    flat = t.view(view_dtype).view(-1)
    i = element % flat.numel()
    flat[i:i + 1].bitwise_xor_(mask)
    return True


class FaultInjector(Callback):
    """Fires plan faults at batch boundaries on the matching rank (the
    batch-poisoning kinds at batch START, through the trainer's batch
    replacement seam)."""

    def __init__(self, faults: List[Fault],
                 state_dir: Optional[str] = None):
        self.faults = faults
        self.state_dir = state_dir
        self._fired_local: set = set()
        #: remaining poison budget per fired batch-start fault (``count=N``
        #: poisons N consecutive batches in the run that fired it; the
        #: once-marker still spans restarts)
        self._active: Dict[str, int] = {}

    # -- once-ness ---------------------------------------------------------
    def _already_fired(self, fault: Fault, rank: int) -> bool:
        marker = fault.marker(rank)
        if marker in self._fired_local:
            return True
        if self.state_dir:
            return os.path.exists(os.path.join(self.state_dir, marker))
        return False

    def _mark_fired(self, fault: Fault, rank: int) -> None:
        # marker BEFORE the fault fires: a kill must not re-fire on resume
        marker = fault.marker(rank)
        self._fired_local.add(marker)
        if self.state_dir:
            os.makedirs(self.state_dir, exist_ok=True)
            with open(os.path.join(self.state_dir, marker), "w") as f:
                f.write(str(time.time()))

    # -- firing ------------------------------------------------------------
    @staticmethod
    def _rank() -> int:
        from ray_lightning_tpu_torch.runtime import session

        if session.is_session_enabled():
            return session.get_actor_rank()
        return 0

    def _fire(self, fault: Fault, trainer) -> None:
        log.warning("fault injection: firing %s (rank=%s step>=%d) at "
                    "global_step=%d", fault.kind, fault.rank, fault.step,
                    trainer.global_step)
        if fault.kind == "kill":
            os.kill(os.getpid(), signal.SIGKILL)
        elif fault.kind == "exit":
            os._exit(int(fault.args.get("rc", "1")))
        elif fault.kind == "preempt":
            # a real SIGTERM: the flag-only handler and the
            # PreemptionGuard drain are both on the tested path
            os.kill(os.getpid(), signal.SIGTERM)
        elif fault.kind == "raise":
            raise RuntimeError(
                f"injected fatal failure at step {trainer.global_step} "
                f"(fault plan #{fault.index})")
        elif fault.kind == "hang":
            from ray_lightning_tpu_torch.resilience.health import (
                HeartbeatCallback,
            )

            for cb in trainer.callbacks:
                if isinstance(cb, HeartbeatCallback):
                    cb.mute()
            time.sleep(float(fault.args.get("secs", "600")))
        elif fault.kind == "bitflip_param":
            self._fire_bitflip(fault, trainer)
        elif fault.kind == "corrupt_latest":
            target = fault.args.get("dir")
            if not target:
                raise ValueError("corrupt_latest fault needs dir=<ckpt dir>")
            newest = _newest_checkpoint_dir(target)
            if newest is not None:
                corrupt_checkpoint(newest)

    @staticmethod
    def _fire_bitflip(fault: Fault, trainer) -> None:
        """One bit of one element of this rank's local copy of the
        ``leaf``-th float parameter (names in sorted order, the JAX
        package's leaf order) flips: the replicas diverge, as a hardware
        fault makes them, and no collective runs."""
        import torch

        module = trainer.module
        if module is None or module.params is None:
            return
        floats = [n for n in sorted(module.params)
                  if module.params[n].is_floating_point()]
        if not floats:
            return
        p = module.params[floats[int(fault.args.get("leaf", "0"))
                                 % len(floats)]]
        local = p.to_local() if hasattr(p, "to_local") else p
        with torch.no_grad():
            _flip_bit(local.data, int(fault.args.get("element", "0")),
                      int(fault.args.get("bit", "12")))

    def on_train_batch_start(self, trainer, module, batch, batch_idx):
        rank = self._rank()
        out = batch
        for fault in self.faults:
            if fault.kind not in _BATCH_START_KINDS:
                continue
            key = fault.marker(rank)
            remaining = self._active.get(key)
            if remaining is None:
                # step=k poisons the batch that becomes global step k
                if not fault.matches(rank, trainer.global_step + 1):
                    continue
                if self._already_fired(fault, rank):
                    continue
                self._mark_fired(fault, rank)
                remaining = int(fault.args.get("count", "1"))
            if remaining <= 0:
                continue
            self._active[key] = remaining - 1
            log.warning(
                "fault injection: poisoning batch for %s (rank=%s "
                "step>=%d, %d more) at global_step=%d", fault.kind,
                fault.rank, fault.step, remaining - 1, trainer.global_step)
            out = _poison_batch(
                out, fault.kind, scale=float(fault.args.get("scale", "1e18")))
        return out if out is not batch else None

    def on_train_batch_end(self, trainer, module, metrics, batch_idx) -> None:
        rank = self._rank()
        for fault in self.faults:
            if fault.kind in _BATCH_START_KINDS:
                continue
            if not fault.matches(rank, trainer.global_step):
                continue
            if self._already_fired(fault, rank):
                continue
            self._mark_fired(fault, rank)
            self._fire(fault, trainer)


def _newest_checkpoint_dir(root: str) -> Optional[str]:
    """The newest checkpoint subdir (one holding ``state/``) by mtime,
    deliberately NOT `latest_checkpoint`: the injector wants the newest
    checkpoint whatever its validity, which is the code under test.
    Other subdirs (the fault markers' own, quarantined checkpoints) are
    no candidates: writing a marker makes its dir the newest."""
    try:
        subdirs = [os.path.join(root, d) for d in os.listdir(root)
                   if os.path.isdir(os.path.join(root, d, "state"))]
    except OSError:
        return None
    return max(subdirs, key=os.path.getmtime, default=None)


def faults_from_env() -> List[Fault]:
    return parse_faults(os.environ.get(FAULTS_ENV))


def maybe_install_faults(trainer) -> Optional[FaultInjector]:
    """Attach a FaultInjector built from the environment (no-op without
    RLT_FAULTS)."""
    faults = faults_from_env()
    if not faults:
        return None
    injector = FaultInjector(faults, os.environ.get(FAULT_STATE_ENV))
    trainer.callbacks.append(injector)
    return injector
