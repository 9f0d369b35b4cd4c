"""supervise(): the restart loop between the driver API and the runtime
(twin of `ray_lightning_tpu/resilience/supervisor.py`).

One supervised attempt is one ordinary ``run_distributed`` call: a fresh
worker group, launched and torn down by runtime/launch.py as an
unsupervised run would be. The supervisor adds, around it:

  driver side   classify every failure (`policy.classify_failure`), sleep
                the backoff, pick the latest VALID checkpoint
                (`checkpoint.latest_checkpoint` skips torn and corrupt
                ones) and relaunch with ``ckpt_path`` pointing at it; the
                trainer's mid-epoch resume replays the REST of the
                interrupted epoch, no batch twice, none skipped. A
                `HealthMonitor` reads the heartbeats on the side channel
                and runs in the pump's watchdog hook.
  worker side   the trainer factory is wrapped to attach the periodic
                step-cadence checkpoint the resume rides on, the
                heartbeat sender, the SIGTERM drain (`PreemptionGuard`),
                the trainguard when configured, and the fault injector
                when a plan is given.
  elastic       ``elastic=ElasticBudget(...)`` makes the world size a
                ladder: when the retry policy refuses another same-size
                relaunch, the latest valid checkpoint is resharded onto
                the largest legal survivor world (the relaunched
                trainer's cross-mesh restore, `Trainer._reshard_move`);
                when the capacity oracle reports capacity back, the
                next relaunch grows. Every change, and every grow the
                oracle refused, lands in `SupervisedResult.reshards` and
                ``<checkpoint_dir>/reshards.jsonl``.
  telemetry     every worker records spans and goodput ledgers into the
                run's ``<checkpoint_dir>/telemetry`` (on by default); the
                driver records its attempt and backoff spans there and
                assembles the goodput of the whole supervised wall into
                `SupervisedResult.goodput` and ``telemetry/goodput.json``.
                ``watch=`` evaluates SLO rules over those files after
                every failure and at the end (`telemetry.watch`).

FATAL failures (a real Python exception in user code) fail fast with the
classified cause; the rank-tagged `WorkerError` with its log tail stays
chained underneath. The factories travel by reference with the standard
pickle, as everywhere in the port's runtime (a lambda raises TypeError).
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import logging
import os
import signal as _signal
import time
from typing import Any, Callable, Dict, List, Optional

from ray_lightning_tpu_torch.checkpoint.io import latest_checkpoint
from ray_lightning_tpu_torch.resilience.health import (
    HealthMonitor,
    HeartbeatCallback,
    is_heartbeat,
)
from ray_lightning_tpu_torch.resilience.policy import (
    FailureKind,
    RetryPolicy,
    classify_failure,
)
from ray_lightning_tpu_torch.telemetry.spans import (
    PH_ATTEMPT,
    PH_BACKOFF,
    PH_RESHARD,
)

log = logging.getLogger(__name__)


@dataclasses.dataclass
class ResilienceConfig:
    """Everything supervise() needs beyond the job itself.

    ``checkpoint_dir`` is the supervisor's OWN durable state: periodic
    step-cadence saves, preemption emergency saves, the fault markers
    and the trainguard's rollback marker (keep it apart from a user
    ModelCheckpoint's dirpath: the supervisor prunes it).
    """

    checkpoint_dir: str
    policy: RetryPolicy = dataclasses.field(default_factory=RetryPolicy)
    save_every_n_steps: int = 50
    keep_checkpoints: int = 2       # >= 2: corrupt-latest still resumes
    heartbeat_interval_s: float = 5.0
    stall_timeout_s: float = 180.0  # <= 0 disables health monitoring
    startup_grace_s: float = 600.0
    preempt_grace_s: float = 30.0
    resume: str = "auto"            # "auto" | "never": pick up an earlier
    #                                 run's checkpoints on first launch
    faults: Optional[str] = None    # fault-plan spec (faults.parse_faults)
    fault_state_dir: Optional[str] = None  # fire-once markers across
    #                                 restarts (defaults beside ckpts)
    #: step-cadence checkpoints write in the background (checkpoint/io.py
    #: block=False) when the job is one process; a multi-process job and
    #: the preemption drain's emergency save block
    async_save: bool = True
    #: the kernel libraries' build directory shared across restarts
    #: (pipeline/compile_cache.py): a directory gives each plan its own
    #: subdirectory (`plan_cache_dir`), so attempt N loads what attempt 1
    #: built. None or "off" keep the package's own build directory, which
    #: is persistent already (the JAX package derives a directory beside
    #: the checkpoints: its compile cache is off by default, the port's
    #: kernel cache is not)
    compile_cache_dir: Optional[str] = None
    #: trainguard (resilience/guard.py): a GuardConfig (or True) arms the
    #: on-device anomaly skip, escalation and the SDC probe in every
    #: worker. A CORRUPTION escalation ROLLS BACK: resume from the last
    #: blessed checkpoint at or below the marker's last-good step, skip
    #: the poisoned window, record quarantined ranks in
    #: <checkpoint_dir>/.quarantine.json
    guard: Any = None
    #: telemetry (telemetry/): True (or a directory / TelemetryConfig)
    #: arms the span recorder in every worker with the run's shared
    #: ``<checkpoint_dir>/telemetry`` dir, the driver records its own
    #: attempt/backoff spans there, and supervise() assembles the goodput
    #: into SupervisedResult.goodput + ``telemetry/goodput.json``. False
    #: turns it off end to end.
    telemetry: Any = True
    #: elastic supervision (elastic/budget.py): an ElasticBudget makes
    #: the world size a LADDER instead of a pin — when the retry policy
    #: refuses another same-size relaunch, the supervisor reshards the
    #: latest valid checkpoint onto the largest legal survivor world and
    #: resumes smaller; when the budget's capacity oracle reports
    #: capacity back, it grows on the next relaunch. Every change is
    #: recorded in SupervisedResult.reshards with its batch plan. None:
    #: a fixed world size
    elastic: Any = None
    #: SLO watch (telemetry/watch.py): True, a WatchConfig or a tuple of
    #: WatchRule evaluates the rules over the run's persisted evidence
    #: after every classified failure and at the end; breaches land in
    #: <checkpoint_dir>/incidents.jsonl and SupervisedResult.incidents
    watch: Any = None

    def resolved_compile_cache_dir(self) -> Optional[str]:
        if self.compile_cache_dir in (None, "off"):
            return None
        return self.compile_cache_dir

    def resolved_telemetry_dir(self) -> Optional[str]:
        if not self.telemetry:
            return None
        from ray_lightning_tpu_torch.telemetry import TelemetryConfig

        cfg = TelemetryConfig.coerce(self.telemetry)
        return cfg.dir or os.path.join(self.checkpoint_dir, "telemetry")


@dataclasses.dataclass
class SupervisedResult:
    """The job's FitResult plus the supervision ledger."""

    result: Any                     # runtime.fit.FitResult
    restarts: int                   # retryable restarts performed
    preemptions: int                # preemption resumes performed
    failures: List[Dict[str, Any]]  # classified history, launch order
    rollbacks: int = 0              # trainguard corruption rollbacks
    quarantined: List[int] = dataclasses.field(default_factory=list)
    #: goodput classification of the TOTAL supervised wall time
    #: (telemetry/goodput.py buckets; None when telemetry is off), also
    #: written to <checkpoint_dir>/telemetry/goodput.json
    goodput: Optional[Dict[str, Any]] = None
    #: elastic world-size changes, launch order: one entry per
    #: shrink/grow with from/to world, reason and the batch plan
    #: (ElasticBudget.batch_plan), and one per grow the capacity oracle
    #: refused. Also appended to <checkpoint_dir>/reshards.jsonl with a
    #: clock-alignment header (the timeline merges it)
    reshards: List[Dict[str, Any]] = dataclasses.field(
        default_factory=list)
    #: watch-rule breaches fired during supervision (the on-disk record
    #: is <checkpoint_dir>/incidents.jsonl)
    incidents: List[Dict[str, Any]] = dataclasses.field(
        default_factory=list)

    @property
    def final_world(self) -> Optional[int]:
        """World size of the attempt that finished (None = unchanged
        from launch). Only ACTUAL world changes count — the ledger also
        holds ``grow_refused`` entries (capacity-oracle refusals), which
        carry no ``to_world``."""
        for entry in reversed(self.reshards):
            if entry.get("reason") in ("shrink", "grow"):
                return entry["to_world"]
        return None

    @property
    def total_attempts(self) -> int:
        return 1 + self.restarts + self.preemptions + self.rollbacks


class SupervisedFailure(RuntimeError):
    """A supervised run that will not be retried: FATAL classification.
    The original exception (WorkerError with rank and log tail) is
    chained as __cause__."""

    def __init__(self, classified, attempts: int):
        self.classified = classified
        self.attempts = attempts
        super().__init__(
            f"supervised run failed FATALLY after {attempts} attempt(s): "
            f"[{classified.kind}/{classified.cause}"
            + (f" rank {classified.rank}" if classified.rank is not None
               else "")
            + f"] {classified.detail} — restarts will not help; see the "
              "chained worker error for the rank-tagged traceback and "
              "log tail")


class RestartBudgetExceeded(SupervisedFailure):
    def __init__(self, classified, attempts: int, budget: int):
        RuntimeError.__init__(
            self,
            f"supervised run still failing after {attempts} attempt(s) "
            f"(restart budget {budget} exhausted): "
            f"[{classified.kind}/{classified.cause}] {classified.detail}")
        self.classified = classified
        self.attempts = attempts


#: the on-disk reshard ledger beside the checkpoints (the JAX package's
#: file and format)
RESHARD_LEDGER = "reshards.jsonl"
RESHARD_LEDGER_VERSION = "rlt-reshards-v1"


def _append_reshard_ledger(directory: str, entry: Dict[str, Any]) -> None:
    """Append one reshard entry (shrink/grow/grow_refused) to
    ``<directory>/reshards.jsonl``, writing the clock-alignment header
    first when creating the file — the ``t0_wall``/monotonic stamp every
    other ledger carries, so the timeline merger never guesses this
    stream's epoch. Entries carry their own epoch ``at`` stamp too.
    Best-effort: a failed bookkeeping write must never cost the run its
    relaunch."""
    try:
        with open(os.path.join(directory, RESHARD_LEDGER), "a") as f:
            if f.tell() == 0:
                f.write(json.dumps({
                    "version": RESHARD_LEDGER_VERSION,
                    "t0_wall": time.time(),
                    "t0_perf": time.perf_counter(),
                    "pid": os.getpid(),
                }) + "\n")
            f.write(json.dumps(entry, default=str) + "\n")
    except OSError:
        log.exception("could not append to the reshard ledger")


def _wrapped_trainer_factory(trainer_factory: Callable[[], Any],
                             cfg: ResilienceConfig):
    """Runs in EVERY worker process (sent by reference as a partial):
    the user's trainer plus the supervision callbacks."""
    import torch.distributed as dist

    from ray_lightning_tpu_torch.core.callbacks import ModelCheckpoint
    from ray_lightning_tpu_torch.resilience.faults import (
        FAULT_STATE_ENV,
        FaultInjector,
        faults_from_env,
        parse_faults,
    )
    from ray_lightning_tpu_torch.resilience.preempt import (
        PreemptionGuard,
        reset_preemption,
    )

    trainer = trainer_factory()
    reset_preemption()  # a fresh process; stale flags impossible but cheap
    world = dist.get_world_size() if dist.is_available() and \
        dist.is_initialized() else 1
    cache_dir = cfg.resolved_compile_cache_dir()
    if cache_dir and not trainer.compile_cache_dir:
        from ray_lightning_tpu_torch.pipeline.compile_cache import (
            plan_cache_dir,
        )

        # one directory a plan: attempt N loads the libraries attempt 1
        # built there (compile_build_s near 0)
        trainer.compile_cache_dir = plan_cache_dir(
            cache_dir, type(trainer.strategy).__name__, world)
    has_periodic = any(
        isinstance(c, ModelCheckpoint)
        and getattr(c, "dirpath", None) == cfg.checkpoint_dir
        for c in trainer.callbacks)
    # async step-cadence saves only in a one-process job: the JAX
    # package's rule, kept so a multi-process save never overlaps the
    # step's collectives with its background write's
    if not has_periodic:
        trainer.callbacks.append(ModelCheckpoint(
            dirpath=cfg.checkpoint_dir, monitor=None,
            every_n_train_steps=max(1, cfg.save_every_n_steps),
            save_top_k=max(2, cfg.keep_checkpoints),
            async_save=cfg.async_save and world == 1))
    if cfg.heartbeat_interval_s > 0:
        trainer.callbacks.append(HeartbeatCallback(cfg.heartbeat_interval_s))
    trainer.callbacks.append(PreemptionGuard(
        cfg.checkpoint_dir, grace_s=cfg.preempt_grace_s,
        signals=(_signal.SIGTERM,)))
    if cfg.guard:
        from ray_lightning_tpu_torch.resilience.guard import (
            GuardCallback,
            GuardConfig,
            read_rollback_marker,
        )

        trainer.guard = GuardConfig.coerce(cfg.guard)
        if not any(isinstance(c, GuardCallback) for c in trainer.callbacks):
            trainer.callbacks.append(GuardCallback(
                trainer.guard, marker_dir=cfg.checkpoint_dir))
        marker = read_rollback_marker(cfg.checkpoint_dir)
        if marker:
            # after a corruption rollback: skip the poisoned window (a
            # stale marker of an older incident does nothing there)
            trainer.resume_skip_past = marker
    tdir = cfg.resolved_telemetry_dir()
    if tdir and trainer.telemetry is None:
        # every supervised worker records into the run's shared dir, with
        # the config's ring and flush cadence; an explicit
        # Trainer(telemetry=) wins
        from ray_lightning_tpu_torch.telemetry import TelemetryConfig

        trainer.telemetry = dataclasses.replace(
            TelemetryConfig.coerce(cfg.telemetry), dir=tdir)
    faults = parse_faults(cfg.faults) if cfg.faults else faults_from_env()
    if faults:
        state_dir = (cfg.fault_state_dir
                     or os.environ.get(FAULT_STATE_ENV)
                     or os.path.join(cfg.checkpoint_dir, ".fault_state"))
        trainer.callbacks.append(FaultInjector(faults, state_dir))
    return trainer


def supervise(
    kind: str,
    module_factory: Callable[[], Any],
    trainer_factory: Callable[[], Any],
    data_factory: Callable[[], Any],
    num_processes: int,
    *,
    resilience: ResilienceConfig,
    **kw: Any,
) -> SupervisedResult:
    """Run one distributed job under supervision; returns the job's
    result and the restart ledger. Takes every ``run_distributed``
    keyword."""
    from ray_lightning_tpu_torch.runtime.fit import run_distributed

    cfg = resilience
    policy = cfg.policy
    os.makedirs(cfg.checkpoint_dir, exist_ok=True)

    original_ckpt = kw.pop("ckpt_path", None)
    ckpt_path = original_ckpt
    if kind == "fit" and cfg.resume == "auto":
        found = latest_checkpoint(cfg.checkpoint_dir)
        if found is not None:
            log.info("supervise: resuming from earlier run's %s", found)
            ckpt_path = found

    world = launch_world = num_processes

    def _make_monitor(n: int) -> Optional[HealthMonitor]:
        if (kind == "fit" and cfg.stall_timeout_s > 0
                and cfg.heartbeat_interval_s > 0):
            # fit only: the heartbeat starts at on_fit_start, which the
            # eval-family jobs never fire; a monitor there would call a
            # long healthy validate() hung at startup_grace_s
            return HealthMonitor(n, stall_timeout_s=cfg.stall_timeout_s,
                                 startup_grace_s=cfg.startup_grace_s)
        return None

    monitor: Optional[HealthMonitor] = _make_monitor(world)

    user_q = kw.pop("on_queue_item", None)
    user_watchdog = kw.pop("watchdog", None)

    def _watchdog() -> None:
        if monitor is not None:
            monitor.check()
        if user_watchdog is not None:
            user_watchdog()

    def _on_queue_item(rank: int, item: Any) -> None:
        if monitor is not None and monitor.consume(rank, item):
            return
        if is_heartbeat(item):
            return  # stall monitoring off: nobody reads heartbeats
        if user_q is not None:
            user_q(rank, item)
        elif callable(item):
            item()  # the pump's trampoline, as the group would apply it
        else:
            log.debug("dropping non-callable queue item from rank %d", rank)

    # the workers need no ladder (the driver climbs it), and the budget's
    # mesh template may be a lambda, which the standard pickle refuses
    wrapped_tf = functools.partial(_wrapped_trainer_factory, trainer_factory,
                                   dataclasses.replace(cfg, elastic=None))

    # driver-side telemetry: attempt/backoff spans into the run's shared
    # dir (rank -1 = the driver), and the wall and backoff the goodput
    # assembly closes its books against
    telemetry_dir = cfg.resolved_telemetry_dir() if kind == "fit" else None
    driver_rec = None
    if telemetry_dir:
        from ray_lightning_tpu_torch.telemetry.spans import TelemetryRecorder

        driver_rec = TelemetryRecorder(directory=telemetry_dir, rank=-1)
    wall_t0 = time.perf_counter()
    backoff_s = 0.0

    # SLO watch: driver-side rule evaluation over the persisted evidence,
    # after every classified failure and at the end (pure file reads)
    watch_engine = None
    if kind == "fit" and cfg.watch:
        from ray_lightning_tpu_torch.telemetry.watch import (
            WatchConfig,
            WatchEngine,
        )

        watch_engine = WatchEngine(cfg.checkpoint_dir,
                                   WatchConfig.coerce(cfg.watch),
                                   telemetry_dir=telemetry_dir)

    def _watch_poll() -> List[Dict[str, Any]]:
        if watch_engine is None:
            return []
        try:
            watch_engine.poll()
        except Exception:  # noqa: BLE001 — observability must never
            # cost the run its result
            log.exception("watch evaluation failed")
        return list(watch_engine.incidents)

    def _assemble(restarts, preemptions, rollbacks):
        if telemetry_dir is None:
            return None
        from ray_lightning_tpu_torch.telemetry import goodput as _gp

        try:
            driver_rec.close()
            report = _gp.assemble_goodput(
                telemetry_dir, time.perf_counter() - wall_t0,
                backoff_s=backoff_s, restarts=restarts,
                preemptions=preemptions, rollbacks=rollbacks)
            _gp.write_goodput(telemetry_dir, report)
            return report
        except Exception:  # noqa: BLE001 — accounting must never cost
            # the run its result
            log.exception("goodput assembly failed")
            return None

    def _span(phase: str, **meta):
        if driver_rec is None:
            return contextlib.nullcontext()
        return driver_rec.span(phase, meta=meta or None)

    restarts = preemptions = rollbacks = 0
    quarantined: List[int] = []
    failures: List[Dict[str, Any]] = []
    reshards: List[Dict[str, Any]] = []
    while True:
        if monitor is not None:
            monitor.reset()
        attempts = 1 + restarts + preemptions + rollbacks
        try:
            with _span(PH_ATTEMPT, attempt=attempts, world=world):
                result = run_distributed(
                    kind, module_factory, wrapped_tf, data_factory,
                    world, ckpt_path=ckpt_path,
                    on_queue_item=_on_queue_item,
                    watchdog=(_watchdog if (monitor is not None
                                            or user_watchdog is not None)
                              else None),
                    **kw)
            goodput = _assemble(restarts, preemptions, rollbacks)
            return SupervisedResult(result, restarts, preemptions, failures,
                                    rollbacks, quarantined, goodput=goodput,
                                    reshards=reshards,
                                    incidents=_watch_poll())
        except (KeyboardInterrupt, SystemExit):
            raise
        except BaseException as exc:  # noqa: BLE001 — classified below
            fc = classify_failure(exc)
            failures.append({"attempt": attempts, **fc.to_dict(),
                             "at": time.time()})
            log.warning("supervised attempt %d failed: [%s/%s] %s",
                        attempts, fc.kind, fc.cause, fc.detail)
            # mid-run watch cadence: a restart-rate breach fires now
            _watch_poll()
            if fc.kind == FailureKind.FATAL:
                # land the driver's spans and the goodput for the
                # post-mortem before failing for good
                _assemble(restarts, preemptions, rollbacks)
                _watch_poll()
                raise SupervisedFailure(fc, attempts) from exc
            allowed = policy.allows(restarts, preemptions, fc, rollbacks)
            new_world = None
            if (kind == "fit" and cfg.elastic is not None
                    and fc.kind != FailureKind.CORRUPTION):
                # elastic supervision: a refused same-size relaunch
                # becomes a SHRINK onto the largest legal survivor world;
                # an allowed relaunch whose capacity oracle reports
                # another size moves toward it (the grow back). Only
                # ACTUAL world changes spend max_reshards — refusal
                # records in the ledger are free
                spent = sum(1 for e in reshards
                            if e.get("reason") in ("shrink", "grow"))
                new_world, grow_refusal = _elastic_decision(
                    cfg.elastic, world, launch_world, allowed, spent)
                if grow_refusal is not None:
                    # the oracle kept a shrunk run small: its answer
                    # (worlds + source) goes on the record
                    refusal_entry = {**grow_refusal, "attempt": attempts,
                                     "at": time.time()}
                    reshards.append(refusal_entry)
                    _append_reshard_ledger(cfg.checkpoint_dir,
                                           refusal_entry)
                    log.warning(
                        "supervise: grow %d -> %d refused — capacity "
                        "oracle (%s) reports %s schedulable world(s)",
                        world, grow_refusal["resolved_max"],
                        grow_refusal["capacity_source"],
                        grow_refusal["capacity"])
            if new_world is None and not allowed:
                _assemble(restarts, preemptions, rollbacks)
                _watch_poll()
                raise RestartBudgetExceeded(
                    fc, attempts,
                    policy.max_rollbacks
                    if fc.kind == FailureKind.CORRUPTION
                    else policy.max_restarts) from exc
            if fc.kind == FailureKind.PREEMPTION:
                preemptions += 1
            elif fc.kind == FailureKind.CORRUPTION:
                rollbacks += 1
            else:
                restarts += 1
            delay = policy.next_delay(restarts + preemptions + rollbacks)
            if fc.kind == FailureKind.CORRUPTION and kind == "fit":
                ckpt_path = _rollback_target(cfg, rollbacks, quarantined,
                                             original_ckpt)
            elif kind == "fit":
                found = latest_checkpoint(cfg.checkpoint_dir)
                ckpt_path = found if found is not None else original_ckpt
            if new_world is not None:
                from ray_lightning_tpu_torch.elastic.reshard import (
                    ReshardError,
                )

                try:
                    entry = _begin_reshard(cfg, world, new_world,
                                           ckpt_path, attempts, driver_rec)
                except ReshardError as rexc:
                    if allowed:
                        # a refused resize (a legacy resume source) must
                        # not cost an otherwise allowed same-size relaunch
                        log.error("supervise: elastic resize %d -> %d "
                                  "refused (%s); relaunching same-size",
                                  world, new_world, rexc)
                    else:
                        # the fixed-size budget is spent AND the resize
                        # cannot proceed: terminal, with the goodput
                        # post-mortem, the refusal chained underneath
                        _assemble(restarts, preemptions, rollbacks)
                        _watch_poll()
                        raise RestartBudgetExceeded(
                            fc, attempts, policy.max_restarts) from rexc
                else:
                    reshards.append(entry)
                    _append_reshard_ledger(cfg.checkpoint_dir, entry)
                    world = new_world
                    monitor = _make_monitor(world)
            log.warning(
                "supervise: restart %d (retryable %d, preemptions %d, "
                "rollbacks %d) in %.1fs at world %d, resuming from %s",
                restarts + preemptions + rollbacks, restarts, preemptions,
                rollbacks, delay, world, ckpt_path or "scratch")
            with _span(PH_BACKOFF):
                time.sleep(delay)
            backoff_s += delay


def _elastic_target_world(budget, world: int, launch_world: int,
                          allowed: bool,
                          reshards_done: int) -> Optional[int]:
    """Just the target world of `_elastic_decision` (the JAX package's
    helper of the same name)."""
    return _elastic_decision(budget, world, launch_world, allowed,
                             reshards_done)[0]


def _elastic_decision(budget, world: int, launch_world: int,
                      allowed: bool, reshards_done: int):
    """The elastic supervision decision: given the current world,
    whether the retry policy still allows a SAME-SIZE relaunch, and how
    many topology changes were already spent, pick the next world size —
    or None for "no change" (the caller then relaunches same-size or,
    when not allowed, exhausts the budget).

      * not allowed — the fixed-size story is over: shrink to the largest
        legal world STRICTLY below the current one, bounded by the
        reported capacity.
      * allowed and the capacity oracle reports another size: move
        toward it (how a shrunk run grows back).

    Returns ``(target, grow_refusal)``: ``grow_refusal`` is a
    ledger-shaped dict when the run sits BELOW its resolved max and the
    oracle's answer is what kept it there (its worlds and source go on
    the record). Never proposes the current world, never exceeds
    max_reshards, and only proposes rungs `ElasticBudget.legal`
    accepts."""
    if budget is None or reshards_done >= budget.max_reshards:
        return None, None
    answer = budget.capacity_answer(launch_world)
    raw_cap = answer.worlds if answer.worlds is not None \
        else budget.resolved_max(launch_world)
    cap = min(raw_cap, budget.resolved_max(launch_world))
    if not allowed:
        return (budget.largest_legal(min(cap, world - 1), launch_world),
                None)
    if cap != world:
        target = budget.largest_legal(cap, launch_world)
        if target is not None and target != world:
            return target, None
    if world < budget.resolved_max(launch_world) and cap <= world:
        # a shrunk run could grow but the oracle says capacity has not
        # returned: refuse, and say WHO said so
        return None, {
            "reason": "grow_refused",
            "from_world": world,
            "resolved_max": budget.resolved_max(launch_world),
            "capacity": raw_cap,
            "capacity_source": answer.source,
            "capacity_detail": answer.detail,
        }
    return None, None


def _begin_reshard(cfg: ResilienceConfig, world: int, new_world: int,
                   ckpt_path: Optional[str], attempts: int,
                   driver_rec) -> Dict[str, Any]:
    """Validate and record one elastic world change. The resume source
    must carry sharding provenance (a legacy checkpoint restores only
    onto its own layout: resharding it would be a silent lie about what
    was trained); the cross-topology restore itself happens in the
    relaunched workers' trainer (`Trainer._reshard_move`), accounted as
    the `reshard` goodput bucket."""
    from ray_lightning_tpu_torch.checkpoint.io import read_meta
    from ray_lightning_tpu_torch.elastic.budget import _resolve
    from ray_lightning_tpu_torch.elastic.reshard import (
        ReshardError,
        validate_reshard,
    )

    move = None
    if ckpt_path is not None:
        meta = read_meta(ckpt_path)
        if "mesh_spec" not in meta:
            raise ReshardError(
                f"elastic resize {world} -> {new_world} refused: resume "
                f"source {ckpt_path} carries no sharding provenance "
                "(legacy checkpoint — its writing mesh is unknowable, "
                "so the move cannot be validated). Re-save it once on "
                "the current mesh, or start the elastic run from a "
                "provenance-stamped checkpoint")
        # mesh-level validation against the WRITER's provenance, with the
        # budget's real mesh template as the target; the workers
        # validate again against the mesh they build
        target_sizes = _resolve(cfg.elastic.spec_for, new_world).sizes()
        move = validate_reshard(meta, target_sizes)["from_mesh"]
    entry: Dict[str, Any] = {
        "from_world": world,
        "to_world": new_world,
        "reason": "shrink" if new_world < world else "grow",
        "attempt": attempts,
        "at": time.time(),
        "ckpt": ckpt_path,
        "from_mesh": move,
        "batch_plan": cfg.elastic.batch_plan(world, new_world),
    }
    log.warning(
        "supervise: elastic %s %d -> %d (resuming from %s); batch "
        "plan: %s", entry["reason"], world, new_world,
        ckpt_path or "scratch",
        entry["batch_plan"].get("note", "global batch preserved"))
    if driver_rec is not None:
        with driver_rec.span(PH_RESHARD, meta={
                k: entry[k] for k in ("from_world", "to_world",
                                      "reason", "attempt")}):
            pass
    return entry


def _rollback_target(cfg: ResilienceConfig, rollbacks: int,
                     quarantined: List[int],
                     original_ckpt: Optional[str]) -> Optional[str]:
    """The resume source after a trainguard CORRUPTION escalation: the
    newest BLESSED checkpoint at or below the marker's last-good step (a
    blessed but newer one could carry the silent corruption the probe
    only just caught). Also folds the marker's quarantine verdict into
    the ledger and the on-disk ``.quarantine.json``, and stamps the
    rollback count into the marker, which the relaunched workers report
    as the ``guard_rollbacks`` metric."""
    from ray_lightning_tpu_torch.resilience.guard import (
        QUARANTINE_FILE,
        read_rollback_marker,
        write_rollback_marker,
    )

    marker = read_rollback_marker(cfg.checkpoint_dir) or {}
    max_step = marker.get("last_good_step")
    for rank in marker.get("quarantine") or []:
        if rank not in quarantined:
            quarantined.append(rank)
    if quarantined:
        qpath = os.path.join(cfg.checkpoint_dir, QUARANTINE_FILE)
        tmp = qpath + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"excluded": sorted(quarantined),
                       "at": time.time()}, f)
        os.replace(tmp, qpath)
        log.error("supervise: quarantining rank(s) %s (divergent "
                  "parameter fingerprint), recorded in %s",
                  sorted(quarantined), qpath)
    if marker:
        write_rollback_marker(cfg.checkpoint_dir,
                              {**marker, "rollbacks_performed": rollbacks})
    if max_step is not None:
        # leave the poisoned window FOR GOOD: a later retryable restart,
        # or a relaunch with resume="auto", must not pick a newer
        # blessed-but-poisoned checkpoint back up. Safe to move: the
        # worker group is torn down.
        _quarantine_newer_checkpoints(cfg.checkpoint_dir, int(max_step))
    found = latest_checkpoint(
        cfg.checkpoint_dir, good_only=True,
        max_step=int(max_step) if max_step is not None else None)
    if found is None:
        log.warning("supervise: no blessed checkpoint at or below step %s; "
                    "rolling back to %s", max_step,
                    original_ckpt or "scratch")
    return found if found is not None else original_ckpt


def _quarantine_newer_checkpoints(directory: str, max_step: int) -> None:
    """Move checkpoint subdirs whose recorded global_step is past the
    rollback horizon into ``<directory>/quarantined.ckpts/``, one level
    down, where `latest_checkpoint` (which scans immediate subdirs) never
    sees them again; they stay for forensics."""
    dest_root = os.path.join(directory, "quarantined.ckpts")
    try:
        names = os.listdir(directory)
    except OSError:
        return
    for name in names:
        cand = os.path.join(directory, name)
        if not os.path.isdir(os.path.join(cand, "state")):
            continue
        try:
            with open(os.path.join(cand, "meta.json")) as f:
                step = int(json.load(f).get("global_step", -1))
        except (OSError, ValueError, TypeError):
            continue  # unreadable: verify_checkpoint rejects it anyway
        if step <= max_step:
            continue
        os.makedirs(dest_root, exist_ok=True)
        try:
            os.rename(cand, os.path.join(
                dest_root, f"{name}.rb{int(time.time())}"))
            log.warning("supervise: quarantined poisoned checkpoint %s "
                        "(step %d > last good %d)", cand, step, max_step)
        except OSError:
            log.exception("could not quarantine checkpoint %s", cand)


def fit_supervised(
    module_factory: Callable[[], Any],
    trainer_factory: Callable[[], Any],
    data_factory: Callable[[], Any],
    num_processes: int,
    *,
    resilience: ResilienceConfig,
    **kw: Any,
) -> SupervisedResult:
    """Supervised ``fit_distributed``: a transient failure becomes a
    resumed run instead of a lost one. See `supervise`."""
    return supervise("fit", module_factory, trainer_factory, data_factory,
                     num_processes, resilience=resilience, **kw)
