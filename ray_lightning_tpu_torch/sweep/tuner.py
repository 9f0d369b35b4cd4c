"""The sweep runner: concurrent trials, each a driver of its own workers
(twin of `ray_lightning_tpu/sweep/tuner.py`).

The reference's three-level topology: Tune driver -> trial actors ->
training-worker actors, where each trial runs the ENTIRE distributed-fit
stack inside itself (reference examples/ray_ddp_example.py:101-113;
tests/test_tune.py). Here:

  sweep driver (this module)
    -> trial processes       (one runtime worker process per trial,
                              pinned to the cards its block reserved)
      -> training workers    (the trial calls Trainer.fit directly, or
                              fit_distributed to launch its own worker
                              group, which inherits the trial's cards)

Differences by design:
  * resource accounting is by integral blocks of cards (resources.py),
    not the reference's extra_cpu oversubscription trick, and the pool
    says which cards: each trial process gets ``CUDA_VISIBLE_DEVICES``
    set to its block at spawn;
  * the report channel is duplex: the scheduler's verdict returns on the
    same socket and a stopped trial unwinds cooperatively through
    TrialStopped (schedulers.py), instead of Tune killing the actor;
  * checkpoints never transit the channel: trials write them in place
    and report paths;
  * a trainable crosses to its trial process by the standard pickle, by
    reference: a module-level callable, a ``functools.partial`` or an
    instance of a module-level class.
"""
from __future__ import annotations

import json
import logging
import os
import secrets
import subprocess
import sys
import threading
import time
import traceback
from collections import deque
from multiprocessing.connection import (
    Listener,
    answer_challenge,
    deliver_challenge,
)
from typing import Any, Callable, Dict, List, Optional, Tuple

from ray_lightning_tpu_torch.analysis.lockwatch import san_lock
from ray_lightning_tpu_torch.resilience.policy import classify_failure
from ray_lightning_tpu_torch.runtime.group import (
    WorkerError,
    WorkerGroup,
    dumps_by_reference,
)
from ray_lightning_tpu_torch.sweep import session as trial_session
from ray_lightning_tpu_torch.sweep.analysis import ExperimentAnalysis, Trial
from ray_lightning_tpu_torch.sweep.resources import GpuResources, ResourcePool
from ray_lightning_tpu_torch.sweep.schedulers import (
    CONTINUE,
    FIFOScheduler,
    TrialScheduler,
)
from ray_lightning_tpu_torch.sweep.space import expand

log = logging.getLogger(__name__)


class SweepError(RuntimeError):
    pass


class _HostPool:
    """Free list of cluster hosts for trial placement (the reference let
    Ray's scheduler put trial actors on any node): each process trial
    borrows ``resources.hosts`` hosts for its lifetime."""

    def __init__(self, hosts):
        self._free = list(hosts)
        self._lock = san_lock("sweep.tuner.hosts")

    def try_acquire(self, n: int):
        with self._lock:
            if len(self._free) < n:
                return None
            taken, self._free = self._free[:n], self._free[n:]
            return taken

    def release(self, hosts) -> None:
        with self._lock:
            self._free.extend(hosts)


def _probe_device_count(executor: str) -> int:
    """The number of CUDA cards this machine shows.

    Process trials each own their cards, so the driver must not create a
    CUDA context of its own: the count comes from a throwaway
    subprocess. Inline trials run in this process, which counts them
    itself."""
    if executor == "inline":
        import torch

        return torch.cuda.device_count()
    out = subprocess.run(
        [sys.executable, "-c",
         "import torch; print(torch.cuda.device_count())"],
        capture_output=True, text=True, timeout=120)
    lines = out.stdout.strip().splitlines()
    if out.returncode != 0 or not lines:
        raise SweepError(
            f"the device-count probe failed (rc={out.returncode}):\n"
            f"{out.stderr[-2000:]}\npass total_gpus= explicitly")
    return int(lines[-1])


def _visible_devices(cards: List[int]) -> str:
    """``CUDA_VISIBLE_DEVICES`` for a block of pool indices: the pool
    counts the cards this process sees, so under a
    ``CUDA_VISIBLE_DEVICES`` of the driver's own, index i is its i-th
    entry. A driver that sees no card (an empty list, the usual way to
    hide them) gives its trials none either."""
    own = os.environ.get("CUDA_VISIBLE_DEVICES")
    if own is None:
        return ",".join(str(i) for i in cards)
    names = [n.strip() for n in own.split(",") if n.strip()]
    if not names:
        return ""
    if max(cards) >= len(names):
        raise SweepError(f"cards {cards} lie outside this process's "
                         f"CUDA_VISIBLE_DEVICES={own!r}")
    return ",".join(names[i] for i in cards)


def _trial_main(trainable, config, trial_id, trial_dir, address, authkey_hex,
                resume_from=None):
    """Body of one trial, run inside the trial's own worker process
    (the analog of the reference's trial-actor trainable, reference
    examples/ray_ddp_example.py:61-76). The trial's identity, resume
    checkpoint and cards arrive in the process's environment at spawn, so
    nested `fit_distributed` workers inherit them."""
    ctx = trial_session.RemoteTrialContext(
        trial_id, trial_dir, address, bytes.fromhex(authkey_hex),
        last_checkpoint=resume_from,
    )
    trial_session.init_trial_session(ctx)
    try:
        result = trainable(config)
        return (Trial.DONE, result)
    except trial_session.TrialStopped:
        return (Trial.STOPPED, None)
    finally:
        ctx.close()
        trial_session.reset_trial_session()


class _ReportServer:
    """Driver-side end of the duplex report channel: accepts one socket
    per trial on loopback, answers every report with the scheduler's
    verdict."""

    def __init__(self,
                 handle_report: Callable[[str, Dict, Optional[str]], str]):
        self._handle = handle_report
        self._authkey = secrets.token_bytes(32)
        self._listener = Listener(("127.0.0.1", 0), authkey=self._authkey)
        self._closed = False
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True
        )
        self._accept_thread.start()

    @property
    def address(self) -> tuple:
        return self._listener.address

    @property
    def authkey_hex(self) -> str:
        return self._authkey.hex()

    def _accept_loop(self) -> None:
        # Accept apart from authentication: a peer that stalls or resets
        # mid-challenge must neither wedge nor kill the acceptor, since
        # later trials still need to hand-shake. The socket-level accept
        # (SocketListener.accept returns the raw Connection, no
        # challenge) only blocks waiting for NEW connections; the
        # challenge runs on the per-connection thread, so a bad peer
        # wedges only its own thread.
        while not self._closed:
            try:
                conn = self._listener._listener.accept()
            except Exception:  # noqa: BLE001 — keep serving
                if self._closed:
                    return  # listener closed by close()
                log.warning("report server: accept failed\n%s",
                            traceback.format_exc(limit=2))
                # a persistent failure (e.g. EMFILE) trickles instead of
                # busy-looping
                time.sleep(0.2)
                continue
            threading.Thread(
                target=self._auth_and_serve, args=(conn,), daemon=True
            ).start()

    def _auth_and_serve(self, conn) -> None:
        try:
            deliver_challenge(conn, self._authkey)
            answer_challenge(conn, self._authkey)
        except Exception:  # noqa: BLE001 — scanner / wrong key / reset
            log.warning("report server: rejected connection\n%s",
                        traceback.format_exc(limit=2))
            try:
                conn.close()
            except OSError:
                pass
            return
        self._serve(conn)

    def _serve(self, conn) -> None:
        try:
            while True:
                msg = conn.recv()
                if msg[0] == "report":
                    _, trial_id, metrics, ckpt = msg
                    # a handler error must still produce a reply: the
                    # trial is blocked on recv() and would hang otherwise
                    try:
                        verdict = self._handle(trial_id, metrics, ckpt)
                    except Exception:  # noqa: BLE001
                        log.error("report handler failed for %s:\n%s",
                                  trial_id, traceback.format_exc())
                        verdict = CONTINUE
                    conn.send(verdict)
                elif msg[0] == "bye":
                    return
                elif msg[0] != "hello":
                    log.warning("report server: unknown message %r", msg[0])
        except (EOFError, OSError):
            return
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def close(self) -> None:
        self._closed = True
        self._listener.close()


class TrialRunner:
    def __init__(
        self,
        trainable: Callable[[Dict[str, Any]], Any],
        configs: List[Dict[str, Any]],
        *,
        metric: Optional[str],
        mode: str,
        scheduler: TrialScheduler,
        resources_per_trial: GpuResources,
        pool: ResourcePool,
        max_concurrent: Optional[int],
        storage_dir: str,
        executor: str,
        trial_timeout: Optional[float],
        env: Optional[Dict[str, str]],
        hosts: Optional[List[str]] = None,
        transport=None,
        retry_policy=None,
    ):
        self.trainable = trainable
        self.metric = metric
        self.mode = mode
        self.scheduler = scheduler
        self.resources = resources_per_trial
        self.pool = pool
        self.storage_dir = storage_dir
        self.executor = executor
        self.trial_timeout = trial_timeout
        self.env = env
        self.transport = transport
        #: trial-level retry (resilience/policy.py RetryPolicy): an
        #: infra-classified trial failure re-enqueues the trial, resuming
        #: from its last registered checkpoint
        self.retry_policy = retry_policy
        self.host_pool: Optional[_HostPool] = None
        if hosts:
            if transport is None or not transport.is_remote:
                # here, not in the trial threads: a per-thread error would
                # strand `running` and deadlock the sweep
                raise SweepError(
                    "hosts= requires a remote transport (e.g. SSHTransport)")
            if resources_per_trial.hosts > len(hosts):
                raise SweepError(
                    f"one trial needs {resources_per_trial.hosts} hosts but "
                    f"only {len(hosts)} were given")
            self.host_pool = _HostPool(hosts)
        cap = pool.max_concurrent(resources_per_trial)
        if cap < 1:
            raise SweepError(
                f"one trial needs {resources_per_trial.gpus} GPUs but the "
                f"pool has {pool.total_gpus}"
            )
        self.max_concurrent = min(max_concurrent or cap, cap)
        self._lock = san_lock("sweep.tuner.runner")
        self._cond = threading.Condition(self._lock)
        self.trials: List[Trial] = []
        for i, cfg in enumerate(configs):
            tid = f"trial_{i:05d}"
            tdir = os.path.join(storage_dir, tid)
            os.makedirs(tdir, exist_ok=True)
            trial = Trial(tid, cfg, tdir, resources_per_trial)
            # a rerun over an existing storage_dir restores each trial's
            # recorded progress; interrupted or errored trials restart
            # from their last registered checkpoint
            self._load_trial_state(trial)
            self.trials.append(trial)
        self._by_id = {t.trial_id: t for t in self.trials}

    # --------------------------------------------------------- persistence
    def _state_path(self, trial: Trial) -> str:
        return os.path.join(trial.trial_dir, "trial_state.json")

    def _snapshot_trial_state(self, trial: Trial) -> Tuple[str, Dict]:
        """Copy the mutable trial record (cheap, in memory); safe under
        self._lock. The file write happens outside it."""
        state = {
            "status": trial.status,
            "history": list(trial.history),
            "checkpoints": list(trial.checkpoints),
            "error": trial.error,
        }
        try:
            json.dumps(trial.result)
            state["result"] = trial.result
        except (TypeError, ValueError):
            pass  # non-JSON trainable return: status/history still persist
        return self._state_path(trial), state

    def _write_trial_state(self, trial_id: str, path: str,
                           state: Dict) -> None:
        tmp = path + ".tmp"
        try:
            with open(tmp, "w") as f:
                json.dump(state, f)
            os.replace(tmp, path)
        except (OSError, TypeError, ValueError) as exc:
            log.warning("could not persist %s state: %s", trial_id, exc)

    def _save_trial_state(self, trial: Trial) -> None:
        """Durable per-trial record (atomic rename), so a later sweep.run
        over the same storage_dir skips DONE trials and resumes the rest.
        Never called holding self._lock: every report thread and the
        scheduling loop contend on it, and disk latency must not
        serialise them."""
        path, state = self._snapshot_trial_state(trial)
        self._write_trial_state(trial.trial_id, path, state)

    def _load_trial_state(self, trial: Trial) -> None:
        path = self._state_path(trial)
        if not os.path.exists(path):
            return
        try:
            with open(path) as f:
                state = json.load(f)
        except (OSError, ValueError) as exc:
            log.warning("ignoring unreadable %s state: %s",
                        trial.trial_id, exc)
            return
        trial.history = list(state.get("history", []))
        if trial.history:
            trial.last_result = trial.history[-1]
        trial.checkpoints = list(state.get("checkpoints", []))
        trial.result = state.get("result")
        status = state.get("status")
        if status in (Trial.DONE, Trial.STOPPED):
            # terminal: STOPPED was the scheduler's deliberate cut, and
            # resurrecting it would let a culled config back in
            trial.status = status
        # anything else (error, a stale "running" from a crashed driver)
        # stays PENDING and is scheduled again, resuming from
        # trial.last_checkpoint if one was registered

    # ------------------------------------------------------------- reports
    def _handle_report(self, trial_id: str, metrics: Dict[str, Any],
                       checkpoint: Optional[str]) -> str:
        with self._lock:
            trial = self._by_id.get(trial_id)
            if trial is None:
                log.warning("report from unknown trial %s", trial_id)
                return CONTINUE
            iteration = trial.iterations + 1
            record = dict(metrics)
            # Ray Tune parity: every report carries training_iteration
            # (asserted by the reference's tests, test_tune.py:44-45)
            record.setdefault("training_iteration", iteration)
            trial.history.append(record)
            trial.last_result = record
            if checkpoint:
                trial.checkpoints.append(checkpoint)
            key = self.scheduler.metric or self.metric
            value = record.get(key) if key else None
            try:
                value = float(value) if value is not None else None
            except (TypeError, ValueError):
                value = None  # non-numeric metric: scheduler sees no signal
            verdict = self.scheduler.on_result(trial_id, iteration, value)
            if verdict != CONTINUE:
                log.info("scheduler stopping %s at iteration %d", trial_id,
                         iteration)
            path, state = self._snapshot_trial_state(trial)
        self._write_trial_state(trial_id, path, state)
        return verdict

    # --------------------------------------------------------------- retry
    def _retry_delay(self, trial: Trial,
                     exc: BaseException) -> Optional[float]:
        """Backoff delay when this failure should be retried, else None.
        FATAL (a deterministic user exception, a CUDA error) is never
        retried: replaying it would burn the budget a flaky host needs."""
        if self.retry_policy is None:
            return None
        fc = classify_failure(exc)
        if (not fc.restartable
                or trial.restarts >= self.retry_policy.max_restarts):
            return None
        trial.restarts += 1
        delay = self.retry_policy.next_delay(trial.restarts)
        log.warning(
            "trial %s: retry %d/%d in %.1fs after [%s/%s] %s "
            "(resuming from %s)", trial.trial_id, trial.restarts,
            self.retry_policy.max_restarts, delay, fc.kind, fc.cause,
            fc.detail, trial.last_checkpoint or "scratch")
        return delay

    # -------------------------------------------------------------- inline
    def _run_inline(self) -> None:
        for trial in self.trials:
            if trial.status in (Trial.DONE, Trial.STOPPED):
                log.info("skipping %s: already %s", trial.trial_id,
                         trial.status)
                self.scheduler.on_trial_complete(trial.trial_id)
                continue
            self._run_inline_trial(trial)
            self.scheduler.on_trial_complete(trial.trial_id)
            self._save_trial_state(trial)

    def _run_inline_trial(self, trial: Trial) -> None:
        while True:
            trial.status = Trial.RUNNING
            # rebuilt per attempt: a retry resumes from the LAST
            # registered checkpoint, not the one the first attempt saw
            ctx = trial_session.LocalTrialContext(
                trial.trial_id, trial.trial_dir, self._handle_report,
                last_checkpoint=trial.last_checkpoint,
            )
            trial_session.init_trial_session(ctx)
            saved_env = {k: os.environ.get(k)
                         for k in ("RLT_TRIAL_ID", "RLT_TRIAL_DIR",
                                   "RLT_TRIAL_RESUME")}
            os.environ["RLT_TRIAL_ID"] = trial.trial_id
            os.environ["RLT_TRIAL_DIR"] = trial.trial_dir
            if trial.last_checkpoint:
                os.environ["RLT_TRIAL_RESUME"] = trial.last_checkpoint
            retry_in: Optional[float] = None
            try:
                trial.result = self.trainable(trial.config)
                trial.status = Trial.DONE
            except trial_session.TrialStopped:
                trial.status = Trial.STOPPED
            except Exception as exc:  # noqa: BLE001 — recorded per trial
                retry_in = self._retry_delay(trial, exc)
                if retry_in is None:
                    trial.status = Trial.ERROR
                    trial.error = traceback.format_exc()
                    log.error("trial %s failed: %s", trial.trial_id, exc)
            finally:
                trial_session.reset_trial_session()
                for k, v in saved_env.items():
                    if v is None:
                        os.environ.pop(k, None)
                    else:
                        os.environ[k] = v
            if retry_in is None:
                return
            time.sleep(retry_in)

    # ------------------------------------------------------------- process
    def _run_process(self) -> None:
        server = _ReportServer(self._handle_report)
        terminal = (Trial.DONE, Trial.STOPPED)
        for t in self.trials:
            if t.status in terminal:
                log.info("skipping %s: already %s", t.trial_id, t.status)
                self.scheduler.on_trial_complete(t.trial_id)
        pending = deque(t for t in self.trials if t.status not in terminal)
        running: set = set()
        try:
            with self._cond:
                while pending or running:
                    while pending and len(running) < self.max_concurrent:
                        cards = self.pool.try_acquire(self.resources)
                        if cards is None:
                            break
                        trial_hosts = None
                        if self.host_pool is not None:
                            trial_hosts = self.host_pool.try_acquire(
                                self.resources.hosts)
                            if trial_hosts is None:
                                self.pool.release(cards)
                                break
                        trial = pending.popleft()
                        running.add(trial.trial_id)
                        trial.status = Trial.RUNNING
                        threading.Thread(
                            target=self._trial_thread,
                            args=(trial, server, running, cards, pending,
                                  trial_hosts),
                            daemon=True,
                        ).start()
                    self._cond.wait(timeout=1.0)
        finally:
            server.close()

    def _trial_thread(self, trial: Trial, server: _ReportServer,
                      running: set, cards: List[int],
                      pending: deque,
                      trial_hosts: Optional[List[str]] = None) -> None:
        group = None
        retry_in: Optional[float] = None
        try:
            # set at spawn, never in this process: CUDA reads
            # CUDA_VISIBLE_DEVICES once, at a process's first CUDA call
            env = {**(self.env or {}),
                   "RLT_TRIAL_ID": trial.trial_id,
                   "RLT_TRIAL_DIR": trial.trial_dir,
                   "CUDA_VISIBLE_DEVICES": _visible_devices(cards)}
            if trial.last_checkpoint:
                env["RLT_TRIAL_RESUME"] = trial.last_checkpoint
            if trial_hosts:
                # the whole borrowed set, so the trial's nested
                # fit_distributed can span it (sweep.get_trial_hosts())
                env["RLT_TRIAL_HOSTS"] = ",".join(trial_hosts)
            # the trial's own process runs on its first borrowed host
            group = WorkerGroup(
                num_workers=1, env=env,
                log_dir=os.path.join(trial.trial_dir, "logs"),
                hosts=trial_hosts[:1] if trial_hosts else None,
                transport=self.transport if trial_hosts else None)
            group.start()
            [out] = group.run(
                _trial_main,
                per_rank_args=[(self.trainable, trial.config, trial.trial_id,
                                trial.trial_dir, server.address,
                                server.authkey_hex, trial.last_checkpoint)],
                timeout=self.trial_timeout,
            )
            trial.status, trial.result = out
        except WorkerError as exc:
            retry_in = self._retry_delay(trial, exc)
            if retry_in is None:
                trial.status = Trial.ERROR
                trial.error = exc.traceback_str
                log.error("trial %s failed:\n%s", trial.trial_id,
                          exc.traceback_str)
        except Exception as exc:  # noqa: BLE001 — recorded per trial
            retry_in = self._retry_delay(trial, exc)
            if retry_in is None:
                trial.status = Trial.ERROR
                trial.error = traceback.format_exc()
                log.error("trial %s infra failure:\n%s", trial.trial_id,
                          trial.error)
        finally:
            if group is not None:
                # the trial process exits before its cards are free again
                group.shutdown()
            self.pool.release(cards)
            if trial_hosts and self.host_pool is not None:
                self.host_pool.release(trial_hosts)
            if retry_in is None:
                # terminal outcome only: a retried trial is not complete
                self.scheduler.on_trial_complete(trial.trial_id)
            self._save_trial_state(trial)
            if retry_in is not None:
                # the cards are released; the backoff costs only this
                # thread and one concurrency slot
                time.sleep(retry_in)
            with self._cond:
                if retry_in is not None:
                    trial.status = Trial.PENDING
                    pending.append(trial)
                running.discard(trial.trial_id)
                self._cond.notify_all()

    # ----------------------------------------------------------------- run
    def run(self) -> List[Trial]:
        if self.executor == "inline":
            self._run_inline()
        elif self.executor == "process":
            self._run_process()
        else:
            raise ValueError(f"unknown executor {self.executor!r}")
        return self.trials


def run(
    trainable: Callable[[Dict[str, Any]], Any],
    config: Optional[Dict[str, Any]] = None,
    *,
    num_samples: int = 1,
    metric: Optional[str] = None,
    mode: str = "min",
    scheduler: Optional[TrialScheduler] = None,
    resources_per_trial: Optional[GpuResources] = None,
    total_gpus: Optional[int] = None,
    total_cpus: Optional[int] = None,
    max_concurrent: Optional[int] = None,
    storage_dir: Optional[str] = None,
    name: str = "sweep",
    executor: str = "process",
    trial_timeout: Optional[float] = None,
    env: Optional[Dict[str, str]] = None,
    hosts: Optional[List[str]] = None,
    transport=None,
    seed: int = 0,
    raise_on_failed_trial: bool = True,
    retry_policy=None,
) -> ExperimentAnalysis:
    """``tune.run`` analog (reference examples/ray_ddp_example.py:101-113).

    ``trainable(config)`` runs once per trial; inside it, ``sweep.report``
    (directly or through the TuneReportCallback family) streams metrics
    back. ``executor="process"`` runs each trial in its own process,
    pinned to the cards its block reserved (``CUDA_VISIBLE_DEVICES``); the
    trial may itself launch a worker group (`fit_distributed`), whose
    workers inherit those cards. The trainable crosses to that process by
    the standard pickle, by reference, so it is a module-level callable,
    a ``functools.partial`` or an instance of a module-level class; any
    other raises `TypeError` before a trial starts. ``"inline"`` runs
    trials one after another in this process, on this process's devices:
    it cannot pin cards.

    ``total_gpus`` is the pool the per-trial blocks are carved from. It
    defaults to the number of cards this machine shows; with none (a
    CPU-only machine) pass it explicitly, and have the trainables pass
    ``device="cpu"`` to their entry points.

    ``retry_policy`` (resilience.RetryPolicy) retries trials whose
    failure classifies as infrastructure (a killed trial process, a
    timeout, a dead collective peer) up to ``max_restarts`` times with
    capped exponential backoff, resuming from the trial's last registered
    checkpoint; FATAL failures (user exceptions, CUDA errors) fail the
    trial at once.

    ``hosts`` with a remote ``transport`` (`runtime.SSHTransport`,
    `runtime.LoopbackTransport`) places process trials on cluster hosts:
    each borrows ``resources_per_trial.hosts`` of them for its lifetime,
    runs its own process on the first and finds the whole set in
    `get_trial_hosts` (``RLT_TRIAL_HOSTS``) for a nested
    ``fit_distributed(hosts=...)``. Its card indices travel in its
    explicit environment (``CUDA_VISIBLE_DEVICES``), which a remote
    transport's scrubbed environment would otherwise drop.
    """
    resources_per_trial = resources_per_trial or GpuResources()
    if mode not in ("min", "max"):
        raise ValueError("mode must be 'min' or 'max'")
    configs = expand(config or {}, num_samples=num_samples, seed=seed)
    if not configs:
        raise ValueError("empty search space")
    if executor == "process":
        dumps_by_reference(trainable, f"trainable {trainable!r:.80}")
    scheduler = scheduler or FIFOScheduler()
    if scheduler.metric is None:
        scheduler.metric = metric
        scheduler.mode = mode
    if total_gpus is None:
        total_gpus = _probe_device_count(executor)
        if total_gpus < 1:
            raise SweepError(
                "no CUDA card found to size the sweep's pool: pass "
                "total_gpus= (and device='cpu' to the trainables' entry "
                "points) to run trials on the CPU")
    if total_cpus is None and resources_per_trial.cpus > 0:
        # trials reserve CPUs: account against this machine's cores
        total_cpus = max(os.cpu_count() or 1, resources_per_trial.cpus)
    pool = ResourcePool(total_gpus, total_cpus)
    storage_dir = storage_dir or os.path.join(os.getcwd(), "rlt_sweeps", name)
    os.makedirs(storage_dir, exist_ok=True)

    runner = TrialRunner(
        trainable, configs,
        metric=metric, mode=mode, scheduler=scheduler,
        resources_per_trial=resources_per_trial, pool=pool,
        max_concurrent=max_concurrent, storage_dir=storage_dir,
        executor=executor, trial_timeout=trial_timeout, env=env,
        hosts=hosts, transport=transport, retry_policy=retry_policy,
    )
    log.info("sweep %s: %d trials, <=%d concurrent, %d GPUs/trial of %d",
             name, len(runner.trials), runner.max_concurrent,
             resources_per_trial.gpus, total_gpus)
    trials = runner.run()
    analysis = ExperimentAnalysis(trials, metric, mode)
    failed = analysis.errors()
    if failed and raise_on_failed_trial:
        detail = "\n".join(f"--- {k} ---\n{v}" for k, v in failed.items())
        raise SweepError(f"{len(failed)} trial(s) failed:\n{detail}")
    return analysis
