"""Driver-side runtime: worker processes, futures, result pump (twin of
`ray_lightning_tpu/runtime/group.py`).

The rebuild of the reference's use of Ray core — actor creation
(reference ray_ddp.py:106-119), env-var injection (:158-164), fan-out of
``train_remote`` (:178-182), the ``process_results`` pump (reference
util.py:96-109) and teardown (:201-213) — with plain subprocesses and
``multiprocessing.connection``, waited on with ``connection.wait``.

Pieces:
  * TpuExecutor  — handle to ONE worker process (RayExecutor analog):
    execute_async, set_env_vars, get_node_ip, kill.
  * WorkerGroup  — N executors + the pump: run() fans a job out to every
    rank, pumps side-channel items (executing callables driver-side, the
    trampoline of reference util.py:88-93), gathers per-rank results,
    and fails fast on the first worker error or death.

Jobs cross by the standard `pickle` (the JAX runtime ships closures by
value with cloudpickle): a function travels by reference, so jobs,
factories and side-channel callables are module-level functions,
`functools.partial` objects or instances of module-level classes. A job
that cannot be pickled raises `TypeError` naming that rule.
"""
from __future__ import annotations

import hashlib
import logging
import os
import pickle
import queue
import secrets
import signal
import subprocess
import threading
import time
from multiprocessing import connection as mpc
from multiprocessing.connection import Connection, Listener
from multiprocessing.connection import wait as conn_wait
from typing import Any, Callable, Dict, List, Optional, Sequence

from ray_lightning_tpu_torch.runtime.transport import (
    _CROSS_HOST,
    LocalTransport,
    Transport,
)

log = logging.getLogger(__name__)

#: how long a worker whose channel hit EOF gets to be reaped before it is
#: reported as still running (a SIGKILL'd 8B worker on an H100 took more
#: than 2 s)
EOF_REAP_S = 30.0


def dumps_by_reference(obj: Any, what: str) -> bytes:
    """``pickle.dumps(obj)``, or a `TypeError` that names the rule."""
    try:
        return pickle.dumps(obj)
    except (pickle.PicklingError, AttributeError, TypeError) as exc:
        raise TypeError(
            f"{what} cannot be pickled ({exc}): the port ships jobs with "
            "the standard pickle, which sends a function by reference, so "
            "jobs, factories and side-channel items must be module-level "
            "callables, functools.partial objects or instances of "
            "module-level classes (no lambdas or nested functions)"
        ) from exc


class _HelloAcceptor:
    """Accept worker connections without letting any single peer wedge
    startup: one daemon thread does raw socket accepts, each
    authentication runs on its own daemon thread, and authenticated
    connections land on a queue the caller polls in short slices, so it
    can also notice dead worker processes between slices."""

    def __init__(self, listener: Listener, authkey: bytes):
        self._listener = listener
        self._authkey = authkey
        self._open = True
        # serializes enqueue-vs-close so a connection that authenticates
        # concurrently with close() is closed, never stranded
        self._lock = threading.Lock()
        self._conns: "queue.Queue" = queue.Queue()
        threading.Thread(target=self._accept_loop, daemon=True).start()

    def _accept_loop(self) -> None:
        while self._open:
            try:
                # socket-level accept: the raw Connection, no challenge
                raw = self._listener._listener.accept()
            except Exception:  # noqa: BLE001 — closed or transient
                if not self._open:
                    return
                log.warning("listener accept failed", exc_info=True)
                time.sleep(0.05)
                continue
            threading.Thread(target=self._challenge, args=(raw,),
                             daemon=True).start()

    def _challenge(self, raw) -> None:
        try:
            # the exact handshake Listener.accept() performs
            mpc.deliver_challenge(raw, self._authkey)
            mpc.answer_challenge(raw, self._authkey)
        except Exception as exc:  # noqa: BLE001 — a bad or hostile peer
            log.warning("worker handshake failed: %s", exc)
            try:
                raw.close()
            except OSError:
                pass
            return
        self._enqueue(raw)

    def _enqueue(self, conn) -> None:
        with self._lock:
            if self._open:
                self._conns.put(conn)
                return
        try:
            conn.close()
        except OSError:
            pass

    def get(self, timeout: float):
        """Next authenticated connection, or None after ``timeout``."""
        try:
            return self._conns.get(timeout=max(0.0, timeout))
        except queue.Empty:
            return None

    def close(self) -> None:
        with self._lock:
            self._open = False
        while True:
            conn = self.get(0.0)
            if conn is None:
                return
            try:
                conn.close()
            except OSError:
                pass


class WorkerError(RuntimeError):
    """A worker failed. ``cause`` classifies how:

      "exception" — the worker returned a Python traceback
      "signal"    — the process was killed by ``signal_name``
      "exit"      — the process exited with ``exit_code`` without
                    returning a result

    The worker's log tail is attached when available.
    """

    def __init__(self, rank: int, traceback_str: str, log_tail: str = "",
                 *, exit_code: Optional[int] = None,
                 signal_name: Optional[str] = None,
                 cause: str = "exception"):
        self.rank = rank
        self.traceback_str = traceback_str
        self.log_tail = log_tail
        self.exit_code = exit_code
        self.signal_name = signal_name
        self.cause = cause
        msg = f"worker rank {rank} failed:\n{traceback_str}"
        if log_tail:
            msg += f"\n--- worker log tail ---\n{log_tail}"
        super().__init__(msg)

    @classmethod
    def from_death(cls, rank: int, returncode: Optional[int],
                   log_tail: str, context: str) -> "WorkerError":
        """Classify a vanished process by its returncode: negative means
        killed by a signal (named), non-negative a plain exit."""
        if returncode is not None and returncode < 0:
            try:
                signame = signal.Signals(-returncode).name
            except ValueError:
                signame = f"signal {-returncode}"
            return cls(rank, f"worker process killed by {signame} "
                             f"(rc={returncode}) {context}",
                       log_tail, exit_code=returncode, signal_name=signame,
                       cause="signal")
        return cls(rank, f"worker process exited rc={returncode} {context}",
                   log_tail, exit_code=returncode, cause="exit")


def _tail(path: str, n: int) -> str:
    try:
        with open(path, errors="replace") as f:
            return "".join(f.readlines()[-n:])
    except OSError:
        return ""


class TpuExecutor:
    """One worker process (reference RayExecutor, ray_ddp.py:17-39)."""

    def __init__(self, rank: int, world: int, proc: subprocess.Popen,
                 conn: Connection, info: Dict[str, Any], log_path: str):
        self.rank = rank
        self.world = world
        self.proc = proc
        self.conn = conn
        self.info = info
        self.log_path = log_path
        self._next_tid = 0
        # a mirror of the worker's FIFO blob cache (the channel is
        # reliable FIFO, so replaying the same insert/evict sequence
        # keeps both sides in sync)
        self._sent_digests: Dict[str, None] = {}

    def _note_digest(self, digest: str) -> bool:
        """Record that `digest` is (about to be) cached worker-side;
        True when the blob must be sent."""
        from ray_lightning_tpu_torch.runtime.worker import _BLOB_CACHE_CAP

        if digest in self._sent_digests:
            return False
        while len(self._sent_digests) >= _BLOB_CACHE_CAP:
            del self._sent_digests[next(iter(self._sent_digests))]
        self._sent_digests[digest] = None
        return True

    def set_env_vars(self, env: Dict[str, str]) -> None:
        """reference ray_ddp.py:27-31 (no ack needed: FIFO ordering)."""
        self.conn.send(("env", dict(env)))

    def get_node_ip(self) -> str:
        """reference ray_ddp.py:33-35."""
        return self.info.get("ip", "127.0.0.1")

    def execute_async(self, fn: Callable, *args, **kwargs) -> int:
        """Ship a job; returns a task id to await."""
        tid = self._next_tid
        self._next_tid += 1
        blob = dumps_by_reference((fn, args, kwargs), f"job {fn!r:.80}")
        self.conn.send(("exec", tid, blob))
        return tid

    def execute_shared(self, digest: str, blob: Optional[bytes],
                       extra_blob: bytes) -> int:
        """Ship-once execution: the (fn, shared_args, kwargs) blob is sent
        only the first time this worker sees its digest."""
        tid = self._next_tid
        self._next_tid += 1
        self.conn.send(("exec2", tid, digest, blob, extra_blob))
        return tid

    def alive(self) -> bool:
        return self.proc.poll() is None

    def log_tail(self, n: int = 40) -> str:
        return _tail(self.log_path, n)

    def kill(self) -> None:
        if self.alive():
            self.proc.kill()
        try:
            self.conn.close()
        except OSError:
            pass


class WorkerGroup:
    """N worker processes + the result/queue pump.

        group = WorkerGroup(num_workers=4, env={...}, init_hook=fn)
        group.start()                      # spawn + hello + init_hook
        results = group.run(train_fn)      # fan-out, pump, gather
        group.shutdown()                   # graceful, then kill
    """

    def __init__(self, num_workers: Optional[int] = None,
                 env: Optional[Dict[str, str]] = None,
                 init_hook: Optional[Callable[[], None]] = None,
                 log_dir: Optional[str] = None,
                 start_timeout: float = 120.0,
                 hosts: Optional[Sequence[str]] = None,
                 transport: Optional[Transport] = None):
        if hosts:
            raise NotImplementedError(
                f"WorkerGroup(hosts=...) is not ported yet ({_CROSS_HOST})")
        num_workers = 1 if num_workers is None else num_workers
        if num_workers < 1:
            raise ValueError("num_workers must be >= 1")
        self.num_workers = num_workers
        self.env = dict(env or {})
        self.init_hook = init_hook
        self.log_dir = log_dir or os.path.join(os.getcwd(), "rlt_logs",
                                               "workers")
        self.start_timeout = start_timeout
        self.transport = transport or LocalTransport()
        self.executors: List[TpuExecutor] = []
        self._listener: Optional[Listener] = None
        self._queue_items: List[Any] = []

    # ------------------------------------------------------------- launch
    def start(self) -> "WorkerGroup":
        os.makedirs(self.log_dir, exist_ok=True)
        authkey = secrets.token_bytes(32)
        host = "127.0.0.1"
        self._listener = Listener((host, 0), authkey=authkey)
        port = self._listener.address[1]
        procs: Dict[int, subprocess.Popen] = {}
        logs: Dict[int, str] = {}
        try:
            for rank in range(self.num_workers):
                logs[rank] = os.path.join(self.log_dir,
                                          f"worker-{rank}.log")
                procs[rank] = self.transport.spawn(
                    host=None, connect=(host, port, rank, self.num_workers),
                    env=self.env, authkey_hex=authkey.hex(),
                    log_path=logs[rank])
        except Exception:
            self._abort_start(procs, logs)
            raise
        # hellos arrive in arbitrary order; each carries its rank
        by_rank: Dict[int, TpuExecutor] = {}
        deadline = time.monotonic() + self.start_timeout
        acceptor = _HelloAcceptor(self._listener, authkey)
        try:
            for _ in range(self.num_workers):
                conn = None
                while conn is None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        self._abort_start(procs, logs)
                        raise TimeoutError(
                            "workers did not all connect within "
                            f"{self.start_timeout}s")
                    # short slices, so a worker that died before its
                    # hello fails the start in about a second
                    conn = acceptor.get(min(remaining, 1.0))
                    if conn is None:
                        for rank, p in procs.items():
                            if rank not in by_rank and p.poll() is not None:
                                tail = _tail(logs[rank], 20)
                                self._abort_start(procs, logs)
                                raise WorkerError.from_death(
                                    rank, p.returncode, tail,
                                    "before connecting")
                # bound the hello read too: a connection that never
                # speaks must not wedge start()
                if not conn.poll(max(0.0, deadline - time.monotonic())):
                    self._abort_start(procs, logs)
                    raise TimeoutError(
                        "worker connected but sent no hello within "
                        f"{self.start_timeout}s")
                try:
                    msg = conn.recv()
                except EOFError:
                    self._abort_start(procs, logs)
                    raise WorkerError(
                        -1, "a worker died between authenticating and "
                            "sending its hello") from None
                if not (isinstance(msg, tuple) and len(msg) == 3
                        and msg[0] == "hello"):
                    self._abort_start(procs, logs)
                    raise WorkerError(
                        -1, f"unexpected first message from a worker "
                            f"(want hello): {msg!r:.200}")
                _, rank, info = msg
                if not isinstance(rank, int) or rank not in procs:
                    self._abort_start(procs, logs)
                    raise WorkerError(
                        rank if isinstance(rank, int) else -1,
                        f"hello with invalid rank {rank!r} (expected "
                        f"0..{self.num_workers - 1})")
                if rank in by_rank:
                    self._abort_start(procs, logs)
                    raise WorkerError(rank,
                                      f"duplicate hello for rank {rank}")
                by_rank[rank] = TpuExecutor(rank, self.num_workers,
                                            procs[rank], conn, info,
                                            logs[rank])
        finally:
            acceptor.close()
        self.executors = [by_rank[r] for r in range(self.num_workers)]
        if self.init_hook is not None:
            # reference ray_ddp.py:118-119: init_hook on every worker
            # before training starts
            self.run(self.init_hook)
        return self

    def _abort_start(self, procs, logs) -> None:
        tails = []
        for rank, p in procs.items():
            if p.poll() is not None:
                tails.append(f"rank {rank} exited rc={p.returncode}:\n"
                             + _tail(logs[rank], 20))
            p.kill()
            p.wait()
        if self._listener is not None:
            self._listener.close()
            self._listener = None
        if tails:
            log.error("worker startup failure:\n%s", "\n".join(tails))

    # --------------------------------------------------------------- exec
    def set_env_vars(self, env: Dict[str, str]) -> None:
        for ex in self.executors:
            ex.set_env_vars(env)

    def run(self, fn: Callable,
            per_rank_args: Optional[Sequence[Sequence[Any]]] = None,
            on_queue_item: Optional[Callable[[int, Any], None]] = None,
            timeout: Optional[float] = None,
            shared_args: Sequence[Any] = (),
            kwargs: Optional[Dict[str, Any]] = None,
            watchdog: Optional[Callable[[], None]] = None) -> List[Any]:
        """Fan ``fn`` out to every rank and pump until all return. Each
        rank executes ``fn(*shared_args, *per_rank_args[rank], **kwargs)``.

        Ship-once (the reference's ``ray.put(model)`` + object-ref
        fan-out, ray_ddp.py:168-171): ``(fn, shared_args, kwargs)`` is
        pickled ONCE per call whatever the worker count, fanned out by
        content digest and cached worker-side; only the per-rank extras
        are pickled per worker.

        The pump handles side-channel items as they arrive (callables run
        here, in the driver), raises `WorkerError` on the first worker
        error or death, and `TimeoutError` after ``timeout`` seconds;
        ``watchdog`` is as in `wait`."""
        if not self.executors:
            raise RuntimeError("call start() first")
        blob = dumps_by_reference((fn, tuple(shared_args),
                                   dict(kwargs or {})), f"job {fn!r:.80}")
        digest = hashlib.sha256(blob).hexdigest()
        tids = []
        extra_blobs: Dict[int, bytes] = {}
        for rank, ex in enumerate(self.executors):
            extra = per_rank_args[rank] if per_rank_args is not None else ()
            extra_blobs[rank] = dumps_by_reference(
                tuple(extra), f"per-rank arguments of rank {rank}")
            payload = blob if ex._note_digest(digest) else None
            try:
                tids.append(ex.execute_shared(digest, payload,
                                              extra_blobs[rank]))
            except OSError:  # the worker is gone: say how it went
                raise self._eof_error(ex) from None
        resend = {"digest": digest, "blob": blob, "extras": extra_blobs}
        return self.wait(tids, on_queue_item=on_queue_item, timeout=timeout,
                         resend=resend, watchdog=watchdog)

    def wait(self, tids: Sequence[int],
             on_queue_item: Optional[Callable[[int, Any], None]] = None,
             timeout: Optional[float] = None,
             resend: Optional[Dict[str, Any]] = None,
             watchdog: Optional[Callable[[], None]] = None) -> List[Any]:
        """``watchdog`` runs once per pump slice (about 1 Hz) in the
        driver: the resilience layer's stall monitor raises `StallError`
        from it to fail a hung but living worker group
        (`resilience.health.HealthMonitor.check`)."""
        results: Dict[int, Any] = {}
        done: Dict[int, bool] = {r: False for r in range(self.num_workers)}
        deadline = (time.monotonic() + timeout) if timeout is not None \
            else None
        conns = {ex.conn: ex for ex in self.executors}
        while not all(done.values()):
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(
                    f"workers still pending after {timeout}s: "
                    f"{[r for r, d in done.items() if not d]}")
            if watchdog is not None:
                watchdog()
            ready = conn_wait(list(conns), timeout=1.0)
            if not ready:
                self._check_liveness(done)
                continue
            for conn in ready:
                ex = conns[conn]
                try:
                    msg = conn.recv()
                except (EOFError, OSError):  # reset by a dead peer too
                    raise self._eof_error(ex) from None
                self._dispatch(msg, ex, tids, results, done, on_queue_item,
                               resend)
        self.drain_queue(on_queue_item)
        return [results[r] for r in range(self.num_workers)]

    def _eof_error(self, ex: TpuExecutor) -> WorkerError:
        """EOF on the channel means the process died (or is dying):
        harvest its returncode so the death is classified. A killed
        process that held a large CUDA context is reaped only after the
        driver has torn that context down, which can take seconds."""
        try:
            rc = ex.proc.wait(timeout=EOF_REAP_S)
        except subprocess.TimeoutExpired:
            rc = ex.proc.poll()
        if rc is None:
            return WorkerError(
                ex.rank, "worker closed its channel but the process is "
                         "still running (EOF on channel)",
                ex.log_tail(), cause="exit")
        return WorkerError.from_death(ex.rank, rc, ex.log_tail(),
                                      "(EOF on channel)")

    def run_single(self, rank: int, fn: Callable, *args,
                   timeout: Optional[float] = None, **kwargs) -> Any:
        """Execute ``fn`` on ONE rank and return its result."""
        if not self.executors:
            raise RuntimeError("call start() first")
        ex = self.executors[rank]
        tid = ex.execute_async(fn, *args, **kwargs)
        deadline = (time.monotonic() + timeout) if timeout is not None \
            else None
        while True:
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f"rank {rank} still pending")
            if not ex.conn.poll(1.0):
                if not ex.alive():
                    raise WorkerError.from_death(
                        ex.rank, ex.proc.returncode, ex.log_tail(),
                        "without returning a result")
                continue
            try:
                msg = ex.conn.recv()
            except (EOFError, OSError):
                raise self._eof_error(ex) from None
            cmd = msg[0]
            if cmd == "result" and msg[1] == tid:
                return pickle.loads(msg[2])
            if cmd == "error":
                if msg[1] == tid:
                    raise WorkerError(ex.rank, msg[2], ex.log_tail())
                log.warning("dropping stale error from rank %d", ex.rank)
            elif cmd == "queue":
                qrank, item = pickle.loads(msg[1])
                self._handle_queue_item(qrank, item, None)

    def _dispatch(self, msg, ex, tids, results, done, on_queue_item,
                  resend=None) -> None:
        cmd = msg[0]
        if cmd == "need_blob":
            # the worker's cache disagrees with the driver's mirror:
            # resend the payload for THIS task
            tid, digest = msg[1], msg[2]
            if tids[ex.rank] != tid:
                log.warning("dropping stale need_blob from rank %d "
                            "(task %s)", ex.rank, tid)
                return
            if resend is not None and resend["digest"] == digest:
                ex.conn.send(("exec2", tid, digest, resend["blob"],
                              resend["extras"][ex.rank]))
                return
            raise WorkerError(
                ex.rank, f"worker requested blob {digest[:12]} for task "
                         f"{tid} but the driver no longer holds it",
                ex.log_tail())
        if cmd == "result":
            tid, blob = msg[1], msg[2]
            if tid == tids[ex.rank]:
                results[ex.rank] = pickle.loads(blob)
                done[ex.rank] = True
        elif cmd == "error":
            # stale errors of an earlier, already raised run stay
            # buffered on other ranks' channels; raise only for THIS task
            if msg[1] == tids[ex.rank]:
                raise WorkerError(ex.rank, msg[2], ex.log_tail())
            log.warning("dropping stale error from rank %d (task %s)",
                        ex.rank, msg[1])
        elif cmd == "queue":
            rank, item = pickle.loads(msg[1])
            self._handle_queue_item(rank, item, on_queue_item)
        elif cmd == "bye":
            done[ex.rank] = True

    def _handle_queue_item(self, rank, item, on_queue_item) -> None:
        """The trampoline (reference util.py:88-93): callables run here,
        in the driver process."""
        if on_queue_item is not None:
            on_queue_item(rank, item)
        elif callable(item):
            item()
        else:
            self._queue_items.append((rank, item))

    def drain_queue(self, on_queue_item=None) -> None:
        """Post-completion drain (reference util.py:106-109)."""
        for conn in [ex.conn for ex in self.executors]:
            while conn.poll(0):
                try:
                    msg = conn.recv()
                except EOFError:
                    break
                if msg[0] == "queue":
                    rank, item = pickle.loads(msg[1])
                    self._handle_queue_item(rank, item, on_queue_item)

    def queue_items(self) -> List[Any]:
        items, self._queue_items = self._queue_items, []
        return items

    def _check_liveness(self, done) -> None:
        for ex in self.executors:
            if not done[ex.rank] and not ex.alive():
                raise WorkerError.from_death(
                    ex.rank, ex.proc.returncode, ex.log_tail(),
                    "without returning a result")

    # ------------------------------------------------------------ teardown
    def shutdown(self, timeout: float = 10.0) -> None:
        """Graceful shutdown, then kill (reference post_dispatch,
        ray_ddp.py:201-213, with `ray.kill` as SIGKILL)."""
        for ex in self.executors:
            if ex.alive():
                try:
                    ex.conn.send(("shutdown",))
                except (BrokenPipeError, OSError):
                    pass
        deadline = time.monotonic() + timeout
        for ex in self.executors:
            try:
                ex.proc.wait(timeout=max(0.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                ex.kill()
                ex.proc.wait()
            try:
                ex.conn.close()
            except OSError:
                pass
        if self._listener is not None:
            self._listener.close()
            self._listener = None
        self.executors = []

    def __enter__(self) -> "WorkerGroup":
        return self.start() if not self.executors else self

    def __exit__(self, *exc) -> None:
        self.shutdown()
