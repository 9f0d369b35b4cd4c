"""Worker process entrypoint — the remote half of the runtime (twin of
`ray_lightning_tpu/runtime/worker.py`).

Executed BY PATH (``python /.../worker.py host port rank world``), or
as the program a remote transport pipes into ``python -u -`` (its
source after a preamble, runtime/transport.py), never via ``-m``, and
stdlib-only, so a worker imports torch (or anything else) only when the
job it is sent needs it.

Reference analog: the ``RayExecutor`` actor body (reference
ray_lightning/ray_ddp.py:17-39). Jobs and results cross a
``multiprocessing.connection`` channel as standard `pickle` blobs: a
function travels by reference (its module is imported here), so jobs are
module-level callables, `functools.partial` objects or instances of
module-level classes, and the repository root leads ``sys.path``.

Wire protocol (all messages are tuples, first element is the command):
  driver -> worker:
    ("env", {k: v})            merge into os.environ (no ack; FIFO)
    ("exec", tid, blob)        blob = pickle((fn, args, kwargs)); reply
                               ("result", tid, blob) or ("error", tid, tb)
    ("exec2", tid, digest, blob_or_None, extra_blob)
                               ship-once execution: blob =
                               pickle((fn, shared_args, kwargs)) on first
                               sight of `digest`, None when this worker
                               has it cached; extra_blob =
                               pickle(per_rank_args). Runs fn(*shared,
                               *per_rank, **kwargs). A None blob whose
                               digest is not cached is answered
                               ("need_blob", tid, digest) and resent.
    ("shutdown",)              reply ("bye", rank), then exit 0
  worker -> driver:
    ("hello", rank, info)      sent once on connect
    ("result", tid, blob) / ("error", tid, tb) / ("need_blob", tid, digest)
    ("queue", blob)            side-channel item from session.put_queue;
                               blob = pickle((rank, item))
"""
import os
import pickle
import socket
import sys
import time
import traceback
from multiprocessing.connection import Client

from ray_lightning_tpu_torch.analysis.lockwatch import san_lock

#: stamped at import — the earliest observable moment of this worker
_PROC_START = time.time()

#: parsed (fn, shared_args, kwargs) tuples by content digest; tiny FIFO
_BLOB_CACHE_CAP = 4


class _WorkerChannel:
    """Thread-safe sender shared by the exec loop and the session side
    channel."""

    def __init__(self, conn, rank: int, world: int):
        self.conn = conn
        self.rank = rank
        self.world = world
        self._lock = san_lock("runtime.worker.channel")

    def send(self, msg) -> None:
        with self._lock:
            self.conn.send(msg)

    def put_queue(self, item) -> None:
        try:
            blob = pickle.dumps((self.rank, item))
        except (pickle.PicklingError, AttributeError, TypeError) as exc:
            raise TypeError(
                f"side-channel item {item!r:.80} cannot be pickled: items "
                "cross by the standard pickle, so a callable must be "
                "picklable by reference (a module-level function, a "
                "functools.partial of one, or an instance of a "
                "module-level class)") from exc
        self.send(("queue", blob))


def _node_ip(conn, host: str) -> str:
    """This worker's address as the other hosts see it: ``RLT_NODE_IP``
    when set (the multi-NIC override), else the local address of its
    channel to the driver, the interface that route leaves by."""
    override = os.environ.get("RLT_NODE_IP")
    if override:
        return override
    try:
        with socket.socket(fileno=os.dup(conn.fileno())) as s:
            return s.getsockname()[0]
    except (OSError, ValueError):
        return host


def _bind_session(channel: _WorkerChannel) -> None:
    """Make ray_lightning_tpu_torch.runtime.session work in this worker;
    deferred until user code runs."""
    from ray_lightning_tpu_torch.runtime import session

    session.init_session(rank=channel.rank, world_size=channel.world,
                         queue=channel, started_at=_PROC_START)


def main(argv) -> int:
    host, port, rank, world = argv[1], int(argv[2]), int(argv[3]), int(argv[4])
    authkey = bytes.fromhex(os.environ.pop("RLT_WORKER_AUTHKEY"))
    conn = Client((host, port), authkey=authkey)
    channel = _WorkerChannel(conn, rank, world)
    channel.send(("hello", rank, {
        "pid": os.getpid(), "ip": _node_ip(conn, host)}))
    session_bound = False
    blob_cache: dict = {}  # digest -> (fn, shared_args, kwargs)
    while True:
        msg = conn.recv()
        cmd = msg[0]
        if cmd == "env":
            os.environ.update(msg[1])
        elif cmd == "exec":
            tid, blob = msg[1], msg[2]
            try:
                fn, args, kwargs = pickle.loads(blob)
                if not session_bound:
                    _bind_session(channel)
                    session_bound = True
                result = fn(*args, **kwargs)
                channel.send(("result", tid, pickle.dumps(result)))
            except BaseException:
                channel.send(("error", tid, traceback.format_exc()))
        elif cmd == "exec2":
            tid, digest, blob, extra_blob = msg[1], msg[2], msg[3], msg[4]
            if blob is None and digest not in blob_cache:
                channel.send(("need_blob", tid, digest))
                continue
            try:
                if blob is not None and digest not in blob_cache:
                    parsed = pickle.loads(blob)  # before any insert
                    while len(blob_cache) >= _BLOB_CACHE_CAP:
                        blob_cache.pop(next(iter(blob_cache)))
                    blob_cache[digest] = parsed
                fn, args, kwargs = blob_cache[digest]
                extra = pickle.loads(extra_blob)
                if not session_bound:
                    _bind_session(channel)
                    session_bound = True
                result = fn(*args, *extra, **kwargs)
                channel.send(("result", tid, pickle.dumps(result)))
            except BaseException:
                channel.send(("error", tid, traceback.format_exc()))
        elif cmd == "shutdown":
            channel.send(("bye", rank))
            return 0
        else:
            channel.send(("error", -1, f"unknown command {cmd!r}"))


if __name__ == "__main__":
    # run by path, the script's own directory leads sys.path; drop it, so
    # the names of its sibling modules do not shadow a job's imports (a
    # program read from stdin has no __file__ and no such entry)
    _here = globals().get("__file__")
    if _here and sys.path and os.path.abspath(sys.path[0]) == \
            os.path.dirname(os.path.abspath(_here)):
        sys.path.pop(0)
    sys.exit(main(sys.argv))
