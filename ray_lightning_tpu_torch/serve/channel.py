"""The driver-to-worker request channel (twin of
`ray_lightning_tpu/serve/channel.py`): the inbound half of a process
replica's wire.

A process replica streams results OUT over its `runtime.WorkerGroup`
side channel; this module is the half that flows IN after spawn: a
seekable, append-only per-replica command log the driver writes and the
replica's worker tails. It imports no framework, and its files are the
JAX package's byte for byte, so either package's reader reads the
other's writer.

- **One JSONL command log per replica per epoch** at
  ``<run_dir>/channel/replica<r>/epoch<k>.jsonl``. Commands are single
  JSON lines ``{"seq": n, "op": ..., **payload}``. ``seq`` is monotonic
  per replica across epochs and never reused, so acks are unambiguous
  across respawns.
- **Seekable, torn-write safe.** The reader remembers its byte offset
  and consumes only lines terminated by ``\\n``: a half-flushed tail line
  is left for the next poll, never parsed. The writer appends each line
  with one ``write()`` and flushes.
- **Acked per batch.** The worker acks over the result side channel
  once per poll batch, with the highest seq consumed (never per
  command, never per token).
- **Replay-safe across respawn.** On respawn the driver seals the old
  epoch and writes a fresh epoch file holding a re-submit for every
  assigned-but-unfinished request (original order) plus the replica's
  control state (drain, pause). The respawned worker reads it from
  offset 0; the scheduler's determinism makes the replayed streams
  bitwise.
- **Cursor files** (``epoch<k>.cursor``): the lockstep of a
  tensor-parallel replica (``tp > 1``, `serve/driver.py`
  `_live_replica_loop`). Every rank holds a whole host-side scheduler
  and must apply the same commands at the same loop iteration, or the
  ranks' admission orders part and the sharded step is fed different
  inputs. Rank 0, the leader, alone reads the command log; it journals
  each state-changing iteration ("consumed commands up to seq N, then
  ticked or not") to the cursor file with `CursorWriter`, before the
  tick whose collectives wait for the followers. The followers read the
  command log only through `CursorReader`: they evaluate no scheduling
  policy and replay the leader's journal, which the scheduler's
  determinism makes their state. The journal is per epoch like the
  command log, so a respawn's replay resets both together. A one-rank
  replica writes none. The format is the JAX package's, so either
  package reads the other's files.

The channel is a FILE, not a socket: the worker loop is single-threaded
and polls between ticks, a file gives seekability (replay is a reader
reset) and outlives the writer, so a driver crash leaves the whole
command history next to the flight recorder's postmortem.
"""
from __future__ import annotations

import json
import logging
import os
import threading
from pathlib import Path
from typing import Any, Dict, List, Optional

log = logging.getLogger(__name__)

#: ops a worker session understands (serve/driver.py _replica_session_main)
OPS = ("submit", "drain", "stop", "pause", "resume")


def channel_dir(run_dir: str | Path, replica: int) -> Path:
    return Path(run_dir) / "channel" / f"replica{replica}"


def epoch_path(run_dir: str | Path, replica: int, epoch: int) -> Path:
    return channel_dir(run_dir, replica) / f"epoch{epoch}.jsonl"


class ChannelWriter:
    """Driver-side command log writer for ONE replica.

    ``send`` appends one command line to the current epoch and returns
    its seq. ``begin_epoch`` seals the current file and starts the next
    one pre-populated with replayed commands — the respawn seam. Seqs
    keep counting across epochs (never reused).
    """

    def __init__(self, run_dir: str | Path, replica: int):
        self.replica = replica
        self.dir = channel_dir(run_dir, replica)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.epoch = 0
        self._seq = 0
        self._run_dir = run_dir
        # serializes the log I/O: driver threads append concurrently
        # (submit routing, eviction rerouting) while the respawn thread
        # rolls epochs. The append body stays INLINE in every locked
        # section — this lock exists to serialize exactly that I/O.
        self._lock = threading.Lock()
        self._f = open(epoch_path(run_dir, replica, 0), "a",
                       encoding="utf-8")

    @property
    def last_seq(self) -> int:
        """Highest seq handed out so far (0 = nothing sent)."""
        return self._seq

    def send(self, op: str, **payload: Any) -> int:
        """Append one command; returns its seq."""
        if op not in OPS:
            raise ValueError(f"unknown channel op {op!r} (one of {OPS})")
        with self._lock:
            self._seq += 1
            rec = {"seq": self._seq, "op": op}
            rec.update(payload)
            # one write() of the full line: a reader that races the
            # append either sees the line with its newline or not at all
            self._f.write(json.dumps(rec) + "\n")
            self._f.flush()
            os.fsync(self._f.fileno())
            return self._seq

    def send_at(self, epoch: int, op: str,
                **payload: Any) -> Optional[int]:
        """Append one command IFF the writer is still on ``epoch``;
        returns its seq, or None when the epoch rolled underneath. The
        deferred-send seam: the driver decides a send under its session
        lock (recording the epoch it decided against) and performs it
        outside — if the replica respawned in between, `begin_epoch`'s
        replay already carries the command (it was computed from the
        same locked state), so appending it again would DUPLICATE the
        stream on the fresh epoch."""
        if op not in OPS:
            raise ValueError(f"unknown channel op {op!r} (one of {OPS})")
        with self._lock:
            if epoch != self.epoch:
                return None
            self._seq += 1
            rec = {"seq": self._seq, "op": op}
            rec.update(payload)
            self._f.write(json.dumps(rec) + "\n")
            self._f.flush()
            os.fsync(self._f.fileno())
            return self._seq

    def begin_epoch(self, replay: List[Dict[str, Any]]) -> int:
        """Seal the current epoch and open the next, pre-populated with
        ``replay`` commands (each an ``{"op": ..., **payload}`` dict —
        seqs are assigned fresh here). Returns the new epoch number the
        respawned worker must be told to read. Atomic against
        `send`/`send_at`: a send deciding against the old epoch either
        lands before the roll (old file, superseded by the replay) or
        is dropped by its epoch guard."""
        with self._lock:
            self._f.close()
            self.epoch += 1
            self._f = open(
                epoch_path(self._run_dir, self.replica, self.epoch), "a",
                encoding="utf-8")
            for cmd in replay:
                payload = {k: v for k, v in cmd.items() if k != "op"}
                self._seq += 1
                rec = {"seq": self._seq, "op": cmd["op"]}
                rec.update(payload)
                self._f.write(json.dumps(rec) + "\n")
            self._f.flush()
            os.fsync(self._f.fileno())
        log.info("replica %d channel epoch %d: %d replayed command(s)",
                 self.replica, self.epoch, len(replay))
        return self.epoch

    def close(self) -> None:
        try:
            self._f.close()
        except Exception:  # noqa: BLE001 — teardown is best-effort
            pass


def _tail_lines(path: Path, offset: int):
    """Complete new JSONL records past ``offset``; returns
    ``(records, new_offset)``. Missing file or a torn tail line read as
    nothing-new (consume only through the last newline)."""
    try:
        with open(path, "rb") as f:
            f.seek(offset)
            chunk = f.read()
    except FileNotFoundError:
        return [], offset
    if not chunk:
        return [], offset
    end = chunk.rfind(b"\n")
    if end < 0:
        return [], offset
    out = [json.loads(line.decode("utf-8"))
           for line in chunk[:end + 1].splitlines() if line.strip()]
    return out, offset + end + 1


class ChannelReader:
    """Worker-side tail of one replica's command log for ONE epoch.

    ``poll()`` (the LEADER's read) returns every COMPLETE new command
    line since the last call (possibly none). ``take_upto(seq)`` (a
    FOLLOWER's read, driven by the leader's cursor log) returns exactly
    the commands with ``seq <= target``, buffering anything newer — the
    primitive that lets every rank of a TP replica group apply
    bit-identical command batches at bit-identical loop iterations.
    The file may not exist yet when the worker races the driver's
    first send — that reads as an empty poll, not an error.
    """

    def __init__(self, run_dir: str | Path, replica: int, epoch: int):
        self.replica = replica
        self.path = epoch_path(run_dir, replica, epoch)
        self._offset = 0
        self._buf: List[Dict[str, Any]] = []
        #: highest seq consumed — the value the leader acks after each
        #: non-empty poll batch (ONE ack per batch: RLT504 discipline)
        self.last_seq = 0

    def _fill(self) -> None:
        recs, self._offset = _tail_lines(self.path, self._offset)
        self._buf.extend(recs)

    def poll(self) -> List[Dict[str, Any]]:
        self._fill()
        out, self._buf = self._buf, []
        for cmd in out:
            self.last_seq = max(self.last_seq, int(cmd.get("seq", 0)))
        return out

    def take_upto(self, seq: int) -> List[Dict[str, Any]]:
        self._fill()
        out = [c for c in self._buf if int(c.get("seq", 0)) <= seq]
        self._buf = [c for c in self._buf if int(c.get("seq", 0)) > seq]
        for cmd in out:
            self.last_seq = max(self.last_seq, int(cmd.get("seq", 0)))
        return out


# ---- the replica-group cursor log (TP lockstep) ---------------------------
#
# Every rank of a tensor-parallel replica group holds a FULL host-side
# scheduler and must apply the same commands at the same loop iteration
# — otherwise two ranks' admission orders diverge and the SPMD step is
# fed different "replicated" inputs (a silent corruption, then a hang).
# Rather than a device-side broadcast per tick, rank 0 (the leader)
# journals every state-changing iteration to a cursor log next to the
# command log: "consumed commands up to seq N, then ticked (or not)".
# Followers do not evaluate scheduling policy at all — they REPLAY the
# leader's iteration journal, which is deterministic by the scheduler's
# purity guarantee. The journal is per-epoch like the command log, so
# respawn replay resets both together.


def cursor_path(run_dir: str | Path, replica: int, epoch: int) -> Path:
    return channel_dir(run_dir, replica) / f"epoch{epoch}.cursor"


class CursorWriter:
    """Leader-side iteration journal for one epoch (tp > 1 only)."""

    def __init__(self, run_dir: str | Path, replica: int, epoch: int):
        p = cursor_path(run_dir, replica, epoch)
        p.parent.mkdir(parents=True, exist_ok=True)
        self._f = open(p, "a", encoding="utf-8")

    def advance(self, seq: int, ticked: bool) -> None:
        self._f.write(json.dumps({"seq": seq, "tick": ticked}) + "\n")
        self._f.flush()

    def end(self) -> None:
        self._f.write(json.dumps({"end": True}) + "\n")
        self._f.flush()

    def close(self) -> None:
        try:
            self._f.close()
        except Exception:  # noqa: BLE001 — teardown is best-effort
            pass


class CursorReader:
    """Follower-side tail of the leader's iteration journal."""

    def __init__(self, run_dir: str | Path, replica: int, epoch: int):
        self.path = cursor_path(run_dir, replica, epoch)
        self._offset = 0
        self._buf: List[Dict[str, Any]] = []

    def next(self) -> Optional[Dict[str, Any]]:
        """The next journal record, or None when the leader has not
        written one yet (the follower idles and retries)."""
        if not self._buf:
            recs, self._offset = _tail_lines(self.path, self._offset)
            self._buf.extend(recs)
        return self._buf.pop(0) if self._buf else None


def ack_item(replica: int, seq: int) -> tuple:
    """The wire item a replica leader puts on the result side channel
    after consuming a poll batch: highest seq consumed, once per batch."""
    return ("ack", replica, seq)


def request_to_wire(req) -> Dict[str, Any]:
    """serve.scheduler.Request -> JSON-safe payload (prompt as a list)."""
    return {
        "rid": req.rid,
        "prompt": [int(t) for t in req.prompt],
        "max_new_tokens": int(req.max_new_tokens),
        "temperature": float(req.temperature),
        "top_k": None if req.top_k is None else int(req.top_k),
        "seed": int(req.seed),
        "eos_id": None if req.eos_id is None else int(req.eos_id),
        "arrival": float(req.arrival),
        "priority": req.priority,
    }


def request_from_wire(d: Dict[str, Any]):
    """Inverse of ``request_to_wire`` (import deferred: the scheduler
    pulls in torch, and the channel itself is host-only)."""
    import numpy as np

    from ray_lightning_tpu_torch.serve.scheduler import Request

    return Request(
        rid=d["rid"],
        prompt=np.asarray(d["prompt"], np.int32),
        max_new_tokens=int(d["max_new_tokens"]),
        temperature=float(d.get("temperature", 0.0)),
        top_k=d.get("top_k"),
        seed=int(d.get("seed", 0)),
        eos_id=d.get("eos_id"),
        arrival=float(d.get("arrival", 0.0)),
        # absent on command logs written before traffic classes
        priority=d.get("priority", "standard"),
    )
